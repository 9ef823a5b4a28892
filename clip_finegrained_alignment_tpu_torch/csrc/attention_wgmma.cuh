// Hopper (sm_90a) building blocks of the bf16 blockwise attention kernels
// (flash_fwd.cu, flash_bwd_dq.cu, flash_bwd_dkdv.cu), bhsd layout: TMA tile loads that
// complete on mbarriers, warpgroup matrix products (wgmma) on tiles in
// shared memory, and the register layouts that pass a product's fp32
// accumulator on as the A operand of the next.
//
// Tiles. A [rows][DH] bf16 tile (DH = 16, 32 or 64, rows of 32, 64 or 128
// bytes) is loaded by TMA through a 4-D tensor map over (d, s, h, b) with
// the swizzle whose span is one row (32B, 64B or 128B swizzle): the 16-byte
// chunks of row r are permuted by r mod 8, so the 8 rows a product reads
// together lie in 8 different bank groups. Rows past S are zero-filled by
// the copy. A tile starts on a 1024-byte boundary, the largest swizzle
// atom (8 rows).
//
// Products. wgmma.mma_async m64nNk16 bf16 -> fp32, issued by one warpgroup
// (4 warps, 128 threads) for 64 rows of the block's own operand:
//   - both operands from shared memory (ss): x . y^T for x and y [64][DH]
//     tiles, both K-major (K = DH contiguous), DH / 16 k-steps
//     that advance the descriptors by 32 bytes inside the swizzled rows;
//   - A from registers (rs): a . y for a [64][K] held as accumulators and
//     y a [K][DH] tile (rows are K, DH contiguous: MN-major, trans-b), K / 16
//     k-steps that advance the B descriptor by 16 rows.
// The accumulator of a 64 x N product holds, in thread 4 g + t of warp w,
// rows 16 w + g and 16 w + g + 8 at columns 8 j + 2 t and 8 j + 2 t + 1 of
// every n8 tile j (d[4 j + 0..3]); two neighbouring n8 tiles, packed to bf16
// pairs, are exactly the A fragment of one k16 step, so p and ds go from
// one product to the next without touching shared memory. A value that
// must keep more than bf16's 8 bits goes in as two fragments, hi = bf16(x)
// and lo = bf16(x - hi) (two products, ~2^-16 of x); the forward's p, which
// the TPU kernel rounds to bf16 once, goes in as the one fragment hi. A row
// of an accumulator lies in the 4 threads of a quad (lanes 4 g .. 4 g + 3),
// so its max and sum are two shuffles each.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;                // rows of a warpgroup's operand / a streamed tile
constexpr int kThreads = 128;            // one warpgroup; its thread 0 issues the copies
constexpr int kAlign = 1024;             // swizzle atom: tile alignment in shared memory

template <int DH> struct Tile {
  static_assert(DH == 16 || DH == 32 || DH == 64, "head dim 16, 32 or 64");
  static constexpr int kRowBytes = DH * 2;           // = the swizzle span
  static constexpr int kBytes = kRows * kRowBytes;   // a 64-row tile
  static constexpr int kSteps = DH / 16;             // k16 steps over DH
  // descriptor layout type: 1 = 128B, 2 = 64B, 3 = 32B swizzle
  static constexpr uint64_t kLayout = DH == 64 ? 1 : DH == 32 ? 2 : 3;
  static constexpr CUtensorMapSwizzle kSwizzle =
      DH == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
               : DH == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialized barriers visible to the async proxy (TMA).
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also expects `bytes` of copies to complete on `bar`.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ---------------------------------------------------------------------

// Rows [row, row + box rows) of head (h, b) of a 4-D (d, s, h, b) tensor map
// into dst; completes on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int row, int h,
                                         int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row), "r"(h), "r"(b),
      "r"(smem_u32(bar))
      : "memory");
}

// `bytes` (a multiple of 16, src and dst 16-byte aligned) global -> shared.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor of a tile that starts at `p` (swizzled as
// TMA wrote it). The stride between 8-row groups (SBO) is 8 rows. The
// leading offset (LBO) steps between swizzle atoms along a row, which these
// layouts never do (one atom spans the K-major k16 step and the MN-major DH
// columns); it is given the same value.
template <int DH>
__device__ __forceinline__ uint64_t desc(const void* p) {
  constexpr uint64_t off = (8 * Tile<DH>::kRowBytes) >> 4;
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (off << 16) | (off << 32) |
         (Tile<DH>::kLayout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products.
template <int R> __device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define CFA_F8(i)                                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),       \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define CFA_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define CFA_R16 CFA_R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define CFA_R32                                                                      \
  CFA_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
          "%30, %31"

// d (+)= A B for a 64 x N fp32 accumulator d[N / 2]; `acc` = 0 overwrites.
// ss (N = 64, a 64-row tile of the other side): A and B from descriptors,
// both K-major. rs (N = DH): A from registers, B MN-major (trans-b).
template <int N> struct Mma;

template <> struct Mma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" CFA_R32
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : CFA_F8(0), CFA_F8(8), CFA_F8(16), CFA_F8(24)
        : "l"(a), "l"(b), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" CFA_R32
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : CFA_F8(0), CFA_F8(8), CFA_F8(16), CFA_F8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <> struct Mma<32> {
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" CFA_R16
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : CFA_F8(0), CFA_F8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

template <> struct Mma<16> {
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                            int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {" CFA_R8
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : CFA_F8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
  }
};

#undef CFA_R32
#undef CFA_R16
#undef CFA_R8
#undef CFA_F8

// d = x . y^T over DH for x and y [64][DH] at xs and ys (both tiles as TMA
// wrote them): DH / 16 ss products, the first overwriting d.
template <int DH>
__device__ __forceinline__ void mma_xyT(float (&d)[32], const void* xs, const void* ys) {
  const uint64_t a = desc<DH>(xs), b = desc<DH>(ys);
#pragma unroll
  for (int ks = 0; ks < Tile<DH>::kSteps; ++ks)  // +32 bytes = 2 descriptor units
    Mma<64>::ss(d, a + 2 * ks, b + 2 * ks, ks > 0);
}

// d += a . y for the A fragment of k16 step ks and y [K][DH] at ys.
template <int DH>
__device__ __forceinline__ void mma_ay(float (&d)[DH / 2], const uint32_t (&a)[4],
                                       const void* ys, int ks) {
  // 16 rows = 16 * rowbytes bytes further, in 16-byte units
  Mma<DH>::rs(d, a, desc<DH>(ys) + ks * Tile<DH>::kRowBytes, 1);
}

// ---- accumulator -> A fragments ---------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x, y as hi = bf16 pair and lo = bf16 pair of what hi left out.
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// The A fragment of k16 step ks from a 64 x N accumulator (its n8 tiles
// 2 ks and 2 ks + 1), rounded to bf16.
template <int R>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&d)[R], int ks) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = pack_bf16(d[8 * ks + 2 * i], d[8 * ks + 2 * i + 1]);
}

// The hi and lo A fragments of k16 step ks from a 64 x N accumulator (its
// n8 tiles 2 ks and 2 ks + 1).
template <int R>
__device__ __forceinline__ void acc_to_a_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                               const float (&d)[R], int ks) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_pair(d[8 * ks + 2 * i], d[8 * ks + 2 * i + 1], hi[i], lo[i]);
}

// The max and the sum of a row over the 4 threads of its quad.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- host: tensor maps ---------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no link against libcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
        cudaSuccess)
      return nullptr;
#endif
    if (found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over a [B, H, S, DH] bf16 tensor at `base` with element strides
// sb, sh, ss (multiples of 8: 16 bytes), in boxes of `rows` rows of one
// head. Rows past S read as zeros.
template <int DH>
cudaError_t make_map(CUtensorMap* map, const void* base, int B, int H, int S, int64_t sb,
                     int64_t sh, int64_t ss, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)DH, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)DH, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            Tile<DH>::kSwizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace wg
}  // namespace
