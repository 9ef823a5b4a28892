// Tensor-core building blocks of the bf16 attention kernels (attention_fwd.cu,
// attention_bwd.cu), bshd layout, Hopper (sm_90a).
//
// Every bf16 kernel is one block of warps, each owning 16 rows of the
// block's own tile (query rows in the forward and dq passes, keys in the
// dk/dv pass), that streams the other operand's 64-row tiles through a
// 2-stage ring in shared memory. Tiles stay bf16 in shared
// memory ([64][DH + 8]: the 16-byte pad puts the 8 rows an ldmatrix reads
// in 8 different bank groups) and are filled by cp.async, 16 bytes a copy,
// through the tensors' strides; rows past S are zero-filled by the copy.
// Every product is mma.sync.m16n8k16 bf16 with fp32 accumulators in
// registers. A 16 x 16 block of an fp32 accumulator (two n8 tiles), packed
// to bf16 pairs, is exactly the A operand of the next product, so p and ds
// go from one product to the next without touching shared memory. An
// optional fp32 bias is added to the fp32 scores after the product: in a
// row masked everywhere q k^T - 1e9 must round to -1e9 exactly, as the TPU
// kernel's fp32 sum does, which the tensor core's own sums do not promise.
//
// The TPU wrapper pads S to Sp = round_up(S, 8) with keys of zero k and v
// that score -1e9. The kernels exclude keys >= S and add what the Sp - S
// padded keys would add to a row's sum, (Sp - S) exp(-1e9 - m), once at the
// end. That term is 0 unless every real key of the row scores at or below
// -1e9; in a fully masked row it makes the row sum(v) / Sp, the TPU's.
//
// Fragment layouts (lane = 4 g + t): an A operand (16 x 16, row-major) holds
// rows g and g + 8, columns 2t, 2t + 1 and 8 + 2t, 9 + 2t; a B operand
// (16 x 8) holds k = 2t, 2t + 1 and 8 + 2t, 9 + 2t of column g; an
// accumulator (16 x 8) holds rows g (c[0], c[1]) and g + 8 (c[2], c[3]),
// columns 2t, 2t + 1.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;              // rows of a streamed tile
constexpr int kWarps = kRows / 16;     // one warp per 16 rows
constexpr int kThreads = 32 * kWarps;  // a block with a 64-row tile of its own
constexpr int kStages = 2;             // ring of streamed tiles
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNeg = -1e9f;          // the TPU wrapper's mask value (_NEG)

// Keys the TPU wrapper adds to reach a multiple of 8 (its sublane quantum).
__host__ __device__ constexpr int padded_keys(int S) { return (S + 7) / 8 * 8 - S; }

// A row's log-sum-exp m + log l as the fp32 pair the forward saves for the
// backward: lse[at] = hi = fp32(m + log l) and lse[plane + at] = lo, what hi
// left out. One fp32 cannot hold it in a fully masked row: at m = -1e9 the
// spacing of fp32 is 64, so hi alone loses log l (log Sp, ~4.4) and the
// backward's exp(s - hi) would give each key 1 where the TPU kernel gives
// 1 / Sp; exp((s - hi) - lo) gives 1 / Sp.
__device__ __forceinline__ void store_lse(float* lse, int64_t plane, int64_t at, float m,
                                          float logl) {
  const float hi = m + logl;
  lse[at] = hi;
  lse[plane + at] = (m - hi) + logl;
}

template <int DH> struct Tile {
  static_assert(DH == 16 || DH == 32 || DH == 64, "head dim 16, 32 or 64");
  static constexpr int kStride = DH + 8;              // elements per smem row
  static constexpr int kElems = kRows * kStride;      // elements per tile
  static constexpr int kChunks = DH / 8;              // 16-byte copies per row
  static constexpr int kSteps = DH / 16;              // k16 steps over DH
  static constexpr int kNTiles = DH / 8;              // n8 tiles over DH
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (src is
// then not read, but is kept a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + ROWS) of one head (x already offset to its batch and head;
// row stride x_ss elements, last dim contiguous) into dst [ROWS][DH + 8];
// rows >= S become zeros. Thread i of THREADS copies chunks i, i + THREADS, ...
template <int DH, int ROWS = kRows, int THREADS = kThreads>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ x,
                                          int64_t x_ss, int r0, int S) {
  using T = Tile<DH>;
  constexpr int kCopies = ROWS * T::kChunks;
#pragma unroll
  for (int n = 0; n < (kCopies + THREADS - 1) / THREADS; ++n) {
    const int i = threadIdx.x + n * THREADS;
    if (kCopies % THREADS != 0 && i >= kCopies) break;
    const int r = i / T::kChunks, c = i % T::kChunks;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * T::kStride + c * 8, x + (ok ? (int64_t)(r0 + r) * x_ss : 0) + c * 8,
               ok);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A bf16 pair, each value multiplied by `scale` in fp32 and rounded back:
// (q * scale).astype(bf16), as the TPU wrapper prescales q.
__device__ __forceinline__ uint32_t scale_pair(uint32_t x, float scale) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  return pack_bf16(f.x * scale, f.y * scale);
}

// The chunks this thread copied with load_tile, scaled in place (call after
// this thread's cp_async_wait for them, before the block's barrier).
template <int DH, int ROWS = kRows, int THREADS = kThreads>
__device__ __forceinline__ void scale_own_chunks(bf16* tile, float scale) {
  using T = Tile<DH>;
  constexpr int kCopies = ROWS * T::kChunks;
#pragma unroll
  for (int n = 0; n < (kCopies + THREADS - 1) / THREADS; ++n) {
    const int i = threadIdx.x + n * THREADS;
    if (kCopies % THREADS != 0 && i >= kCopies) break;
    uint4* p = reinterpret_cast<uint4*>(tile + (i / T::kChunks) * T::kStride +
                                        (i % T::kChunks) * 8);
    uint4 x = *p;
    x.x = scale_pair(x.x, scale);
    x.y = scale_pair(x.y, scale);
    x.z = scale_pair(x.z, scale);
    x.w = scale_pair(x.w, scale);
    *p = x;
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a b: one m16n8k16 bf16 product with fp32 accumulation.
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A operand for rows [r0, r0 + 16), columns [c0, c0 + 16) of a
// row-major tile.
template <int DH>
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* tile, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, tile + (r0 + (lane & 15)) * Tile<DH>::kStride + c0 + (lane >> 4) * 8);
}

// B operands of x · yᵀ for y a row-major [n][k] tile: n8 tiles n0 and n0 + 8
// at k16 step c0. b[0], b[1] go with n0; b[2], b[3] with n0 + 8.
template <int DH>
__device__ __forceinline__ void load_b_rows(uint32_t b[4], const bf16* tile, int n0, int c0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * Tile<DH>::kStride + c0 +
                 ((lane >> 3) & 1) * 8);
}

// B operands of x · y for y a row-major [k][n] tile: k16 step k0, n8 tiles
// n0 and n0 + 8. b[0], b[1] go with n0; b[2], b[3] with n0 + 8.
template <int DH>
__device__ __forceinline__ void load_b_cols(uint32_t b[4], const bf16* tile, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_trans(b, tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * Tile<DH>::kStride + n0 +
                       (lane >> 4) * 8);
}

// The A operand of a 16 x 16 block held as accumulators s0 (columns 0-7)
// and s1 (columns 8-15), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float s0[4], const float s1[4]) {
  a[0] = pack_bf16(s0[0], s0[1]);
  a[1] = pack_bf16(s0[2], s0[3]);
  a[2] = pack_bf16(s1[0], s1[1]);
  a[3] = pack_bf16(s1[2], s1[3]);
}

// The same block as a pair of A operands hi + lo: hi = bf16(x),
// lo = bf16(x - hi), which together hold x to ~2^-16 of its value. Two
// products (hi, then lo) give the backward's sums over p, p * dp and ds
// nearly the precision of fp32 operands.
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

__device__ __forceinline__ void acc_to_a_split(uint32_t hi[4], uint32_t lo[4],
                                               const float s0[4], const float s1[4]) {
  split_pair(s0[0], s0[1], hi[0], lo[0]);
  split_pair(s0[2], s0[3], hi[1], lo[1]);
  split_pair(s1[0], s1[1], hi[2], lo[2]);
  split_pair(s1[2], s1[3], hi[3], lo[3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Accumulator rows g, g + 8 (columns 2t, 2t + 1 of n8 tile j) rounded to
// bf16 and stored at row pointers out0 / out1 (null: row past S).
template <int DH>
__device__ __forceinline__ void store_rows(bf16* out0, bf16* out1, const float acc[][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < Tile<DH>::kNTiles; ++j) {
    if (out0)
      *reinterpret_cast<__nv_bfloat162*>(out0 + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    if (out1)
      *reinterpret_cast<__nv_bfloat162*>(out1 + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[j][2], acc[j][3]);
  }
}

}  // namespace tc
}  // namespace
