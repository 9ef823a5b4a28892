// Dynamic int8 quantize and dequantize passes for Hopper (sm_90a), around
// torch._int_mm (cuBLASLt's int8 GEMM, int32 sums).
//
// No Pallas kernel to replace: the JAX package's int8 path
// (clip_finegrained_alignment_tpu/ops/quant.py) is XLA, which fuses each
// of these into one pass on the TPU: _absmax_quant (:46-57, symmetric
// absmax to int8) and int8_matmul's epilogue (:60-71, int32 -> f32 times
// the row and column scales). Eager PyTorch would take about seven
// launches an operand for them. Three C entries, each one launch from its
// wrapper in ops/quant.py:
//
//   cfa_quant_rows    [R, C] bf16|fp32 -> int8 [R, C], fp32 scales [R]
//                     (x in the forward, g in dgrad, W [N, K] in the
//                     forward: one scale an output feature);
//   cfa_quant_cols_t  [R, C] -> the per-column quantization written
//                     transposed, int8 [C, R_pad] (rows past R zero,
//                     R_pad = R rounded up to 8), fp32 scales [C] (W in
//                     dgrad, x and g in the int8 wgrad). Two kernels: the
//                     columns' partial absmax over chunks of rows, then
//                     the tiles, each reducing its columns' partials;
//   cfa_dequant       int32 [R, C] * (s_row[R] (x) s_col[C]) -> bf16|fp32,
//                     then + bias in that type (bias optional).
//
// When a reduced dimension is split over ranks (a row-parallel layer's
// K, a column-parallel layer's N, the example rows M of global negatives
// or of sequence parallelism), the absmax must be the MAX over the ranks
// that hold the parts, as JAX's GSPMD step takes it: the fused passes
// split in two around that all-reduce (ops/quant.py), four more entries:
//
//   cfa_absmax_rows      [R, C] -> fp32 [R], max |x| of each row;
//   cfa_absmax_cols      [R, C] -> fp32 [C], max |x| of each column
//                        (col_absmax_kernel's partials, then their max);
//   cfa_quant_rows_given [R, C] and a row absmax [R] -> int8 [R, C] and
//                        the scales [R] (quant_rows_kernel, its first
//                        read skipped);
//   cfa_quant_cols_t_given  [R, C] and a column absmax [C] -> int8
//                        [C, R_pad] and the scales [C] (quant_cols_t_kernel
//                        with the absmax as its one chunk of partials).
//
// The scale is computed from the absmax as the fused passes compute it, so
// the split path on one rank is the fused one bit for bit.
//
// Numerics are the plain versions' bit for bit (no fast-math in the build):
// s = max(absmax, 1e-12) / 127 by IEEE division (a NaN absmax stays NaN,
// as torch's clamp_min keeps it), q = rint(x / s) (half to even, as
// torch.round and jnp.round), y = float(acc) * (s_row * s_col), rounded to
// the output type, then the bias added in that type. The _rn intrinsics
// keep nvcc from contracting a multiply and an add into an fma.
//
// Bound on the card (NVIDIA H100 80GB HBM3, 3.35 TB/s): bytes. Each pass
// reads its operand once and writes a quarter (bf16: a half) of it back,
// a few flops a byte; at ViT-B/16's vision microbatch (M = 32 x 197 =
// 6304) quant_rows of x [6304, 768] bf16 moves 14.5 MB (4.3 us), dequant
// of [6304, 3072] int32 -> bf16 116 MB (35 us). Design, simple first:
// quant_rows gives one warp a row, 16-byte loads where C % 8 == 0, and
// reads the row twice (absmax, then quantize; the second read mostly from
// L2); quant_cols_t transposes through a 32-column x 64-row int8 tile in
// shared memory so its stores are 8 bytes a thread along the output rows;
// dequant takes four elements a thread (16-byte loads of the sums).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kScaleFloor = 1e-12f;
constexpr float kQMax = 127.0f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// max that keeps a NaN (fmaxf drops it), so a NaN operand gives a NaN
// scale and a NaN output, as the plain version's amax does.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float absmax_scale(float m) {
  return m != m ? m : __fdiv_rn(fmaxf(m, kScaleFloor), kQMax);
}

// |x / s| <= 127 by construction, so the conversion is exact.
__device__ __forceinline__ int8_t quantize(float x, float s) {
  return static_cast<int8_t>(static_cast<int>(rintf(__fdiv_rn(x, s))));
}

// Eight consecutive elements as floats from a 16-byte aligned address.
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);            // low half first
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack4(int8_t a, int8_t b, int8_t c, int8_t d) {
  return static_cast<uint32_t>(static_cast<uint8_t>(a)) |
         (static_cast<uint32_t>(static_cast<uint8_t>(b)) << 8) |
         (static_cast<uint32_t>(static_cast<uint8_t>(c)) << 16) |
         (static_cast<uint32_t>(static_cast<uint8_t>(d)) << 24);
}

// ---------------------------------------------------------------------------
// quant_rows: one warp a row, eight rows a block.

constexpr int kRowsPerBlock = 8;

// max |x| over one row, the whole warp's (every lane holds it).
template <typename T>
__device__ __forceinline__ float row_absmax(const T* row, int lane, int C, bool vec) {
  float m = 0.0f;
  if (vec) {
    for (int c = lane * 8; c < C; c += 256) {
      float v[8];
      load8(row + c, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) m = nan_max(m, fabsf(v[i]));
    }
  } else {
    for (int c = lane; c < C; c += 32) m = nan_max(m, fabsf(to_f(row[c])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
  return m;
}

// a[r] = max |x[r][:]|.
template <typename T>
__global__ void __launch_bounds__(256) absmax_rows_kernel(const T* __restrict__ x,
                                                          float* __restrict__ a, int R, int C,
                                                          bool vec) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;
  const float m = row_absmax(x + (size_t)r * C, lane, C, vec);
  if (lane == 0) a[r] = m;
}

// given: null (each row's absmax taken here) or the rows' absmax [R].
template <typename T>
__global__ void __launch_bounds__(256) quant_rows_kernel(const T* __restrict__ x,
                                                         const float* __restrict__ given,
                                                         int8_t* __restrict__ q,
                                                         float* __restrict__ s, int R,
                                                         int C, bool vec) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (r >= R) return;  // the whole warp
  const T* row = x + (size_t)r * C;
  int8_t* qrow = q + (size_t)r * C;
  const float m = given ? given[r] : row_absmax(row, lane, C, vec);
  const float sc = absmax_scale(m);
  if (lane == 0) s[r] = sc;
  if (vec) {
    for (int c = lane * 8; c < C; c += 256) {
      float v[8];
      load8(row + c, v);
      uint2 out;
      out.x = pack4(quantize(v[0], sc), quantize(v[1], sc), quantize(v[2], sc),
                    quantize(v[3], sc));
      out.y = pack4(quantize(v[4], sc), quantize(v[5], sc), quantize(v[6], sc),
                    quantize(v[7], sc));
      *reinterpret_cast<uint2*>(qrow + c) = out;
    }
  } else {
    for (int c = lane; c < C; c += 32) qrow[c] = quantize(to_f(row[c]), sc);
  }
}

// ---------------------------------------------------------------------------
// quant_cols_t: blocks of 32 columns x 8 row lanes.

constexpr int kColTile = 32;
constexpr int kRowLanes = 8;
constexpr int kRowTile = 64;  // rows of x in a transposed tile

// partial[k][c] = max |x[r][c]| over rows r of chunk k.
template <typename T>
__global__ void __launch_bounds__(256) col_absmax_kernel(const T* __restrict__ x,
                                                         float* __restrict__ partial,
                                                         int R, int C, int chunk) {
  __shared__ float red[kRowLanes][kColTile];
  const int c = blockIdx.x * kColTile + threadIdx.x;
  const int r0 = blockIdx.y * chunk;
  const int r1 = min(R, r0 + chunk);
  float m = 0.0f;
  if (c < C)
    for (int r = r0 + threadIdx.y; r < r1; r += kRowLanes)
      m = nan_max(m, fabsf(to_f(x[(size_t)r * C + c])));
  red[threadIdx.y][threadIdx.x] = m;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
#pragma unroll
    for (int j = 1; j < kRowLanes; ++j) m = nan_max(m, red[j][threadIdx.x]);
    partial[(size_t)blockIdx.y * C + c] = m;
  }
}

// a[c] = max over k of partial[k][c].
__global__ void __launch_bounds__(256) reduce_partials_kernel(const float* __restrict__ partial,
                                                              float* __restrict__ a, int C,
                                                              int chunks) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float m = 0.0f;
  for (int k = 0; k < chunks; ++k) m = nan_max(m, partial[(size_t)k * C + c]);
  a[c] = m;
}

// qt[c][r] = quantize(x[r][c], s[c]) for r < R, 0 for R <= r < R_pad.
template <typename T>
__global__ void __launch_bounds__(256) quant_cols_t_kernel(const T* __restrict__ x,
                                                           const float* __restrict__ partial,
                                                           int8_t* __restrict__ qt,
                                                           float* __restrict__ s, int R,
                                                           int C, int R_pad, int chunks) {
  __shared__ float sc[kColTile];
  // [column][row]; a row of 72 bytes keeps every 8-byte group aligned.
  __shared__ __align__(16) int8_t tile[kColTile][kRowTile + 8];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c0 = blockIdx.x * kColTile, r0 = blockIdx.y * kRowTile;
  const int c = c0 + tx;
  if (ty == 0) {
    float m = 0.0f;
    if (c < C)
      for (int k = 0; k < chunks; ++k) m = nan_max(m, partial[(size_t)k * C + c]);
    const float v = absmax_scale(m);
    sc[tx] = v;
    if (blockIdx.y == 0 && c < C) s[c] = v;
  }
  __syncthreads();
  for (int i = ty; i < kRowTile; i += kRowLanes) {
    const int r = r0 + i;
    tile[tx][i] = (c < C && r < R) ? quantize(to_f(x[(size_t)r * C + c]), sc[tx]) : 0;
  }
  __syncthreads();
  // 32 output rows of 64 bytes: 8 bytes a thread.
  const int t = ty * kColTile + tx;
  const int oc = t / (kRowTile / 8), part = t % (kRowTile / 8);
  const int col = c0 + oc, r = r0 + part * 8;
  if (col < C && r < R_pad)
    *reinterpret_cast<uint2*>(qt + (size_t)col * R_pad + r) =
        *reinterpret_cast<const uint2*>(&tile[oc][part * 8]);
}

// ---------------------------------------------------------------------------
// dequant: four elements a thread.

__device__ __forceinline__ float dq(int32_t a, float sr, float sc) {
  return __fmul_rn(__int2float_rn(a), __fmul_rn(sr, sc));
}

__device__ __forceinline__ float finish(float y, const float* bias, int c) {
  return bias ? __fadd_rn(y, bias[c]) : y;
}

__device__ __forceinline__ __nv_bfloat16 finish(float y, const __nv_bfloat16* bias, int c) {
  const __nv_bfloat16 b = __float2bfloat16_rn(y);
  return bias ? __float2bfloat16_rn(__fadd_rn(__bfloat162float(b), __bfloat162float(bias[c])))
              : b;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const __nv_bfloat16* v) {
  uint2 u;
  u.x = static_cast<uint32_t>(__bfloat16_as_ushort(v[0])) |
        (static_cast<uint32_t>(__bfloat16_as_ushort(v[1])) << 16);
  u.y = static_cast<uint32_t>(__bfloat16_as_ushort(v[2])) |
        (static_cast<uint32_t>(__bfloat16_as_ushort(v[3])) << 16);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T>
__global__ void __launch_bounds__(256) dequant_kernel(const int32_t* __restrict__ acc,
                                                      const float* __restrict__ s_row,
                                                      const float* __restrict__ s_col,
                                                      const T* __restrict__ bias,
                                                      T* __restrict__ y, int R, int C,
                                                      bool vec) {
  const size_t n = (size_t)R * C;
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  if (vec) {  // C % 4 == 0: the four lie in one row
    const int r = (int)(i / C), c = (int)(i % C);
    const int4 a = *reinterpret_cast<const int4*>(acc + i);
    const float sr = s_row[r];
    const int32_t av[4] = {a.x, a.y, a.z, a.w};
    T out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = finish(dq(av[j], sr, s_col[c + j]), bias, c + j);
    store4(y + i, out);
  } else {
    for (size_t e = i; e < i + 4 && e < n; ++e) {
      const int r = (int)(e / C), c = (int)(e % C);
      y[e] = finish(dq(acc[e], s_row[r], s_col[c]), bias, c);
    }
  }
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Each entry returns 0, a CUDA error code,
// -1 for shapes it does not take, -2 for an unknown dtype.

extern "C" int cfa_quant_rows(const void* x, void* q, void* s, int R, int C, int dtype,
                              void* stream) {
  if (R < 1 || C < 1) return -1;
  const bool vec = C % 8 == 0 && aligned(x, 16) && aligned(q, 8);
  const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    quant_rows_kernel<float><<<grid, 256, 0, st>>>(static_cast<const float*>(x), nullptr,
                                                   static_cast<int8_t*>(q),
                                                   static_cast<float*>(s), R, C, vec);
  else if (dtype == 1)
    quant_rows_kernel<__nv_bfloat16><<<grid, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), nullptr, static_cast<int8_t*>(q),
        static_cast<float*>(s), R, C, vec);
  else
    return -2;
  return (int)cudaGetLastError();
}

// partial: fp32 scratch of ceil(R / chunk) x C.
extern "C" int cfa_quant_cols_t(const void* x, void* qt, void* s, void* partial, int R, int C,
                                int R_pad, int chunk, int dtype, void* stream) {
  if (R < 1 || C < 1 || chunk < 1 || R_pad < R || R_pad % 8 != 0 || !aligned(qt, 8))
    return -1;
  const int chunks = (R + chunk - 1) / chunk;
  const dim3 block(kColTile, kRowLanes);
  const dim3 grid1((C + kColTile - 1) / kColTile, chunks);
  const dim3 grid2((C + kColTile - 1) / kColTile, (R_pad + kRowTile - 1) / kRowTile);
  if (grid1.y > 65535 || grid2.y > 65535) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  if (dtype == 0) {
    const float* xp = static_cast<const float*>(x);
    col_absmax_kernel<float><<<grid1, block, 0, st>>>(xp, part, R, C, chunk);
    quant_cols_t_kernel<float><<<grid2, block, 0, st>>>(
        xp, part, static_cast<int8_t*>(qt), static_cast<float*>(s), R, C, R_pad, chunks);
  } else if (dtype == 1) {
    const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
    col_absmax_kernel<__nv_bfloat16><<<grid1, block, 0, st>>>(xp, part, R, C, chunk);
    quant_cols_t_kernel<__nv_bfloat16><<<grid2, block, 0, st>>>(
        xp, part, static_cast<int8_t*>(qt), static_cast<float*>(s), R, C, R_pad, chunks);
  } else {
    return -2;
  }
  return (int)cudaGetLastError();
}

// bias: null, or [C] in the output's type.
extern "C" int cfa_dequant(const void* acc, const void* s_row, const void* s_col,
                           const void* bias, void* y, int R, int C, int dtype, void* stream) {
  if (R < 1 || C < 1) return -1;
  const size_t n = (size_t)R * C;
  const bool vec = C % 4 == 0 && aligned(acc, 16) && aligned(y, dtype == 0 ? 16 : 8);
  const size_t blocks = (n + 4 * 256 - 1) / (4 * 256);
  if (blocks > 0x7fffffff) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* a = static_cast<const int32_t*>(acc);
  const float* sr = static_cast<const float*>(s_row);
  const float* sc = static_cast<const float*>(s_col);
  if (dtype == 0)
    dequant_kernel<float><<<(unsigned)blocks, 256, 0, st>>>(
        a, sr, sc, static_cast<const float*>(bias), static_cast<float*>(y), R, C, vec);
  else if (dtype == 1)
    dequant_kernel<__nv_bfloat16><<<(unsigned)blocks, 256, 0, st>>>(
        a, sr, sc, static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(y), R,
        C, vec);
  else
    return -2;
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The split passes: reduce, then quantize with a given absmax.

extern "C" int cfa_absmax_rows(const void* x, void* a, int R, int C, int dtype, void* stream) {
  if (R < 1 || C < 1) return -1;
  const bool vec = C % 8 == 0 && aligned(x, 16);
  const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    absmax_rows_kernel<float><<<grid, 256, 0, st>>>(static_cast<const float*>(x),
                                                    static_cast<float*>(a), R, C, vec);
  else if (dtype == 1)
    absmax_rows_kernel<__nv_bfloat16><<<grid, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<float*>(a), R, C, vec);
  else
    return -2;
  return (int)cudaGetLastError();
}

// partial: fp32 scratch of ceil(R / chunk) x C (unused with one chunk).
extern "C" int cfa_absmax_cols(const void* x, void* a, void* partial, int R, int C, int chunk,
                               int dtype, void* stream) {
  if (R < 1 || C < 1 || chunk < 1) return -1;
  const int chunks = (R + chunk - 1) / chunk;
  const dim3 block(kColTile, kRowLanes);
  const dim3 grid((C + kColTile - 1) / kColTile, chunks);
  if (grid.y > 65535) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = chunks == 1 ? static_cast<float*>(a) : static_cast<float*>(partial);
  if (dtype == 0)
    col_absmax_kernel<float><<<grid, block, 0, st>>>(static_cast<const float*>(x), part, R, C,
                                                     chunk);
  else if (dtype == 1)
    col_absmax_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), part, R, C, chunk);
  else
    return -2;
  if (chunks > 1)
    reduce_partials_kernel<<<(C + 255) / 256, 256, 0, st>>>(part, static_cast<float*>(a), C,
                                                            chunks);
  return (int)cudaGetLastError();
}

extern "C" int cfa_quant_rows_given(const void* x, const void* a, void* q, void* s, int R,
                                    int C, int dtype, void* stream) {
  if (R < 1 || C < 1) return -1;
  const bool vec = C % 8 == 0 && aligned(x, 16) && aligned(q, 8);
  const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* given = static_cast<const float*>(a);
  if (dtype == 0)
    quant_rows_kernel<float><<<grid, 256, 0, st>>>(static_cast<const float*>(x), given,
                                                   static_cast<int8_t*>(q),
                                                   static_cast<float*>(s), R, C, vec);
  else if (dtype == 1)
    quant_rows_kernel<__nv_bfloat16><<<grid, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), given, static_cast<int8_t*>(q),
        static_cast<float*>(s), R, C, vec);
  else
    return -2;
  return (int)cudaGetLastError();
}

extern "C" int cfa_quant_cols_t_given(const void* x, const void* a, void* qt, void* s, int R,
                                      int C, int R_pad, int dtype, void* stream) {
  if (R < 1 || C < 1 || R_pad < R || R_pad % 8 != 0 || !aligned(qt, 8)) return -1;
  const dim3 block(kColTile, kRowLanes);
  const dim3 grid((C + kColTile - 1) / kColTile, (R_pad + kRowTile - 1) / kRowTile);
  if (grid.y > 65535) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* given = static_cast<const float*>(a);
  if (dtype == 0)
    quant_cols_t_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(x), given, static_cast<int8_t*>(qt), static_cast<float*>(s),
        R, C, R_pad, 1);
  else if (dtype == 1)
    quant_cols_t_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), given, static_cast<int8_t*>(qt),
        static_cast<float*>(s), R, C, R_pad, 1);
  else
    return -2;
  return (int)cudaGetLastError();
}
