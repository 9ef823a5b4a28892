// Device helpers shared by the blockwise attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkdv.cu), bhsd layout. The whole-tile kernels
// (attention_fwd.cu, attention_bwd.cu) keep their own copies: built against
// this header, attention_bwd.cu ran 7 % slower on an H100 (other register
// allocation), so they were left as measured.
//
// Every kernel is one block of 256 threads (16 x 16) over a 64 x 64 tile of
// scores: thread (tx, ty) owns 4 rows ty*4.. and 4 columns tx*4.., and the
// 16 threads of a row group are 16 neighbouring lanes of one warp, so row
// maxima and sums are 4 xor-shuffles. Operands are staged in shared memory
// as fp32, transposed where a float4 read along the tile's rows is wanted.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int NT = TX * TY;     // threads per block
constexpr int R4 = 4;           // rows / keys per thread in a score tile
constexpr int QSTR = BQ + 4;    // row stride of query-indexed tiles (float4 aligned)
constexpr int KSTR = BK + 4;    // row stride of key-indexed tiles
constexpr float NEG = -1e9f;    // the TPU wrapper's mask value (_NEG)

static_assert(BQ == TY * R4 && BK == TX * R4 && BK == TY * R4 && BQ == TX * R4,
              "the float4 tile reads assume 64 x 64 tiles of 4 x 4");

// Floats of a [DH][64 + 4] operand tile, or of the [64][64 + 4] score tile
// that takes its space once the operand is read.
template <int DH>
__host__ __device__ constexpr size_t tile_floats() {
  return (size_t)DH * KSTR > (size_t)BK * QSTR ? (size_t)DH * KSTR : (size_t)BK * QSTR;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}

// RD consecutive floats (RD in {1, 2, 4}) from 16-byte-aligned shared memory.
template <int RD>
__device__ __forceinline__ void load_rd(const float* p, float out[RD]) {
  if constexpr (RD == 4) {
    load4(p, out);
  } else if constexpr (RD == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    out[0] = a.x; out[1] = a.y;
  } else {
#pragma unroll
    for (int j = 0; j < RD; ++j) out[j] = p[j];
  }
}

// Loads rows [r0, r0 + 64) of one head (xb points at its row 0; rows x_ss
// elements apart, the head dim contiguous) into shared memory as fp32:
// transposed into xt[DH][STR] and row-major into xs[64][DH], each where it
// is not null. Rows >= S are zero. With SCALED the value is (x * scale)
// rounded to T, as the TPU wrapper prescales q.
template <typename T, int DH, int STR, bool SCALED = false>
__device__ __forceinline__ void load_tile(const T* __restrict__ xb, int64_t x_ss,
                                          int r0, int S, float scale,
                                          float* __restrict__ xt,
                                          float* __restrict__ xs) {
  for (int i = threadIdx.x; i < 64 * DH; i += NT) {
    const int r = i / DH, d = i % DH;
    const int row = r0 + r;
    float x = 0.f;
    if (row < S) {
      x = to_f(xb[row * x_ss + d]);
      if (SCALED) x = round_to<T>(x * scale);
    }
    if (xt) xt[d * STR + r] = x;
    if (xs) xs[r * DH + d] = x;
  }
}

// s[i][j] = sum_d At[d][a0 + i] * Bt[d][b0 + j] for a 4 x 4 block.
template <int DH>
__device__ __forceinline__ void dot4x4(const float* __restrict__ At, int astr, int a0,
                                       const float* __restrict__ Bt, int bstr, int b0,
                                       float s[R4][R4]) {
#pragma unroll
  for (int i = 0; i < R4; ++i)
#pragma unroll
    for (int j = 0; j < R4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DH; ++d) {
    float a[R4], b[R4];
    load4(&At[d * astr + a0], a);
    load4(&Bt[d * bstr + b0], b);
#pragma unroll
    for (int i = 0; i < R4; ++i)
#pragma unroll
      for (int j = 0; j < R4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// Above 48 KB dynamic shared memory needs the opt-in, which holds for the
// current device only; it is a cheap host call, made on every launch.
template <typename Kern>
cudaError_t opt_in(Kern kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// The three C entries dispatch on (dtype, Dh) the same way: 0 = float32,
// 1 = bfloat16; Dh in {16, 32, 64}; -1 for anything else.
#define CFA_DISPATCH(LAUNCH)                   \
  if (dtype == 0) {                                  \
    if (Dh == 16) return (int)LAUNCH(float, 16);     \
    if (Dh == 32) return (int)LAUNCH(float, 32);     \
    if (Dh == 64) return (int)LAUNCH(float, 64);     \
  } else if (dtype == 1) {                           \
    if (Dh == 16) return (int)LAUNCH(__nv_bfloat16, 16); \
    if (Dh == 32) return (int)LAUNCH(__nv_bfloat16, 32); \
    if (Dh == 64) return (int)LAUNCH(__nv_bfloat16, 64); \
  }                                                  \
  return -1
