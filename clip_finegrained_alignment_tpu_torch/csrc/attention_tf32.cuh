// Building blocks of the float32 attention kernels on the TF32 tensor cores
// (attention_fwd.cu's forward, attention_bwd.cu's two backward passes),
// Hopper (sm_90a).
//
// Both take every fp32 product as three mma.sync.m16n8k8 TF32 products
// (tf32_mma.cuh) of operands split once into TF32 hi and lo halves as they
// are stored in shared memory. A pair of head dims (2i, 2i + 1) of a row
// is stored as one 16-byte chunk of four words, hi(2i), hi(2i + 1),
// lo(2i), lo(2i + 1), so the lane that reads a fragment's two elements
// takes their four words in one 16-byte load; within a k8 step, A column
// t holds head dim 2t and column t + 4 head dim 2t + 1, and the B
// fragment pairs them the same way (a sum over the k dim may be taken in
// any order).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {
namespace tfa {

// Head dims 4c .. 4c + 3 of one row as the two chunks of pairs 2c and
// 2c + 1.
__device__ __forceinline__ void split_pairs(float4 x, uint4& a, uint4& b) {
  uint32_t h[4], l[4];
  tf32::split(x.x, h[0], l[0]);
  tf32::split(x.y, h[1], l[1]);
  tf32::split(x.z, h[2], l[2]);
  tf32::split(x.w, h[3], l[3]);
  a = make_uint4(h[0], h[1], l[0], l[1]);
  b = make_uint4(h[2], h[3], l[2], l[3]);
}

// c[n] += a·b[n] with fp32 accuracy for the n8 tiles n < N: the lo·hi
// products of all of them, then hi·lo, then hi·hi (lo·lo first when
// PRODUCTS is 4; hi·hi alone, plain TF32, when it is 1), so one
// accumulator's products sit N apart.
template <int N, int PRODUCTS>
__device__ __forceinline__ void mma_row(float (*c)[4], const uint32_t* ah, const uint32_t* al,
                                        const uint32_t (*bh)[2], const uint32_t (*bl)[2]) {
  if (PRODUCTS == 4) {
#pragma unroll
    for (int n = 0; n < N; ++n) tf32::mma_tf32(c[n], al, bl[n]);
  }
  if (PRODUCTS >= 3) {
#pragma unroll
    for (int n = 0; n < N; ++n) tf32::mma_tf32(c[n], al, bh[n]);
#pragma unroll
    for (int n = 0; n < N; ++n) tf32::mma_tf32(c[n], ah, bl[n]);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) tf32::mma_tf32(c[n], ah, bh[n]);
}

// c[n] += a·b[n] as mma_row, but each n8 tile's products are taken into a
// zeroed accumulator and then added to c[n] with an ordinary fp32 add,
// rounded to nearest. mma.sync's TF32 sums round toward zero: a running
// sum kept in the mma accumulator itself loses about half an ulp of the
// sum at every k8 step (the backward's dq, dk and dv came out ~2e-6
// small, perf/fp32_grad_bias_study.py); here the truncation spans one
// k8 step's products, and the running sum is rounded without bias.
template <int N, int PRODUCTS>
__device__ __forceinline__ void mma_row_rn(float (*c)[4], const uint32_t* ah, const uint32_t* al,
                                           const uint32_t (*bh)[2], const uint32_t (*bl)[2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    if (PRODUCTS == 4) tf32::mma_tf32(d, al, bl[n]);
    if (PRODUCTS >= 3) {
      tf32::mma_tf32(d, al, bh[n]);
      tf32::mma_tf32(d, ah, bl[n]);
    }
    tf32::mma_tf32(d, ah, bh[n]);
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = __fadd_rn(c[n][e], d[e]);
  }
}

// A fragment of a 16-row block held as m16n8k8 accumulators c (rows g,
// g + 8; columns 2t, 2t + 1), split: column t takes the accumulator's
// column 2t and column t + 4 its column 2t + 1, so the B fragment of the
// next product is the matching pair of its k rows.
__device__ __forceinline__ void acc_to_a(uint32_t ah[4], uint32_t al[4], const float c[4]) {
  tf32::split(c[0], ah[0], al[0]);
  tf32::split(c[2], ah[1], al[1]);
  tf32::split(c[1], ah[2], al[2]);
  tf32::split(c[3], ah[3], al[3]);
}

}  // namespace tfa
}  // namespace
