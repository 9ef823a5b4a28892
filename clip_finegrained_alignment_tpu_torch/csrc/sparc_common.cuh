// Device code shared by the fused SPARC pooling forward (sparc_fwd.cu) and
// backward (sparc_bwd.cu).
//
// The backward recomputes the forward's similarity, min/max, threshold and
// weights, and its decisions (ties sm == mn, z < tau) are exact
// comparisons. So both kernels compute them with the functions below, with
// the same block size and the same summation order: the backward sees
// exactly the forward's numbers.
//
// Every product is a full fp32 fmaf on the CUDA cores (no TF32); every
// division and square root is the IEEE one (nvcc's default -prec-div and
// -prec-sqrt; no --use_fast_math).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sparc {

constexpr int NT = 256;                // threads per block
constexpr int NWARP = NT / 32;
constexpr int TT = 16;                 // token rows per block
constexpr int DS = 32;                 // width of a D-slab
constexpr int SLAB = DS + 1;           // padded row stride of a slab
constexpr float EPS = 1e-8f;           // objectives/losses.py _EPS
constexpr float NEPS = 1e-12f * 1e-12f;  // l2_normalize's eps squared

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fminf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// For rows r < n of x [n, D] (row stride D): sq[r] = sum x^2 and
// inv[r] = 1 / sqrt(max(sq, eps^2)), the l2_normalize guard. One warp per
// row, lanes over d, then a fixed xor tree.
__device__ __forceinline__ void row_norms(const float* __restrict__ x, int n, int D,
                                          float* __restrict__ inv, float* __restrict__ sq) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < n; r += NWARP) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s = fmaf(x[(int64_t)r * D + d], x[(int64_t)r * D + d], s);
    s = warp_sum(s);
    if (lane == 0) {
      sq[r] = s;
      inv[r] = 1.f / sqrtf(fmaxf(s, NEPS));
    }
  }
}

// out[t * P + p] = sum_d (a[t][d] * sa[t]) * (b[p][d] * sb[p]) for t < TT
// (rows t >= na read as zero) and p < P; sa / sb null means scale 1.
// a is [na, D] and b [P, D], both row stride D, in device memory. D is
// streamed in slabs of DS through aslab [TT][SLAB] and bslab [P][SLAB];
// element e = t * P + p always belongs to thread e % NT, which adds the
// slab's products in d order onto out[e] with fmaf, so the sum runs over
// d = 0, 1, ..., D - 1 in order on every call.
__device__ __forceinline__ void tile_dot(const float* __restrict__ a, const float* sa, int na,
                                         const float* __restrict__ b, const float* sb, int P,
                                         int D, float* __restrict__ out,
                                         float* __restrict__ aslab,
                                         float* __restrict__ bslab) {
  for (int e = threadIdx.x; e < TT * P; e += NT) out[e] = 0.f;
  for (int d0 = 0; d0 < D; d0 += DS) {
    __syncthreads();  // the previous slab's readers are done
    for (int i = threadIdx.x; i < TT * DS; i += NT) {
      const int t = i / DS, dd = i % DS, d = d0 + dd;
      float x = 0.f;
      if (t < na && d < D) x = sa ? a[(int64_t)t * D + d] * sa[t] : a[(int64_t)t * D + d];
      aslab[t * SLAB + dd] = x;
    }
    for (int i = threadIdx.x; i < P * DS; i += NT) {
      const int p = i / DS, dd = i % DS, d = d0 + dd;
      float x = 0.f;
      if (d < D) x = sb ? b[(int64_t)p * D + d] * sb[p] : b[(int64_t)p * D + d];
      bslab[p * SLAB + dd] = x;
    }
    __syncthreads();
    const int dn = min(DS, D - d0);
    for (int e = threadIdx.x; e < TT * P; e += NT) {
      const int t = e / P, p = e % P;
      float acc = out[e];
      for (int dd = 0; dd < dn; ++dd) acc = fmaf(aslab[t * SLAB + dd], bslab[p * SLAB + dd], acc);
      out[e] = acc;
    }
  }
  __syncthreads();
}

// Per-row quantities of the min-max / threshold / renormalize chain.
struct RowStats {
  float mk;         // the row's mask value
  float mn, mx;     // masked min and max (+-2 when the row is masked)
  float s;          // mx - mn + EPS
  float denom_raw;  // sum of the thresholded row
  float denom;      // max(denom_raw, EPS)
};

// z and the thresholded value t of one element (objectives/losses.py::
// sparc_alignment_weights; ops/sparc_kernel.py::_sparc_kernel).
__device__ __forceinline__ void threshold_one(float sim, const RowStats& r, bool cons,
                                              float tau, float& z, float& t) {
  const float sm = sim * r.mk;
  z = (sm - r.mn) / r.s;
  const float thr = z < tau ? 0.f : z;
  t = cons ? thr * r.mk : 0.f;
}

// For tile row t (its warp calls this): the masked min/max over
// p < P with the +-2 sentinel, the threshold and the row sum, then
// w[t * P + p] = t_p / max(sum, EPS) (w may alias sim). Returns the row's
// statistics to every lane of the warp.
__device__ __forceinline__ RowStats row_weights(const float* sim, float* w, int t, float mk,
                                                int P, float tau) {
  const int lane = threadIdx.x % 32;
  const bool cons = mk > 0.f;
  RowStats r;
  r.mk = mk;
  float mn = 2.f, mx = -2.f;
  if (cons) {
    for (int p = lane; p < P; p += 32) {
      const float sm = sim[t * P + p] * mk;
      mn = fminf(mn, sm);
      mx = fmaxf(mx, sm);
    }
  }
  r.mn = warp_min(mn);
  r.mx = warp_max(mx);
  r.s = r.mx - r.mn + EPS;
  float sum = 0.f;
  for (int p = lane; p < P; p += 32) {
    float z, tv;
    threshold_one(sim[t * P + p], r, cons, tau, z, tv);
    sum += tv;
  }
  r.denom_raw = warp_sum(sum);
  r.denom = fmaxf(r.denom_raw, EPS);
  for (int p = lane; p < P; p += 32) {
    float z, tv;
    threshold_one(sim[t * P + p], r, cons, tau, z, tv);
    w[t * P + p] = tv / r.denom;
  }
  return r;
}

// Shared memory of the weights part, in floats: rv, vsq [P]; rl, lsq,
// mask [TT]; sim [TT * P]; aslab [TT * SLAB]; bslab [P * SLAB].
__host__ __device__ constexpr size_t weights_smem_floats(int P) {
  return 2 * (size_t)P + 3 * (size_t)TT + (size_t)TT * P + (size_t)TT * SLAB +
         (size_t)P * SLAB;
}

}  // namespace sparc
