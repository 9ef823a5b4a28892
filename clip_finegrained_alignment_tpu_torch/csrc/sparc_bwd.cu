// Fused SPARC language-grouped patch pooling, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel clip_finegrained_alignment_tpu/ops/
// sparc_kernel.py::_sparc_bwd_kernel (wrapper _fused_backward): from v
// [B, P, D], l [B, T, D], mask [B, T] and the cotangent g [B, T, D] of the
// pooled output it recomputes the forward chain and applies the same
// hand-derived VJP, term for term, in fp32:
//
//   dw   = g v^T;   dv  = w^T g + (through v_norm, below)
//   dt   = dw / denom - [denom_raw > eps] * sum(dw * t) / denom^2
//   dz   = 0 where z < tau or not consider, else dt * mask
//   dsm  = dz / s + (ties of the min share sum(dz (z - 1)) / s evenly)
//                 + (ties of the max share sum(dz (-z)) / s evenly)
//   dsim = dsm * mask;  dl_norm = dsim v_norm;  dv_norm = dsim^T l_norm
//   dx   = dx_norm * r - x * sum(dx_norm * x) * r^3 * [sum x^2 > eps^2]
//          for (x, r) = (l, rl) and (v, rv), added onto dv for v.
//
// The similarity, min/max, threshold and weights come from the same device
// functions (sparc_common.cuh), block size and summation order as the
// forward kernel, so ties and threshold decisions are the forward's.
//
// Same function, not the same blocking. dl needs sums over patches (one
// token row at a time), dv sums over tokens (one patch row at a time), and
// one batch element's v (403 KB at P=197, D=512) does not fit a block's
// 227 KB of shared memory. So the work is two kernels, launched by one
// call, with no atomics (the result is the same on every run):
//
//   rows: one block per (16 token rows, batch element), as the forward:
//     recompute sim and w, dw = g v^T by streaming raw v in D-slabs, the
//     row-wise VJP down to dsim; dl_norm = dsim v_norm by streaming v_norm
//     again, then dl. It writes w and dsim ([B, T, P] fp32, 2 x 1.9 MB at
//     B=32) for the second kernel.
//   columns: one block per (16 patch rows, batch element): w^T g and
//     dsim^T l_norm by streaming g and l_norm in D-slabs, then dv.
//
// Bound on the card: at B=32, T=77, P=197, D=512 the chain needs five
// [T, P, D] products, ~2.5 GFLOP of fp32 fmas (37 us at 67 TFLOP/s on the
// CUDA cores), and moves ~41 MB (v, l, mask, g in; dv, dl out; 12 us at
// 3.35 TB/s), so operations bound it. This first version reads its
// operands from shared memory in every inner loop and re-reads v from L2
// three times per block of token rows, so it runs well above that bound;
// what it does about the bytes is keep sim out of device memory and pass
// only w and dsim (4 MB) between its two kernels.

#include "sparc_common.cuh"

namespace {

using namespace sparc;

constexpr int PT = 16;  // patch rows per block of the columns kernel

__host__ __device__ constexpr size_t rows_smem_floats(int P, int D) {
  // the weights part; dsim [TT * P]; row statistics [TT * 6]; dl_norm [TT * D]
  return weights_smem_floats(P) + (size_t)TT * P + (size_t)TT * 6 + (size_t)TT * D;
}

__host__ __device__ constexpr size_t cols_smem_floats(int T, int D) {
  // rl, lsq [T]; rv, vsq [PT]; w, dsim [T * PT]; g, l_norm slabs [T * SLAB];
  // w^T g and dv_norm [PT * D]
  return 2 * (size_t)T + 2 * (size_t)PT + 2 * (size_t)T * PT + 2 * (size_t)T * SLAB +
         2 * (size_t)PT * D;
}

__global__ void __launch_bounds__(NT) sparc_bwd_rows_kernel(
    const float* __restrict__ v, const float* __restrict__ l, const float* __restrict__ mask,
    const float* __restrict__ g, float* __restrict__ dl, float* __restrict__ w_out,
    float* __restrict__ dsim_out, int T, int P, int D, float tau) {
  extern __shared__ float smem[];
  float* rv = smem;                  // [P]
  float* vsq = rv + P;               // [P]
  float* rl = vsq + P;               // [TT]
  float* lsq = rl + TT;              // [TT]
  float* mrow = lsq + TT;            // [TT]
  float* sim = mrow + TT;            // [TT * P]
  float* aslab = sim + TT * P;       // [TT * SLAB]
  float* bslab = aslab + TT * SLAB;  // [P * SLAB]
  float* dw = bslab + P * SLAB;      // [TT * P], then dsim
  RowStats* stats = reinterpret_cast<RowStats*>(dw + TT * P);  // [TT]
  float* dln = dw + TT * P + TT * 6;  // [TT * D]
  static_assert(sizeof(RowStats) == 6 * sizeof(float), "RowStats is 6 floats");

  const int t0 = blockIdx.x * TT, b = blockIdx.y;
  const int nt = min(TT, T - t0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* vb = v + (int64_t)b * P * D;
  const float* lt = l + ((int64_t)b * T + t0) * D;
  const float* gt = g + ((int64_t)b * T + t0) * D;
  float* dlt = dl + ((int64_t)b * T + t0) * D;
  float* wt = w_out + ((int64_t)b * T + t0) * P;
  float* dst = dsim_out + ((int64_t)b * T + t0) * P;

  // ---- forward recompute (as sparc_fwd.cu) ----
  row_norms(vb, P, D, rv, vsq);
  row_norms(lt, nt, D, rl, lsq);
  for (int t = threadIdx.x; t < TT; t += NT) mrow[t] = t < nt ? mask[(int64_t)b * T + t0 + t] : 0.f;
  __syncthreads();
  tile_dot(lt, rl, nt, vb, rv, P, D, sim, aslab, bslab);
  for (int t = warp; t < nt; t += NWARP) {
    const RowStats r = row_weights(sim, wt, t, mrow[t], P, tau);
    if (lane == 0) stats[t] = r;
  }

  // ---- dw = g v^T (raw v) ----
  tile_dot(gt, nullptr, nt, vb, nullptr, P, D, dw, aslab, bslab);

  // ---- row-wise VJP down to dsim ----
  for (int t = warp; t < nt; t += NWARP) {
    const RowStats r = stats[t];
    const bool cons = r.mk > 0.f;
    float sdwt = 0.f;
    for (int p = lane; p < P; p += 32) {
      float z, tv;
      threshold_one(sim[t * P + p], r, cons, tau, z, tv);
      sdwt += dw[t * P + p] * tv;
    }
    sdwt = warp_sum(sdwt);
    const float corr = r.denom_raw > EPS ? sdwt / (r.denom * r.denom) : 0.f;
    float asum = 0.f, bsum = 0.f, nmn = 0.f, nmx = 0.f;
    for (int p = lane; p < P; p += 32) {
      float z, tv;
      const float x = sim[t * P + p];
      threshold_one(x, r, cons, tau, z, tv);
      const float dz = (z < tau || !cons) ? 0.f : (dw[t * P + p] / r.denom - corr) * r.mk;
      asum += dz * (z - 1.f);
      bsum += dz * (-z);
      const float sm = x * r.mk;
      nmn += (cons && sm == r.mn) ? 1.f : 0.f;
      nmx += (cons && sm == r.mx) ? 1.f : 0.f;
    }
    const float a = warp_sum(asum) / r.s;
    const float bb = warp_sum(bsum) / r.s;
    nmn = fmaxf(warp_sum(nmn), 1.f);
    nmx = fmaxf(warp_sum(nmx), 1.f);
    for (int p = lane; p < P; p += 32) {
      float z, tv;
      const float x = sim[t * P + p];
      threshold_one(x, r, cons, tau, z, tv);
      const float dz = (z < tau || !cons) ? 0.f : (dw[t * P + p] / r.denom - corr) * r.mk;
      const float sm = x * r.mk;
      float dsm = dz / r.s;
      dsm = dsm + ((cons && sm == r.mn) ? a / nmn : 0.f) + ((cons && sm == r.mx) ? bb / nmx : 0.f);
      const float ds = dsm * r.mk;
      dw[t * P + p] = ds;
      dst[(int64_t)t * P + p] = ds;
    }
  }

  // ---- dl_norm = dsim v_norm, v_norm streamed in slabs ----
  for (int d0 = 0; d0 < D; d0 += DS) {
    __syncthreads();  // dsim is complete / the previous slab's readers are done
    for (int i = threadIdx.x; i < P * DS; i += NT) {
      const int p = i / DS, dd = i % DS, d = d0 + dd;
      bslab[p * SLAB + dd] = d < D ? vb[(int64_t)p * D + d] * rv[p] : 0.f;
    }
    __syncthreads();
    const int d = d0 + lane;
    for (int t = warp; t < nt; t += NWARP) {
      if (d >= D) continue;
      float acc = 0.f;
      for (int p = 0; p < P; ++p) acc = fmaf(dw[t * P + p], bslab[p * SLAB + lane], acc);
      dln[t * D + d] = acc;
    }
  }
  __syncthreads();

  // ---- dl through the normalization ----
  for (int t = warp; t < nt; t += NWARP) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += dln[t * D + d] * lt[(int64_t)t * D + d];
    s = warp_sum(s);
    const float r = rl[t];
    const float act = lsq[t] > NEPS ? 1.f : 0.f;
    for (int d = lane; d < D; d += 32) {
      const float x = lt[(int64_t)t * D + d];
      dlt[(int64_t)t * D + d] = dln[t * D + d] * r - x * s * (r * r * r) * act;
    }
  }
}

__global__ void __launch_bounds__(NT) sparc_bwd_cols_kernel(
    const float* __restrict__ v, const float* __restrict__ l, const float* __restrict__ g,
    const float* __restrict__ w, const float* __restrict__ dsim, float* __restrict__ dv,
    int T, int P, int D) {
  extern __shared__ float smem[];
  float* rl = smem;                  // [T]
  float* lsq = rl + T;               // [T]
  float* rv = lsq + T;               // [PT]
  float* vsq = rv + PT;              // [PT]
  float* wc = vsq + PT;              // [T * PT]
  float* dsc = wc + T * PT;          // [T * PT]
  float* gslab = dsc + T * PT;       // [T * SLAB]
  float* lslab = gslab + T * SLAB;   // [T * SLAB]
  float* wg = lslab + T * SLAB;      // [PT * D]
  float* dvn = wg + PT * D;          // [PT * D]

  const int p0 = blockIdx.x * PT, b = blockIdx.y;
  const int np = min(PT, P - p0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* lb = l + (int64_t)b * T * D;
  const float* gb = g + (int64_t)b * T * D;
  const float* vt = v + ((int64_t)b * P + p0) * D;
  float* dvt = dv + ((int64_t)b * P + p0) * D;

  row_norms(lb, T, D, rl, lsq);
  row_norms(vt, np, D, rv, vsq);
  for (int i = threadIdx.x; i < T * PT; i += NT) {
    const int t = i / PT, pp = i % PT;
    const int64_t at = ((int64_t)b * T + t) * P + p0 + pp;
    wc[i] = pp < np ? w[at] : 0.f;
    dsc[i] = pp < np ? dsim[at] : 0.f;
  }

  for (int d0 = 0; d0 < D; d0 += DS) {
    __syncthreads();  // norms are done / the previous slab's readers are done
    for (int i = threadIdx.x; i < T * DS; i += NT) {
      const int t = i / DS, dd = i % DS, d = d0 + dd;
      const bool in = d < D;
      gslab[t * SLAB + dd] = in ? gb[(int64_t)t * D + d] : 0.f;
      lslab[t * SLAB + dd] = in ? lb[(int64_t)t * D + d] * rl[t] : 0.f;
    }
    __syncthreads();
    const int d = d0 + lane;
    for (int pp = warp; pp < np; pp += NWARP) {
      if (d >= D) continue;
      float a = 0.f, c = 0.f;
      for (int t = 0; t < T; ++t) {
        a = fmaf(wc[t * PT + pp], gslab[t * SLAB + lane], a);
        c = fmaf(dsc[t * PT + pp], lslab[t * SLAB + lane], c);
      }
      wg[pp * D + d] = a;
      dvn[pp * D + d] = c;
    }
  }
  __syncthreads();

  for (int pp = warp; pp < np; pp += NWARP) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += dvn[pp * D + d] * vt[(int64_t)pp * D + d];
    s = warp_sum(s);
    const float r = rv[pp];
    const float act = vsq[pp] > NEPS ? 1.f : 0.f;
    for (int d = lane; d < D; d += 32) {
      const float x = vt[(int64_t)pp * D + d];
      dvt[(int64_t)pp * D + d] = wg[pp * D + d] + dvn[pp * D + d] * r - x * s * (r * r * r) * act;
    }
  }
}

}  // namespace

// Plain C entry, loaded with ctypes. v, dv [B, P, D], l, g, dl [B, T, D],
// mask [B, T] are contiguous fp32; w and dsim are fp32 scratch of B * T * P
// floats each, written by the first kernel and read by the second. Returns
// the cudaError_t of the launches, or -1 when the shared memory a kernel
// needs exceeds what a block has.
extern "C" int cfa_sparc_bwd(const void* v, const void* l, const void* mask, const void* g,
                             void* dv, void* dl, void* w, void* dsim, int B, int T, int P,
                             int D, float tau, void* stream) {
  const size_t smem1 = rows_smem_floats(P, D) * sizeof(float);
  const size_t smem2 = cols_smem_floats(T, D) * sizeof(float);
  if (smem1 > 232448 || smem2 > 232448) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      sparc_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(sparc_bwd_cols_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return (int)err;
  const float* vp = static_cast<const float*>(v);
  const float* lp = static_cast<const float*>(l);
  const float* gp = static_cast<const float*>(g);
  sparc_bwd_rows_kernel<<<dim3((T + TT - 1) / TT, B), NT, smem1, s>>>(
      vp, lp, static_cast<const float*>(mask), gp, static_cast<float*>(dl),
      static_cast<float*>(w), static_cast<float*>(dsim), T, P, D, tau);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sparc_bwd_cols_kernel<<<dim3((P + PT - 1) / PT, B), NT, smem2, s>>>(
      vp, lp, gp, static_cast<const float*>(w), static_cast<const float*>(dsim),
      static_cast<float*>(dv), T, P, D);
  return (int)cudaGetLastError();
}
