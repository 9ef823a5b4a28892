// Fused SPARC language-grouped patch pooling, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel clip_finegrained_alignment_tpu/ops/
// sparc_kernel.py::_sparc_kernel (wrapper _fused_forward). Per batch
// element, in fp32:
//
//   rl = rsqrt(max(sum l^2, eps^2)) [T],  rv = rsqrt(max(sum v^2, eps^2)) [P]
//   sim = (l v^T) * rl * rv                      [T, P]  (= l_norm v_norm^T)
//   w   = renorm(threshold(minmax(sim, mask)))   (+-2 sentinel, z < tau
//         gives 0, consider = mask > 0, sum clipped at 1e-8)
//   out = w v                                    [T, D]  (unnormalized v)
//
// and saves sim [B, T, P], rl [B, T] and rv [B, P] for the backward
// (sparc_bwd.cu), which then takes every threshold and tie decision from
// the forward's own numbers instead of recomputing them.
//
// Same function, not the same blocking. The TPU kernel holds a batch
// element's v [P, D] in VMEM; here it is 403 KB at P=197, D=512, beyond a
// block's 227 KB. The chain runs along token rows, so one block of 256
// threads takes 16 token rows of one batch element (grid ceil(T/16) x B,
// 160 blocks at B=32, T=77):
//
//   1. sim = l v^T over K = D (sparc_common.cuh::product_nt, 3xTF32 on the
//      tensor cores), l and v streamed in 32-wide D-slabs through a cp.async
//      ring; the squares of the v slabs give sum v^2 (a pre-pass sum l^2),
//      and the product is scaled by rl and rv after it (raw operands, no
//      normalized tile). At most 256 patches at a time;
//   2. the row statistics and w, one warp per token row, from sim in shared
//      memory (sparc_common.cuh::row_stats);
//   3. out = w v over K = P (product_nn), v streamed again in 16-row slabs.
//
// Bound on the card (NVIDIA H100 80GB HBM3, 700 W): at B=32, T=77, P=197,
// D=512 it moves ~25.0 MB (v, l, mask in; out, sim, rl, rv out: 7.5 us at
// 3.35 TB/s) and does two [T, P, D] products, ~1.0 GFLOP, issued three
// times as TF32 (6.0 us at 495 TFLOP/s): bytes bound it, narrowly. Its
// first version ran its products on the CUDA cores, reading both operands
// of every fmaf from shared memory (0.370 ms, ~25x the bound); this one
// keeps operands in registers across a warp's n8 tiles, runs them on the
// tensor cores, and overlaps each slab's loads with the previous slab's
// products: 0.075 ms (chip_smoke.py, graph ms), 10x the bound. What holds
// it there is in sparc_common.cuh. Shared memory is ~82 KB a block at
// P=197 and registers 125 a thread, so all 160 blocks are resident at
// once (two a multiprocessor).

#include "sparc_common.cuh"

namespace {

using namespace sparc;

// One block: the TR (or, in the last block, fewer) token rows from t0 of
// batch element b, as MT m16 tiles.
template <int MT>
__device__ __forceinline__ void fwd_rows(const float* __restrict__ v, const float* __restrict__ l,
                                         const float* __restrict__ mask, float* __restrict__ out,
                                         float* __restrict__ sim_out, float* __restrict__ rl_out,
                                         float* __restrict__ rv_out, int T, int P, int D,
                                         float tau, bool vec4, float* smem) {
  constexpr int R = TT * MT;
  const int Pp = round_up(P, 8), Pk = round_up(P, KP), lw = a_stride(Pk);
  float* ring = smem;                               // NST stages
  float* wbuf = ring + NST * ring_stage_floats(P);  // [TR][lw]: sim, then w
  float* rvs = wbuf + TR * lw;                      // [Pp]
  float* rls = rvs + Pp;                            // [TR]

  const int t0 = blockIdx.x * TR, b = blockIdx.y;
  const int nt = min(R, T - t0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const float* vb = v + (int64_t)b * P * D;
  const float* lt = l + ((int64_t)b * T + t0) * D;

  // ---- 1. sim = (l v^T) rl rv, at most NCMAX patches at a time ----
  row_norms(lt, nt, R, D, nullptr, rls);
  for (int c0 = 0; c0 < Pp; c0 += NCMAX) {
    const int nc = min(NCMAX, Pp - c0);
    float acc[MT][JS][4], sqb[JS] = {};
    product_nt<true, MT>(lt, nt, vb + (int64_t)c0 * D, P - c0, nc, D, vec4, ring, acc, sqb);
#pragma unroll
    for (int j = 0; j < JS; ++j) {
      const int n0 = 8 * (warp + NWARP * j);
      const float sq = quad_sum(sqb[j]);
      if (n0 < nc && t == 0) rvs[c0 + n0 + g] = 1.f / sqrtf(fmaxf(sq, NEPS));
    }
    __syncthreads();  // rv of the chunk
#pragma unroll
    for (int j = 0; j < JS; ++j) {
      const int n0 = 8 * (warp + NWARP * j);
      if (n0 >= nc) break;
#pragma unroll
      for (int i = 0; i < 4 * MT; ++i) {
        const int m = i / 4, e = i % 4;
        const int r = 16 * m + g + 8 * (e / 2), p = c0 + n0 + 2 * t + e % 2;
        const float s = acc[m][j][e] * rls[r] * rvs[p];
        wbuf[r * lw + p] = s;
        if (r < nt && p < P) sim_out[((int64_t)b * T + t0 + r) * P + p] = s;
      }
    }
  }
  __syncthreads();  // sim is complete
  for (int r = threadIdx.x; r < nt; r += NT) rl_out[(int64_t)b * T + t0 + r] = rls[r];
  if (blockIdx.x == 0)
    for (int p = threadIdx.x; p < P; p += NT) rv_out[(int64_t)b * P + p] = rvs[p];

  // ---- 2. w, one warp per token row, in place ----
  for (int r = warp; r < R; r += NWARP) {
    float* row = wbuf + r * lw;
    const float mk = r < nt ? mask[(int64_t)b * T + t0 + r] : 0.f;
    const RowStats st = row_stats(row, P, mk, tau);
    const bool cons = mk > 0.f;
    for (int p = lane; p < Pk; p += 32) {
      float z, tv = 0.f;
      if (p < P) threshold_one(row[p], st, cons, tau, z, tv);
      row[p] = tv / st.denom;
    }
  }

  // ---- 3. out = w v, at most PCH columns of D at a time ----
  float* ob = out + ((int64_t)b * T + t0) * D;
  for (int dc = 0; dc < D; dc += PCH) {
    const int ncv = min(PCH, D - dc);
    float acc[MT][JP][4];
    product_nn<MT>(wbuf, lw, Pk, vb + dc, D, P, ncv, vec4, ring, acc);
#pragma unroll
    for (int j = 0; j < JP; ++j) {
      const int n0 = 8 * (warp + NWARP * j);
      if (n0 >= ncv) break;
#pragma unroll
      for (int i = 0; i < 4 * MT; ++i) {
        const int m = i / 4, e = i % 4;
        const int r = 16 * m + g + 8 * (e / 2), d = dc + n0 + 2 * t + e % 2;
        if (r < nt && d < D) ob[(int64_t)r * D + d] = acc[m][j][e];
      }
    }
  }
}

__global__ void __launch_bounds__(NT, KMINR) sparc_fwd_kernel(
    const float* __restrict__ v, const float* __restrict__ l, const float* __restrict__ mask,
    float* __restrict__ out, float* __restrict__ sim_out, float* __restrict__ rl_out,
    float* __restrict__ rv_out, int T, int P, int D, float tau, int vec4) {
  extern __shared__ __align__(16) float smem[];
  if (MTR > 1 && T - (int)blockIdx.x * TR > TT)
    fwd_rows<MTR>(v, l, mask, out, sim_out, rl_out, rv_out, T, P, D, tau, vec4, smem);
  else
    fwd_rows<1>(v, l, mask, out, sim_out, rl_out, rv_out, T, P, D, tau, vec4, smem);
}

}  // namespace

// Plain C entry, loaded with ctypes. v [B, P, D], l [B, T, D], mask [B, T]
// are contiguous fp32; it writes out [B, T, D], sim [B, T, P], rl [B, T]
// and rv [B, P], contiguous fp32. Returns the cudaError_t of the launch, or
// -1 when the shared memory it needs exceeds what a block has.
extern "C" int cfa_sparc_fwd(const void* v, const void* l, const void* mask, void* out,
                             void* sim, void* rl, void* rv, int B, int T, int P, int D,
                             float tau, void* stream) {
  using namespace sparc;
  const int Pk = round_up(P, KP);
  const size_t smem = ((size_t)NST * ring_stage_floats(P) + (size_t)TR * a_stride(Pk) +
                       (size_t)round_up(P, 8) + TR) * sizeof(float);
  if (smem > SMEM_MAX) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      sparc_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + TR - 1) / TR, B);
  sparc_fwd_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const float*>(l),
      static_cast<const float*>(mask), static_cast<float*>(out), static_cast<float*>(sim),
      static_cast<float*>(rl), static_cast<float*>(rv), T, P, D, tau, D % 4 == 0);
  return (int)cudaGetLastError();
}
