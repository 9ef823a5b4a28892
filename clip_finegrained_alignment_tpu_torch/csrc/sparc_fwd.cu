// Fused SPARC language-grouped patch pooling, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel clip_finegrained_alignment_tpu/ops/
// sparc_kernel.py::_sparc_kernel (wrapper _fused_forward). Per batch
// element, in fp32 throughout:
//
//   l_norm = l * rsqrt(max(sum l^2, eps^2))      [T, D]
//   v_norm = v * rsqrt(max(sum v^2, eps^2))      [P, D]
//   sim    = l_norm v_norm^T                     [T, P]
//   w      = renorm(threshold(minmax(sim, mask)))   (+-2 sentinel, z < tau
//            gives 0, consider = mask > 0, sum clipped at 1e-8)
//   out    = w v                                 [T, D]  (unnormalized v)
//
// Same function, not the same blocking. The TPU kernel holds one batch
// element's v [P, D], l [T, D] and the [T, P] tiles in VMEM; here one
// element's v alone is 197 x 512 x 4 = 403 KB, beyond the 227 KB of shared
// memory a block has. The min/max, threshold and renormalization run along
// a token row, so the rows are independent: one block of 256 threads takes
// 16 token rows of one batch element (grid ceil(T/16) x B, 160 blocks at
// B=32, T=77), keeps its [16, P] sim / w tile in shared memory, and streams
// v and l through shared memory in 32-wide D-slabs, once for the
// similarity and once, unnormalized, for the pooling. Each block
// recomputes the P inverse norms of v it needs (P x D fmas, small beside
// the 2 x 16 x P x D of its products).
//
// Bound on the card: at B=32, T=77, P=197, D=512 it does ~1.0 GFLOP of
// fp32 products (15 us at 67 TFLOP/s on the CUDA cores) and moves ~23 MB
// (v, l, mask in; out out; 7 us at 3.35 TB/s), so operations bound it.
// This first version reads v from L2 once per 16 token rows and its inner
// loops read both operands from shared memory, so it runs well above that
// bound; what it does about the bytes is keep sim and w out of device
// memory.

#include "sparc_common.cuh"

namespace {

using namespace sparc;

__global__ void __launch_bounds__(NT) sparc_fwd_kernel(const float* __restrict__ v,
                                                       const float* __restrict__ l,
                                                       const float* __restrict__ mask,
                                                       float* __restrict__ out, int T,
                                                       int P, int D, float tau) {
  extern __shared__ float smem[];
  float* rv = smem;              // [P]
  float* vsq = rv + P;           // [P]
  float* rl = vsq + P;           // [TT]
  float* lsq = rl + TT;          // [TT]
  float* mrow = lsq + TT;        // [TT]
  float* sim = mrow + TT;        // [TT * P], then w
  float* aslab = sim + TT * P;   // [TT * SLAB]
  float* bslab = aslab + TT * SLAB;  // [P * SLAB]

  const int t0 = blockIdx.x * TT, b = blockIdx.y;
  const int nt = min(TT, T - t0);
  const float* vb = v + (int64_t)b * P * D;
  const float* lt = l + ((int64_t)b * T + t0) * D;

  row_norms(vb, P, D, rv, vsq);
  row_norms(lt, nt, D, rl, lsq);
  for (int t = threadIdx.x; t < TT; t += NT) mrow[t] = t < nt ? mask[(int64_t)b * T + t0 + t] : 0.f;
  __syncthreads();

  tile_dot(lt, rl, nt, vb, rv, P, D, sim, aslab, bslab);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t < TT; t += NWARP) row_weights(sim, sim, t, mrow[t], P, tau);

  // out[t][d] = sum_p w[t][p] v[p][d], v streamed in slabs (unnormalized).
  float* ob = out + ((int64_t)b * T + t0) * D;
  for (int d0 = 0; d0 < D; d0 += DS) {
    __syncthreads();  // w is complete / the previous slab's readers are done
    for (int i = threadIdx.x; i < P * DS; i += NT) {
      const int p = i / DS, dd = i % DS, d = d0 + dd;
      bslab[p * SLAB + dd] = d < D ? vb[(int64_t)p * D + d] : 0.f;
    }
    __syncthreads();
    const int d = d0 + lane;
    for (int t = warp; t < nt; t += NWARP) {
      if (d >= D) continue;
      float acc = 0.f;
      for (int p = 0; p < P; ++p) acc = fmaf(sim[t * P + p], bslab[p * SLAB + lane], acc);
      ob[(int64_t)t * D + d] = acc;
    }
  }
}

}  // namespace

// Plain C entry, loaded with ctypes. v [B, P, D], l [B, T, D], mask [B, T]
// and out [B, T, D] are contiguous fp32. Returns the cudaError_t of the
// launch, or -1 when the shared memory it needs exceeds what a block has.
extern "C" int cfa_sparc_fwd(const void* v, const void* l, const void* mask, void* out,
                             int B, int T, int P, int D, float tau, void* stream) {
  const size_t smem = weights_smem_floats(P) * sizeof(float);
  if (smem > 232448) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      sparc_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + TT - 1) / TT, B);
  sparc_fwd_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<const float*>(l),
      static_cast<const float*>(mask), static_cast<float*>(out), T, P, D, tau);
  return (int)cudaGetLastError();
}
