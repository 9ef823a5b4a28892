// Blockwise (long-sequence) attention backward, dq, for Hopper (sm_90a), bhsd.
//
// Replaces the Pallas TPU kernel clip_finegrained_alignment_tpu/ops/
// flash_attention.py::_bwd_dq_kernel (wrapper _bwd): from q, k, v, the
// bias, the output cotangent do and the forward's fp32 lse and the row term
// delta = rowsum(do * o) (the flash-2 identity; the wrapper computes it),
//
//   p = exp(s - lse),  dp = do v^T,  ds = p * (dp - delta),  dq = ds k,
//
// s = qs k^T + bias, qs = (q * scale) rounded to q's type, all in fp32. dq
// is rounded to the input type, multiplied by the scale (rounded to the
// input type) and rounded again, the TPU wrapper's two roundings.
//
// Same function, not the same blocking. The TPU kernel's grid cell loads a
// query block and all of k and v of its head into VMEM (1 MB at S=4096 in
// bf16). Here one block of 256 threads takes 64 query rows of one (batch,
// head), keeps their qs and do in shared memory, and streams 64-key tiles
// of k and v; ds goes through shared memory (in the space of the k tile it
// was computed from, ~86 KB a block at Dh=64, two blocks to an SM) into the
// 64 x Dh fp32 dq accumulator in registers. Keys >= S and query rows >= S
// get p = 0 inside the kernel: the TPU wrapper's padded keys have zero k,
// so they add nothing to dq either. The bias is read through L2.
//
// Bound on the card: at the microbenchmark's S=2048, B=4, H=12, Dh=64 bf16
// it moves ~31 MB (q, k, v, do in, dq out) for 3 products of 2 B H S^2 Dh
// (q k^T, do v^T, ds k) = 77.3 GFLOP, so it is bound by operations:
// 0.078 ms at 989 TFLOP/s. This first version computes on the fp32 CUDA
// cores from shared memory (no mma.sync / wgmma, no TMA), far above that
// bound; what it does about the bytes is keep p, dp and ds out of device
// memory and write dq once.

#include "flash_common.cuh"

namespace {

// Kt and the DSt written after the scores share their space.
template <int DH>
constexpr size_t dq_smem_floats() {
  // Qt, DOt [DH][QSTR]; Kt then DSt; Vt [DH][KSTR]; Ks [BK][DH]
  return 2 * (size_t)DH * QSTR + tile_floats<DH>() + (size_t)DH * KSTR + (size_t)BK * DH;
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT, 2) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int H, int S,
    int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss,
    int64_t bias_sb, float scale) {
  constexpr int RD = DH / TX;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                       // [DH][QSTR], q pre-scaled
  float* DOt = Qt + DH * QSTR;            // [DH][QSTR]
  float* Kt = DOt + DH * QSTR;            // [DH][KSTR], then DSt [BK][QSTR]
  float* Vt = Kt + tile_floats<DH>();      // [DH][KSTR]
  float* Ks = Vt + DH * KSTR;             // [BK][DH]
  float* DSt = Kt;

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const float* biasb = bias ? bias + b * bias_sb : nullptr;
  const int64_t bh = (int64_t)b * H + h;

  load_tile<T, DH, QSTR, true>(q + b * q_sb + h * q_sh, q_ss, q0, S, scale, Qt, nullptr);
  load_tile<T, DH, QSTR>(dout + b * o_sb + h * o_sh, o_ss, q0, S, 0.f, DOt, nullptr);

  float L[R4], Dl[R4], acc[R4][RD];
#pragma unroll
  for (int i = 0; i < R4; ++i) {
    const int row = q0 + ty * R4 + i;
    L[i] = row < S ? lse[bh * S + row] : 0.f;
    Dl[i] = row < S ? delta[bh * S + row] : 0.f;
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, DH, KSTR>(kb, k_ss, k0, S, 0.f, Kt, Ks);
    load_tile<T, DH, KSTR>(vb, v_ss, k0, S, 0.f, Vt, nullptr);
    __syncthreads();

    // Scores and dp for rows q0 + ty*4+i, keys k0 + tx*4+j, turned into ds.
    float s[R4][R4], dp[R4][R4];
    dot4x4<DH>(Qt, QSTR, ty * R4, Kt, KSTR, tx * R4, s);
    dot4x4<DH>(DOt, QSTR, ty * R4, Vt, KSTR, tx * R4, dp);
#pragma unroll
    for (int i = 0; i < R4; ++i) {
      const int row = q0 + ty * R4 + i;
#pragma unroll
      for (int j = 0; j < R4; ++j) {
        const int col = k0 + tx * R4 + j;
        float ds = 0.f;
        if (row < S && col < S) {
          float x = s[i][j];
          if (biasb) x += biasb[(int64_t)row * S + col];
          const float p = expf(x - L[i]);
          ds = p * (dp[i][j] - Dl[i]);
        }
        s[i][j] = ds;
      }
    }
    __syncthreads();  // Kt is read; DSt takes its space
#pragma unroll
    for (int j = 0; j < R4; ++j)
      *reinterpret_cast<float4*>(&DSt[(tx * R4 + j) * QSTR + ty * R4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    const int kmax = min(BK, S - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float ds[R4], kv[RD];
      load4(&DSt[kk * QSTR + ty * R4], ds);
      load_rd<RD>(&Ks[kk * DH + tx * RD], kv);
#pragma unroll
      for (int i = 0; i < R4; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) acc[i][j] = fmaf(ds[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < R4; ++i) {
    const int row = q0 + ty * R4 + i;
    if (row >= S) continue;
    T* out = dq + (bh * S + row) * DH + tx * RD;
#pragma unroll
    for (int j = 0; j < RD; ++j) out[j] = from_f<T>(round_to<T>(acc[i][j]) * scale);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   const void* dout, const float* lse, const float* delta, void* dq,
                   int B, int H, int S, const int64_t* st, int64_t bias_sb, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = dq_smem_floats<DH>() * sizeof(float);
  const cudaError_t attr = opt_in(flash_bwd_dq_kernel<T, DH>, smem);
  if (attr != cudaSuccess) return attr;
  flash_bwd_dq_kernel<T, DH><<<dim3((S + BQ - 1) / BQ, H, B), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), H, S, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], bias_sb,
      scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry, loaded with ctypes. q, k, v and do are [B, H, S, Dh]
// through their (batch, head, sequence) strides in elements, the last dim
// contiguous; lse and delta are contiguous fp32 [B, H, S]; dq is written
// [B, H, S, Dh] contiguous. bias is null or a contiguous fp32 [B|1, S, S]
// with batch stride bias_sb (0 = shared). scale is already rounded to the
// input type. Returns the cudaError_t of the launch, or -1 for an
// unsupported dtype / Dh.
extern "C" int cfa_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* bias, const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int H, int S,
                                int Dh, int dtype,
                                long long q_sb, long long q_sh, long long q_ss,
                                long long k_sb, long long k_sh, long long k_ss,
                                long long v_sb, long long v_sh, long long v_ss,
                                long long o_sb, long long o_sh, long long o_ss,
                                long long bias_sb, float scale, void* stream) {
  const int64_t st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                          v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  const float* bp = static_cast<const float*>(bias);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CFA_DQ(T, D) \
  launch<T, D>(q, k, v, bp, dout, lp, dp, dq, B, H, S, st, bias_sb, scale, s)
  CFA_DISPATCH(CFA_DQ);
#undef CFA_DQ
}
