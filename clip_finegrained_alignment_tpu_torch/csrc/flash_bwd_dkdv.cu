// Blockwise (long-sequence) attention backward, dk and dv, for Hopper
// (sm_90a), bhsd.
//
// Replaces the Pallas TPU kernel clip_finegrained_alignment_tpu/ops/
// flash_attention.py::_bwd_dkv_kernel (wrapper _bwd): from q, k, v, the
// bias, the output cotangent do and the forward's fp32 lse and row term
// delta = rowsum(do * o),
//
//   p = exp(s - lse),  dv = p^T do,  ds = p * (do v^T - delta),  dk = ds^T qs,
//
// s = qs k^T + bias, qs = (q * scale) rounded to q's type, all in fp32 (p
// unrounded); dk and dv are each rounded to the input type once.
//
// Same function, not the same blocking. As the TPU kernel's kv grid does,
// one block takes a key tile of one (batch, head) and walks all query rows,
// so each dk, dv row is summed by one block and no atomics are needed. But
// the TPU cell loads all of q and do of its head into VMEM (1 MB at S=4096
// in bf16); here the block keeps 64 keys' k and v in shared memory and
// streams 64-row tiles of qs and do, with their lse and delta; p and ds go
// through shared memory in the space of the q and do tiles they were
// computed from (~103 KB a block at Dh=64, two blocks to an SM) into the
// 64 x Dh fp32 dk and dv accumulators in registers. Keys >= S and query
// rows >= S get p = 0 inside the kernel: the TPU wrapper's padded query
// rows have zero do and delta, so they add nothing either. The bias is read
// through L2.
//
// Bound on the card: at the microbenchmark's S=2048, B=4, H=12, Dh=64 bf16
// it moves ~38 MB (q, k, v, do in, dk, dv out) for 4 products of
// 2 B H S^2 Dh (k q^T, v do^T, p^T do, ds^T qs) = 103 GFLOP, so it is bound
// by operations: 0.104 ms at 989 TFLOP/s. This first version computes on
// the fp32 CUDA cores from shared memory (no mma.sync / wgmma, no TMA), far
// above that bound; what it does about the bytes is keep p, dp and ds out
// of device memory and write dk and dv once.

#include "flash_common.cuh"

namespace {

template <int DH>
constexpr size_t dkdv_smem_floats() {
  // Kt, Vt [DH][KSTR]; Qt then Pq, DOt then DSq; Qs, DOs [BQ][DH];
  // per-row lse and delta [BQ]
  return 2 * (size_t)DH * KSTR + 2 * tile_floats<DH>() + 2 * (size_t)BQ * DH +
         2 * (size_t)BQ;
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT, 2) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int H, int S,
    int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss,
    int64_t bias_sb, float scale) {
  constexpr int RD = DH / TX;
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;                       // [DH][KSTR]
  float* Vt = Kt + DH * KSTR;             // [DH][KSTR]
  float* Qt = Vt + DH * KSTR;             // [DH][QSTR], then Pq [BQ][KSTR]
  float* DOt = Qt + tile_floats<DH>();      // [DH][QSTR], then DSq [BQ][KSTR]
  float* Qs = DOt + tile_floats<DH>();      // [BQ][DH]
  float* DOs = Qs + BQ * DH;              // [BQ][DH]
  float* Lr = DOs + BQ * DH;              // [BQ]
  float* Dr = Lr + BQ;                    // [BQ]
  float* Pq = Qt;
  float* DSq = DOt;

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int kb0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* ob = dout + b * o_sb + h * o_sh;
  const float* biasb = bias ? bias + b * bias_sb : nullptr;
  const int64_t bh = (int64_t)b * H + h;
  const float* lseb = lse + bh * S;
  const float* deltab = delta + bh * S;

  load_tile<T, DH, KSTR>(k + b * k_sb + h * k_sh, k_ss, kb0, S, 0.f, Kt, nullptr);
  load_tile<T, DH, KSTR>(v + b * v_sb + h * v_sh, v_ss, kb0, S, 0.f, Vt, nullptr);

  float dkacc[R4][RD], dvacc[R4][RD];
#pragma unroll
  for (int i = 0; i < R4; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) dkacc[i][j] = dvacc[i][j] = 0.f;

  for (int q0 = 0; q0 < S; q0 += BQ) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, DH, QSTR, true>(qb, q_ss, q0, S, scale, Qt, Qs);
    load_tile<T, DH, QSTR>(ob, o_ss, q0, S, 0.f, DOt, DOs);
    for (int i = threadIdx.x; i < BQ; i += NT) {
      const int row = q0 + i;
      Lr[i] = row < S ? lseb[row] : 0.f;
      Dr[i] = row < S ? deltab[row] : 0.f;
    }
    __syncthreads();

    // Transposed scores and dp for keys kb0 + ty*4+i, rows q0 + tx*4+j,
    // turned into p and ds in place.
    float s[R4][R4], dp[R4][R4];
    dot4x4<DH>(Kt, KSTR, ty * R4, Qt, QSTR, tx * R4, s);
    dot4x4<DH>(Vt, KSTR, ty * R4, DOt, QSTR, tx * R4, dp);
#pragma unroll
    for (int j = 0; j < R4; ++j) {
      const int jr = tx * R4 + j;
      const int row = q0 + jr;
#pragma unroll
      for (int i = 0; i < R4; ++i) {
        const int col = kb0 + ty * R4 + i;
        float p = 0.f;
        if (row < S && col < S) {
          float x = s[i][j];
          if (biasb) x += biasb[(int64_t)row * S + col];
          p = expf(x - Lr[jr]);
        }
        s[i][j] = p;
        dp[i][j] = p * (dp[i][j] - Dr[jr]);
      }
    }
    __syncthreads();  // Qt and DOt are read; Pq and DSq take their space
#pragma unroll
    for (int j = 0; j < R4; ++j) {
      const int jr = tx * R4 + j;
      *reinterpret_cast<float4*>(&Pq[jr * KSTR + ty * R4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(&DSq[jr * KSTR + ty * R4]) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    }
    __syncthreads();

    const int qmax = min(BQ, S - q0);
    for (int qq = 0; qq < qmax; ++qq) {
      float p[R4], ds[R4], dov[RD], qv[RD];
      load4(&Pq[qq * KSTR + ty * R4], p);
      load4(&DSq[qq * KSTR + ty * R4], ds);
      load_rd<RD>(&DOs[qq * DH + tx * RD], dov);
      load_rd<RD>(&Qs[qq * DH + tx * RD], qv);
#pragma unroll
      for (int i = 0; i < R4; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) {
          dvacc[i][j] = fmaf(p[i], dov[j], dvacc[i][j]);
          dkacc[i][j] = fmaf(ds[i], qv[j], dkacc[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < R4; ++i) {
    const int key = kb0 + ty * R4 + i;
    if (key >= S) continue;
    const int64_t at = (bh * S + key) * DH + tx * RD;
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      dk[at + j] = from_f<T>(dkacc[i][j]);
      dv[at + j] = from_f<T>(dvacc[i][j]);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   const void* dout, const float* lse, const float* delta, void* dk,
                   void* dv, int B, int H, int S, const int64_t* st, int64_t bias_sb,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = dkdv_smem_floats<DH>() * sizeof(float);
  const cudaError_t attr = opt_in(flash_bwd_dkdv_kernel<T, DH>, smem);
  if (attr != cudaSuccess) return attr;
  flash_bwd_dkdv_kernel<T, DH><<<dim3((S + BK - 1) / BK, H, B), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      H, S, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], bias_sb, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry, loaded with ctypes. q, k, v and do are [B, H, S, Dh]
// through their (batch, head, sequence) strides in elements, the last dim
// contiguous; lse and delta are contiguous fp32 [B, H, S]; dk and dv are
// written [B, H, S, Dh] contiguous. bias is null or a contiguous fp32
// [B|1, S, S] with batch stride bias_sb (0 = shared). scale is already
// rounded to the input type. Returns the cudaError_t of the launch, or -1
// for an unsupported dtype / Dh.
extern "C" int cfa_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                  const void* bias, const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int B, int H,
                                  int S, int Dh, int dtype,
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
#define CFA_DKDV(T, D) \
  launch<T, D>(q, k, v, bp, dout, lp, dp, dk, dv, B, H, S, st, bias_sb, scale, s)
  CFA_DISPATCH(CFA_DKDV);
#undef CFA_DKDV
}
