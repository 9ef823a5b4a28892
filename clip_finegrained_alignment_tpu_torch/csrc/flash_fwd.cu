// Blockwise (long-sequence) attention forward for Hopper (sm_90a), bhsd.
//
// Replaces the Pallas TPU kernel clip_finegrained_alignment_tpu/ops/
// flash_attention.py::_fwd_kernel (wrapper _fwd): for every (batch, head)
// it streams the keys with the online softmax and writes
//
//   o = (sum_k round(p_k) v_k) / l,   lse = m + log l,   p_k = exp(s_k - m),
//
// s = qs k^T + bias with qs = (q * scale) rounded to q's type; m is the
// running max, started at -1e9 as the TPU kernel starts it; l sums the fp32
// p; the product with v takes p rounded to v's type and sums in fp32; o is
// rounded to the input type once, lse stays fp32.
//
// Same function, not the same blocking. The TPU kernel's grid cell loads a
// query block and all of the padded k and v of its head into VMEM (1 MB at
// S=4096 in bf16), beyond the 227 KB a block has here. So one block of 256
// threads takes 64 query rows of one (batch, head) and streams 64-key tiles
// of k (transposed) and v through shared memory (~69 KB at Dh=64, three
// blocks to an SM); m, l and the 64 x Dh accumulator stay in registers.
//
// Padding. The TPU wrapper pads the keys to Sk = round_up(S, block_k) with
// zero k, v and a -1e9 bias. This kernel tiles its own way and masks keys
// >= S; it adds what the npad = Sk - S padded keys would have added to l,
// npad * exp(-1e9 - m), at the end. That term is 0 unless every real key of
// the row scores at or below -1e9 (a fully masked row), where it makes the
// row sum(v) / Sk exactly as on the TPU. The bias (fp32 [B|1, S, S], batch
// stride 0 when shared) is read from device memory through L2, not staged:
// a 64 x 64 fp32 bias tile would be as large as the score tile.
//
// Bound on the card: at the microbenchmark's S=2048, B=4, H=12, Dh=64 bf16
// it moves ~25 MB (q, k, v in, o out) for 2 x 2 x B H S^2 Dh = 51.5 GFLOP,
// so it is bound by operations: 0.052 ms at 989 TFLOP/s (tensor cores).
// This first version computes on the fp32 CUDA cores from shared memory (no
// mma.sync / wgmma, no TMA), so it runs far above that bound; what it does
// about the bytes is read q once and k, v once per query tile and never
// write scores or probabilities to device memory.

#include "flash_common.cuh"

namespace {

template <int DH>
constexpr size_t fwd_smem_floats() {
  // Qt [DH][QSTR] + Kt [DH][KSTR] + Vs [BK][DH] + Pt [BK][QSTR]
  return (size_t)DH * QSTR + (size_t)DH * KSTR + (size_t)BK * DH + (size_t)BK * QSTR;
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, T* __restrict__ o, float* __restrict__ lse,
    int H, int S, int npad,
    int64_t q_sb, int64_t q_sh, int64_t q_ss,
    int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int64_t bias_sb, float scale) {
  constexpr int RD = DH / TX;   // output head dims per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                       // [DH][QSTR], q pre-scaled
  float* Kt = Qt + DH * QSTR;             // [DH][KSTR], k transposed
  float* Vs = Kt + DH * KSTR;             // [BK][DH]
  float* Pt = Vs + BK * DH;               // [BK][QSTR], rounded p transposed

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const float* biasb = bias ? bias + b * bias_sb : nullptr;

  load_tile<T, DH, QSTR, true>(q + b * q_sb + h * q_sh, q_ss, q0, S, scale, Qt, nullptr);

  float m[R4], l[R4], acc[R4][RD];
#pragma unroll
  for (int i = 0; i < R4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // the previous tile's Kt / Vs / Pt readers are done
    load_tile<T, DH, KSTR>(kb, k_ss, k0, S, 0.f, Kt, nullptr);
    load_tile<T, DH, KSTR>(vb, v_ss, k0, S, 0.f, nullptr, Vs);
    __syncthreads();

    // Scores for rows q0 + ty*4+i, keys k0 + tx*4+j.
    float s[R4][R4];
    dot4x4<DH>(Qt, QSTR, ty * R4, Kt, KSTR, tx * R4, s);
#pragma unroll
    for (int i = 0; i < R4; ++i) {
      const int row = q0 + ty * R4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < R4; ++j) {
        const int col = k0 + tx * R4 + j;
        float x = -INFINITY;   // keys >= S: weight exp(-inf) = 0
        if (col < S) {
          x = s[i][j];
          if (biasb && row < S) x += biasb[(int64_t)row * S + col];
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // m starts at -1e9, so it stays finite.
      const float m_new = fmaxf(m[i], group16_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < R4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + group16_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < RD; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < R4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * R4 + j) * QSTR + ty * R4]) =
          make_float4(round_to<T>(s[0][j]), round_to<T>(s[1][j]),
                      round_to<T>(s[2][j]), round_to<T>(s[3][j]));
    __syncthreads();

    const int kmax = min(BK, S - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float pv[R4], vv[RD];
      load4(&Pt[kk * QSTR + ty * R4], pv);
      load_rd<RD>(&Vs[kk * DH + tx * RD], vv);
#pragma unroll
      for (int i = 0; i < R4; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < R4; ++i) {
    const int row = q0 + ty * R4 + i;
    if (row >= S) continue;
    // The padded keys' share of the sum (zero v, so none of the output's).
    const float lf = l[i] + (float)npad * expf(NEG - m[i]);
    const int64_t at = ((int64_t)b * H + h) * S + row;
    T* orow = o + at * DH + tx * RD;
#pragma unroll
    for (int j = 0; j < RD; ++j) orow[j] = from_f<T>(acc[i][j] / lf);
    if (tx == 0) lse[at] = m[i] + logf(lf);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   void* o, float* lse, int B, int H, int S, int npad,
                   const int64_t* st, int64_t bias_sb, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_floats<DH>() * sizeof(float);
  const cudaError_t attr = opt_in(flash_fwd_kernel<T, DH>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, DH><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      bias, static_cast<T*>(o), lse, H, S, npad, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], bias_sb, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry, loaded with ctypes. q, k, v are [B, H, S, Dh] through
// their (batch, head, sequence) strides in elements, the last dim
// contiguous. o is written [B, H, S, Dh] and lse [B, H, S] (fp32)
// contiguous. npad = Sk - S padded keys of the TPU wrapper. bias is null or
// a contiguous fp32 [B|1, S, S] with batch stride bias_sb (0 = shared).
// scale is already rounded to the input type. Returns the cudaError_t of
// the launch, or -1 for an unsupported dtype / Dh.
extern "C" int cfa_flash_fwd(const void* q, const void* k, const void* v,
                             const void* bias, void* o, void* lse, int B, int H,
                             int S, int Dh, int dtype, int npad,
                             long long q_sb, long long q_sh, long long q_ss,
                             long long k_sb, long long k_sh, long long k_ss,
                             long long v_sb, long long v_sh, long long v_ss,
                             long long bias_sb, float scale, void* stream) {
  const int64_t st[9] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  const float* bp = static_cast<const float*>(bias);
  float* lp = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CFA_FWD(T, D) launch<T, D>(q, k, v, bp, o, lp, B, H, S, npad, st, bias_sb, scale, s)
  CFA_DISPATCH(CFA_FWD);
#undef CFA_FWD
}
