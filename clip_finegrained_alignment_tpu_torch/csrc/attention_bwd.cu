// Fused multi-head attention backward for Hopper (sm_90a), bshd layout.
//
// Replaces the Pallas TPU kernel clip_finegrained_alignment_tpu/ops/
// attention.py::_bwd_kernel_bshd (math in _bwd_math, wrapper
// _fused_backward): from q, k, v, the head-invariant fp32 bias and the
// output cotangent do, it computes, with p recomputed in fp32,
//
//   dv = p^T do,  dp = do v^T,  ds = p * (dp - rowsum(dp * p)),
//   dq = (ds k) * scale,  dk = ds^T qs,     qs = (q * scale) in q's type.
//
// Each output is rounded to the input type; dq is then multiplied by the
// scale (rounded to the input type) and rounded again, as the TPU wrapper
// does. The bias gets no gradient. p is the TPU's over Sp = round_up(S, 8)
// keys: the wrapper's padded keys (zero k, v, score -1e9) add only to a
// row's sum, which decides p in a fully masked row (attention_mma.cuh).
//
// Same function, not the same blocking. The TPU kernel holds the padded
// S x S fp32 p, dp and ds tiles of a whole head group in VMEM (~5.8 MB at
// ViT-B/16, S=197 padded to 200, 12 heads); a Hopper block has 227 KB of
// shared memory. So both passes stream 64-wide tiles, and no sum crosses
// blocks (no atomics: the result is the same on every run). Since
//   dq_i = sum_j p_ij (dp_ij - r_i) k_j = sum_j p_ij dp_ij k_j - r_i sum_j p_ij k_j,
// the dq pass needs the row term r_i = sum_j dp_ij p_ij only at its end:
// it accumulates A = (p * dp) k, B = p k and r, and ends with dq = A - r B.
// r is JAX's fp32 row term, taken from p itself (not from the bf16 o).
//
// Bound on the card: at B=32, ViT-B/16 vision (S=197, H=12, Dh=64, bf16)
// moves ~68 MB (q, k, v, do in; dq, dk, dv out) for ~9.5 GFLOP, so it is
// memory-bound at ~20 us at 3.35 TB/s; the text tower (S=77, H=8) ~18 MB,
// ~5 us.
//
// bf16 (every path on the card): two tensor-core kernels (building blocks
// and fragment layouts in attention_mma.cuh), one block of 4 warps per
// 64-row tile, the streamed tiles bf16 in shared memory through a 2-stage
// cp.async ring, every product mma.sync.m16n8k16 bf16 with fp32 sums:
//
//   dq pass, one block per (64 query rows, head, batch): each warp keeps
//     its 16 rows of qs and do as mma operands in registers and streams
//     64-key tiles of k and v. The forward saved the per-row log-sum-exp
//     as an fp32 pair (hi, lo) (tc::store_lse), so p = exp((s - hi) - lo)
//     is exact per tile, in a fully masked row too, and no online softmax
//     is needed. For each 16-key slice: s = qs k^T + bias and dp = do v^T,
//     then p and p * dp in fp32 (summed into r unrounded), which become
//     the A operands of A += (p * dp) k and B += p k in registers.
//     It writes dq and r per row.
//   dk/dv pass, one block per (64 keys, head, batch): each warp keeps its
//     16 keys of k and v as operands and streams 64-row tiles of q (scaled
//     in shared memory once per tile) and do. For each 16-row slice:
//     s^T = k qs^T + bias and dp^T = v do^T, then p^T and
//     ds^T = p^T (dp^T - r) in fp32, which become the A operands of
//     dv += p^T do and dk += ds^T qs in registers. dk and dv are written
//     once.
//
// The operands p, p * dp and ds of those four sums are not rounded to
// bf16 once, as the forward's P is: each is split into a bf16 pair
// hi + lo (two products), which holds it to ~2^-16, so the gradients keep
// the 1 % per-element tolerance of the fp32-operand version where a single
// bf16 rounding of p (2^-9) summed over S terms would not.
//
// What it does about the bytes: q, k, v, do are read once per tile of the
// other side, p, dp and ds never reach device memory, each gradient is
// written once. mma.sync rather than wgmma: at these lengths the passes are
// bound by bytes, not operations, and 16-row warp tiles fit S=77 and S=197
// with little padding; 16-row slices past S are skipped.
//
// float32 (no path on the card runs it; evaluation runs the float32
// forward only): the first version, kept as it was: fp32 CUDA cores from
// fp32 copies of the tiles (the forward's 3xTF32 products would carry over
// when a path needs them), a dq pass with an online softmax that writes
// its own per-row m, l (the padded keys' share added at the end, m started
// at -1e9 when there are any) and r / l (it does not read lse), and a
// dk/dv pass that recomputes p = exp(s - m) / l.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int NT = TX * TY;     // threads per block
constexpr int R4 = 4;           // rows / keys per thread in a score tile
constexpr int QSTR = BQ + 4;    // row stride of query-indexed tiles
constexpr int KSTR = BK + 4;    // row stride of key-indexed tiles

static_assert(BQ == TY * R4 && BK == TX * R4 && BK == TY * R4 && BQ == TX * R4,
              "the float4 tile reads below assume 64 x 64 tiles of 4 x 4");

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

// Loads rows [r0, r0 + 64) of one head of x (bshd view through strides)
// into shared memory as fp32: transposed into xt[DH][STR] and, if xs is
// not null, row-major into xs[64][DH]. Rows >= S are zero. With scale != 0
// the value is x * scale, as the TPU wrapper prescales q.
template <int DH, int STR>
__device__ __forceinline__ void load_tile(const float* __restrict__ xb, int64_t x_ss,
                                          int r0, int S, float scale,
                                          float* __restrict__ xt,
                                          float* __restrict__ xs) {
  for (int i = threadIdx.x; i < 64 * DH; i += NT) {
    const int r = i / DH, d = i % DH;
    const int row = r0 + r;
    float x = 0.f;
    if (row < S) {
      x = xb[row * x_ss + d];
      if (scale != 0.f) x *= scale;
    }
    xt[d * STR + r] = x;
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

// ---------------------------------------------------------------------------
// float32, pass 1: dq and the per-row statistics
// ---------------------------------------------------------------------------

// Kt / Vt and the Et / EDt written after the scores share their space, as
// Qt / DOt and Pq / DSq do in pass 2: under ~113 KB a block, two blocks
// fit on an SM.
template <int DH>
__host__ __device__ constexpr size_t ke_floats() {
  return (size_t)DH * KSTR > (size_t)BK * QSTR ? (size_t)DH * KSTR : (size_t)BK * QSTR;
}

template <int DH>
constexpr size_t dq_smem_floats() {
  // Qt, DOt [DH][QSTR]; Kt then Et, Vt then EDt; Ks [BK][DH]
  return 2 * (size_t)DH * QSTR + 2 * ke_floats<DH>() + (size_t)BK * DH;
}

template <int DH>
__global__ void __launch_bounds__(NT, 2) attention_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ dout,
    float* __restrict__ dq, float* __restrict__ stats, int B, int S, int H,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int64_t bias_sb, float scale) {
  constexpr int RD = DH / TX;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;
  float* DOt = Qt + DH * QSTR;
  float* Kt = DOt + DH * QSTR;            // [DH][KSTR], then Et [BK][QSTR]
  float* Vt = Kt + ke_floats<DH>();       // [DH][KSTR], then EDt [BK][QSTR]
  float* Ks = Vt + ke_floats<DH>();       // [BK][DH]
  float* Et = Kt;
  float* EDt = Vt;

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const float* biasb = bias ? bias + b * bias_sb : nullptr;
  const int npad = tc::padded_keys(S);

  load_tile<DH, QSTR>(q + b * q_sb + h * q_sh, q_ss, q0, S, scale, Qt, nullptr);
  load_tile<DH, QSTR>(dout + b * o_sb + h * o_sh, o_ss, q0, S, 0.f, DOt, nullptr);

  float m[R4], l[R4], r[R4], A[R4][RD], Bc[R4][RD];
#pragma unroll
  for (int i = 0; i < R4; ++i) {
    m[i] = npad ? tc::kNeg : -INFINITY;
    l[i] = 0.f;
    r[i] = 0.f;
#pragma unroll
    for (int j = 0; j < RD; ++j) A[i][j] = Bc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<DH, KSTR>(kb, k_ss, k0, S, 0.f, Kt, Ks);
    load_tile<DH, KSTR>(vb, v_ss, k0, S, 0.f, Vt, nullptr);
    __syncthreads();

    // Scores and dp for rows ty*4+i, keys k0 + tx*4+j.
    float s[R4][R4], dp[R4][R4];
    dot4x4<DH>(Qt, QSTR, ty * R4, Kt, KSTR, tx * R4, s);
    dot4x4<DH>(DOt, QSTR, ty * R4, Vt, KSTR, tx * R4, dp);

#pragma unroll
    for (int i = 0; i < R4; ++i) {
      const int row = q0 + ty * R4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < R4; ++j) {
        const int col = k0 + tx * R4 + j;
        float x = -INFINITY;
        if (col < S) {
          x = s[i][j];
          if (biasb && row < S) x += biasb[(int64_t)row * S + col];
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // Column k0 < S lies in every tile, so the new max is finite.
      const float m_new = fmaxf(m[i], group16_max(mx));
      const float alpha = expf(m[i] - m_new);
      float se = 0.f, sed = 0.f;
#pragma unroll
      for (int j = 0; j < R4; ++j) {
        const float e = expf(s[i][j] - m_new);
        s[i][j] = e;
        dp[i][j] *= e;
        se += e;
        sed += dp[i][j];
      }
      l[i] = l[i] * alpha + group16_sum(se);
      r[i] = r[i] * alpha + group16_sum(sed);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < RD; ++j) {
        A[i][j] *= alpha;
        Bc[i][j] *= alpha;
      }
    }
    __syncthreads();  // Kt and Vt are read; Et and EDt take their space
#pragma unroll
    for (int j = 0; j < R4; ++j) {
      *reinterpret_cast<float4*>(&Et[(tx * R4 + j) * QSTR + ty * R4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(&EDt[(tx * R4 + j) * QSTR + ty * R4]) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    }
    __syncthreads();

    const int kmax = min(BK, S - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      float e[R4], ed[R4], kv[RD];
      load4(&Et[kk * QSTR + ty * R4], e);
      load4(&EDt[kk * QSTR + ty * R4], ed);
      load_rd<RD>(&Ks[kk * DH + tx * RD], kv);
#pragma unroll
      for (int i = 0; i < R4; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) {
          A[i][j] = fmaf(ed[i], kv[j], A[i][j]);
          Bc[i][j] = fmaf(e[i], kv[j], Bc[i][j]);
        }
    }
  }

  const int64_t BHS = (int64_t)B * H * S;
#pragma unroll
  for (int i = 0; i < R4; ++i) {
    const int row = q0 + ty * R4 + i;
    if (row >= S) continue;
    // The padded keys' share of the sum (zero v: none of r's, A's or B's).
    l[i] += npad ? npad * expf(tc::kNeg - m[i]) : 0.f;
    const float inv = 1.f / l[i];
    const float rowterm = r[i] * inv;
    float* out = dq + (((int64_t)b * S + row) * H + h) * DH + tx * RD;
#pragma unroll
    for (int j = 0; j < RD; ++j) out[j] = (A[i][j] - rowterm * Bc[i][j]) * inv * scale;
    if (tx == 0) {
      const int64_t at = ((int64_t)b * H + h) * S + row;
      stats[at] = m[i];
      stats[BHS + at] = l[i];
      stats[2 * BHS + at] = rowterm;
    }
  }
}

// ---------------------------------------------------------------------------
// float32, pass 2: dk and dv
// ---------------------------------------------------------------------------

template <int DH>
__host__ __device__ constexpr size_t qp_floats() {
  return (size_t)DH * QSTR > (size_t)BQ * KSTR ? (size_t)DH * QSTR : (size_t)BQ * KSTR;
}

template <int DH>
constexpr size_t dkdv_smem_floats() {
  // Kt, Vt [DH][KSTR]; Qt then Pq, DOt then DSq; Qs, DOs [BQ][DH];
  // per-row m, l, r [BQ]
  return 2 * (size_t)DH * KSTR + 2 * qp_floats<DH>() + 2 * (size_t)BQ * DH +
         3 * (size_t)BQ;
}

template <int DH>
__global__ void __launch_bounds__(NT, 2) attention_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ dout,
    float* __restrict__ dk, float* __restrict__ dv, const float* __restrict__ stats,
    int B, int S, int H,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int64_t bias_sb, float scale) {
  constexpr int RD = DH / TX;
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;
  float* Vt = Kt + DH * KSTR;
  float* Qt = Vt + DH * KSTR;             // [DH][QSTR], then Pq [BQ][KSTR]
  float* DOt = Qt + qp_floats<DH>();      // [DH][QSTR], then DSq [BQ][KSTR]
  float* Qs = DOt + qp_floats<DH>();      // [BQ][DH]
  float* DOs = Qs + BQ * DH;
  float* Pq = Qt;
  float* DSq = DOt;
  float* Mr = DOs + BQ * DH;
  float* Lr = Mr + BQ;
  float* Rr = Lr + BQ;

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int kb0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* ob = dout + b * o_sb + h * o_sh;
  const float* biasb = bias ? bias + b * bias_sb : nullptr;
  const int64_t BHS = (int64_t)B * H * S;
  const float* st = stats + ((int64_t)b * H + h) * S;

  load_tile<DH, KSTR>(k + b * k_sb + h * k_sh, k_ss, kb0, S, 0.f, Kt, nullptr);
  load_tile<DH, KSTR>(v + b * v_sb + h * v_sh, v_ss, kb0, S, 0.f, Vt, nullptr);

  float dkacc[R4][RD], dvacc[R4][RD];
#pragma unroll
  for (int i = 0; i < R4; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) dkacc[i][j] = dvacc[i][j] = 0.f;

  for (int q0 = 0; q0 < S; q0 += BQ) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<DH, QSTR>(qb, q_ss, q0, S, scale, Qt, Qs);
    load_tile<DH, QSTR>(ob, o_ss, q0, S, 0.f, DOt, DOs);
    for (int i = threadIdx.x; i < BQ; i += NT) {
      const int row = q0 + i;
      Mr[i] = row < S ? st[row] : 0.f;
      Lr[i] = row < S ? st[BHS + row] : 1.f;
      Rr[i] = row < S ? st[2 * BHS + row] : 0.f;
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
          p = expf(x - Mr[jr]) / Lr[jr];
        }
        s[i][j] = p;
        dp[i][j] = p * (dp[i][j] - Rr[jr]);
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
    const int64_t at = (((int64_t)b * S + key) * H + h) * DH + tx * RD;
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      dk[at + j] = dkacc[i][j];
      dv[at + j] = dvacc[i][j];
    }
  }
}

template <typename Kern>
cudaError_t opt_in(Kern kernel, size_t smem) {
  // Above 48 KB dynamic shared memory needs the opt-in, which holds for the
  // current device only; it is a cheap host call, made on every launch.
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v, const float* bias,
                   const float* dout, float* dq, float* dk, float* dv, float* stats,
                   int B, int S, int H, const int64_t* st, int64_t bias_sb,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem1 = dq_smem_floats<DH>() * sizeof(float);
  constexpr size_t smem2 = dkdv_smem_floats<DH>() * sizeof(float);
  cudaError_t err = opt_in(attention_bwd_dq_kernel<DH>, smem1);
  if (err != cudaSuccess) return err;
  err = opt_in(attention_bwd_dkdv_kernel<DH>, smem2);
  if (err != cudaSuccess) return err;
  attention_bwd_dq_kernel<DH><<<dim3((S + BQ - 1) / BQ, H, B), NT, smem1, stream>>>(
      q, k, v, bias, dout, dq, stats, B, S, H, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], bias_sb, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_kernel<DH><<<dim3((S + BK - 1) / BK, H, B), NT, smem2, stream>>>(
      q, k, v, bias, dout, dk, dv, stats, B, S, H, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], bias_sb, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

template <int DH>
constexpr size_t mma_smem_bytes() {
  // The block's own two tiles (dq pass: q, do; dk/dv pass: k, v), then the
  // two streamed operands, each a ring of kStages tiles.
  return (size_t)(2 + 2 * tc::kStages) * tc::Tile<DH>::kElems * sizeof(tc::bf16);
}

// Both passes are capped at 168 registers a thread (__launch_bounds__ with 3
// blocks an SM): left alone, dk/dv at Dh=64 takes 195 and fits 2 blocks; at
// 3 it spills ~70 bytes a thread to L1 and still runs the ViT-B/16 backward
// 13 % faster on an H100 (0.190 -> 0.166 ms at B=32).
template <int DH>
__global__ void __launch_bounds__(tc::kThreads, 3) attention_bwd_dq_mma(
    const tc::bf16* __restrict__ q, const tc::bf16* __restrict__ k,
    const tc::bf16* __restrict__ v, const float* __restrict__ bias,
    const tc::bf16* __restrict__ dout, const float* __restrict__ lse,
    tc::bf16* __restrict__ dq, float* __restrict__ rowterm, int S, int H,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int64_t bias_sb, float scale) {
  using T = tc::Tile<DH>;
  using tc::bf16;
  constexpr int NC = tc::kRows / 16;      // 16-key slices of a key tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Os = Qs + T::kElems;
  bf16* Ks = Os + T::kElems;              // [kStages][64][DH + 8]
  bf16* Vs = Ks + tc::kStages * T::kElems;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * tc::kRows, h = blockIdx.y, b = blockIdx.z;
  const int64_t bhs = ((int64_t)b * H + h) * S;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  const float* biasb = bias ? bias + b * bias_sb : nullptr;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const int tiles = (S + tc::kRows - 1) / tc::kRows;

  tc::load_tile<DH>(Qs, q + b * q_sb + h * q_sh, q_ss, q0, S);
  tc::load_tile<DH>(Os, dout + b * o_sb + h * o_sh, o_ss, q0, S);
  tc::load_tile<DH>(Ks, kb, k_ss, 0, S);
  tc::load_tile<DH>(Vs, vb, v_ss, 0, S);
  tc::cp_async_commit();

  // Per row the forward's lse pair: hi, and lo in log2 units.
  const int64_t plane = (int64_t)gridDim.z * H * S;
  float lh[2], ll[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lh[i] = rows[i] < S ? lse[bhs + rows[i]] : 0.f;
    ll[i] = rows[i] < S ? lse[plane + bhs + rows[i]] * tc::kLog2e : 0.f;
  }

  uint32_t qf[T::kSteps][4], of[T::kSteps][4];
  float A[T::kNTiles][4], Bp[T::kNTiles][4], r[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < T::kNTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) A[j][e] = Bp[j][e] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {   // the next tile loads while this one is computed
      const int next = (it + 1) % tc::kStages;
      tc::load_tile<DH>(Ks + next * T::kElems, kb, k_ss, (it + 1) * tc::kRows, S);
      tc::load_tile<DH>(Vs + next * T::kElems, vb, v_ss, (it + 1) * tc::kRows, S);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < T::kSteps; ++ks) {
        tc::load_a<DH>(qf[ks], Qs, warp * 16, ks * 16);
        tc::load_a<DH>(of[ks], Os, warp * 16, ks * 16);
#pragma unroll
        for (int e = 0; e < 4; ++e) qf[ks][e] = tc::scale_pair(qf[ks][e], scale);
      }
    }
    const bf16* Kt = Ks + (it % tc::kStages) * T::kElems;
    const bf16* Vt = Vs + (it % tc::kStages) * T::kElems;
    const int k0 = it * tc::kRows;

#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c * 16 >= S - k0) continue;     // a slice of keys past S
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < T::kSteps; ++ks) {
        uint32_t f[4];
        tc::load_b_rows<DH>(f, Kt, c * 16, ks * 16);
        tc::mma(s[0], qf[ks], f[0], f[1]);
        tc::mma(s[1], qf[ks], f[2], f[3]);
        tc::load_b_rows<DH>(f, Vt, c * 16, ks * 16);
        tc::mma(dp[0], of[ks], f[0], f[1]);
        tc::mma(dp[1], of[ks], f[2], f[3]);
      }
      if (biasb) {   // its loads issued together, added after the products
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + c * 16 + j * 8 + 2 * t + (e & 1), row = rows[e >> 1];
            s[j][e] += row < S && col < S ? biasb[(int64_t)row * S + col] : 0.f;
          }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + c * 16 + j * 8 + 2 * t + (e & 1);
          const float p = col < S ? exp2f(fmaf(s[j][e] - lh[e >> 1], tc::kLog2e, -ll[e >> 1]))
                                  : 0.f;
          const float pd = p * dp[j][e];
          r[e >> 1] += pd;
          s[j][e] = p;
          dp[j][e] = pd;
        }
      uint32_t pa[4], pa_lo[4], pda[4], pda_lo[4];
      tc::acc_to_a_split(pa, pa_lo, s[0], s[1]);
      tc::acc_to_a_split(pda, pda_lo, dp[0], dp[1]);
#pragma unroll
      for (int j = 0; j < T::kNTiles; j += 2) {
        uint32_t f[4];
        tc::load_b_cols<DH>(f, Kt, c * 16, j * 8);
        tc::mma(A[j], pda, f[0], f[1]);
        tc::mma(A[j + 1], pda, f[2], f[3]);
        tc::mma(A[j], pda_lo, f[0], f[1]);
        tc::mma(A[j + 1], pda_lo, f[2], f[3]);
        tc::mma(Bp[j], pa, f[0], f[1]);
        tc::mma(Bp[j + 1], pa, f[2], f[3]);
        tc::mma(Bp[j], pa_lo, f[0], f[1]);
        tc::mma(Bp[j + 1], pa_lo, f[2], f[3]);
      }
    }
    __syncthreads();  // this stage is read; the next iteration refills it
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) r[i] = tc::quad_sum(r[i]);
#pragma unroll
  for (int j = 0; j < T::kNTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float gq = A[j][e] - r[e >> 1] * Bp[j][e];
      A[j][e] = __bfloat162float(__float2bfloat16_rn(gq)) * scale;
    }
  bf16* out[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    out[i] = rows[i] < S ? dq + (((int64_t)b * S + rows[i]) * H + h) * DH : nullptr;
  tc::store_rows<DH>(out[0], out[1], A);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (rows[i] < S) rowterm[bhs + rows[i]] = r[i];
  }
}

template <int DH>
__global__ void __launch_bounds__(tc::kThreads, 3) attention_bwd_dkdv_mma(
    const tc::bf16* __restrict__ q, const tc::bf16* __restrict__ k,
    const tc::bf16* __restrict__ v, const float* __restrict__ bias,
    const tc::bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ rowterm, tc::bf16* __restrict__ dk,
    tc::bf16* __restrict__ dv, int S, int H,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss, int64_t o_sh,
    int64_t bias_sb, float scale) {
  using T = tc::Tile<DH>;
  using tc::bf16;
  constexpr int NC = tc::kRows / 16;      // 16-row slices of a query tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + T::kElems;
  bf16* Qs = Vs + T::kElems;              // [kStages][64][DH + 8], scaled
  bf16* Os = Qs + tc::kStages * T::kElems;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kb0 = blockIdx.x * tc::kRows, h = blockIdx.y, b = blockIdx.z;
  const int64_t bhs = ((int64_t)b * H + h) * S;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* ob = dout + b * o_sb + h * o_sh;
  const float* biasb = bias ? bias + b * bias_sb : nullptr;
  const int keys[2] = {kb0 + warp * 16 + g, kb0 + warp * 16 + g + 8};
  const int tiles = (S + tc::kRows - 1) / tc::kRows;
  const int64_t plane = (int64_t)gridDim.z * H * S;   // lse: hi, then lo

  tc::load_tile<DH>(Ks, k + b * k_sb + h * k_sh, k_ss, kb0, S);
  tc::load_tile<DH>(Vs, v + b * v_sb + h * v_sh, v_ss, kb0, S);
  tc::load_tile<DH>(Qs, qb, q_ss, 0, S);
  tc::load_tile<DH>(Os, ob, o_ss, 0, S);
  tc::cp_async_commit();

  uint32_t kf[T::kSteps][4], vf[T::kSteps][4];
  float dkacc[T::kNTiles][4], dvacc[T::kNTiles][4];
#pragma unroll
  for (int j = 0; j < T::kNTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkacc[j][e] = dvacc[j][e] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int stage = it % tc::kStages;
    if (it + 1 < tiles) {   // the next tile loads while this one is computed
      const int next = (it + 1) % tc::kStages;
      tc::load_tile<DH>(Qs + next * T::kElems, qb, q_ss, (it + 1) * tc::kRows, S);
      tc::load_tile<DH>(Os + next * T::kElems, ob, o_ss, (it + 1) * tc::kRows, S);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    // qs = (q * scale) in bf16, once per tile, for both of its products.
    tc::scale_own_chunks<DH>(Qs + stage * T::kElems, scale);
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < T::kSteps; ++ks) {
        tc::load_a<DH>(kf[ks], Ks, warp * 16, ks * 16);
        tc::load_a<DH>(vf[ks], Vs, warp * 16, ks * 16);
      }
    }
    const bf16* Qt = Qs + stage * T::kElems;
    const bf16* Ot = Os + stage * T::kElems;
    const int q0 = it * tc::kRows;

#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c * 16 >= S - q0) continue;     // a slice of rows past S
      // Transposed: rows are this warp's keys, columns query rows; the
      // row statistics of columns 2t + u of n8 tile j, and the bias.
      float s[2][4] = {}, dp[2][4] = {}, lh[2][2], ll[2][2], rt[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int row = q0 + c * 16 + j * 8 + 2 * t + u;
          lh[j][u] = row < S ? lse[bhs + row] : 0.f;
          ll[j][u] = row < S ? lse[plane + bhs + row] * tc::kLog2e : 0.f;
          rt[j][u] = row < S ? rowterm[bhs + row] : 0.f;
        }
#pragma unroll
      for (int ks = 0; ks < T::kSteps; ++ks) {
        uint32_t f[4];
        tc::load_b_rows<DH>(f, Qt, c * 16, ks * 16);
        tc::mma(s[0], kf[ks], f[0], f[1]);
        tc::mma(s[1], kf[ks], f[2], f[3]);
        tc::load_b_rows<DH>(f, Ot, c * 16, ks * 16);
        tc::mma(dp[0], vf[ks], f[0], f[1]);
        tc::mma(dp[1], vf[ks], f[2], f[3]);
      }
      if (biasb) {   // its loads issued together, added after the products
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int row = q0 + c * 16 + j * 8 + 2 * t + u;
#pragma unroll
            for (int i = 0; i < 2; ++i)
              s[j][2 * i + u] += row < S && keys[i] < S
                                     ? biasb[(int64_t)row * S + keys[i]] : 0.f;
          }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int row = q0 + c * 16 + j * 8 + 2 * t + u;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = 2 * i + u;
            float p = 0.f, ds = 0.f;
            if (row < S && keys[i] < S) {
              p = exp2f(fmaf(s[j][e] - lh[j][u], tc::kLog2e, -ll[j][u]));
              ds = p * (dp[j][e] - rt[j][u]);
            }
            s[j][e] = p;
            dp[j][e] = ds;
          }
        }
      uint32_t pa[4], pa_lo[4], dsa[4], dsa_lo[4];
      tc::acc_to_a_split(pa, pa_lo, s[0], s[1]);
      tc::acc_to_a_split(dsa, dsa_lo, dp[0], dp[1]);
#pragma unroll
      for (int j = 0; j < T::kNTiles; j += 2) {
        uint32_t f[4];
        tc::load_b_cols<DH>(f, Ot, c * 16, j * 8);
        tc::mma(dvacc[j], pa, f[0], f[1]);
        tc::mma(dvacc[j + 1], pa, f[2], f[3]);
        tc::mma(dvacc[j], pa_lo, f[0], f[1]);
        tc::mma(dvacc[j + 1], pa_lo, f[2], f[3]);
        tc::load_b_cols<DH>(f, Qt, c * 16, j * 8);
        tc::mma(dkacc[j], dsa, f[0], f[1]);
        tc::mma(dkacc[j + 1], dsa, f[2], f[3]);
        tc::mma(dkacc[j], dsa_lo, f[0], f[1]);
        tc::mma(dkacc[j + 1], dsa_lo, f[2], f[3]);
      }
    }
    __syncthreads();  // this stage is read; the next iteration refills it
  }

  bf16* kout[2];
  bf16* vout[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t at = (((int64_t)b * S + keys[i]) * H + h) * DH;
    kout[i] = keys[i] < S ? dk + at : nullptr;
    vout[i] = keys[i] < S ? dv + at : nullptr;
  }
  tc::store_rows<DH>(kout[0], kout[1], dkacc);
  tc::store_rows<DH>(vout[0], vout[1], dvacc);
}

template <int DH>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const float* bias,
                       const void* dout, const float* lse, void* dq, void* dk, void* dv,
                       float* rowterm, int B, int S, int H, const int64_t* st,
                       int64_t bias_sb, float scale, cudaStream_t stream) {
  using tc::bf16;
  constexpr size_t smem = mma_smem_bytes<DH>();
  cudaError_t err = opt_in(attention_bwd_dq_mma<DH>, smem);
  if (err != cudaSuccess) return err;
  err = opt_in(attention_bwd_dkdv_mma<DH>, smem);
  if (err != cudaSuccess) return err;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* op = static_cast<const bf16*>(dout);
  const dim3 grid((S + tc::kRows - 1) / tc::kRows, H, B);
  attention_bwd_dq_mma<DH><<<grid, tc::kThreads, smem, stream>>>(
      qp, kp, vp, bias, op, lse, static_cast<bf16*>(dq), rowterm, S, H, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], bias_sb, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_mma<DH><<<grid, tc::kThreads, smem, stream>>>(
      qp, kp, vp, bias, op, lse, rowterm, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      S, H, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], bias_sb, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry, loaded with ctypes. Strides are in elements (batch,
// sequence, head) for q, k, v and do; their last dim is contiguous; in bf16
// every pointer and stride is a multiple of 16 bytes (the cp.async copies).
// dq, dk, dv are written [B, S, H, Dh] contiguous. dtype: 0 = float32,
// 1 = bfloat16. bias is null or a contiguous fp32 [B|1, S, S] with batch
// stride bias_sb (0 = shared). scale is already rounded to the input type.
// lse is the forward's fp32 [2, B, H, S] log-sum-exp pair (hi, lo), read
// by the bf16 path (the float32 path recomputes its statistics and takes
// null). stats is fp32 scratch: 3 * B * H * S floats in float32 (m, l,
// r / l), B * H * S in bf16 (r). Returns the cudaError_t of the launches,
// or -1 for an unsupported dtype / Dh or a bf16 call without lse.
extern "C" int cfa_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* bias, const void* dout, const void* lse,
                                 void* dq, void* dk, void* dv, void* stats, int B,
                                 int S, int H, int Dh, int dtype,
                                 long long q_sb, long long q_ss, long long q_sh,
                                 long long k_sb, long long k_ss, long long k_sh,
                                 long long v_sb, long long v_ss, long long v_sh,
                                 long long o_sb, long long o_ss, long long o_sh,
                                 long long bias_sb, float scale, void* stream) {
  const int64_t st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                          v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  const float* bp = static_cast<const float*>(bias);
  const float* lp = static_cast<const float*>(lse);
  float* sp = static_cast<float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CFA_F32(D)                                                                      \
  return (int)launch<D>(static_cast<const float*>(q), static_cast<const float*>(k),      \
                        static_cast<const float*>(v), bp, static_cast<const float*>(dout), \
                        static_cast<float*>(dq), static_cast<float*>(dk),                \
                        static_cast<float*>(dv), sp, B, S, H, st, bias_sb, scale, s)
#define CFA_BF16(D) \
  return (int)launch_mma<D>(q, k, v, bp, dout, lp, dq, dk, dv, sp, B, S, H, st, bias_sb, scale, s)
  if (dtype == 0) {
    if (Dh == 16) CFA_F32(16);
    if (Dh == 32) CFA_F32(32);
    if (Dh == 64) CFA_F32(64);
  } else if (dtype == 1 && lp) {
    if (Dh == 16) CFA_BF16(16);
    if (Dh == 32) CFA_BF16(32);
    if (Dh == 64) CFA_BF16(64);
  }
#undef CFA_BF16
#undef CFA_F32
  return -1;
}
