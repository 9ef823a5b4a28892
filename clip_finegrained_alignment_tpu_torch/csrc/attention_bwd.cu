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
// does. The bias gets no gradient.
//
// Same function, not the same blocking. The TPU kernel holds the padded
// S x S fp32 p, dp and ds tiles of a whole head group in VMEM (~5.8 MB at
// ViT-B/16, S=197 padded to 200, 12 heads); a Hopper block has 227 KB of
// shared memory. So both passes stream 64-wide tiles, and no sum crosses
// blocks (no atomics: the result is the same on every run):
//
//   pass 1, one block per (64 query rows, head, batch), a loop over 64-key
//     tiles with an online softmax (fp32 running max m and sum l). Since
//       dq_i = sum_j p_ij (dp_ij - r_i) k_j = sum_j p_ij dp_ij k_j
//                                           - r_i sum_j p_ij k_j,
//     it accumulates A = sum e dp k, B = sum e k and r = sum e dp with the
//     unnormalized weights e = exp(s - m), rescaled when m moves, and ends
//     with dq = (A - (r / l) B) / l. The row term r / l = sum_j dp_ij p_ij
//     is JAX's fp32 row term, taken from p itself (not from the bf16 o).
//     It writes m, l and r / l per row for pass 2.
//   pass 2, one block per (64 keys, head, batch), a loop over 64-query
//     tiles: it recomputes p = exp(s - m) / l (the forward's formula) and
//     dp, forms ds, and accumulates dv and dk for its keys in registers.
//
// Keys >= S are excluded (weight 0), which is what the TPU wrapper's -1e9
// padding keys give after exp; query rows >= S are computed on zeros and
// take no part in dk, dv (p = 0 there), and rows >= S are never written.
//
// Bound on the card: at B=32, ViT-B/16 vision (S=197, H=12, Dh=64, bf16)
// moves ~68 MB (q, k, v, do in; dq, dk, dv out) for ~9.5 GFLOP, so it is
// memory-bound at ~20 us at 3.35 TB/s; the text tower (S=77, H=8) ~18 MB,
// ~5 us. This first version computes on the fp32 CUDA cores from shared
// memory (no mma.sync / wgmma, no TMA) and recomputes the scores twice, so
// it runs far above that bound; what it does about the bytes is keep p,
// dp and ds out of device memory and write each gradient once.

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
constexpr int QSTR = BQ + 4;    // row stride of query-indexed tiles
constexpr int KSTR = BK + 4;    // row stride of key-indexed tiles

static_assert(BQ == TY * R4 && BK == TX * R4 && BK == TY * R4 && BQ == TX * R4,
              "the float4 tile reads below assume 64 x 64 tiles of 4 x 4");

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

// Loads rows [r0, r0 + 64) of one head of x (bshd view through strides)
// into shared memory as fp32: transposed into xt[DH][STR] and, if xs is
// not null, row-major into xs[64][DH]. Rows >= S are zero. With scale != 0
// the value is (x * scale) rounded to T, as the TPU wrapper prescales q.
template <typename T, int DH, int STR>
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
      if (scale != 0.f) x = round_to<T>(x * scale);
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
// Pass 1: dq and the per-row statistics
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

template <typename T, int DH>
__global__ void __launch_bounds__(NT, 2) attention_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const T* __restrict__ dout,
    T* __restrict__ dq, float* __restrict__ stats, int B, int S, int H,
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
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const float* biasb = bias ? bias + b * bias_sb : nullptr;

  load_tile<T, DH, QSTR>(q + b * q_sb + h * q_sh, q_ss, q0, S, scale, Qt, nullptr);
  load_tile<T, DH, QSTR>(dout + b * o_sb + h * o_sh, o_ss, q0, S, 0.f, DOt, nullptr);

  float m[R4], l[R4], r[R4], A[R4][RD], Bc[R4][RD];
#pragma unroll
  for (int i = 0; i < R4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    r[i] = 0.f;
#pragma unroll
    for (int j = 0; j < RD; ++j) A[i][j] = Bc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, DH, KSTR>(kb, k_ss, k0, S, 0.f, Kt, Ks);
    load_tile<T, DH, KSTR>(vb, v_ss, k0, S, 0.f, Vt, nullptr);
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
    const float inv = 1.f / l[i];
    const float rowterm = r[i] * inv;
    T* out = dq + (((int64_t)b * S + row) * H + h) * DH + tx * RD;
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      const float g = (A[i][j] - rowterm * Bc[i][j]) * inv;
      out[j] = from_f<T>(round_to<T>(g) * scale);
    }
    if (tx == 0) {
      const int64_t at = ((int64_t)b * H + h) * S + row;
      stats[at] = m[i];
      stats[BHS + at] = l[i];
      stats[2 * BHS + at] = rowterm;
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 2: dk and dv
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

template <typename T, int DH>
__global__ void __launch_bounds__(NT, 2) attention_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, const T* __restrict__ dout,
    T* __restrict__ dk, T* __restrict__ dv, const float* __restrict__ stats,
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
  const T* qb = q + b * q_sb + h * q_sh;
  const T* ob = dout + b * o_sb + h * o_sh;
  const float* biasb = bias ? bias + b * bias_sb : nullptr;
  const int64_t BHS = (int64_t)B * H * S;
  const float* st = stats + ((int64_t)b * H + h) * S;

  load_tile<T, DH, KSTR>(k + b * k_sb + h * k_sh, k_ss, kb0, S, 0.f, Kt, nullptr);
  load_tile<T, DH, KSTR>(v + b * v_sb + h * v_sh, v_ss, kb0, S, 0.f, Vt, nullptr);

  float dkacc[R4][RD], dvacc[R4][RD];
#pragma unroll
  for (int i = 0; i < R4; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) dkacc[i][j] = dvacc[i][j] = 0.f;

  for (int q0 = 0; q0 < S; q0 += BQ) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, DH, QSTR>(qb, q_ss, q0, S, scale, Qt, Qs);
    load_tile<T, DH, QSTR>(ob, o_ss, q0, S, 0.f, DOt, DOs);
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
      dk[at + j] = from_f<T>(dkacc[i][j]);
      dv[at + j] = from_f<T>(dvacc[i][j]);
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

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   const void* dout, void* dq, void* dk, void* dv, float* stats,
                   int B, int S, int H, const int64_t* st, int64_t bias_sb,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem1 = dq_smem_floats<DH>() * sizeof(float);
  constexpr size_t smem2 = dkdv_smem_floats<DH>() * sizeof(float);
  cudaError_t err = opt_in(attention_bwd_dq_kernel<T, DH>, smem1);
  if (err != cudaSuccess) return err;
  err = opt_in(attention_bwd_dkdv_kernel<T, DH>, smem2);
  if (err != cudaSuccess) return err;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* op = static_cast<const T*>(dout);
  attention_bwd_dq_kernel<T, DH><<<dim3((S + BQ - 1) / BQ, H, B), NT, smem1, stream>>>(
      qp, kp, vp, bias, op, static_cast<T*>(dq), stats, B, S, H, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], bias_sb, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_kernel<T, DH><<<dim3((S + BK - 1) / BK, H, B), NT, smem2, stream>>>(
      qp, kp, vp, bias, op, static_cast<T*>(dk), static_cast<T*>(dv), stats, B, S, H,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], bias_sb, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry, loaded with ctypes. Strides are in elements (batch,
// sequence, head) for q, k, v and do; their last dim is contiguous. dq, dk,
// dv are written [B, S, H, Dh] contiguous. stats is fp32 scratch of
// 3 * B * H * S floats. dtype: 0 = float32, 1 = bfloat16. bias is null or
// a contiguous fp32 [B|1, S, S] with batch stride bias_sb (0 = shared).
// scale is already rounded to the input type. Returns the cudaError_t of
// the launches, or -1 for an unsupported dtype / Dh.
extern "C" int cfa_attention_bwd(const void* q, const void* k, const void* v,
                                 const void* bias, const void* dout, void* dq,
                                 void* dk, void* dv, void* stats, int B, int S,
                                 int H, int Dh, int dtype,
                                 long long q_sb, long long q_ss, long long q_sh,
                                 long long k_sb, long long k_ss, long long k_sh,
                                 long long v_sb, long long v_ss, long long v_sh,
                                 long long o_sb, long long o_ss, long long o_sh,
                                 long long bias_sb, float scale, void* stream) {
  const int64_t st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                          v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  const float* bp = static_cast<const float*>(bias);
  float* sp = static_cast<float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CFA_LAUNCH(T, D) \
  return (int)launch<T, D>(q, k, v, bp, dout, dq, dk, dv, sp, B, S, H, st, bias_sb, scale, s)
  if (dtype == 0) {
    if (Dh == 16) CFA_LAUNCH(float, 16);
    if (Dh == 32) CFA_LAUNCH(float, 32);
    if (Dh == 64) CFA_LAUNCH(float, 64);
  } else if (dtype == 1) {
    if (Dh == 16) CFA_LAUNCH(__nv_bfloat16, 16);
    if (Dh == 32) CFA_LAUNCH(__nv_bfloat16, 32);
    if (Dh == 64) CFA_LAUNCH(__nv_bfloat16, 64);
  }
#undef CFA_LAUNCH
  return -1;
}
