// Fused multi-head attention forward for Hopper (sm_90a), bshd layout.
//
// Replaces the Pallas TPU kernel clip_finegrained_alignment_tpu/ops/
// attention.py::_fwd_kernel_bshd (math in _fwd_math): for every (batch,
// head), o = softmax(q * scale * k^T + bias) v with fp32 max, sum and
// accumulation, and, when the caller passes a buffer, the per-row
// log-sum-exp (an fp32 pair [2, B, H, S], tc::store_lse) that the backward
// reads. Same function, not the same blocking: the TPU kernel holds the
// whole padded S x S fp32 score tile of a head group in VMEM (~1.9 MB at
// ViT-B/16, S=197 padded to 200, 12 heads), far beyond the 227 KB of
// shared memory a block has here. So
// both kernels below stream 64-key tiles with an online softmax (fp32
// running max and sum per row, one division by the sum at the end):
//
//   * keys >= S are excluded inside the kernel (score -inf, exp 0), and
//     the TPU wrapper's Sp - S padded keys (Sp = round_up(S, 8), score
//     -1e9) are added to the row's sum in closed form at the end,
//     (Sp - S) exp(-1e9 - m), with m started at -1e9 when there are any,
//     as the TPU kernel's max over Sp keys is: 0 in every row unless its
//     every real key scores at or below -1e9, where the row is then
//     sum(v) / Sp as on the TPU (attention_mma.cuh);
//   * the optional fp32 bias [B|1, S, S] (head-invariant, as in CLIP's
//     causal and padding masks) is added per (q, k) before the max;
//   * q, k, v are read through their strides as bshd views of the
//     projection outputs, so no transposes are made; o is written
//     [B, S, H, Dh] contiguous in the input type;
//   * q is scaled as the TPU wrapper does it, (q * scale).astype(q.dtype):
//     the host passes `scale` already rounded to the input type, the
//     product is taken in fp32 and rounded back to the input type.
//
// Bound on the card: at B=64, ViT-B/16 vision (S=197, H=12, Dh=64, bf16)
// moves ~77 MB of q/k/v/o for ~7.6 GFLOP, so it is memory-bound at ~23 us
// at 3.35 TB/s (the 989 TFLOP/s of the tensor cores would take ~8 us); the
// text tower (S=77, H=8) moves ~20 MB, ~6 us.
//
// bf16 (every path on the card): attention_fwd_mma, on the tensor cores
// (building blocks and fragment layouts in attention_mma.cuh). One block of
// 8 warps per (128 query rows, head, batch); each warp owns 16 rows, keeps
// its scaled q as mma operands in registers and its 16 x Dh fp32 output in
// registers (warps whose rows all lie past S only help with the copies).
// 128 rows rather than 64 halve how often each head's k and v are read
// from L2 (0.0845 -> 0.0758 ms at ViT-B/16, B=64 on an H100). 64-key k and
// v tiles stay bf16 in shared memory and stream through a
// 2-stage cp.async ring, so the next tile loads while this one is computed;
// S = q k^T and O += P v are mma.sync.m16n8k16 bf16 with fp32 sums, and P
// goes from the score accumulators to the second product in registers. The
// one deliberate difference from _fwd_math: P is rounded to bf16 against
// the running max, before the final division by the sum (which sums the
// unrounded weights), where _fwd_math rounds p = e / s; at S=197 the last
// key tile holds 5 keys, so 16-key slices past S are skipped. What it does
// about the bytes: q, k, v are read once per query tile, no score or
// probability reaches device memory, and every global read is a 16-byte
// copy of a full 128-byte row segment at Dh=64. mma.sync rather than wgmma:
// at these sequence lengths the kernel is bound by bytes, not operations,
// and mma.sync reaches the tensor cores with 16-row warp tiles that fit
// S=77 and S=197 with little padding.
//
// float32 (no path on the card runs it): attention_fwd_kernel, the first
// version, kept as it was: fp32 CUDA cores from fp32 copies of the tiles
// (TF32 tensor cores would not hold the 1e-4 fp32 tolerance).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int TX = 16;          // threads along keys / head dims
constexpr int TY = 16;          // threads along query rows
constexpr int NT = TX * TY;     // threads per block
constexpr int RQ = BQ / TY;     // query rows per thread (4)
constexpr int RK = BK / TX;     // keys per thread in the score tile (4)
constexpr int QSTR = BQ + 4;    // row stride of Qt / Pt (keeps float4 alignment)
constexpr int KSTR = BK + 4;    // row stride of Kt

static_assert(RQ == 4 && RK == 4, "the float4 reads below assume 4x4");

template <int DH>
constexpr size_t smem_floats() {
  // Qt [DH][QSTR] + Kt [DH][KSTR] + Vs [BK][DH] + Pt [BK][QSTR]
  return (size_t)DH * QSTR + (size_t)DH * KSTR + (size_t)BK * DH + (size_t)BK * QSTR;
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

template <int DH>
__global__ void __launch_bounds__(NT) attention_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, float* __restrict__ o, float* __restrict__ lse,
    int S, int H, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t bias_sb, float scale) {
  constexpr int RD = DH / TX;   // output head dims per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                       // [DH][QSTR], q pre-scaled
  float* Kt = Qt + DH * QSTR;             // [DH][KSTR], k transposed
  float* Vs = Kt + DH * KSTR;             // [BK][DH]
  float* Pt = Vs + BK * DH;               // [BK][QSTR], weights transposed

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const float* biasb = bias ? bias + b * bias_sb : nullptr;
  const int npad = tc::padded_keys(S);

  for (int i = tid; i < BQ * DH; i += NT) {
    const int r = i / DH, d = i % DH;
    const int row = q0 + r;
    float x = 0.f;
    if (row < S) x = qb[row * q_ss + d] * scale;
    Qt[d * QSTR + r] = x;
  }

  float m[RQ], l[RQ], acc[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = npad ? tc::kNeg : -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // the previous tile's Kt / Vs / Pt readers are done
    for (int i = tid; i < BK * DH; i += NT) {
      const int r = i / DH, d = i % DH;
      const int key = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (key < S) {
        kx = kb[key * k_ss + d];
        vx = vb[key * v_ss + d];
      }
      Kt[d * KSTR + r] = kx;
      Vs[r * DH + d] = vx;
    }
    __syncthreads();

    // Scores for rows ty*4+i, keys k0 + tx*4+j.
    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[d * QSTR + ty * RQ]);
      const float4 ka = *reinterpret_cast<const float4*>(&Kt[d * KSTR + tx * RK]);
      const float qv[RQ] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[RK] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = q0 + ty * RQ + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int col = k0 + tx * RK + j;
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
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + group16_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < RD; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < RK; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * RK + j) * QSTR + ty * RQ]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    const int kmax = min(BK, S - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      const float4 pa = *reinterpret_cast<const float4*>(&Pt[kk * QSTR + ty * RQ]);
      const float pv[RQ] = {pa.x, pa.y, pa.z, pa.w};
      float vv[RD];
      if constexpr (RD == 4) {
        const float4 va = *reinterpret_cast<const float4*>(&Vs[kk * DH + tx * RD]);
        vv[0] = va.x; vv[1] = va.y; vv[2] = va.z; vv[3] = va.w;
      } else if constexpr (RD == 2) {
        const float2 va = *reinterpret_cast<const float2*>(&Vs[kk * DH + tx * RD]);
        vv[0] = va.x; vv[1] = va.y;
      } else {
#pragma unroll
        for (int j = 0; j < RD; ++j) vv[j] = Vs[kk * DH + tx * RD + j];
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty * RQ + i;
    if (row >= S) continue;
    // m >= -1e9 when npad > 0, so the term is at most npad.
    const float lf = l[i] + (npad ? npad * expf(tc::kNeg - m[i]) : 0.f);
    float* orow = o + (((int64_t)b * S + row) * H + h) * DH + tx * RD;
#pragma unroll
    for (int j = 0; j < RD; ++j) orow[j] = acc[i][j] / lf;
    if (lse && tx == 0)
      tc::store_lse(lse, (int64_t)gridDim.z * H * S, ((int64_t)b * H + h) * S + row, m[i],
                    logf(lf));
  }
}

template <int DH>
cudaError_t launch(const float* q, const float* k, const float* v, const float* bias,
                   float* o, float* lse, int B, int S, int H,
                   int64_t q_sb, int64_t q_ss, int64_t q_sh,
                   int64_t k_sb, int64_t k_ss, int64_t k_sh,
                   int64_t v_sb, int64_t v_ss, int64_t v_sh,
                   int64_t bias_sb, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<DH>() * sizeof(float);
  // Above 48 KB dynamic shared memory needs the opt-in, which holds for the
  // current device only; it is a cheap host call, so it is made on every
  // launch and holds on whichever device the caller made current.
  const cudaError_t attr = cudaFuncSetAttribute(
      attention_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  attention_fwd_kernel<DH><<<grid, NT, smem, stream>>>(
      q, k, v, bias, o, lse, S, H, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
      v_sb, v_ss, v_sh, bias_sb, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kQWarps = 8;                    // 16 query rows each
constexpr int kQRows = 16 * kQWarps;          // query rows a block
constexpr int kQThreads = 32 * kQWarps;

template <int DH>
constexpr size_t mma_smem_bytes() {
  // q [128][DH + 8], then k and v, each a ring of kStages [64][DH + 8] tiles
  return ((size_t)kQRows * tc::Tile<DH>::kStride + 2 * tc::kStages * tc::Tile<DH>::kElems) *
         sizeof(tc::bf16);
}

template <int DH>
__global__ void __launch_bounds__(kQThreads, 2) attention_fwd_mma(
    const tc::bf16* __restrict__ q, const tc::bf16* __restrict__ k,
    const tc::bf16* __restrict__ v, const float* __restrict__ bias,
    tc::bf16* __restrict__ o, float* __restrict__ lse, int S, int H,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t bias_sb, float scale) {
  using namespace tc;
  using T = Tile<DH>;
  constexpr int NK = kRows / 8;           // n8 tiles of a key tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);       // [128][DH + 8]
  bf16* Ks = Qs + kQRows * T::kStride;                // [kStages][64][DH + 8]
  bf16* Vs = Ks + kStages * T::kElems;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kQRows, h = blockIdx.y, b = blockIdx.z;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  const float* biasb = bias ? bias + b * bias_sb : nullptr;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  // A warp whose 16 rows all lie past S only helps load the tiles.
  const bool active = q0 + warp * 16 < S;
  const int tiles = (S + kRows - 1) / kRows;
  const int npad = padded_keys(S);

  load_tile<DH, kQRows, kQThreads>(Qs, q + b * q_sb + h * q_sh, q_ss, q0, S);
  load_tile<DH, kRows, kQThreads>(Ks, kb, k_ss, 0, S);
  load_tile<DH, kRows, kQThreads>(Vs, vb, v_ss, 0, S);
  cp_async_commit();

  uint32_t qf[T::kSteps][4];
  const float m0 = npad ? kNeg : -INFINITY;
  float m[2] = {m0, m0}, l[2] = {0.f, 0.f};
  float acc[T::kNTiles][4];
#pragma unroll
  for (int j = 0; j < T::kNTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {   // the next tile loads while this one is computed
      const int next = (it + 1) % kStages;
      load_tile<DH, kRows, kQThreads>(Ks + next * T::kElems, kb, k_ss, (it + 1) * kRows, S);
      load_tile<DH, kRows, kQThreads>(Vs + next * T::kElems, vb, v_ss, (it + 1) * kRows, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      if (it == 0) {
#pragma unroll
        for (int ks = 0; ks < T::kSteps; ++ks) {
          load_a<DH>(qf[ks], Qs, warp * 16, ks * 16);
#pragma unroll
          for (int e = 0; e < 4; ++e) qf[ks][e] = scale_pair(qf[ks][e], scale);
        }
      }
      const bf16* Kt = Ks + (it % kStages) * T::kElems;
      const bf16* Vt = Vs + (it % kStages) * T::kElems;
      const int k0 = it * kRows;
      const int valid = S - k0;             // keys of this tile below S

      // Scores q k^T (+ bias) for rows g, g + 8 of this warp, keys
      // k0 + 8n + 2t (+1); the 16-key slices past S are skipped.
      float s[NK][4] = {};
#pragma unroll
      for (int n = 0; n < NK; n += 2) {
        if (n * 8 < valid) {
#pragma unroll
          for (int ks = 0; ks < T::kSteps; ++ks) {
            uint32_t kf[4];
            load_b_rows<DH>(kf, Kt, n * 8, ks * 16);
            mma(s[n], qf[ks], kf[0], kf[1]);
            mma(s[n + 1], qf[ks], kf[2], kf[3]);
          }
        }
      }

      if (biasb) {   // its loads issued together, added after the product
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + n * 8 + 2 * t + (e & 1), row = rows[e >> 1];
            s[n][e] += row < S && col < S ? biasb[(int64_t)row * S + col] : 0.f;
          }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (k0 + n * 8 + 2 * t + (e & 1) >= S) s[n][e] = -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
      float mb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // Key k0 < S lies in every tile, so the new max is finite.
        const float m_new = quad_max(mx[i]);
        const float alpha = exp2f((m[i] - m_new) * kLog2e);
        m[i] = m_new;
        mb[i] = __fmul_rn(m_new, kLog2e);
        l[i] *= alpha;                      // this thread's share of the sum
#pragma unroll
        for (int j = 0; j < T::kNTiles; ++j) {
          acc[j][2 * i] *= alpha;
          acc[j][2 * i + 1] *= alpha;
        }
      }
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fmaf(s[n][e], kLog2e, -mb[e >> 1]));
          s[n][e] = p;
          l[e >> 1] += p;
        }

      // O += P V, 16 keys a step, P rounded to bf16 in registers.
#pragma unroll
      for (int c = 0; c < NK / 2; ++c) {
        if (c * 16 < valid) {
          uint32_t pa[4];
          acc_to_a(pa, s[2 * c], s[2 * c + 1]);
#pragma unroll
          for (int j = 0; j < T::kNTiles; j += 2) {
            uint32_t vf[4];
            load_b_cols<DH>(vf, Vt, c * 16, j * 8);
            mma(acc[j], pa, vf[0], vf[1]);
            mma(acc[j + 1], pa, vf[2], vf[3]);
          }
        }
      }
    }
    __syncthreads();  // this stage is read; the next iteration refills it
  }

  // The weights are exp2(s log2e - mb), mb = m log2e rounded to fp32: each
  // is exp(s - m) times 2^r, r = m log2e - mb, which o = acc / l cancels
  // and the log-sum-exp takes out. The padded keys' share is taken in the
  // same form (in a fully masked row r is ~18 at m = -1e9).
  float inv[2], logl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float mb = __fmul_rn(m[i], kLog2e);
    l[i] = quad_sum(l[i]) + (npad ? npad * exp2f(fmaf(kNeg, kLog2e, -mb)) : 0.f);
    inv[i] = 1.f / l[i];
    logl[i] = logf(l[i]) - fmaf(m[i], kLog2e, -mb) * kLn2;
  }
#pragma unroll
  for (int j = 0; j < T::kNTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= inv[e >> 1];
  bf16* out[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    out[i] = rows[i] < S ? o + (((int64_t)b * S + rows[i]) * H + h) * DH : nullptr;
  store_rows<DH>(out[0], out[1], acc);
  if (lse && t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (rows[i] < S)
        store_lse(lse, (int64_t)gridDim.z * H * S, ((int64_t)b * H + h) * S + rows[i], m[i],
                  logl[i]);
  }
}

template <int DH>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const float* bias,
                       void* o, float* lse, int B, int S, int H,
                       int64_t q_sb, int64_t q_ss, int64_t q_sh,
                       int64_t k_sb, int64_t k_ss, int64_t k_sh,
                       int64_t v_sb, int64_t v_ss, int64_t v_sh,
                       int64_t bias_sb, float scale, cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<DH>();
  const cudaError_t attr = cudaFuncSetAttribute(
      attention_fwd_mma<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + kQRows - 1) / kQRows, H, B);
  attention_fwd_mma<DH><<<grid, kQThreads, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), bias, static_cast<tc::bf16*>(o), lse, S, H,
      q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, bias_sb, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry, loaded with ctypes. Strides are in elements; the last dim
// of q, k, v is contiguous; in bf16 every pointer and stride is a multiple
// of 16 bytes (the cp.async copies). dtype: 0 = float32, 1 = bfloat16. bias
// is null or a contiguous fp32 [B|1, S, S] with batch stride bias_sb
// (0 = shared). lse is null or fp32 [2, B, H, S], each row's log-sum-exp as
// the pair tc::store_lse writes.
// Returns the cudaError_t of the launch, or -1 for an unsupported dtype / Dh.
extern "C" int cfa_attention_fwd(const void* q, const void* k, const void* v,
                                 const void* bias, void* o, void* lse, int B, int S,
                                 int H, int Dh, int dtype,
                                 long long q_sb, long long q_ss, long long q_sh,
                                 long long k_sb, long long k_ss, long long k_sh,
                                 long long v_sb, long long v_ss, long long v_sh,
                                 long long bias_sb, float scale, void* stream) {
  const float* bp = static_cast<const float*>(bias);
  float* lp = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CFA_ARGS                                                                 \
  B, S, H, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, bias_sb, scale, st
#define CFA_F32(D)                                                                 \
  return (int)launch<D>(static_cast<const float*>(q), static_cast<const float*>(k), \
                        static_cast<const float*>(v), bp, static_cast<float*>(o), lp,  \
                        CFA_ARGS)
#define CFA_BF16(D) return (int)launch_mma<D>(q, k, v, bp, o, lp, CFA_ARGS)
  if (dtype == 0) {
    if (Dh == 16) CFA_F32(16);
    if (Dh == 32) CFA_F32(32);
    if (Dh == 64) CFA_F32(64);
  } else if (dtype == 1) {
    if (Dh == 16) CFA_BF16(16);
    if (Dh == 32) CFA_BF16(32);
    if (Dh == 64) CFA_BF16(64);
  }
#undef CFA_BF16
#undef CFA_F32
#undef CFA_ARGS
  return -1;
}
