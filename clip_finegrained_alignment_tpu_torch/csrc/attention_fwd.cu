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
// shared memory a block has here. So both kernels below stream key tiles
// with an online softmax (fp32 running max and sum per row, one division
// by the sum at the end):
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
// text tower (S=77, H=8) moves ~20 MB, ~6 us. In float32 (evaluation's
// towers) the bytes double and each product is three TF32 products on the
// 495 TFLOP/s of the TF32 tensor cores: at evaluation's vision batch (B=32)
// 77.5 MB and 3 x 3.8 GFLOP, ~23 us either way; its text batch (B=320,
// S=77, H=8) 202 MB, ~60 us of bytes.
//
// Both kernels share one shape: one block per (query rows, head, batch),
// each warp owning 16 query rows and its 16 x Dh fp32 output in registers;
// k and v stream through two or more tiles in shared memory, read 16 bytes
// at a time through the tensors' strides (keys past S zero), so the next
// tile loads while this one is computed; the scores go to the weights and
// the weights to the second product in registers; the online softmax
// keeps an fp32 max and sum per row, its weights exp2(s log2e - m log2e)
// from one FFMA, and divides by the sum once at the end. Warps whose rows
// all lie past S only help with the loads. No score or weight reaches
// device memory.
//
// bf16 (serving, training): attention_fwd_mma, on the bf16 tensor cores
// (building blocks and fragment layouts in attention_mma.cuh). 8 warps,
// 128 query rows a block, the scaled q as mma operands in registers;
// 128 rows rather than 64 halve how often each head's k and v are read
// from L2 (0.0845 -> 0.0758 ms at ViT-B/16, B=64 on an H100). 64-key tiles
// stay bf16 in shared memory; S = q k^T and O += P v are
// mma.sync.m16n8k16 bf16 with fp32 sums. The one deliberate difference
// from _fwd_math: P is rounded to bf16 against the running max, before the
// final division by the sum (which sums the unrounded weights), where
// _fwd_math rounds p = e / s; at S=197 the last key tile holds 5 keys, so
// 16-key slices past S are skipped. Every global read is a 16-byte copy of
// a full 128-byte row segment at Dh=64. mma.sync rather than wgmma: at
// these sequence lengths the kernel is bound by bytes, not operations, and
// mma.sync reaches the tensor cores with 16-row warp tiles that fit S=77
// and S=197 with little padding.
//
// float32 (evaluation): attention_fwd_tf32, fp32-accurate on the TF32
// tensor cores. Every product is mma.sync.m16n8k8 TF32 with fp32 sums,
// three of them for each fp32 one (tf32_mma.cuh: each operand split into
// hi = tf32(x) and lo = tf32(x - hi), and lo·hi + hi·lo + hi·hi added onto
// one accumulator), which holds the fp32 tolerance that one TF32 product
// would miss. Operands are split once, as they are stored in shared memory,
// not by each warp that reads them: q (scaled and rounded to fp32 as the
// TPU wrapper scales it) when the block starts, each 16-key tile of k and
// v by the whole block after its global loads, which are issued before the
// tile ahead of it is computed (one barrier a tile). The words are laid out
// so that a lane takes a fragment's hi and lo halves in one 16-byte load.
// A tile is one branch-free step of the softmax and both products, masked
// past S. The m16n8k8 accumulator holds keys 2t, 2t + 1 where the next
// product's A fragment wants columns t, t + 4: P stays in place and v's B
// fragment is the matching key pair (a sum over keys may be taken in any
// order); q's and k's head dims are paired the same way. 8 warps, 128
// query rows a block, two blocks an SM (124 registers, 109 KB of shared
// memory at Dh=64). What bounds it: each warp reads every k and v word of
// its head in hi and lo halves (~24 KB of shared-memory loads a warp a
// tile), and a warp-step's products and softmax run in sequence; the
// products alone, at the mma.sync.m16n8k8 TF32 rate the card reaches with
// no loads (326 TFLOP/s, 66 % of the 495 peak), would take about a third
// of its time (perf/attention_fp32_study.py on an NVIDIA H100 80GB HBM3 at
// 700 W). Splitting k and v in each warp as it loads its fragments, q's
// halves in registers (one block an SM), 32-key tiles (the shared memory
// of one block an SM) and 64-row blocks each measured slower; a branch
// around each n8 tile's products, as the bf16 kernel has to skip keys past
// S, serialized them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"
#include "attention_tf32.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: 3xTF32 tensor cores
// ---------------------------------------------------------------------------

constexpr int kF32Keys = 16;       // keys a tile, one branch-free step of the softmax and products
constexpr int kF32Warps = 8;       // warps a block, 16 query rows each
// TF32 products an fp32 one: 3; 4 adds lo·lo; 1 (hi·hi, plain TF32, which
// misses the tolerance) only in perf/attention_fp32_study.py, to weigh the
// tensor cores' share of the time.
constexpr int kF32Products = 3;
constexpr int kF32MinBlocks = 2;   // blocks an SM that __launch_bounds__ leaves registers for

// q, k and v live in shared memory already split, as the bit patterns of
// their TF32 hi and lo halves. A row of q or k holds, for each pair of
// head dims (2i, 2i + 1), hi(2i), hi(2i + 1), lo(2i), lo(2i + 1); v holds,
// for each pair of keys (2p, 2p + 1) and head dim d, hi and lo of both
// keys. So the lane that reads a fragment's two elements takes their four
// words in one 16-byte load.
template <int DH> struct F32Tile {
  static_assert(DH == 16 || DH == 32 || DH == 64, "head dim 16, 32 or 64");
  static constexpr int kThreads = 32 * kF32Warps;
  // Row strides in words: 16 (mod 32) for q and k rows, 8 (mod 32) for v's
  // key pairs, keep those loads conflict-free.
  static constexpr int kQKStride = 2 * DH + 16;
  static constexpr int kVStride = 4 * DH + 8;
  static constexpr int kTile = kF32Keys * kQKStride + kF32Keys / 2 * kVStride;  // words, k then v
  static constexpr int kSteps = DH / 8;   // k8 steps over DH, and n8 tiles of o
  // A tile's global loads: float4s of k (4 head dims of one key), and
  // float2 pairs of v (2 head dims of each key of a pair).
  static constexpr int kKLoads = kF32Keys * DH / 4;
  static constexpr int kVLoads = kF32Keys / 2 * DH / 2;
  static constexpr int kKPer = (kKLoads + kThreads - 1) / kThreads;
  static constexpr int kVPer = (kVLoads + kThreads - 1) / kThreads;
};

// Two k/v tiles (the one computed and the next), then the block's q rows.
template <int DH>
constexpr size_t f32_smem_bytes() {
  using T = F32Tile<DH>;
  return (2 * (size_t)T::kTile + (size_t)16 * kF32Warps * T::kQKStride) * sizeof(uint32_t);
}

// Head dims 4c .. 4c + 3 of one q or k row, split into that row's words.
__device__ __forceinline__ void store_split4(uint32_t* row, int c, float4 x) {
  uint4 a, b;
  tfa::split_pairs(x, a, b);
  *reinterpret_cast<uint4*>(row + 8 * c) = a;
  *reinterpret_cast<uint4*>(row + 8 * c + 4) = b;
}

// A k/v tile on its way from device memory to shared memory: this thread's
// share, held in registers while the tile before it is computed.
template <int DH> struct F32Stage {
  float4 k[F32Tile<DH>::kKPer];
  float2 v0[F32Tile<DH>::kVPer], v1[F32Tile<DH>::kVPer];
};

// Issues the loads of keys [k0, k0 + kF32Keys) of one head's k and v (kb,
// vb already offset to it; rows past S read as zeros).
template <int DH>
__device__ __forceinline__ void f32_load(F32Stage<DH>& st, const float* __restrict__ kb,
                                         int64_t k_ss, const float* __restrict__ vb,
                                         int64_t v_ss, int k0, int S) {
  using T = F32Tile<DH>;
#pragma unroll
  for (int i = 0; i < T::kKPer; ++i) {
    const int at = threadIdx.x + i * T::kThreads, key = k0 + at / (DH / 4);
    const bool ok = (T::kKLoads % T::kThreads == 0 || at < T::kKLoads) && key < S;
    st.k[i] = ok ? *reinterpret_cast<const float4*>(kb + key * k_ss + at % (DH / 4) * 4)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < T::kVPer; ++i) {
    const int at = threadIdx.x + i * T::kThreads, key = k0 + 2 * (at / (DH / 2));
    const bool ok = T::kVLoads % T::kThreads == 0 || at < T::kVLoads;
    const float* x = vb + key * v_ss + at % (DH / 2) * 2;
    st.v0[i] = ok && key < S ? *reinterpret_cast<const float2*>(x) : make_float2(0.f, 0.f);
    st.v1[i] = ok && key + 1 < S ? *reinterpret_cast<const float2*>(x + v_ss)
                                 : make_float2(0.f, 0.f);
  }
}

// Splits this thread's share of a loaded tile into the tile's words.
template <int DH>
__device__ __forceinline__ void f32_store(const F32Stage<DH>& st, uint32_t* tile) {
  using T = F32Tile<DH>;
#pragma unroll
  for (int i = 0; i < T::kKPer; ++i) {
    const int at = threadIdx.x + i * T::kThreads;
    if (T::kKLoads % T::kThreads == 0 || at < T::kKLoads)
      store_split4(tile + at / (DH / 4) * T::kQKStride, at % (DH / 4), st.k[i]);
  }
  uint32_t* vt = tile + kF32Keys * T::kQKStride;
#pragma unroll
  for (int i = 0; i < T::kVPer; ++i) {
    const int at = threadIdx.x + i * T::kThreads;
    if (T::kVLoads % T::kThreads == 0 || at < T::kVLoads) {
      uint32_t* w = vt + at / (DH / 2) * T::kVStride + at % (DH / 2) * 8;
      uint32_t h0, l0, h1, l1;
      tf32::split(st.v0[i].x, h0, l0);
      tf32::split(st.v1[i].x, h1, l1);
      *reinterpret_cast<uint4*>(w) = make_uint4(h0, h1, l0, l1);
      tf32::split(st.v0[i].y, h0, l0);
      tf32::split(st.v1[i].y, h1, l1);
      *reinterpret_cast<uint4*>(w + 4) = make_uint4(h0, h1, l0, l1);
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(32 * kF32Warps, kF32MinBlocks) attention_fwd_tf32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, float* __restrict__ o, float* __restrict__ lse,
    int S, int H, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t bias_sb, float scale) {
  using T = F32Tile<DH>;
  constexpr int NC = kF32Keys / 8;   // n8 key tiles of a tile
  constexpr int KS = T::kSteps;
  static_assert(kF32Keys % 8 == 0, "tiles of whole n8 tiles");
  extern __shared__ __align__(16) uint32_t wsmem[];   // two k/v tiles, then q

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (blockIdx.x * kF32Warps + warp) * 16;   // 16 rows a warp
  const int h = blockIdx.y, b = blockIdx.z;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const float* biasb = bias ? bias + b * bias_sb : nullptr;
  const int rows[2] = {r0 + g, r0 + g + 8};
  // A warp whose 16 rows all lie past S only helps load the tiles.
  const bool active = r0 < S;
  const int npad = tc::padded_keys(S);

  // The warp's 16 rows of q, scaled and rounded to fp32 as the TPU wrapper
  // scales them, split once (a warp reads only its own rows).
  uint32_t* Qw = wsmem + 2 * T::kTile + warp * 16 * T::kQKStride;
  if (active) {
#pragma unroll
    for (int i = 0; i < 16 * DH / 4 / 32; ++i) {
      const int at = i * 32 + lane, r = at / (DH / 4), c = at % (DH / 4);
      float4 x = r0 + r < S ? *reinterpret_cast<const float4*>(qb + (r0 + r) * q_ss + 4 * c)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      x = make_float4(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale), __fmul_rn(x.z, scale),
                      __fmul_rn(x.w, scale));
      store_split4(Qw + r * T::kQKStride, c, x);
    }
  }

  const float m0 = npad ? tc::kNeg : -INFINITY;
  float m[2] = {m0, m0}, l[2] = {0.f, 0.f};
  float acc[KS][4];                // o: n8 tile j holds floats 8 j + 2t, 2t + 1
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // Tile s + 1 is read from device memory into registers while tile s is
  // computed, then split into the other buffer; one barrier a tile.
  const int tiles = (S + kF32Keys - 1) / kF32Keys;
  F32Stage<DH> st;
  f32_load<DH>(st, kb, k_ss, vb, v_ss, 0, S);
  f32_store<DH>(st, wsmem);
  __syncthreads();
  for (int s = 0; s < tiles; ++s) {
    const bool more = s + 1 < tiles;
    if (more) f32_load<DH>(st, kb, k_ss, vb, v_ss, (s + 1) * kF32Keys, S);
    if (active) {
      const uint32_t* Kt = wsmem + (s & 1) * T::kTile;
      const uint32_t* Vt = Kt + kF32Keys * T::kQKStride;
      const int k0 = s * kF32Keys;

      // Scores qs k^T for rows g, g + 8, keys k0 + 8n + 2t (+1). Within a
      // k8 step, A column t holds head dim 2t and column t + 4 head dim
      // 2t + 1, and k's B fragment pairs them the same way: the step's sum
      // does not depend on the order.
      float sc[NC][4];
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint4 x0 = *reinterpret_cast<const uint4*>(Qw + g * T::kQKStride + (ks * 4 + t) * 4);
        const uint4 x1 =
            *reinterpret_cast<const uint4*>(Qw + (g + 8) * T::kQKStride + (ks * 4 + t) * 4);
        const uint32_t ah[4] = {x0.x, x1.x, x0.y, x1.y}, al[4] = {x0.z, x1.z, x0.w, x1.w};
        uint32_t bh[NC][2], bl[NC][2];
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const uint4 y =
              *reinterpret_cast<const uint4*>(Kt + (n * 8 + g) * T::kQKStride + (ks * 4 + t) * 4);
          bh[n][0] = y.x;
          bh[n][1] = y.y;
          bl[n][0] = y.z;
          bl[n][1] = y.w;
        }
        tfa::mma_row<NC, kF32Products>(sc, ah, al, bh, bl);
      }

      if (biasb) {   // its loads issued together, added after the product
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + n * 8 + 2 * t + (e & 1), row = rows[e >> 1];
            sc[n][e] += row < S && col < S ? biasb[(int64_t)row * S + col] : 0.f;
          }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (k0 + n * 8 + 2 * t + (e & 1) >= S) sc[n][e] = -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
        }
      float mb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // Key k0 < S lies in every tile, so the new max is finite.
        const float m_new = tc::quad_max(mx[i]);
        const float alpha = exp2f((m[i] - m_new) * tc::kLog2e);
        m[i] = m_new;
        mb[i] = __fmul_rn(m_new, tc::kLog2e);
        l[i] *= alpha;                      // this thread's share of the sum
#pragma unroll
        for (int j = 0; j < KS; ++j) {
          acc[j][2 * i] *= alpha;
          acc[j][2 * i + 1] *= alpha;
        }
      }
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(fmaf(sc[n][e], tc::kLog2e, -mb[e >> 1]));
          sc[n][e] = p;
          l[e >> 1] += p;
        }

      // O += P V over k8 steps of 8 keys. The score accumulator holds keys
      // 2t, 2t + 1 of a step where the A fragment wants columns t, t + 4:
      // column t takes key 2t and column t + 4 key 2t + 1, and v's B
      // fragment is that key pair's words, so P goes from one product to
      // the next in registers, in place.
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        uint32_t ah[4], al[4];
        tfa::acc_to_a(ah, al, sc[n]);
        uint32_t vh[KS][2], vl[KS][2];
        const uint32_t* vp = Vt + (n * 4 + t) * T::kVStride + g * 4;
#pragma unroll
        for (int j = 0; j < KS; ++j) {
          const uint4 y = *reinterpret_cast<const uint4*>(vp + j * 32);
          vh[j][0] = y.x;
          vh[j][1] = y.y;
          vl[j][0] = y.z;
          vl[j][1] = y.w;
        }
        tfa::mma_row<KS, kF32Products>(acc, ah, al, vh, vl);
      }
    }
    if (more) f32_store<DH>(st, wsmem + ((s + 1) & 1) * T::kTile);
    __syncthreads();   // the next tile is in place; this one is free again
  }

  if (!active) return;
  // The weights are exp2(s log2e - mb), mb = m log2e rounded to fp32: each
  // is exp(s - m) times 2^r, r = m log2e - mb, which o = acc / l cancels
  // and the log-sum-exp takes out. The padded keys' share is taken in the
  // same form (in a fully masked row r is ~18 at m = -1e9).
  float lf[2], logl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float mb = __fmul_rn(m[i], tc::kLog2e);
    lf[i] = tc::quad_sum(l[i]) + (npad ? npad * exp2f(fmaf(tc::kNeg, tc::kLog2e, -mb)) : 0.f);
    logl[i] = logf(lf[i]) - fmaf(m[i], tc::kLog2e, -mb) * tc::kLn2;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= S) continue;
    float* orow = o + (((int64_t)b * S + rows[i]) * H + h) * DH + 2 * t;
#pragma unroll
    for (int j = 0; j < KS; ++j)
      *reinterpret_cast<float2*>(orow + j * 8) =
          make_float2(acc[j][2 * i] / lf[i], acc[j][2 * i + 1] / lf[i]);
    if (lse && t == 0)
      tc::store_lse(lse, (int64_t)gridDim.z * H * S, ((int64_t)b * H + h) * S + rows[i], m[i],
                    logl[i]);
  }
}

template <int DH>
cudaError_t launch_tf32(const float* q, const float* k, const float* v, const float* bias,
                        float* o, float* lse, int B, int S, int H,
                        int64_t q_sb, int64_t q_ss, int64_t q_sh,
                        int64_t k_sb, int64_t k_ss, int64_t k_sh,
                        int64_t v_sb, int64_t v_ss, int64_t v_sh,
                        int64_t bias_sb, float scale, cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<DH>();
  // Above 48 KB dynamic shared memory needs the opt-in, which holds for the
  // current device only; it is a cheap host call, so it is made on every
  // launch and holds on whichever device the caller made current.
  const cudaError_t attr = cudaFuncSetAttribute(
      attention_fwd_tf32<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  constexpr int kRowsABlock = 16 * kF32Warps;
  const dim3 grid((S + kRowsABlock - 1) / kRowsABlock, H, B);
  attention_fwd_tf32<DH><<<grid, 32 * kF32Warps, smem, stream>>>(
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
// of q, k, v is contiguous; every pointer and stride is a multiple of 16
// bytes (the cp.async copies of both kernels). dtype: 0 = float32, 1 = bfloat16. bias
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
#define CFA_F32(D)                                                                      \
  return (int)launch_tf32<D>(static_cast<const float*>(q), static_cast<const float*>(k), \
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
