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
// shared memory. So each dtype's two passes hold 64 rows of their own a
// block and stream the other side's tiles, and no sum crosses blocks (no
// atomics: the result is the same on every run). Since
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
// bf16 (training's default compute type): two tensor-core kernels (building blocks
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
// float32 (cli/train.py --no-amp: every layer of every tower), near fp32
// accuracy (see Accuracy below) on the TF32 tensor cores:
// attention_bwd_dq_tf32 and attention_bwd_dkdv_tf32, the same two passes,
// every product mma.sync.m16n8k8 TF32 with fp32 sums, three of them for each
// fp32 one (attention_tf32.cuh: hi·hi + hi·lo + lo·hi; p, p * dp and ds are
// split into hi and lo like any other operand). Both read the forward's lse
// pair, as the bf16 passes do; dq is A - r B. 4 warps, 64 rows a block (dq:
// query rows; dk/dv: keys), whose two tiles (qs and do, or k and v) stay fp32
// in shared memory, split by each warp as it reads its fragments; 16-row
// tiles of the streamed pair (k and v, or qs and do) are read from device
// memory into registers while the tile before them is computed, then split
// once into hi / lo words in the other of two buffers (one barrier a tile).
// 68 KB of shared memory at Dh=64: each pass runs two blocks an SM (dq 255
// registers, dk/dv 247; at three, dk/dv's 168 registers spill since the
// sums over the rows take mma_row_rn, below).
//
// What bounds it: not the tensor cores alone. Plain TF32 (hi·hi alone, a
// third of the products) saves only 19-28 % of the time: each warp reads
// its operands' words from shared memory for every tile and runs its
// products, exponentials and splits in sequence, with 8 warps an SM to
// overlap them. Own tiles split once into hi / lo words in
// shared memory (twice their bytes) measured 9-22 % slower, 32-row tiles
// and 8-warp blocks slower on two of three shapes, and a software
// pipeline that overlaps tile s + 1's products over the head dim with
// tile s's products over the rows (a third buffer, 224 registers) 25-63 %
// slower (perf/attention_bwd_fp32_study.py on an NVIDIA H100 80GB HBM3 at
// 700 W; PERF.md).
//
// Layouts. Each streamed tile is read from two sides: as the B operand of
// a product over the head dim (s = qs k^T: lane (g, t) takes row g and the
// head-dim pair of column t) and as the B operand of a product over the
// tile's rows (A += (p * dp) k: lane (g, t) takes rows 2t and 2t + 1, the
// key pair the m16n8k8 accumulator holds in place of columns t, t + 4,
// and head dims of column g). One layout serves both with 16-byte loads
// and no bank conflicts: a row is its DH / 2 chunks with no padding,
// chunk c of row r stored at chunk c ^ swizzle(r). The product over rows
// takes the gradient's n dim in an order of its own: n8 tile j, column c
// holds head dim (DH / 8) c + j, so lane g reads (DH / 8) contiguous head
// dims (DH / 16 chunks) of each of its two rows, and lane t ends with
// 2 DH / 8 contiguous head dims of a gradient row, stored as float4s.
//
// Accuracy. The tensor cores round each fp32 sum mostly toward zero, not
// to nearest (perf/fp32_grad_bias_study.py). Kept in the mma accumulator
// over a vision row's 26 k8 steps of three products each, dq, dk and dv
// came out 1.5-1.9e-6 smaller than exact, about 15 units of fp32's last
// place, with or without a fourth product (lo·lo), which showed in a
// model's gradient norm, 2.3e-6 below the CPU's at ViT-B/16 (PERF.md). So
// the four sums over the streamed rows (A, B, dk, dv) take each k8 step's
// three products into a zeroed accumulator and add it to the running sum
// with a round-to-nearest fp32 add (attention_tf32.cuh::mma_row_rn): the
// truncation spans one step's products, not the whole row. On the card dq,
// dk and dv then read 0.4-0.7e-6 small (what is left: the scores' sums
// over the head dim) and the model's gradient norm 6.7e-8 low (PERF.md).
//
// Bound on the card: the vision backward at B=32 moves 136 MB for 9.5
// GFLOP of fp32 products, 28.6 GFLOP of TF32 ones, 0.058 ms at 495
// TFLOP/s (operations); its text tower (S=77, causal) 35 MB, 0.011 ms
// (bytes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"
#include "attention_tf32.cuh"

namespace {

template <typename Kern>
cudaError_t opt_in(Kern kernel, size_t smem) {
  // Above 48 KB dynamic shared memory needs the opt-in, which holds for the
  // current device only; it is a cheap host call, made on every launch.
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 tensor cores
// ---------------------------------------------------------------------------

constexpr int kF32Warps = 4;       // warps a block, 16 rows of the block's own tiles each
constexpr int kF32Rows = 16;       // rows of a streamed tile (dq: keys; dk/dv: query rows)
// TF32 products an fp32 one: 3; 4 adds lo·lo; 1 (hi·hi, plain TF32, which
// misses the tolerance) only to weigh the tensor cores' share of the time.
constexpr int kF32Products = 3;
// Blocks an SM that __launch_bounds__ leaves registers for: dq pass, dk/dv pass.
constexpr int kF32MinBlocks = 2;
constexpr int kF32DkdvMinBlocks = 2;

template <int DH> struct F32Bwd {
  static_assert(DH == 16 || DH == 32 || DH == 64, "head dim 16, 32 or 64");
  static constexpr int kThreads = 32 * kF32Warps;
  static constexpr int kOwn = 16 * kF32Warps;         // rows of the block's own tiles
  static constexpr int kWords = 2 * DH;               // words a row: DH / 2 chunks
  static constexpr int kSteps = DH / 8;               // k8 steps over DH; n8 tiles of a gradient
  static constexpr int kTile = kF32Rows * kWords;     // words of one streamed tensor's tile
  static constexpr int kLoads = kF32Rows * DH / 4;    // its float4s in device memory
  static constexpr int kPer = (kLoads + kThreads - 1) / kThreads;
  static constexpr int kOwnPer = kOwn * DH / 4 / kThreads;
  // Words a row of an own tile: fp32 and 8 words of padding, which keep
  // the fragment reads' 8-byte loads conflict-free.
  static constexpr int kOwnWords = DH + 8;
  static_assert(kOwn * DH / 4 % kThreads == 0, "own tiles in whole rounds of loads");
  // two own tiles, then two stages of two streamed tiles
  static constexpr size_t kSmem = (2 * (size_t)kOwn * kOwnWords + 4 * (size_t)kTile) * 4;
};

// The XOR of row r's chunk indices. Lanes (g, t) reading chunk 4 ks + t of
// rows g (a product over the head dim) meet 8 distinct banks of 16 bytes
// when rows 2i and 2i + 1 differ in bit 2; lanes reading chunk
// (DH / 16) g + i of rows 2t (or 2t + 1: a product over the rows) when
// rows 2t, t < 4, take the 4 values of the two bits that (DH / 16) g
// leaves free.
template <int DH>
__device__ __forceinline__ int swizzle(int r) {
  const int t = (r >> 1) & 3;
  const int s = DH == 64 ? t : DH == 32 ? ((t & 1) | ((t & 2) << 1)) : t << 1;
  return s ^ ((r & 1) << 2);
}

__device__ __forceinline__ uint4 lds128(const uint32_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// Head dims 4c .. 4c + 3 of row r of a tile, split into its words.
template <int DH>
__device__ __forceinline__ void store_row4(uint32_t* tile, int r, int c, float4 x) {
  uint4 a, b;
  tfa::split_pairs(x, a, b);
  uint32_t* row = tile + r * F32Bwd<DH>::kWords;
  const int m = swizzle<DH>(r);
  *reinterpret_cast<uint4*>(row + (((2 * c) ^ m) << 2)) = a;
  *reinterpret_cast<uint4*>(row + (((2 * c + 1) ^ m) << 2)) = b;
}

// Head dims 4c .. 4c + 3 of row `row` of one head (x offset to it; zeros
// past S), multiplied by `scale` in fp32 when it is not 0 (qs, as the TPU
// wrapper scales q).
__device__ __forceinline__ float4 load_row4(const float* __restrict__ x, int64_t x_ss, int row,
                                           int S, int c, float scale) {
  float4 y = row < S ? *reinterpret_cast<const float4*>(x + row * x_ss + 4 * c)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  if (scale != 0.f)
    y = make_float4(__fmul_rn(y.x, scale), __fmul_rn(y.y, scale), __fmul_rn(y.z, scale),
                    __fmul_rn(y.w, scale));
  return y;
}

// Rows [r0, r0 + kOwn) of one head into the block's own tile.
template <int DH>
__device__ __forceinline__ void load_own(float* tile, const float* __restrict__ x,
                                         int64_t x_ss, int r0, int S, float scale) {
  using T = F32Bwd<DH>;
#pragma unroll
  for (int i = 0; i < T::kOwnPer; ++i) {
    const int at = threadIdx.x + i * T::kThreads, r = at / (DH / 4), c = at % (DH / 4);
    *reinterpret_cast<float4*>(tile + r * T::kOwnWords + 4 * c) =
        load_row4(x, x_ss, r0 + r, S, c, scale);
  }
}

// A streamed tile pair on its way from device memory to shared memory:
// this thread's share, held in registers while the tile before it is
// computed.
template <int DH> struct F32Pair {
  float4 a[F32Bwd<DH>::kPer], b[F32Bwd<DH>::kPer];
};

// Issues the loads of rows [r0, r0 + kF32Rows) of two heads' tensors.
template <int DH>
__device__ __forceinline__ void pair_load(F32Pair<DH>& st, const float* __restrict__ a,
                                          int64_t a_ss, const float* __restrict__ b,
                                          int64_t b_ss, int r0, int S) {
  using T = F32Bwd<DH>;
#pragma unroll
  for (int i = 0; i < T::kPer; ++i) {
    const int at = threadIdx.x + i * T::kThreads, r = r0 + at / (DH / 4), c = at % (DH / 4);
    const bool ok = T::kLoads % T::kThreads == 0 || at < T::kLoads;
    st.a[i] = load_row4(a, a_ss, ok ? r : S, S, c, 0.f);
    st.b[i] = load_row4(b, b_ss, ok ? r : S, S, c, 0.f);
  }
}

// Splits this thread's share into the two tiles at `tile` (a, then b), a's
// values multiplied by `scale_a` when it is not 0.
template <int DH>
__device__ __forceinline__ void pair_store(const F32Pair<DH>& st, uint32_t* tile, float scale_a) {
  using T = F32Bwd<DH>;
#pragma unroll
  for (int i = 0; i < T::kPer; ++i) {
    const int at = threadIdx.x + i * T::kThreads, r = at / (DH / 4), c = at % (DH / 4);
    if (T::kLoads % T::kThreads == 0 || at < T::kLoads) {
      float4 x = st.a[i];
      if (scale_a != 0.f)
        x = make_float4(__fmul_rn(x.x, scale_a), __fmul_rn(x.y, scale_a),
                        __fmul_rn(x.z, scale_a), __fmul_rn(x.w, scale_a));
      store_row4<DH>(tile, r, c, x);
      store_row4<DH>(tile + T::kTile, r, c, st.b[i]);
    }
  }
}

// The A fragment of a product over the head dim at k8 step ks, split as
// it is read: rows r0 + g and r0 + g + 8 of an own tile (fp32), head dims
// 8 ks + 2t and 8 ks + 2t + 1.
template <int DH>
__device__ __forceinline__ void frag_a(uint32_t ah[4], uint32_t al[4], const float* tile,
                                       int r0, int ks, int g, int t) {
  constexpr int W = F32Bwd<DH>::kOwnWords;
  const float* f = tile + 8 * ks + 2 * t;
  const float2 x0 = *reinterpret_cast<const float2*>(f + (r0 + g) * W);
  const float2 x1 = *reinterpret_cast<const float2*>(f + (r0 + g + 8) * W);
  tf32::split(x0.x, ah[0], al[0]);
  tf32::split(x1.x, ah[1], al[1]);
  tf32::split(x0.y, ah[2], al[2]);
  tf32::split(x1.y, ah[3], al[3]);
}

// The B fragment of a product over the head dim at k8 step ks: row n0 + g
// of a tile, head-dim pair 4 ks + t.
template <int DH>
__device__ __forceinline__ void frag_b_dims(uint32_t bh[2], uint32_t bl[2], const uint32_t* tile,
                                            int n0, int ks, int g, int t, int m) {
  const uint4 y = lds128(tile + (n0 + g) * F32Bwd<DH>::kWords + (((4 * ks + t) ^ m) << 2));
  bh[0] = y.x; bh[1] = y.y;
  bl[0] = y.z; bl[1] = y.w;
}

// The B fragments of a product over the tile's rows k0 .. k0 + 7 (k0 a
// multiple of 8), for every n8 tile j of the head dim: rows k0 + 2t and
// k0 + 2t + 1 (the accumulator's column pair), head dim (DH / 8) g + j.
template <int DH>
__device__ __forceinline__ void frag_b_rows(uint32_t (*bh)[2], uint32_t (*bl)[2],
                                            const uint32_t* tile, int k0, int g, int t) {
  constexpr int KS = F32Bwd<DH>::kSteps, W = F32Bwd<DH>::kWords;
  const uint32_t* r0 = tile + (k0 + 2 * t) * W;
  const int m = swizzle<DH>(2 * t);
#pragma unroll
  for (int i = 0; i < KS / 2; ++i) {
    const int c = KS / 2 * g + i;
    const uint4 y0 = lds128(r0 + ((c ^ m) << 2));
    const uint4 y1 = lds128(r0 + W + ((c ^ m ^ 4) << 2));
    bh[2 * i][0] = y0.x; bh[2 * i][1] = y1.x; bl[2 * i][0] = y0.z; bl[2 * i][1] = y1.z;
    bh[2 * i + 1][0] = y0.y; bh[2 * i + 1][1] = y1.y;
    bl[2 * i + 1][0] = y0.w; bl[2 * i + 1][1] = y1.w;
  }
}

// A gradient's rows g and g + 8 (null: past S), each already offset to
// head dim 2 (DH / 8) t: accumulator n8 tile j, column 2t holds head dim
// 2 (DH / 8) t + j and column 2t + 1 head dim 2 (DH / 8) t + DH / 8 + j.
template <int DH>
__device__ __forceinline__ void store_grad(float* out0, float* out1, const float (*acc)[4]) {
  constexpr int KS = F32Bwd<DH>::kSteps;
  float* out[2] = {out0, out1};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!out[i]) continue;
    float x[2 * KS];
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      x[j] = acc[j][2 * i];
      x[KS + j] = acc[j][2 * i + 1];
    }
#pragma unroll
    for (int c = 0; c < KS / 2; ++c)
      *reinterpret_cast<float4*>(out[i] + 4 * c) =
          make_float4(x[4 * c], x[4 * c + 1], x[4 * c + 2], x[4 * c + 3]);
  }
}

template <int DH>
__global__ void __launch_bounds__(32 * kF32Warps, kF32MinBlocks) attention_bwd_dq_tf32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ dq, float* __restrict__ rowterm,
    int S, int H, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,
    int64_t o_sh, int64_t bias_sb, float scale) {
  using T = F32Bwd<DH>;
  constexpr int KS = T::kSteps, NC = kF32Rows / 8;
  extern __shared__ __align__(16) float fsmem[];
  float* Qs = fsmem;                         // own rows: qs, then do
  float* Os = Qs + T::kOwn * T::kOwnWords;
  // two stages of a k tile and a v tile
  uint32_t* ring = reinterpret_cast<uint32_t*>(Os + T::kOwn * T::kOwnWords);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * T::kOwn, h = blockIdx.y, b = blockIdx.z;
  const int w0 = warp * 16;                  // the warp's rows of the own tiles
  const int64_t bhs = ((int64_t)b * H + h) * S;
  const int64_t plane = (int64_t)gridDim.z * H * S;   // lse: hi, then lo
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const float* biasb = bias ? bias + b * bias_sb : nullptr;
  const int rows[2] = {q0 + w0 + g, q0 + w0 + g + 8};
  // A warp whose 16 rows all lie past S only helps load the tiles.
  const bool active = q0 + w0 < S;
  const int mg = swizzle<DH>(g);

  load_own<DH>(Qs, q + b * q_sb + h * q_sh, q_ss, q0, S, scale);
  load_own<DH>(Os, dout + b * o_sb + h * o_sh, o_ss, q0, S, 0.f);
  F32Pair<DH> st;
  pair_load<DH>(st, kb, k_ss, vb, v_ss, 0, S);
  pair_store<DH>(st, ring, 0.f);

  // Per row the forward's lse pair: hi, and lo in log2 units.
  float lh[2], ll[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lh[i] = rows[i] < S ? lse[bhs + rows[i]] : 0.f;
    ll[i] = rows[i] < S ? lse[plane + bhs + rows[i]] * tc::kLog2e : 0.f;
  }
  float A[KS][4], Bp[KS][4], r[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) A[j][e] = Bp[j][e] = 0.f;
  __syncthreads();

  const int tiles = (S + kF32Rows - 1) / kF32Rows;
  for (int s = 0; s < tiles; ++s) {
    const bool more = s + 1 < tiles;
    if (more) pair_load<DH>(st, kb, k_ss, vb, v_ss, (s + 1) * kF32Rows, S);
    if (active) {
      const uint32_t* Kt = ring + (s & 1) * 2 * T::kTile;
      const uint32_t* Vt = Kt + T::kTile;
      const int k0 = s * kF32Rows;

      // s = qs k^T and dp = do v^T for rows g, g + 8, keys k0 + 8n + 2t (+1).
      float sc[NC][4], dp[NC][4];
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t qh[4], ql[4], oh[4], ol[4];
        frag_a<DH>(qh, ql, Qs, w0, ks, g, t);
        frag_a<DH>(oh, ol, Os, w0, ks, g, t);
        uint32_t kh[NC][2], kl[NC][2], vh[NC][2], vl[NC][2];
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          frag_b_dims<DH>(kh[n], kl[n], Kt, 8 * n, ks, g, t, mg);
          frag_b_dims<DH>(vh[n], vl[n], Vt, 8 * n, ks, g, t, mg);
        }
        tfa::mma_row<NC, kF32Products>(sc, qh, ql, kh, kl);
        tfa::mma_row<NC, kF32Products>(dp, oh, ol, vh, vl);
      }
      if (biasb) {   // its loads issued together, added after the products
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + n * 8 + 2 * t + (e & 1), row = rows[e >> 1];
            sc[n][e] += row < S && col < S ? biasb[(int64_t)row * S + col] : 0.f;
          }
      }
      // p exact per tile from the lse pair (keys past S: 0), p * dp into
      // r unrounded.
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + n * 8 + 2 * t + (e & 1);
          const float p = col < S ? exp2f(fmaf(sc[n][e] - lh[e >> 1], tc::kLog2e, -ll[e >> 1]))
                                  : 0.f;
          const float pd = p * dp[n][e];
          r[e >> 1] += pd;
          sc[n][e] = p;
          dp[n][e] = pd;
        }
      // A += (p * dp) k and B += p k over the tile's keys.
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        uint32_t ph[4], pl[4], dh[4], dl[4];
        tfa::acc_to_a(ph, pl, sc[n]);
        tfa::acc_to_a(dh, dl, dp[n]);
        uint32_t bh[KS][2], bl[KS][2];
        frag_b_rows<DH>(bh, bl, Kt, 8 * n, g, t);
        tfa::mma_row_rn<KS, kF32Products>(A, dh, dl, bh, bl);
        tfa::mma_row_rn<KS, kF32Products>(Bp, ph, pl, bh, bl);
      }
    }
    if (more) pair_store<DH>(st, ring + ((s + 1) & 1) * 2 * T::kTile, 0.f);
    __syncthreads();   // the next tile is in place; this one is free again
  }

  if (!active) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) r[i] = tc::quad_sum(r[i]);
  // dq = (A - r B) * scale, as the TPU wrapper folds the scale in.
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) A[j][e] = __fmul_rn(A[j][e] - r[e >> 1] * Bp[j][e], scale);
  float* out[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    out[i] = rows[i] < S ? dq + (((int64_t)b * S + rows[i]) * H + h) * DH + 2 * KS * t : nullptr;
  store_grad<DH>(out[0], out[1], A);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (rows[i] < S) rowterm[bhs + rows[i]] = r[i];
  }
}

template <int DH>
__global__ void __launch_bounds__(32 * kF32Warps, kF32DkdvMinBlocks) attention_bwd_dkdv_tf32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ rowterm, float* __restrict__ dk,
    float* __restrict__ dv, int S, int H, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    int64_t o_sb, int64_t o_ss, int64_t o_sh, int64_t bias_sb, float scale) {
  using T = F32Bwd<DH>;
  constexpr int KS = T::kSteps, NC = kF32Rows / 8;
  extern __shared__ __align__(16) float fsmem[];
  float* Ks = fsmem;                         // own rows: k, then v
  float* Vs = Ks + T::kOwn * T::kOwnWords;
  // two stages of a qs tile and a do tile
  uint32_t* ring = reinterpret_cast<uint32_t*>(Vs + T::kOwn * T::kOwnWords);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kb0 = blockIdx.x * T::kOwn, h = blockIdx.y, b = blockIdx.z;
  const int w0 = warp * 16;
  const int64_t bhs = ((int64_t)b * H + h) * S;
  const int64_t plane = (int64_t)gridDim.z * H * S;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* ob = dout + b * o_sb + h * o_sh;
  const float* biasb = bias ? bias + b * bias_sb : nullptr;
  const int keys[2] = {kb0 + w0 + g, kb0 + w0 + g + 8};
  const bool active = kb0 + w0 < S;
  const int mg = swizzle<DH>(g);

  load_own<DH>(Ks, k + b * k_sb + h * k_sh, k_ss, kb0, S, 0.f);
  load_own<DH>(Vs, v + b * v_sb + h * v_sh, v_ss, kb0, S, 0.f);
  F32Pair<DH> st;
  pair_load<DH>(st, qb, q_ss, ob, o_ss, 0, S);
  pair_store<DH>(st, ring, scale);

  float dK[KS][4], dV[KS][4];
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dK[j][e] = dV[j][e] = 0.f;
  __syncthreads();

  const int tiles = (S + kF32Rows - 1) / kF32Rows;
  for (int s = 0; s < tiles; ++s) {
    const bool more = s + 1 < tiles;
    if (more) pair_load<DH>(st, qb, q_ss, ob, o_ss, (s + 1) * kF32Rows, S);
    if (active) {
      const uint32_t* Qt = ring + (s & 1) * 2 * T::kTile;
      const uint32_t* Ot = Qt + T::kTile;
      const int q0 = s * kF32Rows;
      // Transposed: rows are this warp's keys, columns the tile's query
      // rows q0 + 8n + 2t + u, whose lse pair and row term are these.
      float lh[NC][2], ll[NC][2], rt[NC][2];
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int row = q0 + 8 * n + 2 * t + u;
          lh[n][u] = row < S ? lse[bhs + row] : 0.f;
          ll[n][u] = row < S ? lse[plane + bhs + row] * tc::kLog2e : 0.f;
          rt[n][u] = row < S ? rowterm[bhs + row] : 0.f;
        }
      float sc[NC][4], dp[NC][4];
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kh[4], kl[4], vh[4], vl[4];
        frag_a<DH>(kh, kl, Ks, w0, ks, g, t);
        frag_a<DH>(vh, vl, Vs, w0, ks, g, t);
        uint32_t qh[NC][2], ql[NC][2], oh[NC][2], ol[NC][2];
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          frag_b_dims<DH>(qh[n], ql[n], Qt, 8 * n, ks, g, t, mg);
          frag_b_dims<DH>(oh[n], ol[n], Ot, 8 * n, ks, g, t, mg);
        }
        tfa::mma_row<NC, kF32Products>(sc, kh, kl, qh, ql);
        tfa::mma_row<NC, kF32Products>(dp, vh, vl, oh, ol);
      }
      if (biasb) {   // its loads issued together, added after the products
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = q0 + 8 * n + 2 * t + (e & 1), key = keys[e >> 1];
            sc[n][e] += row < S && key < S ? biasb[(int64_t)row * S + key] : 0.f;
          }
      }
      // p^T and ds^T = p^T (dp^T - r); rows or keys past S: 0.
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int u = e & 1;
          const bool ok = q0 + 8 * n + 2 * t + u < S && keys[e >> 1] < S;
          const float p = ok ? exp2f(fmaf(sc[n][e] - lh[n][u], tc::kLog2e, -ll[n][u])) : 0.f;
          dp[n][e] = p * (dp[n][e] - rt[n][u]);
          sc[n][e] = p;
        }
      // dv += p^T do and dk += ds^T qs over the tile's rows.
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        uint32_t ph[4], pl[4], dh[4], dl[4];
        tfa::acc_to_a(ph, pl, sc[n]);
        tfa::acc_to_a(dh, dl, dp[n]);
        uint32_t bh[KS][2], bl[KS][2];
        frag_b_rows<DH>(bh, bl, Ot, 8 * n, g, t);
        tfa::mma_row_rn<KS, kF32Products>(dV, ph, pl, bh, bl);
        frag_b_rows<DH>(bh, bl, Qt, 8 * n, g, t);
        tfa::mma_row_rn<KS, kF32Products>(dK, dh, dl, bh, bl);
      }
    }
    if (more) pair_store<DH>(st, ring + ((s + 1) & 1) * 2 * T::kTile, scale);
    __syncthreads();   // the next tile is in place; this one is free again
  }

  if (!active) return;
  float* kout[2];
  float* vout[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t at = (((int64_t)b * S + keys[i]) * H + h) * DH + 2 * KS * t;
    kout[i] = keys[i] < S ? dk + at : nullptr;
    vout[i] = keys[i] < S ? dv + at : nullptr;
  }
  store_grad<DH>(kout[0], kout[1], dK);
  store_grad<DH>(vout[0], vout[1], dV);
}

template <int DH>
cudaError_t launch_tf32(const float* q, const float* k, const float* v, const float* bias,
                        const float* dout, const float* lse, float* dq, float* dk, float* dv,
                        float* rowterm, int B, int S, int H, const int64_t* st,
                        int64_t bias_sb, float scale, cudaStream_t stream) {
  using T = F32Bwd<DH>;
  cudaError_t err = opt_in(attention_bwd_dq_tf32<DH>, T::kSmem);
  if (err != cudaSuccess) return err;
  err = opt_in(attention_bwd_dkdv_tf32<DH>, T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + T::kOwn - 1) / T::kOwn, H, B);
  attention_bwd_dq_tf32<DH><<<grid, T::kThreads, T::kSmem, stream>>>(
      q, k, v, bias, dout, lse, dq, rowterm, S, H, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], bias_sb, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dkdv_tf32<DH><<<grid, T::kThreads, T::kSmem, stream>>>(
      q, k, v, bias, dout, lse, rowterm, dk, dv, S, H, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], bias_sb, scale);
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
// sequence, head) for q, k, v and do; their last dim is contiguous; every
// pointer and stride is a multiple of 16 bytes (the kernels' 16-byte
// loads). dq, dk, dv are written [B, S, H, Dh] contiguous. dtype: 0 =
// float32, 1 = bfloat16. bias is null or a contiguous fp32 [B|1, S, S]
// with batch stride bias_sb (0 = shared). scale is already rounded to the
// input type. lse is the forward's fp32 [2, B, H, S] log-sum-exp pair (hi,
// lo), which both paths read. stats is fp32 scratch of B * H * S floats,
// each row's term r, written by the dq pass and read by the dk/dv pass.
// Returns the cudaError_t of the launches, or -1 for an unsupported dtype
// / Dh or a call without lse.
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
#define CFA_F32(D)                                                                         \
  return (int)launch_tf32<D>(static_cast<const float*>(q), static_cast<const float*>(k),    \
                             static_cast<const float*>(v), bp,                              \
                             static_cast<const float*>(dout), lp, static_cast<float*>(dq), \
                             static_cast<float*>(dk), static_cast<float*>(dv), sp, B, S, H, \
                             st, bias_sb, scale, s)
#define CFA_BF16(D) \
  return (int)launch_mma<D>(q, k, v, bp, dout, lp, dq, dk, dv, sp, B, S, H, st, bias_sb, scale, s)
  if (!lp) return -1;
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
  return -1;
}
