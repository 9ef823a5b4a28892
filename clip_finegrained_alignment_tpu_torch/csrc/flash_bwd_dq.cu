// Blockwise (long-sequence) attention backward, dq, for Hopper (sm_90a), bhsd.
//
// Replaces the Pallas TPU kernel clip_finegrained_alignment_tpu/ops/
// flash_attention.py::_bwd_dq_kernel (wrapper _bwd): from qs = (q * scale)
// rounded to q's type, k, v, the bias, the output cotangent do and the
// forward's fp32 lse and row term delta = rowsum(do * o) (the flash-2
// identity; the wrapper computes it, as JAX does in XLA),
//
//   p = exp(s - lse),  dp = do v^T,  ds = p * (dp - delta),  dq = ds k,
//
// s = qs k^T + bias, all sums in fp32. dq is rounded to the input type,
// multiplied by the scale (rounded to the input type) and rounded again,
// the TPU wrapper's two roundings.
//
// Bound on the card: at the microbenchmark's S=2048, B=4, H=12, Dh=64 bf16
// it moves ~31 MB (q, k, v, do in, dq out) for 3 products of 2 B H S^2 Dh
// (qs k^T, do v^T, ds k) = 77.3 GFLOP: bound by operations, 0.078 ms at
// 989 TFLOP/s of bf16 tensor work.
//
// bf16 (flash_bwd_dq_wgmma, building blocks in attention_wgmma.cuh): the
// products run on the tensor cores through wgmma, fed by TMA. One block, one
// warpgroup, per (64 query rows, head, batch), four blocks to an SM (122
// registers at Dh=64): its thread 0 has the block's qs and do tiles copied
// once and keeps 64-key tiles of k and v streaming through a 2-stage ring in
// shared memory, one tile ahead (mbarriers: full when a copy lands, empty
// when the warpgroup is done with a stage). Per key tile the warpgroup does
//   s = qs k^T, then dp = do v^T (wgmma, both operands in shared memory, in
//                                 two commit groups),
//   p = exp(s + bias - lse)      (fp32, in registers, while dp's products
//                                 still run), ds = p * (dp - delta),
//   dq += ds k                   (wgmma, ds as the register A operand, the
//                                 k tile as the transposed B operand),
// so no [S, S] tile reaches device memory and ds never goes through shared
// memory. ds enters its product as a bf16 pair hi + lo (two products, ~2^-16
// of ds: one bf16 rounding of ds summed over S keys misses the 1e-3 of the
// largest gradient that the tolerance allows, as measured on the fused
// backward), so the pass issues 4 products of 25.8 GFLOP where the function
// needs 3. Keys >= S get p = 0 (the copy zero-fills their k and v rows); the
// bias is read through L2 and added to the scores in fp32 after the product,
// so in a row masked everywhere s - 1e9 rounds to -1e9, the row's lse, and
// p = 1 for every real key, as in JAX.
//
// float32 (flash_bwd_dq_kernel, the first version, kept: TF32 would not hold
// the fp32 tolerance): one block of 256 threads, 64 query rows, fp32 copies
// of the tiles in shared memory and fp32 CUDA-core products, ds through
// shared memory; it reads q and prescales it itself.

#include "attention_wgmma.cuh"
#include "flash_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

// Kt and the DSt written after the scores share their space.
template <int DH>
constexpr size_t dq_smem_floats() {
  // Qt, DOt [DH][QSTR]; Kt then DSt; Vt [DH][KSTR]; Ks [BK][DH]
  return 2 * (size_t)DH * QSTR + tile_floats<DH>() + (size_t)DH * KSTR + (size_t)BK * DH;
}

template <int DH>
__global__ void __launch_bounds__(NT, 2) flash_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int H, int S, int ls,
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
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const float* biasb = bias ? bias + b * bias_sb : nullptr;
  const int64_t bh = (int64_t)b * H + h;

  load_tile<float, DH, QSTR, true>(q + b * q_sb + h * q_sh, q_ss, q0, S, scale, Qt, nullptr);
  load_tile<float, DH, QSTR>(dout + b * o_sb + h * o_sh, o_ss, q0, S, 0.f, DOt, nullptr);

  float L[R4], Dl[R4], acc[R4][RD];
#pragma unroll
  for (int i = 0; i < R4; ++i) {
    const int row = q0 + ty * R4 + i;
    L[i] = row < S ? lse[bh * ls + row] : 0.f;
    Dl[i] = row < S ? delta[bh * ls + row] : 0.f;
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<float, DH, KSTR>(kb, k_ss, k0, S, 0.f, Kt, Ks);
    load_tile<float, DH, KSTR>(vb, v_ss, k0, S, 0.f, Vt, nullptr);
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
    float* out = dq + (bh * S + row) * DH + tx * RD;
#pragma unroll
    for (int j = 0; j < RD; ++j) out[j] = acc[i][j] * scale;
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   const void* dout, const float* lse, const float* delta, void* dq,
                   int B, int H, int S, int ls, const int64_t* st, int64_t bias_sb,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_floats<DH>() * sizeof(float);
  const cudaError_t attr = opt_in(flash_bwd_dq_kernel<DH>, smem);
  if (attr != cudaSuccess) return attr;
  flash_bwd_dq_kernel<DH><<<dim3((S + BQ - 1) / BQ, H, B), NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dq), H, S, ls, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], bias_sb, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

// Ring depth: one key tile in flight ahead of the one in use, so that four
// blocks fit the SM's shared memory (50,216 bytes each at Dh=64).
constexpr int kStages = 2;

template <int DH>
constexpr size_t dq_wgmma_smem() {
  // alignment slack; qs, do; kStages x (k, v); full[], empty[], resident
  return wg::kAlign + (2 + 2 * kStages) * (size_t)wg::Tile<DH>::kBytes +
         (2 * kStages + 1) * sizeof(uint64_t);
}

template <int DH>
__global__ void __launch_bounds__(wg::kThreads, 4) flash_bwd_dq_wgmma(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
    const float* __restrict__ bias, const float* __restrict__ lse,
    const float* __restrict__ delta, wg::bf16* __restrict__ dq, int H, int S, int ls,
    int64_t bias_sb, float scale) {
  using T = wg::Tile<DH>;
  constexpr int ST = kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + wg::kAlign - 1) & ~(uintptr_t)(wg::kAlign - 1));
  unsigned char* Qs = base;                   // [64][DH] qs, swizzled
  unsigned char* Os = Qs + T::kBytes;         // [64][DH] do
  unsigned char* ring = Os + T::kBytes;       // stage i: k at 2i, v at 2i + 1
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + 2 * ST * T::kBytes);
  uint64_t* empty = full + ST;
  uint64_t* resident = empty + ST;

  const int q0 = blockIdx.x * wg::kRows, h = blockIdx.y, b = blockIdx.z;
  const int tiles = (S + wg::kRows - 1) / wg::kRows;
  // Thread 0 copies: key tile `it` of k and v into stage it % ST, once the
  // warpgroup has released the stage's previous tile.
  auto fill = [&](int it) {
    const int st = it % ST;
    if (it >= ST) wg::bar_wait(&empty[st], (it / ST - 1) & 1);
    wg::bar_expect(&full[st], 2 * T::kBytes);
    wg::tma_load(ring + 2 * st * T::kBytes, &tm_k, it * wg::kRows, h, b, &full[st]);
    wg::tma_load(ring + (2 * st + 1) * T::kBytes, &tm_v, it * wg::kRows, h, b, &full[st]);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      wg::bar_init(&full[i], 1);
      wg::bar_init(&empty[i], wg::kThreads);
    }
    wg::bar_init(resident, 1);
    wg::bar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    wg::bar_expect(resident, 2 * T::kBytes);
    wg::tma_load(Qs, &tm_q, q0, h, b, resident);
    wg::tma_load(Os, &tm_o, q0, h, b, resident);
    for (int it = 0; it < ST - 1 && it < tiles; ++it) fill(it);
  }

  // Thread 4 g + t of warp w owns rows 16 w + g and 16 w + g + 8 of the
  // block's 64.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const int64_t bh = (int64_t)b * H + h;
  const float* biasb = bias ? bias + b * bias_sb : nullptr;
  float L[2], Dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    L[i] = rows[i] < S ? lse[bh * ls + rows[i]] : 0.f;
    Dl[i] = rows[i] < S ? delta[bh * ls + rows[i]] : 0.f;
  }
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;

  wg::bar_wait(resident, 0);
  for (int it = 0; it < tiles; ++it) {
    const int st = it % ST;
    const unsigned char* Kt = ring + 2 * st * T::kBytes;
    const unsigned char* Vt = Kt + T::kBytes;
    const int k0 = it * wg::kRows;
    if (threadIdx.x == 0 && it + ST - 1 < tiles) fill(it + ST - 1);
    wg::bar_wait(&full[st], (it / ST) & 1);

    float s[32], dp[32];
    wg::wgmma_fence();
    wg::mma_xyT<DH>(s, Qs, Kt);
    wg::wgmma_commit();
    wg::mma_xyT<DH>(dp, Os, Vt);
    wg::wgmma_commit();
    wg::wgmma_wait<1>();
    wg::fence_regs(s);

    // p in place of s while dp = do v^T runs: n8 tile j, element e is row
    // rows[e >> 1], key k0 + 8 j + 2 t + (e & 1).
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1), r = e >> 1;
        float p = 0.f;
        if (col < S) {
          float x = s[4 * j + e];
          if (biasb && rows[r] < S) x += biasb[(int64_t)rows[r] * S + col];
          p = __expf(x - L[r]);
        }
        s[4 * j + e] = p;
      }
    wg::wgmma_wait<0>();
    wg::fence_regs(dp);
    // ds = p (dp - delta) in place of s.
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= dp[i] - Dl[(i >> 1) & 1];
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wg::acc_to_a_split(hi[ks], lo[ks], s, ks);

    wg::wgmma_fence();
    wg::fence_regs(acc);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wg::mma_ay<DH>(acc, hi[ks], Kt, ks);
      wg::mma_ay<DH>(acc, lo[ks], Kt, ks);
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(acc);
    wg::bar_arrive(&empty[st]);
  }

  // dq rounded, times the rounded scale, rounded again.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= S) continue;
    wg::bf16* out = dq + (bh * S + rows[i]) * DH + 2 * t;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const float x0 = __bfloat162float(__float2bfloat16_rn(acc[4 * j + 2 * i])) * scale;
      const float x1 = __bfloat162float(__float2bfloat16_rn(acc[4 * j + 2 * i + 1])) * scale;
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) = __floats2bfloat162_rn(x0, x1);
    }
  }
}

template <int DH>
cudaError_t launch_wgmma(const void* qs, const void* k, const void* v, const float* bias,
                         const void* dout, const float* lse, const float* delta, void* dq,
                         int B, int H, int S, int ls, const int64_t* st, int64_t bias_sb,
                         float scale, cudaStream_t stream) {
  CUtensorMap maps[4];
  const void* ptrs[4] = {qs, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = wg::make_map<DH>(&maps[i], ptrs[i], B, H, S, st[3 * i],
                                             st[3 * i + 1], st[3 * i + 2], wg::kRows);
    if (err != cudaSuccess) return err;
  }
  constexpr size_t smem = dq_wgmma_smem<DH>();
  const cudaError_t attr = opt_in(flash_bwd_dq_wgmma<DH>, smem);
  if (attr != cudaSuccess) return attr;
  flash_bwd_dq_wgmma<DH><<<dim3((S + wg::kRows - 1) / wg::kRows, H, B), wg::kThreads, smem,
                           stream>>>(maps[0], maps[1], maps[2], maps[3], bias, lse, delta,
                                     static_cast<wg::bf16*>(dq), H, S, ls, bias_sb, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry, loaded with ctypes. q, k, v and do are [B, H, S, Dh]
// through their (batch, head, sequence) strides in elements, the last dim
// contiguous. float32 takes q and scales it; bf16 takes qs = (q * scale)
// rounded to bf16 in place of q, every pointer and stride a multiple of
// 16 bytes (the TMA copies; a dim of extent 1 may take any such stride).
// lse and delta are fp32 [B, H, ls] (row (b, h) at (b H + h) ls), the first
// S of each row read; dq is written [B, H, S, Dh] contiguous. bias is null
// or a contiguous fp32 [B|1, S, S] with batch stride bias_sb (0 = shared).
// scale is already rounded to the input type. Returns the cudaError_t of
// the launch, or -1 for an unsupported dtype / Dh.
extern "C" int cfa_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* bias, const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int H, int S,
                                int Dh, int dtype, int ls,
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
#define CFA_DQ(D) (dtype == 0 ? launch<D> : launch_wgmma<D>)( \
    q, k, v, bp, dout, lp, dp, dq, B, H, S, ls, st, bias_sb, scale, s)
  if (dtype != 0 && dtype != 1) return -1;
  if (Dh == 16) return (int)CFA_DQ(16);
  if (Dh == 32) return (int)CFA_DQ(32);
  if (Dh == 64) return (int)CFA_DQ(64);
  return -1;
#undef CFA_DQ
}
