// Blockwise (long-sequence) attention backward, dk and dv, for Hopper
// (sm_90a), bhsd.
//
// Replaces the Pallas TPU kernel clip_finegrained_alignment_tpu/ops/
// flash_attention.py::_bwd_dkv_kernel (wrapper _bwd): from qs = (q * scale)
// rounded to q's type, k, v, the bias, the output cotangent do and the
// forward's fp32 lse and row term delta = rowsum(do * o),
//
//   p = exp(s - lse),  dv = p^T do,  ds = p * (do v^T - delta),  dk = ds^T qs,
//
// s = qs k^T + bias, all sums in fp32 (p unrounded); dk and dv are each
// rounded to the input type once. As the TPU kernel's kv grid does, one
// block takes a key tile of one (batch, head) and walks all query rows, so
// each dk, dv row is summed by one block: no atomics, the same result on
// every run, two passes as the JAX package has.
//
// Bound on the card: at the microbenchmark's S=2048, B=4, H=12, Dh=64 bf16
// it moves ~38 MB (q, k, v, do in, dk, dv out) for 4 products of
// 2 B H S^2 Dh (k qs^T, v do^T, p^T do, ds^T qs) = 103 GFLOP: bound by
// operations, 0.104 ms at 989 TFLOP/s of bf16 tensor work.
//
// bf16 (flash_bwd_dkdv_wgmma, building blocks in attention_wgmma.cuh): one
// block, one warpgroup, per (64 keys, head, batch), two blocks to an SM
// (196 registers at Dh=64; capped at 168 for three, ptxas serializes the
// wgmma chain). Its thread 0 has the block's k and v tiles copied once and
// keeps 64-row tiles of qs and do, with their 64 lse and delta values,
// streaming through a 3-stage ring in shared memory, two tiles ahead (TMA
// and bulk copies completing on mbarriers). Per query tile the warpgroup
// computes, each step overlapping the products issued before it,
//   s^T = k qs^T, then dp^T = v do^T  (wgmma, both operands in shared
//                                      memory, two commit groups),
//   p^T                               (fp32, in registers),
//   dv += p^T do                      (wgmma, p^T as the register A operand,
//                                      the do tile as transposed B),
//   ds^T = p^T (dp^T - delta),
//   dk += ds^T qs                     (wgmma, likewise),
// and writes dk and dv once. p and ds enter their products as bf16 pairs
// hi + lo (two products each, ~2^-16: one bf16 rounding of p missed the
// tolerance on dv in the fused backward, attention_bwd.cu), so the pass
// issues 6 products where the function needs 4. Query rows >= S get p = 0
// (the copies zero-fill their qs and do rows; lse and delta arrive padded
// with zeros); the bias is read through L2 and added to the scores in fp32
// after the product.
//
// float32 (flash_bwd_dkdv_kernel, the first version, kept: TF32 would not
// hold the fp32 tolerance): one block of 256 threads, 64 keys, fp32 copies
// of the tiles in shared memory, fp32 CUDA-core products, p and ds through
// shared memory; it reads q and prescales it itself.

#include "attention_wgmma.cuh"
#include "flash_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

template <int DH>
constexpr size_t dkdv_smem_floats() {
  // Kt, Vt [DH][KSTR]; Qt then Pq, DOt then DSq; Qs, DOs [BQ][DH];
  // per-row lse and delta [BQ]
  return 2 * (size_t)DH * KSTR + 2 * tile_floats<DH>() + 2 * (size_t)BQ * DH +
         2 * (size_t)BQ;
}

template <int DH>
__global__ void __launch_bounds__(NT, 2) flash_bwd_dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int H, int S, int ls,
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
  const float* qb = q + b * q_sb + h * q_sh;
  const float* ob = dout + b * o_sb + h * o_sh;
  const float* biasb = bias ? bias + b * bias_sb : nullptr;
  const int64_t bh = (int64_t)b * H + h;
  const float* lseb = lse + bh * ls;
  const float* deltab = delta + bh * ls;

  load_tile<float, DH, KSTR>(k + b * k_sb + h * k_sh, k_ss, kb0, S, 0.f, Kt, nullptr);
  load_tile<float, DH, KSTR>(v + b * v_sb + h * v_sh, v_ss, kb0, S, 0.f, Vt, nullptr);

  float dkacc[R4][RD], dvacc[R4][RD];
#pragma unroll
  for (int i = 0; i < R4; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) dkacc[i][j] = dvacc[i][j] = 0.f;

  for (int q0 = 0; q0 < S; q0 += BQ) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<float, DH, QSTR, true>(qb, q_ss, q0, S, scale, Qt, Qs);
    load_tile<float, DH, QSTR>(ob, o_ss, q0, S, 0.f, DOt, DOs);
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
      dk[at + j] = dkacc[i][j];
      dv[at + j] = dvacc[i][j];
    }
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   const void* dout, const float* lse, const float* delta, void* dk,
                   void* dv, int B, int H, int S, int ls, const int64_t* st,
                   int64_t bias_sb, float scale, cudaStream_t stream) {
  constexpr size_t smem = dkdv_smem_floats<DH>() * sizeof(float);
  const cudaError_t attr = opt_in(flash_bwd_dkdv_kernel<DH>, smem);
  if (attr != cudaSuccess) return attr;
  flash_bwd_dkdv_kernel<DH><<<dim3((S + BK - 1) / BK, H, B), NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<const float*>(dout), lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), H, S, ls, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], bias_sb, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int kStatBytes = wg::kRows * sizeof(float);  // 64 lse or delta values
constexpr int kStages = 3;  // ring depth: two query tiles in flight ahead

template <int DH>
constexpr size_t dkdv_wgmma_smem() {
  // alignment slack; k, v; kStages x (qs, do); kStages x (lse, delta);
  // full[], empty[], resident
  return wg::kAlign + (2 + 2 * kStages) * (size_t)wg::Tile<DH>::kBytes +
         2 * kStages * kStatBytes + (2 * kStages + 1) * sizeof(uint64_t);
}

template <int DH>
__global__ void __launch_bounds__(wg::kThreads, 2) flash_bwd_dkdv_wgmma(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
    const float* __restrict__ bias, const float* __restrict__ lse,
    const float* __restrict__ delta, wg::bf16* __restrict__ dk, wg::bf16* __restrict__ dv,
    int H, int S, int ls, int64_t bias_sb) {
  using T = wg::Tile<DH>;
  constexpr int ST = kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + wg::kAlign - 1) & ~(uintptr_t)(wg::kAlign - 1));
  unsigned char* Ks = base;                   // [64][DH] k, swizzled
  unsigned char* Vs = Ks + T::kBytes;         // [64][DH] v
  unsigned char* ring = Vs + T::kBytes;       // stage i: qs at 2i, do at 2i + 1
  float* stats = reinterpret_cast<float*>(ring + 2 * ST * T::kBytes);  // stage i: lse, delta
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + 2 * ST * wg::kRows);
  uint64_t* empty = full + ST;
  uint64_t* resident = empty + ST;

  const int kb0 = blockIdx.x * wg::kRows, h = blockIdx.y, b = blockIdx.z;
  const int tiles = (S + wg::kRows - 1) / wg::kRows;
  const int64_t bh = (int64_t)b * H + h;
  // Thread 0 copies: query tile `it` of qs and do, with its lse and delta,
  // into stage it % ST, once the warpgroup has released the stage's
  // previous tile.
  auto fill = [&](int it) {
    const int st = it % ST;
    const int64_t at = bh * ls + it * wg::kRows;   // ls is a multiple of 64
    if (it >= ST) wg::bar_wait(&empty[st], (it / ST - 1) & 1);
    wg::bar_expect(&full[st], 2 * T::kBytes + 2 * kStatBytes);
    wg::tma_load(ring + 2 * st * T::kBytes, &tm_q, it * wg::kRows, h, b, &full[st]);
    wg::tma_load(ring + (2 * st + 1) * T::kBytes, &tm_o, it * wg::kRows, h, b, &full[st]);
    wg::bulk_load(stats + 2 * st * wg::kRows, lse + at, kStatBytes, &full[st]);
    wg::bulk_load(stats + (2 * st + 1) * wg::kRows, delta + at, kStatBytes, &full[st]);
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
    wg::tma_load(Ks, &tm_k, kb0, h, b, resident);
    wg::tma_load(Vs, &tm_v, kb0, h, b, resident);
    for (int it = 0; it < ST - 1 && it < tiles; ++it) fill(it);
  }

  // Thread 4 g + t of warp w owns keys 16 w + g and 16 w + g + 8 of the
  // block's 64; the columns of s^T are query rows.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int keys[2] = {kb0 + warp * 16 + g, kb0 + warp * 16 + g + 8};
  const float* biasb = bias ? bias + b * bias_sb : nullptr;
  float dkacc[DH / 2], dvacc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dkacc[i] = dvacc[i] = 0.f;

  wg::bar_wait(resident, 0);
  for (int it = 0; it < tiles; ++it) {
    const int st = it % ST;
    const unsigned char* Qt = ring + 2 * st * T::kBytes;
    const unsigned char* Ot = Qt + T::kBytes;
    const float* Lt = stats + 2 * st * wg::kRows;
    const float* Dt = Lt + wg::kRows;
    const int q0 = it * wg::kRows;
    if (threadIdx.x == 0 && it + ST - 1 < tiles) fill(it + ST - 1);
    wg::bar_wait(&full[st], (it / ST) & 1);

    float s[32], dp[32];
    wg::wgmma_fence();
    wg::mma_xyT<DH>(s, Ks, Qt);
    wg::wgmma_commit();
    wg::mma_xyT<DH>(dp, Vs, Ot);
    wg::wgmma_commit();
    wg::wgmma_wait<1>();
    wg::fence_regs(s);

    // p^T in place of s^T while dp^T = v do^T runs: n8 tile j, element e
    // is key keys[e >> 1], query row q0 + 8 j + 2 t + (e & 1).
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1), row = q0 + c, key = keys[e >> 1];
        float p = 0.f;
        if (row < S && key < S) {
          float x = s[4 * j + e];
          if (biasb) x += biasb[(int64_t)row * S + key];
          p = __expf(x - Lt[c]);
        }
        s[4 * j + e] = p;
      }
    // dv += p^T do goes out first; ds^T is formed and packed while it runs.
    uint32_t phi[4][4], plo[4][4], dhi[4][4], dlo[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wg::acc_to_a_split(phi[ks], plo[ks], s, ks);
    wg::wgmma_fence();
    wg::fence_regs(dvacc);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wg::mma_ay<DH>(dvacc, phi[ks], Ot, ks);
      wg::mma_ay<DH>(dvacc, plo[ks], Ot, ks);
    }
    wg::wgmma_commit();
    wg::wgmma_wait<1>();
    wg::fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - Dt[c]);
      }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wg::acc_to_a_split(dhi[ks], dlo[ks], dp, ks);
    wg::wgmma_fence();
    wg::fence_regs(dkacc);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wg::mma_ay<DH>(dkacc, dhi[ks], Qt, ks);
      wg::mma_ay<DH>(dkacc, dlo[ks], Qt, ks);
    }
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_regs(dvacc);
    wg::fence_regs(dkacc);
    wg::bar_arrive(&empty[st]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= S) continue;
    const int64_t at = (bh * S + keys[i]) * DH + 2 * t;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
          __floats2bfloat162_rn(dkacc[4 * j + 2 * i], dkacc[4 * j + 2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
          __floats2bfloat162_rn(dvacc[4 * j + 2 * i], dvacc[4 * j + 2 * i + 1]);
    }
  }
}

template <int DH>
cudaError_t launch_wgmma(const void* qs, const void* k, const void* v, const float* bias,
                         const void* dout, const float* lse, const float* delta, void* dk,
                         void* dv, int B, int H, int S, int ls, const int64_t* st,
                         int64_t bias_sb, float, cudaStream_t stream) {
  if (ls % wg::kRows != 0) return cudaErrorInvalidValue;  // the 256-byte stat copies
  CUtensorMap maps[4];
  const void* ptrs[4] = {qs, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = wg::make_map<DH>(&maps[i], ptrs[i], B, H, S, st[3 * i],
                                             st[3 * i + 1], st[3 * i + 2], wg::kRows);
    if (err != cudaSuccess) return err;
  }
  constexpr size_t smem = dkdv_wgmma_smem<DH>();
  const cudaError_t attr = opt_in(flash_bwd_dkdv_wgmma<DH>, smem);
  if (attr != cudaSuccess) return attr;
  flash_bwd_dkdv_wgmma<DH><<<dim3((S + wg::kRows - 1) / wg::kRows, H, B), wg::kThreads, smem,
                             stream>>>(maps[0], maps[1], maps[2], maps[3], bias, lse, delta,
                                       static_cast<wg::bf16*>(dk), static_cast<wg::bf16*>(dv),
                                       H, S, ls, bias_sb);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry, loaded with ctypes. q, k, v and do are [B, H, S, Dh]
// through their (batch, head, sequence) strides in elements, the last dim
// contiguous. float32 takes q and scales it; bf16 takes qs = (q * scale)
// rounded to bf16 in place of q, every pointer and stride a multiple of
// 16 bytes (the TMA copies; a dim of extent 1 may take any such stride).
// lse and delta are fp32 [B, H, ls] (row (b, h) at (b H + h) ls); float32
// reads the first S of each row, bf16 reads 64-value blocks up to
// round_up(S, 64) (ls a multiple of 64, the values past S zero). dk and dv
// are written [B, H, S, Dh] contiguous. bias is null or a contiguous fp32
// [B|1, S, S] with batch stride bias_sb (0 = shared). scale is already
// rounded to the input type. Returns the cudaError_t of the launch, or -1
// for an unsupported dtype / Dh.
extern "C" int cfa_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                  const void* bias, const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv, int B, int H,
                                  int S, int Dh, int dtype, int ls,
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
#define CFA_DKDV(D) (dtype == 0 ? launch<D> : launch_wgmma<D>)( \
    q, k, v, bp, dout, lp, dp, dk, dv, B, H, S, ls, st, bias_sb, scale, s)
  if (dtype != 0 && dtype != 1) return -1;
  if (Dh == 16) return (int)CFA_DKDV(16);
  if (Dh == 32) return (int)CFA_DKDV(32);
  if (Dh == 64) return (int)CFA_DKDV(64);
  return -1;
#undef CFA_DKDV
}
