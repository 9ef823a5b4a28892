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
// S=4096 in bf16), beyond the 227 KB a block has here. So a block takes
// query rows of one (batch, head) and streams 64-key tiles of k and v
// through shared memory; m, l and the rows x Dh accumulator stay in
// registers.
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
//
// bf16 (flash_fwd_wgmma, building blocks in attention_wgmma.cuh): both
// products run on the tensor cores through wgmma, fed by TMA. One block per
// (kConsumers x 64 query rows, head, batch), one warpgroup per 64 rows: its
// qs tile is copied once (the `resident` barrier) and stays in shared
// memory; thread 0 keeps 64-key tiles of k and v streaming through a
// kStages ring that the warpgroups share (mbarriers: full when a copy lands,
// empty when every warpgroup is done with a stage). Per key tile a
// warpgroup does
//   s = qs k^T                  (wgmma, both operands in shared memory),
//   s += bias; keys >= S at -inf (fp32, in registers: s - 1e9 rounds to
//                                 -1e9 exactly, as in the TPU kernel),
//   m, l, p = exp(s - m)         (the online softmax in registers: a row
//                                 lies in the 4 threads of a quad; p as
//                                 2^(s log2e - mb), see online_softmax),
//   o = o alpha + p v            (wgmma, p rounded to bf16 once, as the TPU
//                                 kernel rounds it, as the register A
//                                 operand; the v tile as the MN-major B),
// so no score or weight reaches shared or device memory, and the tiles are
// pipelined: tile it + 1's s product is issued before tile it's p v, and
// its softmax (exponentials on the special-function units) runs while p v
// does on the tensor cores; o is scaled by alpha once p v is done. So two tiles are in
// use at once and the ring holds a third in flight. Two warpgroups share
// the ring (128 query rows a block), which halves the k and v a block reads
// from L2 per query row. The copies zero-fill rows past S. m starts at
// -1e9 as the TPU kernel's does.
//
// float32 (flash_fwd_kernel, the first version, kept: TF32 would not hold
// the fp32 tolerance): one block of 256 threads (16 x 16) per 64 query
// rows, 64-key tiles of k (transposed) and v staged in shared memory as
// fp32, fp32 CUDA-core products.

#include "attention_wgmma.cuh"
#include "flash_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

template <int DH>
constexpr size_t fwd_smem_floats() {
  // Qt [DH][QSTR] + Kt [DH][KSTR] + Vs [BK][DH] + Pt [BK][QSTR]
  return (size_t)DH * QSTR + (size_t)DH * KSTR + (size_t)BK * DH + (size_t)BK * QSTR;
}

template <int DH>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, float* __restrict__ o, float* __restrict__ lse,
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
  float* Pt = Vs + BK * DH;               // [BK][QSTR], p transposed

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const float* biasb = bias ? bias + b * bias_sb : nullptr;

  load_tile<float, DH, QSTR, true>(q + b * q_sb + h * q_sh, q_ss, q0, S, scale, Qt, nullptr);

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
    load_tile<float, DH, KSTR>(kb, k_ss, k0, S, 0.f, Kt, nullptr);
    load_tile<float, DH, KSTR>(vb, v_ss, k0, S, 0.f, nullptr, Vs);
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
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
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
    float* orow = o + at * DH + tx * RD;
#pragma unroll
    for (int j = 0; j < RD; ++j) orow[j] = acc[i][j] / lf;
    if (tx == 0) lse[at] = m[i] + logf(lf);
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   void* o, float* lse, int B, int H, int S, int npad,
                   const int64_t* st, int64_t bias_sb, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_floats<DH>() * sizeof(float);
  const cudaError_t attr = opt_in(flash_fwd_kernel<DH>, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<DH><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), bias, static_cast<float*>(o), lse, H, S, npad, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], bias_sb, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

// The design's constants (perf/flash_fwd_study.py rebuilds the kernel with
// others and times them against it).
constexpr int kConsumers = 2;   // warpgroups a block, 64 query rows each
constexpr int kStages = 3;      // ring depth: tile it + 1 ready while it + 2 loads
constexpr int kMinBlocks = 2;   // blocks an SM __launch_bounds__ leaves registers for
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {   // 2^x, the special-function unit's
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int DH>
constexpr size_t fwd_wgmma_smem() {
  // alignment slack; kConsumers x qs; kStages x (k, v); full[], empty[], resident
  return wg::kAlign + (kConsumers + 2 * kStages) * (size_t)wg::Tile<DH>::kBytes +
         (2 * kStages + 1) * sizeof(uint64_t);
}

// One 64-key tile of the online softmax, in place, for this thread's rows
// (n8 tile j, element e of s: row rows[e >> 1], key k0 + 8 j + 2 t + (e & 1)):
// the bias added to the fp32 scores, keys >= S at -inf, the running max m
// and this thread's share of the sum l moved on; s becomes
// p = exp(s - m) and alpha = exp(m_old - m), the accumulator's factor.
// p is taken as 2^(s log2e - mb), mb = m log2e rounded to fp32: one FFMA
// where exp(s - m) takes a subtraction and a product (10 % of the kernel's
// time at S=2048 B=4). That is exp(s - m) times 2^r, r = m log2e - mb, the
// same r for every weight of the row (alpha moves the earlier ones from
// mb_old to mb), so o = acc / l cancels it and the log-sum-exp takes it
// out; it is ~1e-7 unless m is huge, as in a fully masked row (r ~ 18 at
// m = -1e9, where p = 2^r rounds to bf16 with the rest of the weights).
__device__ __forceinline__ void online_softmax(float (&s)[32], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], const int (&rows)[2], int k0,
                                               int S, int t, const float* __restrict__ biasb) {
  if (biasb || k0 + wg::kRows > S) {   // uniform: most tiles skip this
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1), row = rows[e >> 1];
        float& x = s[4 * j + e];
        if (col >= S)
          x = -INFINITY;
        else if (biasb && row < S)
          x += biasb[(int64_t)row * S + col];
      }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float mb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = wg::quad_max(mx[r]);   // at least -1e9: finite
    mb[r] = __fmul_rn(m_new, kLog2e);
    alpha[r] = ex2(__fmul_rn(m[r], kLog2e) - mb[r]);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    const float p = ex2(fmaf(s[i], kLog2e, -mb[r]));
    l[r] += p;
    s[i] = p;
  }
}

template <int DH>
__global__ void __launch_bounds__(kConsumers * wg::kThreads, kMinBlocks) flash_fwd_wgmma(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ bias,
    wg::bf16* __restrict__ o, float* __restrict__ lse, int H, int S, int npad,
    int64_t bias_sb) {
  using T = wg::Tile<DH>;
  constexpr int ST = kStages;
  constexpr int kRowsBlock = kConsumers * wg::kRows;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + wg::kAlign - 1) & ~(uintptr_t)(wg::kAlign - 1));
  unsigned char* Qs = base;                           // warpgroup c: [64][DH] qs at c
  unsigned char* ring = Qs + kConsumers * T::kBytes;  // stage i: k at 2i, v at 2i + 1
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + 2 * ST * T::kBytes);
  uint64_t* empty = full + ST;
  uint64_t* resident = empty + ST;

  const int q0 = blockIdx.x * kRowsBlock, h = blockIdx.y, b = blockIdx.z;
  const int tiles = (S + wg::kRows - 1) / wg::kRows;
  // Thread 0 copies: key tile `it` of k and v into stage it % ST, once every
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
      wg::bar_init(&empty[i], kConsumers * wg::kThreads);
    }
    wg::bar_init(resident, 1);
    wg::bar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    wg::bar_expect(resident, kConsumers * T::kBytes);
    for (int c = 0; c < kConsumers; ++c)
      wg::tma_load(Qs + c * T::kBytes, &tm_q, q0 + c * wg::kRows, h, b, resident);
    for (int it = 0; it < ST - 1 && it < tiles; ++it) fill(it);
  }

  // Thread 4 g + t of warp w of warpgroup c owns rows 16 w + g and
  // 16 w + g + 8 of the warpgroup's 64.
  const int c = threadIdx.x / wg::kThreads;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + c * wg::kRows + warp * 16 + g;
  const int rows[2] = {r0, r0 + 8};
  const unsigned char* Qc = Qs + c * T::kBytes;
  const int64_t bh = (int64_t)b * H + h;
  const float* biasb = bias ? bias + b * bias_sb : nullptr;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};   // l: this thread's share
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;

  // Tile 0's weights; then per tile it, tile it + 1's scores go out on
  // the tensor cores, o += p v for tile it after them, and tile it + 1's
  // softmax runs while that product does. The last tile's p v is peeled
  // off, so no product is issued under a branch (ptxas serializes the
  // chain of one that is).
  float s[32], alpha[2];
  uint32_t pa[4][4];
  wg::bar_wait(resident, 0);
  wg::bar_wait(&full[0], 0);
  wg::wgmma_fence();
  wg::mma_xyT<DH>(s, Qc, ring);
  wg::wgmma_commit();
  wg::wgmma_wait<0>();
  wg::fence_regs(s);
  online_softmax(s, m, l, alpha, rows, 0, S, t, biasb);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) wg::acc_to_a(pa[ks], s, ks);
  for (int it = 0; it + 1 < tiles; ++it) {
    const int st = it % ST, nst = (it + 1) % ST;
    if (threadIdx.x == 0 && it + ST - 1 < tiles) fill(it + ST - 1);
    wg::bar_wait(&full[nst], ((it + 1) / ST) & 1);
    wg::wgmma_fence();
    wg::fence_regs(acc);
    wg::mma_xyT<DH>(s, Qc, ring + 2 * nst * T::kBytes);
    wg::wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wg::mma_ay<DH>(acc, pa[ks], ring + (2 * st + 1) * T::kBytes, ks);
    wg::wgmma_commit();
    wg::wgmma_wait<1>();
    wg::fence_regs(s);
    online_softmax(s, m, l, alpha, rows, (it + 1) * wg::kRows, S, t, biasb);
    wg::wgmma_wait<0>();
    wg::fence_regs(acc);
    wg::bar_arrive(&empty[st]);
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wg::acc_to_a(pa[ks], s, ks);
  }
  wg::wgmma_fence();
  wg::fence_regs(acc);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wg::mma_ay<DH>(acc, pa[ks], ring + (2 * ((tiles - 1) % ST) + 1) * T::kBytes, ks);
  wg::wgmma_commit();
  wg::wgmma_wait<0>();
  wg::fence_regs(acc);

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // The padded keys' share of the sum (zero v, so none of the output's),
    // in the weights' own form; their 2^r taken out of the lse.
    const float mb = __fmul_rn(m[i], kLog2e);
    const float lf = wg::quad_sum(l[i]) + (float)npad * ex2(fmaf(NEG, kLog2e, -mb));
    const float r = fmaf(m[i], kLog2e, -mb);
    if (rows[i] >= S) continue;
    const float inv = 1.f / lf;
    wg::bf16* out = o + (bh * S + rows[i]) * DH + 2 * t;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
    if (t == 0) lse[bh * S + rows[i]] = m[i] + (logf(lf) - r * kLn2);
  }
}

template <int DH>
cudaError_t launch_wgmma(const void* qs, const void* k, const void* v, const float* bias,
                         void* o, float* lse, int B, int H, int S, int npad,
                         const int64_t* st, int64_t bias_sb, float, cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* ptrs[3] = {qs, k, v};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = wg::make_map<DH>(&maps[i], ptrs[i], B, H, S, st[3 * i],
                                             st[3 * i + 1], st[3 * i + 2], wg::kRows);
    if (err != cudaSuccess) return err;
  }
  constexpr size_t smem = fwd_wgmma_smem<DH>();
  const cudaError_t attr = opt_in(flash_fwd_wgmma<DH>, smem);
  if (attr != cudaSuccess) return attr;
  constexpr int kRowsBlock = kConsumers * wg::kRows;
  flash_fwd_wgmma<DH><<<dim3((S + kRowsBlock - 1) / kRowsBlock, H, B),
                        kConsumers * wg::kThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], bias, static_cast<wg::bf16*>(o), lse, H, S, npad, bias_sb);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry, loaded with ctypes. q, k, v are [B, H, S, Dh] through
// their (batch, head, sequence) strides in elements, the last dim
// contiguous. float32 takes q and scales it; bf16 takes qs = (q * scale)
// rounded to bf16 in place of q, every pointer and stride a multiple of
// 16 bytes (the TMA copies; a dim of extent 1 may take any such stride).
// o is written [B, H, S, Dh] and lse [B, H, S] (fp32) contiguous.
// npad = Sk - S padded keys of the TPU wrapper. bias is null or a
// contiguous fp32 [B|1, S, S] with batch stride bias_sb (0 = shared).
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
#define CFA_FWD(D) (dtype == 0 ? launch<D> : launch_wgmma<D>)( \
    q, k, v, bp, o, lp, B, H, S, npad, st, bias_sb, scale, s)
  if (dtype != 0 && dtype != 1) return -1;
  if (Dh == 16) return (int)CFA_FWD(16);
  if (Dh == 32) return (int)CFA_FWD(32);
  if (Dh == 64) return (int)CFA_FWD(64);
  return -1;
#undef CFA_FWD
}
