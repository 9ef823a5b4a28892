// Fused SPARC language-grouped patch pooling, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel clip_finegrained_alignment_tpu/ops/
// sparc_kernel.py::_sparc_bwd_kernel (wrapper _fused_backward): from v
// [B, P, D], l [B, T, D], mask [B, T], the cotangent g [B, T, D] of the
// pooled output and the forward's sim [B, T, P], rl [B, T], rv [B, P]
// (sparc_fwd.cu) it applies the TPU kernel's hand-derived VJP, term for
// term, in fp32:
//
//   dw   = g v^T;   dv  = w^T g + (through v_norm, below)
//   dt   = dw / denom - [denom_raw > eps] * sum(dw * t) / denom^2
//   dz   = 0 where z < tau or not consider, else dt * mask
//   dsm  = dz / s + (ties of the min share sum(dz (z - 1)) / s evenly)
//                 + (ties of the max share sum(dz (-z)) / s evenly)
//   dsim = dsm * mask;  dl_norm = (dsim * rv) v;  dv_norm = (dsim * rl)^T l
//   dx   = dx_norm * r - x * sum(dx_norm * x) * r^3 * [sum x^2 > eps^2]
//          for (x, r) = (l, rl) and (v, rv), added onto dv for v.
//
// The norm terms' sums come from sim, which is l_norm v_norm^T:
// sum_d dl_norm l = sum_p dsim sim / rl and sum_d dv_norm v = sum_t dsim
// sim / rv (the same function, summed in another order), so each is known
// before the product it corrects and dl, dv are written once.
//
// The TPU kernel recomputes the forward chain; this one reads the forward's
// sim, so the min/max, ties and threshold decisions are the forward's own
// (sparc_common.cuh::row_stats, as the forward calls it), and w is the
// forward's to the bit. Four [T, P, D] products, not five.
//
// Same function, not the same blocking. dl needs sums over patches (one
// token row at a time), dv sums over tokens (one patch row at a time), and
// one batch element's v (403 KB at P=197, D=512) does not fit a block's
// 227 KB of shared memory. So the work is two kernels, launched by one
// call, with no atomics (the result is the same on every run):
//
//   rows: one block per (16 token rows, batch element): dw = g v^T over
//     K = D (product_nt), the row-wise VJP down to dsim (one warp per row),
//     dl_norm = (dsim * rv) v over K = P (product_nn, raw v), then dl. It
//     writes w, dsim * rl * rv and dsim * sim ([3, B, T, P] fp32 scratch)
//     for the second kernel.
//   columns: one block per (32 patch rows, batch element): dv_raw +
//     rv dv_norm = [w; dsim * rl * rv]^T [g; l], one product over
//     K = 2 round_up(T, 8), 512 columns of D at a time, g and l streamed in
//     8-token slabs, the A operands transposed reads of the scratch; then
//     dv.
//
// Every product is 3xTF32 on the tensor cores (sparc_common.cuh). Bound on
// the card (NVIDIA H100 80GB HBM3, 700 W): at B=32, T=77, P=197, D=512 it
// moves ~42.9 MB (v, l, mask, g, sim, rl, rv in; dv, dl out: 12.8 us at
// 3.35 TB/s) and does four [T, P, D] products, ~2.0 GFLOP, issued three
// times as TF32 (12.1 us at 495 TFLOP/s). Its first version recomputed the
// forward and ran five products on the CUDA cores with both operands of
// every fmaf read from shared memory (0.776 ms, ~21x the bound); this one
// takes ~0.144 ms (perf/sparc_study.py, graph ms): the rows kernel ~0.089,
// shaped as the forward and held back by the same (sparc_common.cuh), the
// columns kernel ~0.056 (224 blocks of 32 patch rows, one wave at two a
// multiprocessor; each B fragment serves both m16 tiles).

#include "sparc_common.cuh"

namespace {

using namespace sparc;

// The columns kernel: MTC m16 tiles of patch rows a block, K = 2 x tokens in
// slabs of KT, at most PCC columns of D at a time (JC n8 tiles a warp for
// each m16 tile), a ring of NSTC stages, registers for KMINC blocks a
// multiprocessor.
constexpr int MTC = 2;
constexpr int PT = 16 * MTC;  // patch rows a block
constexpr int KT = 8;
constexpr int PCC = 512;
constexpr int PSC = PCC + 8;
constexpr int JC = PCC / (8 * NWARP);
constexpr int NSTC = 2;
constexpr int KMINC = 2;
constexpr int ATS = PT + 8;   // row stride of its transposed A tiles [K][PT]

__host__ __device__ constexpr size_t rows_smem_floats(int P) {
  // ring; dw, then dsim * rv [TR][lw]; rv [Pk]; rl, sum l^2, the norm
  // factor [TR]
  const int Pk = round_up(P, KP);
  return (size_t)NST * ring_stage_floats(P) + (size_t)TR * a_stride(Pk) + Pk + 3 * TR;
}

__host__ __device__ constexpr size_t cols_smem_floats(int T) {
  // ring of g or l slabs [KT][PSC]; w^T, (dsim * rl * rv)^T [Tk][ATS]; rv,
  // sum v^2, the norm factor [PT]
  return (size_t)NSTC * KT * PSC + 2 * (size_t)round_up(T, KT) * ATS + 3 * PT;
}

// The rows kernel's block: the TR (or, in the last block, fewer) token rows
// from t0 of batch element b, as MT m16 tiles.
template <int MT>
__device__ __forceinline__ void bwd_rows(
    const float* __restrict__ v, const float* __restrict__ l, const float* __restrict__ mask,
    const float* __restrict__ g, const float* __restrict__ sim, const float* __restrict__ rl,
    const float* __restrict__ rv, float* __restrict__ dl, float* __restrict__ scratch,
    int B, int T, int P, int D, float tau, bool vec4, float* smem) {
  constexpr int R = TT * MT;
  const int Pp = round_up(P, 8), Pk = round_up(P, KP), lw = a_stride(Pk);
  float* ring = smem;
  float* dwb = ring + NST * ring_stage_floats(P);  // [TR][lw]: dw, then dsim * rv
  float* rvs = dwb + TR * lw;                      // [Pk]
  float* rls = rvs + Pk;                           // [TR]
  float* lsq = rls + TR;                           // [TR] sum l^2
  float* cs = lsq + TR;                            // [TR] the norm factor

  const int t0 = blockIdx.x * TR, b = blockIdx.y;
  const int nt = min(R, T - t0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const float* vb = v + (int64_t)b * P * D;
  const float* lt = l + ((int64_t)b * T + t0) * D;
  const float* gt = g + ((int64_t)b * T + t0) * D;
  float* dlt = dl + ((int64_t)b * T + t0) * D;
  const int64_t plane = (int64_t)B * T * P, rowp = ((int64_t)b * T + t0) * P;

  for (int p = threadIdx.x; p < Pk; p += NT) rvs[p] = p < P ? rv[(int64_t)b * P + p] : 0.f;
  for (int r = threadIdx.x; r < R; r += NT) rls[r] = r < nt ? rl[(int64_t)b * T + t0 + r] : 0.f;
  row_norms(lt, nt, R, D, lsq, nullptr);

  // ---- dw = g v^T (raw v), at most NCMAX patches at a time ----
  for (int c0 = 0; c0 < Pp; c0 += NCMAX) {
    const int nc = min(NCMAX, Pp - c0);
    float acc[MT][JS][4];
    product_nt<false, MT>(gt, nt, vb + (int64_t)c0 * D, P - c0, nc, D, vec4, ring, acc,
                          nullptr);
#pragma unroll
    for (int j = 0; j < JS; ++j) {
      const int n0 = 8 * (warp + NWARP * j);
      if (n0 >= nc) break;
#pragma unroll
      for (int i = 0; i < 4 * MT; ++i) {
        const int m = i / 4, e = i % 4;
        dwb[(16 * m + gq + 8 * (e / 2)) * lw + c0 + n0 + 2 * tq + e % 2] = acc[m][j][e];
      }
    }
  }
  __syncthreads();  // dw, rv, rl, sum l^2 are complete

  // ---- the row-wise VJP down to dsim, one warp per token row ----
  for (int r = warp; r < R; r += NWARP) {
    float* dw = dwb + r * lw;
    const float* sr = sim + rowp + (int64_t)r * P;  // the forward's, read p < P only
    if (r >= nt) {
      for (int p = lane; p < Pk; p += 32) dw[p] = 0.f;
      if (lane == 0) cs[r] = 0.f;
      continue;
    }
    const RowStats st = row_stats(sr, P, mask[(int64_t)b * T + t0 + r], tau);
    const bool cons = st.mk > 0.f;
    float sdwt = 0.f;
    for (int p = lane; p < P; p += 32) {
      float z, tv;
      threshold_one(sr[p], st, cons, tau, z, tv);
      sdwt += dw[p] * tv;
    }
    sdwt = warp_sum(sdwt);
    const float corr = st.denom_raw > EPS ? sdwt / (st.denom * st.denom) : 0.f;
    float asum = 0.f, bsum = 0.f, nmn = 0.f, nmx = 0.f;
    for (int p = lane; p < P; p += 32) {
      float z, tv;
      const float x = sr[p];
      threshold_one(x, st, cons, tau, z, tv);
      const float dz = (z < tau || !cons) ? 0.f : (dw[p] / st.denom - corr) * st.mk;
      asum += dz * (z - 1.f);
      bsum += dz * (-z);
      const float sm = x * st.mk;
      nmn += (cons && sm == st.mn) ? 1.f : 0.f;
      nmx += (cons && sm == st.mx) ? 1.f : 0.f;
    }
    const float a = warp_sum(asum) / st.s;
    const float bb = warp_sum(bsum) / st.s;
    nmn = fmaxf(warp_sum(nmn), 1.f);
    nmx = fmaxf(warp_sum(nmx), 1.f);
    const float rlr = rls[r];
    float es = 0.f;  // sum_p dsim sim = rl sum_d dl_norm l
    for (int p = lane; p < Pk; p += 32) {
      if (p >= P) {
        dw[p] = 0.f;
        continue;
      }
      float z, tv;
      const float x = sr[p];
      threshold_one(x, st, cons, tau, z, tv);
      const float dz = (z < tau || !cons) ? 0.f : (dw[p] / st.denom - corr) * st.mk;
      const float sm = x * st.mk;
      float dsm = dz / st.s;
      dsm = dsm + ((cons && sm == st.mn) ? a / nmn : 0.f) +
            ((cons && sm == st.mx) ? bb / nmx : 0.f);
      const float ds = dsm * st.mk;
      const int64_t at = rowp + (int64_t)r * P + p;
      scratch[at] = tv / st.denom;
      scratch[plane + at] = ds * rlr * rvs[p];
      scratch[2 * plane + at] = ds * x;
      es = fmaf(ds, x, es);
      dw[p] = ds * rvs[p];
    }
    es = warp_sum(es);
    // l sum_d(dl_norm l) rl^3 = l (sum_p dsim sim) rl^2
    if (lane == 0) cs[r] = lsq[r] > NEPS ? es * (rlr * rlr) : 0.f;
  }

  // ---- dl = dl_norm rl - l c, dl_norm = (dsim * rv) v (raw v), at most
  //      PCH columns at a time ----
  for (int dc = 0; dc < D; dc += PCH) {
    const int ncv = min(PCH, D - dc);
    float acc[MT][JP][4];
    product_nn<MT>(dwb, lw, Pk, vb + dc, D, P, ncv, vec4, ring, acc);
#pragma unroll
    for (int j = 0; j < JP; ++j) {
      const int n0 = 8 * (warp + NWARP * j);
      if (n0 >= ncv) break;
#pragma unroll
      for (int i = 0; i < 4 * MT; ++i) {
        const int m = i / 4, e = i % 4;
        const int r = 16 * m + gq + 8 * (e / 2), d = dc + n0 + 2 * tq + e % 2;
        if (r < nt && d < D) {
          const int64_t at = (int64_t)r * D + d;
          dlt[at] = acc[m][j][e] * rls[r] - lt[at] * cs[r];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(NT, KMINR) sparc_bwd_rows_kernel(
    const float* __restrict__ v, const float* __restrict__ l, const float* __restrict__ mask,
    const float* __restrict__ g, const float* __restrict__ sim, const float* __restrict__ rl,
    const float* __restrict__ rv, float* __restrict__ dl, float* __restrict__ scratch,
    int B, int T, int P, int D, float tau, int vec4) {
  extern __shared__ __align__(16) float smem[];
  if (MTR > 1 && T - (int)blockIdx.x * TR > TT)
    bwd_rows<MTR>(v, l, mask, g, sim, rl, rv, dl, scratch, B, T, P, D, tau, vec4, smem);
  else
    bwd_rows<1>(v, l, mask, g, sim, rl, rv, dl, scratch, B, T, P, D, tau, vec4, smem);
}

// The columns kernel's product for one PCC-wide chunk of D: acc[m][j] =
// [w; dsim * rl * rv]^T [g; l] for the m16 tile m (m < MTC) of the block's
// patch rows and the n8 tiles w + 8 j (j < J) of the chunk, over K =
// 2 round_up(T, KT): A from the transposed tiles aw, ad [Tk][ATS] in shared
// memory, g then l (gc, lc: the chunk's first column, row stride D)
// streamed in KT-token slabs through the ring. Each B fragment serves the
// MTC m16 tiles.
template <int J>
__device__ __forceinline__ void cols_product(const float* aw, const float* ad,
                                             const float* __restrict__ gc,
                                             const float* __restrict__ lc, int T, int D,
                                             int ncv, bool vec4, float* ring,
                                             float (*acc)[JC][4]) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int ntile = (ncv + 7) / 8, half = round_up(T, KT) / KT;
  constexpr int stage = KT * PSC;
  int col[J];
#pragma unroll
  for (int j = 0; j < J; ++j) col[j] = t * PSC + tile_of(j, ntile) * 8 + g;
#pragma unroll
  for (int m = 0; m < MTC; ++m)
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
  pipeline<NSTC>(
      2 * half,
      [&](int s) {
        const int k = s % half;
        load_tile<PCC>(ring + (s % NSTC) * stage, PSC,
                       (s < half ? gc : lc) + (int64_t)k * KT * D, D, KT, T - k * KT, ncv,
                       vec4);
      },
      [&](int s) {
        const float* bs = ring + (s % NSTC) * stage;
        const float* at = s < half ? aw : ad;
        const int k = (s % half) * KT;
        uint32_t ahi[MTC][4], alo[MTC][4], bhi[J][2], blo[J][2];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          split(bs[col[j]], bhi[j][0], blo[j][0]);
          split(bs[col[j] + 4 * PSC], bhi[j][1], blo[j][1]);
        }
#pragma unroll
        for (int m = 0; m < MTC; ++m) {
          // A [patch][token] of m16 tile m: (p, k) is at[k][p].
          const int p = 16 * m + g;
          split(at[(k + t) * ATS + p], ahi[m][0], alo[m][0]);
          split(at[(k + t) * ATS + p + 8], ahi[m][1], alo[m][1]);
          split(at[(k + t + 4) * ATS + p], ahi[m][2], alo[m][2]);
          split(at[(k + t + 4) * ATS + p + 8], ahi[m][3], alo[m][3]);
        }
        mma3_tiles<J, MTC, JC>(acc, ahi, alo, bhi, blo);
      });
}

__global__ void __launch_bounds__(NT, KMINC) sparc_bwd_cols_kernel(
    const float* __restrict__ v, const float* __restrict__ l, const float* __restrict__ g,
    const float* __restrict__ rv, const float* __restrict__ scratch, float* __restrict__ dv,
    int B, int T, int P, int D, int vec4) {
  extern __shared__ __align__(16) float smem[];
  const int Tk = round_up(T, KT);
  float* ring = smem;                        // NSTC stages of a g or l slab [KT][PSC]
  float* aw = ring + NSTC * KT * PSC;        // w^T [Tk][ATS]
  float* ad = aw + Tk * ATS;                 // (dsim * rl * rv)^T [Tk][ATS]
  float* rvs = ad + Tk * ATS;                // [PT]
  float* vsq = rvs + PT;                     // [PT] sum v^2
  float* cs = vsq + PT;                      // [PT] the norm factor

  const int p0 = blockIdx.x * PT, b = blockIdx.y;
  const int np = min(PT, P - p0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const float* lb = l + (int64_t)b * T * D;
  const float* gb = g + (int64_t)b * T * D;
  const float* vt = v + ((int64_t)b * P + p0) * D;
  float* dvt = dv + ((int64_t)b * P + p0) * D;
  const int64_t plane = (int64_t)B * T * P;

  for (int i = threadIdx.x; i < Tk * PT; i += NT) {
    const int t = i / PT, pp = i % PT;
    const bool in = t < T && pp < np;
    const int64_t at = ((int64_t)b * T + t) * P + p0 + pp;
    aw[t * ATS + pp] = in ? scratch[at] : 0.f;
    ad[t * ATS + pp] = in ? scratch[plane + at] : 0.f;
  }
  row_norms(vt, np, PT, D, vsq, nullptr);
  __syncthreads();  // sum v^2
  for (int pp = warp; pp < PT; pp += NWARP) {
    // sum_t dsim sim = rv sum_d dv_norm v: lanes over t, a fixed xor tree
    float es = 0.f;
    if (pp < np)
      for (int t = lane; t < T; t += 32) es += scratch[2 * plane + ((int64_t)b * T + t) * P + p0 + pp];
    es = warp_sum(es);
    if (lane == 0) {
      const float r = pp < np ? rv[(int64_t)b * P + p0 + pp] : 0.f;
      rvs[pp] = r;
      // v sum_d(dv_norm v) rv^3 = v (sum_t dsim sim) rv^2
      cs[pp] = vsq[pp] > NEPS ? es * (r * r) : 0.f;
    }
  }

  float acc[MTC][JC][4];
  for (int dc = 0; dc < D; dc += PCC) {
    const int ncv = min(PCC, D - dc);
    switch (tiles_a_warp((ncv + 7) / 8, JC)) {
      case 1: cols_product<1>(aw, ad, gb + dc, lb + dc, T, D, ncv, vec4, ring, acc); break;
      case 2: cols_product<2>(aw, ad, gb + dc, lb + dc, T, D, ncv, vec4, ring, acc); break;
      default: cols_product<JC>(aw, ad, gb + dc, lb + dc, T, D, ncv, vec4, ring, acc); break;
    }
#pragma unroll
    for (int j = 0; j < JC; ++j) {
      const int n0 = 8 * (warp + NWARP * j);
      if (n0 >= ncv) break;
#pragma unroll
      for (int i = 0; i < 4 * MTC; ++i) {
        const int m = i / 4, e = i % 4;
        const int pp = 16 * m + gq + 8 * (e / 2), d = dc + n0 + 2 * tq + e % 2;
        if (pp < np && d < D) {
          const int64_t at = (int64_t)pp * D + d;
          dvt[at] = acc[m][j][e] - vt[at] * cs[pp];
        }
      }
    }
  }
}

}  // namespace

// Plain C entry, loaded with ctypes. v, dv [B, P, D], l, g, dl [B, T, D],
// mask [B, T] and the forward's sim [B, T, P], rl [B, T], rv [B, P] are
// contiguous fp32; scratch is fp32 [3, B, T, P], written by the first
// kernel (w, dsim * rl * rv, dsim * sim) and read by the second. Returns
// the cudaError_t of the launches, or -1 when the shared memory a kernel
// needs exceeds what a block has.
extern "C" int cfa_sparc_bwd(const void* v, const void* l, const void* mask, const void* g,
                             const void* sim, const void* rl, const void* rv, void* dv,
                             void* dl, void* scratch, int B, int T, int P, int D, float tau,
                             void* stream) {
  const size_t smem1 = rows_smem_floats(P) * sizeof(float);
  const size_t smem2 = cols_smem_floats(T) * sizeof(float);
  if (smem1 > SMEM_MAX || smem2 > SMEM_MAX) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      sparc_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(sparc_bwd_cols_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return (int)err;
  const float* vp = static_cast<const float*>(v);
  const float* lp = static_cast<const float*>(l);
  const float* gp = static_cast<const float*>(g);
  const float* rvp = static_cast<const float*>(rv);
  float* sp = static_cast<float*>(scratch);
  const int vec4 = D % 4 == 0;
  sparc_bwd_rows_kernel<<<dim3((T + TR - 1) / TR, B), NT, smem1, s>>>(
      vp, lp, static_cast<const float*>(mask), gp, static_cast<const float*>(sim),
      static_cast<const float*>(rl), rvp, static_cast<float*>(dl), sp, B, T, P, D, tau, vec4);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sparc_bwd_cols_kernel<<<dim3((P + PT - 1) / PT, B), NT, smem2, s>>>(
      vp, lp, gp, rvp, sp, static_cast<float*>(dv), B, T, P, D, vec4);
  return (int)cudaGetLastError();
}
