// Device code shared by the fused SPARC pooling forward (sparc_fwd.cu) and
// backward (sparc_bwd.cu), for Hopper (sm_90a). They replace the Pallas TPU
// kernels clip_finegrained_alignment_tpu/ops/sparc_kernel.py::_sparc_kernel
// and ::_sparc_bwd_kernel.
//
// Products: fp32-accurate on the tensor cores. Every matrix product is
// mma.sync.m16n8k8 TF32 with fp32 sums, three of them per step: each fp32
// operand x is split into hi = tf32(x) and lo = tf32(x - hi) (rounded to
// nearest, ties away, as cvt.rna; tf32_mma.cuh), and the step adds lo·hi,
// hi·lo, then hi·hi onto the same accumulator. The lo·lo term it leaves out
// is below 2^-22 of each product, so a sum over D = 512 lands within ~1e-7
// of the fp32 one; plain TF32 (hi·hi alone) misses the 1e-4 tolerance.
// Every output tile of a product runs the same K loop in the same order (no
// split-K, the same hi/lo order in every warp), so two equal columns give
// bit-equal sums: the ties of the min and max stay ties. (Not wgmma: its
// TF32 form takes K-major operands only, and w·v and the backward's
// products over tokens have an MN-major one; a batch element's 77 token
// rows fill m16 tiles to 96 %, wgmma's m64 to 60 %.)
//
// Layout: a block of NT threads owns MT m16 tiles of rows of one output
// (the M side), each B fragment serving all of them; its 8 warps split the
// N side into n8 tiles, round robin,
// each warp a fixed count of them (a template parameter), so the K loop has
// no branch and the J products of a pass issue back to back. Operands that
// stream pass through a ring of NST stages in shared memory filled by
// cp.async (16-byte copies when D is a multiple of 4, else 4-byte ones),
// the next slabs' copies in flight while one is multiplied. Row strides are
// padded for conflict-free fragment loads: a K-major tile ([n][k]) has a
// stride of 4 x odd floats, a [k][n] tile 8 (mod 32).
//
// What bounds them (perf/sparc_study.py and chip_smoke.py on an NVIDIA H100
// 80GB HBM3 at 700 W, B=32 T=77 P=197 D=512): not device memory (7.5 us of
// the forward's 75 us). Issuing hi·hi alone cuts 27 % of the forward's time,
// so the tensor cores' TF32 rate under mma.sync is a share; the rest is
// issue: each B element feeds one m16 tile, so every three products need
// one split (four instructions) and two shared loads. A block's own
// instruction stream is the critical path: one alone takes 0.048 ms at B=4,
// the 28 multiprocessors that hold two of the 160 set the time at B=32, and
// a block of two m16 tiles alone takes 0.071 ms.
//
// The decisions of the chain (the masked min and max, ties sm == mn and
// sm == mx, z < tau) are taken from sim by row_stats below, one warp per
// token row, lanes over p, in the same order in both kernels; the backward
// reads the forward's sim, so it takes the forward's decisions, and its w
// is the forward's to the bit. Every division and square root is the IEEE
// one (nvcc's default -prec-div and -prec-sqrt; no --use_fast_math).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace sparc {

constexpr int NT = 256;                  // threads per block
constexpr int NWARP = NT / 32;
constexpr int TT = 16;                   // rows of an m16 tile
// m16 tiles of token rows a block of the forward and the backward's rows
// kernel; a block with TT or fewer rows left runs one. Two (96 blocks at
// B=32, one a multiprocessor) measured no faster forward and a slower
// backward than one: a block's own instruction stream sets its time
// (perf/sparc_study.py).
constexpr int MTR = 1;
// Blocks a multiprocessor that the forward's and the rows kernel's
// registers leave room for (two: 128 registers a thread).
constexpr int KMINR = 2;
constexpr int TR = TT * MTR;             // token rows a block
constexpr int NST = 2;                   // stages of the ring
// K-major products (sim = l v^T, dw = g v^T): D streamed in slabs of KS,
// at most NCMAX columns (patches) at a time.
constexpr int KS = 32;
constexpr int SS = KS + 4;               // row stride of a K-major slab (4 x odd)
constexpr int NCMAX = 256;
constexpr int JS = NCMAX / (8 * NWARP);  // n8 tiles a warp, K-major products
// [k][n] products (out = w v, dl_norm, dv): K streamed in slabs of KP rows,
// at most PCH output columns (of D) at a time.
constexpr int KP = 16;
constexpr int PCH = 512;
constexpr int PS = PCH + 8;              // row stride of a [k][n] slab
constexpr int JP = PCH / (8 * NWARP);    // n8 tiles a warp, [k][n] products
constexpr float EPS = 1e-8f;             // objectives/losses.py _EPS
constexpr float NEPS = 1e-12f * 1e-12f;  // l2_normalize's eps squared
constexpr int SMEM_MAX = 232448;         // dynamic shared memory a block may have
// TF32 products a step: 3 (lo·hi, hi·lo, hi·hi); 1 (hi·hi, plain TF32,
// which misses the tolerance) only in perf/sparc_study.py, to weigh the
// tensor cores' share of the time.
constexpr int NPROD = 3;

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Row stride of a [rows][K] A operand in shared memory: >= n, 4 (mod 32).
__host__ __device__ constexpr int a_stride(int n) { return round_up(n + 28, 32) - 28; }

// Floats of one ring stage: a K-major stage holds A [TR][SS] and B [nc][SS]
// (nc <= NCMAX); a [k][n] stage holds B [KP][PS].
__host__ __device__ constexpr int ring_stage_floats(int P) {
  const int nc = round_up(P, 8) < NCMAX ? round_up(P, 8) : NCMAX;
  const int nt = (TR + nc) * SS, nn = KP * PS;
  return nt > nn ? nt : nn;
}

// ---- warp reductions (fixed xor trees) ----

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fminf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Sum over the 4 lanes of a quad (the lanes sharing one fragment row);
// every lane gets the same bits.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// For rows r < rows: sq[r] = sum x[r]^2 and inv[r] = rsqrt(max(sq, eps^2))
// for r < n of x [n, D] (row stride D, in device memory), 0 for r >= n;
// either output may be null. One warp a row, lanes over d, then a fixed
// xor tree.
__device__ __forceinline__ void row_norms(const float* __restrict__ x, int n, int rows, int D,
                                          float* sq, float* inv) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += NWARP) {
    float s = 0.f;
    if (r < n)
      for (int d = lane; d < D; d += 32) s = fmaf(x[(int64_t)r * D + d], x[(int64_t)r * D + d], s);
    s = warp_sum(s);
    if (lane == 0 && sq) sq[r] = s;
    if (lane == 0 && inv) inv[r] = r < n ? 1.f / sqrtf(fmaxf(s, NEPS)) : 0.f;
  }
}

// ---- cp.async ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A ring of NS stages: slabs 0 .. nslab - 1, slab s in stage s % NS.
// load(s) issues slab s's copies; compute(s) reads it. NS - 1 slabs are in
// flight while one is multiplied; one barrier a slab (slab s has landed for
// every thread, and slab s - 1's readers are done with the stage that slab
// s + NS - 1 then fills).
template <int NS, class Load, class Compute>
__device__ __forceinline__ void pipeline(int nslab, Load&& load, Compute&& compute) {
  __syncthreads();  // the ring's last readers are done
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nslab) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < nslab; ++s) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    if (s + NS - 1 < nslab) load(s + NS - 1);
    cp_async_commit();
    compute(s);
  }
}

// dst [rows][COLS] (row stride lds) <- src [rows][COLS] (row stride ldg);
// elements at row >= vr or column >= vc become zeros. vec4: 16-byte copies
// (vc, ldg and src's alignment multiples of 4 floats).
template <int COLS>
__device__ __forceinline__ void load_tile(float* dst, int lds, const float* __restrict__ src,
                                          int64_t ldg, int rows, int vr, int vc, bool vec4) {
  if (vec4) {
    constexpr int C4 = COLS / 4;
    for (int i = threadIdx.x; i < rows * C4; i += NT) {
      const int r = i / C4, c = (i % C4) * 4;
      const bool ok = r < vr && c < vc;
      cp_async16(dst + r * lds + c, ok ? src + (int64_t)r * ldg + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * COLS; i += NT) {
      const int r = i / COLS, c = i % COLS;
      const bool ok = r < vr && c < vc;
      cp_async4(dst + r * lds + c, ok ? src + (int64_t)r * ldg + c : src, ok);
    }
  }
}

// ---- 3xTF32 products ----

using tf32::mma_tf32;
using tf32::split;

// The A fragment (layouts in tf32_mma.cuh) of rows [0, 16) of a (row
// stride lda) at column k.
__device__ __forceinline__ void load_a(const float* a, int lda, int k, float* x) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  x[0] = a[g * lda + k + t];
  x[1] = a[(g + 8) * lda + k + t];
  x[2] = a[g * lda + k + t + 4];
  x[3] = a[(g + 8) * lda + k + t + 4];
}

// acc[m][j] += a[m]·b[j] for m < MT, j < J with fp32 accuracy: the lo·hi
// products of all MT x J tiles, then the hi·lo, then the hi·hi ones, so
// that the three products of one accumulator sit MT J instructions apart.
template <int J, int MT, int JA>
__device__ __forceinline__ void mma3_tiles(float (*acc)[JA][4], uint32_t (*ahi)[4],
                                           uint32_t (*alo)[4], uint32_t (*bhi)[2],
                                           uint32_t (*blo)[2]) {
  if (NPROD == 3) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < J; ++j) mma_tf32(acc[m][j], alo[m], bhi[j]);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < J; ++j) mma_tf32(acc[m][j], ahi[m], blo[j]);
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < J; ++j) mma_tf32(acc[m][j], ahi[m], bhi[j]);
}

// The n8 tile of warp-local index j: warp + NWARP j, or the last of ntile
// where that is past it (the warp then computes that tile once more, into
// an accumulator nobody writes out), so every warp runs the same branch-free
// K loop.
__device__ __forceinline__ int tile_of(int j, int ntile) {
  return min((int)(threadIdx.x / 32) + NWARP * j, ntile - 1);
}

// The tiles a warp needs for ntile n8 tiles, rounded up to one of the
// counts the products are compiled for.
__device__ __forceinline__ int tiles_a_warp(int ntile, int most) {
  const int j = (ntile + NWARP - 1) / NWARP;
  return j <= 1 ? 1 : j <= 2 ? 2 : j <= 4 ? 4 : most;
}

// The A fragments of the MT m16 tiles of a (row stride lda; tile m from row
// 16 m) at column k, split into hi and lo.
template <int MT>
__device__ __forceinline__ void a_frags(const float* a, int lda, int k, uint32_t (*hi)[4],
                                        uint32_t (*lo)[4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float x[4];
    load_a(a + 16 * m * lda, lda, k, x);
#pragma unroll
    for (int i = 0; i < 4; ++i) split(x[i], hi[m][i], lo[m][i]);
  }
}

// C [16 MT][nc] = A [16 MT][D] · B [nc][D]^T, with A the rows [0, na) of a
// and B the rows [0, nb) of b (row stride D, in device memory; the rest
// read as zeros), nc a multiple of 8 and at most 8 NWARP J. D is streamed
// in slabs of KS through the ring. Warp w owns the n8 tiles w + 8 j
// (j < J) of C's m16 tile m in acc[m][j]; each B fragment serves the MT
// tiles. With SQ it also sums the squares of the B elements it loads:
// sqb[j] of B's row 8 (w + 8 j) + g (to be summed over the quad).
template <bool SQ, int J, int MT>
__device__ __forceinline__ void product_nt_j(const float* __restrict__ a, int na,
                                             const float* __restrict__ b, int nb, int nc,
                                             int D, bool vec4, float* ring,
                                             float (*acc)[JS][4], float* sqb) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  const int stage = (16 * MT + nc) * SS;
  int row[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
    if (SQ) sqb[j] = 0.f;
    row[j] = (8 * tile_of(j, nc / 8) + g) * SS + t;
  }
  pipeline<NST>(
      (D + KS - 1) / KS,
      [&](int s) {
        float* st = ring + (s % NST) * stage;
        load_tile<KS>(st, SS, a + s * KS, D, 16 * MT, na, D - s * KS, vec4);
        load_tile<KS>(st + 16 * MT * SS, SS, b + s * KS, D, nc, nb, D - s * KS, vec4);
      },
      [&](int s) {
        const float* as = ring + (s % NST) * stage;
        const float* bs = as + 16 * MT * SS;
#pragma unroll
        for (int k = 0; k < KS; k += 8) {
          uint32_t ahi[MT][4], alo[MT][4], bhi[J][2], blo[J][2];
          a_frags<MT>(as, SS, k, ahi, alo);
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const float b0 = bs[row[j] + k], b1 = bs[row[j] + k + 4];
            split(b0, bhi[j][0], blo[j][0]);
            split(b1, bhi[j][1], blo[j][1]);
            if (SQ) {
              sqb[j] = fmaf(b0, b0, sqb[j]);
              sqb[j] = fmaf(b1, b1, sqb[j]);
            }
          }
          mma3_tiles<J, MT, JS>(acc, ahi, alo, bhi, blo);
        }
      });
}

// product_nt_j with J = the tiles a warp needs for nc columns; acc and sqb
// hold JS tiles, of which the first J are set.
template <bool SQ, int MT>
__device__ __forceinline__ void product_nt(const float* __restrict__ a, int na,
                                           const float* __restrict__ b, int nb, int nc,
                                           int D, bool vec4, float* ring,
                                           float (*acc)[JS][4], float* sqb) {
  switch (tiles_a_warp(nc / 8, JS)) {
    case 1: product_nt_j<SQ, 1, MT>(a, na, b, nb, nc, D, vec4, ring, acc, sqb); break;
    case 2: product_nt_j<SQ, 2, MT>(a, na, b, nb, nc, D, vec4, ring, acc, sqb); break;
    default: product_nt_j<SQ, JS, MT>(a, na, b, nb, nc, D, vec4, ring, acc, sqb); break;
  }
}

// C [16 MT][PCH] = A [16 MT][K] · B [K][PCH]: A in shared memory (row
// stride lda, columns [0, K) all set, K a multiple of KP), B the rows
// [0, kv) and columns [0, ncv) of b (row stride ldb, in device memory; the
// rest read as zeros), streamed in slabs of KP rows through the ring. Warp
// w owns the n8 tiles w + 8 j (j < J) of C's m16 tile m in acc[m][j].
template <int J, int MT>
__device__ __forceinline__ void product_nn_j(const float* a, int lda, int K,
                                             const float* __restrict__ b, int64_t ldb, int kv,
                                             int ncv, bool vec4, float* ring,
                                             float (*acc)[JP][4]) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  constexpr int stage = KP * PS;
  int col[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
    col[j] = t * PS + tile_of(j, (ncv + 7) / 8) * 8 + g;
  }
  pipeline<NST>(
      K / KP,
      [&](int s) {
        load_tile<PCH>(ring + (s % NST) * stage, PS, b + (int64_t)s * KP * ldb, ldb, KP,
                       kv - s * KP, ncv, vec4);
      },
      [&](int s) {
        const float* bs = ring + (s % NST) * stage;
#pragma unroll
        for (int kk = 0; kk < KP; kk += 8) {
          uint32_t ahi[MT][4], alo[MT][4], bhi[J][2], blo[J][2];
          a_frags<MT>(a, lda, s * KP + kk, ahi, alo);
#pragma unroll
          for (int j = 0; j < J; ++j) {
            split(bs[kk * PS + col[j]], bhi[j][0], blo[j][0]);
            split(bs[(kk + 4) * PS + col[j]], bhi[j][1], blo[j][1]);
          }
          mma3_tiles<J, MT, JP>(acc, ahi, alo, bhi, blo);
        }
      });
}

// product_nn_j with J = the tiles a warp needs for ncv columns; acc holds
// JP tiles, of which the first J are set.
template <int MT>
__device__ __forceinline__ void product_nn(const float* a, int lda, int K,
                                           const float* __restrict__ b, int64_t ldb, int kv,
                                           int ncv, bool vec4, float* ring,
                                           float (*acc)[JP][4]) {
  switch (tiles_a_warp((ncv + 7) / 8, JP)) {
    case 1: product_nn_j<1, MT>(a, lda, K, b, ldb, kv, ncv, vec4, ring, acc); break;
    case 2: product_nn_j<2, MT>(a, lda, K, b, ldb, kv, ncv, vec4, ring, acc); break;
    case 4: product_nn_j<4, MT>(a, lda, K, b, ldb, kv, ncv, vec4, ring, acc); break;
    default: product_nn_j<JP, MT>(a, lda, K, b, ldb, kv, ncv, vec4, ring, acc); break;
  }
}

// ---- the min-max / threshold / renormalize chain ----

// Per-row quantities of the chain.
struct RowStats {
  float mk;         // the row's mask value
  float mn, mx;     // masked min and max (+-2 when the row is masked)
  float s;          // mx - mn + EPS
  float denom_raw;  // sum of the thresholded row
  float denom;      // max(denom_raw, EPS)
};

// z and the thresholded value t of one element (objectives/losses.py::
// sparc_alignment_weights; ops/sparc_kernel.py::_sparc_kernel).
__device__ __forceinline__ void threshold_one(float sim, const RowStats& r, bool cons,
                                              float tau, float& z, float& t) {
  const float sm = sim * r.mk;
  z = (sm - r.mn) / r.s;
  const float thr = z < tau ? 0.f : z;
  t = cons ? thr * r.mk : 0.f;
}

// The statistics of one token row sim [P] (in shared memory) with mask
// value mk, to every lane of the calling warp: the masked min/max over
// p < P with the +-2 sentinel, the threshold and the row sum (lanes over p,
// then a fixed xor tree).
__device__ __forceinline__ RowStats row_stats(const float* sim, int P, float mk, float tau) {
  const int lane = threadIdx.x % 32;
  const bool cons = mk > 0.f;
  RowStats r;
  r.mk = mk;
  float mn = 2.f, mx = -2.f;
  if (cons) {
    for (int p = lane; p < P; p += 32) {
      const float sm = sim[p] * mk;
      mn = fminf(mn, sm);
      mx = fmaxf(mx, sm);
    }
  }
  r.mn = warp_min(mn);
  r.mx = warp_max(mx);
  r.s = r.mx - r.mn + EPS;
  float sum = 0.f;
  for (int p = lane; p < P; p += 32) {
    float z, tv;
    threshold_one(sim[p], r, cons, tau, z, tv);
    sum += tv;
  }
  r.denom_raw = warp_sum(sum);
  r.denom = fmaxf(r.denom_raw, EPS);
  return r;
}

}  // namespace sparc
