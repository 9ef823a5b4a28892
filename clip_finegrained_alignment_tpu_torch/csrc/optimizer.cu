// Multi-tensor clip by global norm and AdamSPD for Hopper (sm_90a): every
// parameter tensor of a train step in one launch a pass.
//
// No Pallas kernel to replace: the JAX package jits its optimizer chain
// (clip_finegrained_alignment_tpu/optim/factory.py, optax's
// clip_by_global_norm, then optim/adamspd.py's update) and XLA fuses it.
// Eager PyTorch took ~47 launches a tensor for the same work (the plain
// versions in ops/optimizer.py: the moments, sqrt, the divide, the three
// sums, the projection, the norm's squares and the clip), ~18,700 a
// ViT-B/16 step over its 398 tensors, each moving a few hundred KB or
// less. Seven C entries, each one launch from its wrapper in
// ops/optimizer.py:
//
//   cfa_clip_sumsq       each chunk's sum of g*g             -> partial[c]
//   cfa_clip_rows        a tensor's chunk partials summed in a fixed
//                        order                               -> rows[t]
//   cfa_clip_norm        sqrt of the rows summed in a fixed order (one
//                        block; under ZeRO-1, FSDP, TP and PP the rows
//                        are first added over the ranks, so one rank's
//                        norm is the norm without a mesh bit for bit)
//                                                            -> norm[0]
//   cfa_clip_scale       g = g / norm * max_norm in place where
//                        !(norm < max_norm), the norm read from device
//                        memory (no host sync); the whole grid returns
//                        at once otherwise
//   cfa_adamspd_update   AdamSPD's first pass: m, v (and max v under
//                        amsgrad) and p in place, each chunk's sums
//                        [-g.(p - pre), (new - pre)^2, (p - pre)^2]
//                                                            -> partial[c, 3]
//   cfa_adamspd_sums     a tensor's chunk partials summed in a fixed order
//                                                            -> sums[t, 3]
//   cfa_adamspd_project  the second pass: p - (wd * ratio) * (p - pre) for
//                        the tensors whose condition sums[t, 0] < 0; a
//                        block of any other tensor returns without
//                        reading it
//
// The tensors: a table of records, one a tensor, that the wrapper builds
// on the host each step (gradients are new tensors every step) and copies
// up from pinned memory. A tensor's elements are `runs` runs of `inner`
// contiguous elements, run r at r * stride (a contiguous tensor is one
// run; ZeRO-1's shards are views split along a later dimension, so many
// runs). Each run is cut into chunks of kChunk elements; block b takes
// global chunk b and finds its tensor by a binary search of the records'
// first chunks. The moments, the anchor and max v are contiguous; p and g
// each have their own run stride.
//
// Sums are deterministic: each thread adds its elements in order, a warp
// and then the block add theirs in a fixed tree, and the chunk partials
// are added the same way by the next launch (no atomics), so a step is
// bit-equal run to run. ZeRO-1 and FSDP add their shards' rows between
// cfa_adamspd_sums and cfa_adamspd_project (ops/optimizer.py's caller).
//
// Numerics follow the plain versions op for op, in fp32 with no
// fast-math: m = g * (1 - b1) + m * b1 and v = (g * g) * (1 - b2) + v * b2
// as one fma each (torch's add_ with alpha), denom = sqrt(v) / sqrt(bc2) +
// eps with IEEE division (where torch on the card multiplies by a
// scalar's reciprocal), p - (step_size * m) / denom; the bias corrections
// come from the host in fp32. The _rn intrinsics keep nvcc from
// contracting the other multiplies and adds into fmas. A NaN propagates
// as in torch: maximum and clamp keep it, a NaN condition or norm fails
// its `<` test.
//
// Bound on the card (NVIDIA H100 80GB HBM3, 3.35 TB/s): bytes, at well
// under one flop a byte. Per parameter: update reads p, g, m, v, pre and
// writes p, m, v (32 B; 40 under amsgrad), project reads p and pre and
// writes p where it projects (12 B), the norm reads g (4 B), the clip
// reads and writes it (8 B): ~56 B, 8.4 GB at ViT-B/16's 149.6 M
// parameters, 2.5 ms. Design: 16-byte loads where a chunk's pointers are
// aligned, 64 elements a thread (a chunk of 16,384 at 256 threads), so
// enough loads are in flight to stream at the card's rate; the partials
// (~9,400 chunks at ViT-B/16) and rows are the only extra traffic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16384;       // elements a block takes (ops/optimizer.py CHUNK)
constexpr int kNormThreads = 1024;

// ops/optimizer.py ADAM_RECORD, PROJECT_RECORD and GRAD_RECORD, field for
// field.
struct AdamRec {
  float* p;
  const float* g;      // null: a zero gradient
  float* m;
  float* v;
  const float* pre;
  float* vmax;         // null: no amsgrad
  long long inner;     // elements a run
  long long p_stride;  // elements from one run of p to the next
  long long g_stride;
  int first_chunk;
  int run_chunks;      // chunks a run: ceil(inner / kChunk)
  float step_size;     // lr / (1 - b1^t)
  float sqrt_bc2;      // sqrt(1 - b2^t)
  float b1, omb1, b2, omb2, eps, unused;
};
static_assert(sizeof(AdamRec) == 112, "AdamRec != ops/optimizer.py ADAM_RECORD");

struct ProjectRec {
  float* p;
  const float* pre;
  long long inner;
  long long p_stride;
  int first_chunk;
  int run_chunks;
  float wd;
  float unused;
};
static_assert(sizeof(ProjectRec) == 48, "ProjectRec != ops/optimizer.py PROJECT_RECORD");

struct GradRec {
  float* g;
  long long inner;
  long long g_stride;
  int first_chunk;
  int run_chunks;
};
static_assert(sizeof(GradRec) == 32, "GradRec != ops/optimizer.py GRAD_RECORD");

// The record whose chunks hold global chunk `chunk`: the last one whose
// first chunk is at or before it (a tensor with no chunks shares its first
// chunk with the next tensor and is never the last such).
template <typename Rec>
__device__ __forceinline__ int tensor_of(const Rec* recs, int n, int chunk) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (recs[mid].first_chunk <= chunk) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Where this block's chunk lies in its tensor: the run, and the offset
// and length inside it.
struct Span {
  long long run, start, len;
};

template <typename Rec>
__device__ __forceinline__ Span span_of(const Rec& r) {
  const int local = static_cast<int>(blockIdx.x) - r.first_chunk;
  const int run = local / r.run_chunks;          // 32-bit: chunks fit an int
  Span s;
  s.run = run;
  s.start = static_cast<long long>(local - run * r.run_chunks) * kChunk;
  s.len = min(static_cast<long long>(kChunk), r.inner - s.start);
  return s;
}

template <typename Rec>
__device__ __forceinline__ Rec block_record(const Rec* recs, int n) {
  __shared__ int s_tensor;
  if (threadIdx.x == 0) s_tensor = tensor_of(recs, n, blockIdx.x);
  __syncthreads();
  return recs[s_tensor];
}

// x[k] summed over the block in a fixed order (each warp's lanes in a
// tree, then the warps in index order); thread 0 gets the totals.
template <int K, int THREADS>
__device__ __forceinline__ void block_sum(float (&x)[K]) {
  __shared__ float warps[K][THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = x[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, o));
    if (lane == 0) warps[k][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float s = warps[k][0];
      for (int w = 1; w < THREADS / 32; ++w) s = __fadd_rn(s, warps[k][w]);
      x[k] = s;
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b, const void* c = nullptr,
                                          const void* d = nullptr, const void* e = nullptr,
                                          const void* f = nullptr) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d) |
           reinterpret_cast<uintptr_t>(e) | reinterpret_cast<uintptr_t>(f)) & 15) == 0;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float get(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ void put(float4& v, int i, float x) {
  if (i == 0) v.x = x;
  else if (i == 1) v.y = x;
  else if (i == 2) v.z = x;
  else v.w = x;
}

// torch.maximum's: a NaN in either gives NaN.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// ---------------------------------------------------------------------------
// The clip

__global__ void __launch_bounds__(kThreads) clip_sumsq_kernel(const GradRec* __restrict__ recs,
                                                               int n, float* __restrict__ partial) {
  const GradRec r = block_record(recs, n);
  const Span s = span_of(r);
  const float* __restrict__ g = r.g + s.run * r.g_stride + s.start;
  float acc[1] = {0.0f};
  long long i = 0;
  if (aligned16(g, g)) {
    const long long nv = s.len >> 2;
    for (long long k = threadIdx.x; k < nv; k += kThreads) {
      const float4 G = load4(g + 4 * k);
      acc[0] = __fadd_rn(acc[0], __fmul_rn(G.x, G.x));
      acc[0] = __fadd_rn(acc[0], __fmul_rn(G.y, G.y));
      acc[0] = __fadd_rn(acc[0], __fmul_rn(G.z, G.z));
      acc[0] = __fadd_rn(acc[0], __fmul_rn(G.w, G.w));
    }
    i = 4 * nv;
  }
  for (long long e = i + threadIdx.x; e < s.len; e += kThreads)
    acc[0] = __fadd_rn(acc[0], __fmul_rn(g[e], g[e]));
  block_sum<1, kThreads>(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = acc[0];
}

// One block a tensor: its chunks' K partials each added in the block's
// fixed order into out[t * K + k].
template <int K, typename Rec>
__device__ __forceinline__ void tensor_sums(const Rec* recs, int n, int chunks,
                                            const float* partial, float* out) {
  const int t = blockIdx.x;
  const int c0 = recs[t].first_chunk;
  const int c1 = t + 1 < n ? recs[t + 1].first_chunk : chunks;
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0f;
  for (int c = c0 + threadIdx.x; c < c1; c += kThreads) {
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = __fadd_rn(acc[k], partial[K * c + k]);
  }
  block_sum<K, kThreads>(acc);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) out[K * t + k] = acc[k];
  }
}

__global__ void __launch_bounds__(kThreads) clip_rows_kernel(const GradRec* __restrict__ recs,
                                                              int n, int chunks,
                                                              const float* __restrict__ partial,
                                                              float* __restrict__ rows) {
  tensor_sums<1>(recs, n, chunks, partial, rows);
}

__global__ void __launch_bounds__(kNormThreads) clip_norm_kernel(const float* __restrict__ rows,
                                                                 int n,
                                                                 float* __restrict__ norm) {
  float acc[1] = {0.0f};
  for (int t = threadIdx.x; t < n; t += kNormThreads) acc[0] = __fadd_rn(acc[0], rows[t]);
  block_sum<1, kNormThreads>(acc);
  if (threadIdx.x == 0) norm[0] = __fsqrt_rn(acc[0]);
}

__global__ void __launch_bounds__(kThreads) clip_scale_kernel(const GradRec* __restrict__ recs,
                                                               int n,
                                                               const float* __restrict__ norm_p,
                                                               float max_norm) {
  const float norm = *norm_p;
  if (norm < max_norm) return;      // the same for every block: nothing moves
  const GradRec r = block_record(recs, n);
  const Span s = span_of(r);
  float* __restrict__ g = r.g + s.run * r.g_stride + s.start;
  long long i = 0;
  if (aligned16(g, g)) {
    const long long nv = s.len >> 2;
    for (long long k = threadIdx.x; k < nv; k += kThreads) {
      float4 G = load4(g + 4 * k);
      G.x = __fmul_rn(__fdiv_rn(G.x, norm), max_norm);
      G.y = __fmul_rn(__fdiv_rn(G.y, norm), max_norm);
      G.z = __fmul_rn(__fdiv_rn(G.z, norm), max_norm);
      G.w = __fmul_rn(__fdiv_rn(G.w, norm), max_norm);
      store4(g + 4 * k, G);
    }
    i = 4 * nv;
  }
  for (long long e = i + threadIdx.x; e < s.len; e += kThreads)
    g[e] = __fmul_rn(__fdiv_rn(g[e], norm), max_norm);
}

// ---------------------------------------------------------------------------
// AdamSPD

// One element of the first pass: the moments in place, the new value
// returned, the three sums accumulated (acc[0] the unnegated condition).
__device__ __forceinline__ float adam_element(const AdamRec& r, bool ams, float p, float g,
                                              float& m, float& v, float& vm, float pre,
                                              float (&acc)[3]) {
  m = __fmaf_rn(g, r.omb1, __fmul_rn(m, r.b1));
  v = __fmaf_rn(__fmul_rn(g, g), r.omb2, __fmul_rn(v, r.b2));
  float vv = v;
  if (ams) {
    vm = nan_max(vm, v);
    vv = vm;
  }
  const float denom = __fadd_rn(__fdiv_rn(__fsqrt_rn(vv), r.sqrt_bc2), r.eps);
  const float d0 = __fsub_rn(p, pre);
  acc[0] = __fadd_rn(acc[0], __fmul_rn(g, d0));
  acc[2] = __fadd_rn(acc[2], __fmul_rn(d0, d0));
  const float q = __fsub_rn(p, __fdiv_rn(__fmul_rn(r.step_size, m), denom));
  const float d1 = __fsub_rn(q, pre);
  acc[1] = __fadd_rn(acc[1], __fmul_rn(d1, d1));
  return q;
}

__global__ void __launch_bounds__(kThreads) adamspd_update_kernel(const AdamRec* __restrict__ recs,
                                                                   int n,
                                                                   float* __restrict__ partial) {
  const AdamRec r = block_record(recs, n);
  const Span s = span_of(r);
  const long long c = s.run * r.inner + s.start;   // the contiguous tensors' offset
  float* __restrict__ p = r.p + s.run * r.p_stride + s.start;
  const float* __restrict__ g = r.g ? r.g + s.run * r.g_stride + s.start : nullptr;
  float* __restrict__ m = r.m + c;
  float* __restrict__ v = r.v + c;
  const float* __restrict__ pre = r.pre + c;
  float* __restrict__ vmax = r.vmax ? r.vmax + c : nullptr;
  const bool ams = vmax != nullptr;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  long long i = 0;
  if (aligned16(p, g, m, v, pre, vmax)) {
    const long long nv = s.len >> 2;
    for (long long k = threadIdx.x; k < nv; k += kThreads) {
      const long long e = 4 * k;
      float4 P = load4(p + e);
      const float4 G = g ? load4(g + e) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float4 M = load4(m + e), V = load4(v + e);
      const float4 PRE = load4(pre + e);
      float4 VM = ams ? load4(vmax + e) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float mj = get(M, j), vj = get(V, j), vmj = get(VM, j);
        put(P, j, adam_element(r, ams, get(P, j), get(G, j), mj, vj, vmj, get(PRE, j), acc));
        put(M, j, mj);
        put(V, j, vj);
        put(VM, j, vmj);
      }
      store4(p + e, P);
      store4(m + e, M);
      store4(v + e, V);
      if (ams) store4(vmax + e, VM);
    }
    i = 4 * nv;
  }
  for (long long e = i + threadIdx.x; e < s.len; e += kThreads) {
    float vm = ams ? vmax[e] : 0.0f;
    p[e] = adam_element(r, ams, p[e], g ? g[e] : 0.0f, m[e], v[e], vm, pre[e], acc);
    if (ams) vmax[e] = vm;
  }
  acc[0] = -acc[0];      // -(a + b) == (-a) + (-b): the condition's sign
  block_sum<3, kThreads>(acc);
  if (threadIdx.x == 0) {
    partial[3 * blockIdx.x] = acc[0];
    partial[3 * blockIdx.x + 1] = acc[1];
    partial[3 * blockIdx.x + 2] = acc[2];
  }
}

__global__ void __launch_bounds__(kThreads) adamspd_sums_kernel(const AdamRec* __restrict__ recs,
                                                                 int n, int chunks,
                                                                 const float* __restrict__ partial,
                                                                 float* __restrict__ sums) {
  tensor_sums<3>(recs, n, chunks, partial, sums);
}

__global__ void __launch_bounds__(kThreads) adamspd_project_kernel(
    const ProjectRec* __restrict__ recs, int n, const float* __restrict__ sums) {
  __shared__ int s_tensor;
  if (threadIdx.x == 0) s_tensor = tensor_of(recs, n, blockIdx.x);
  __syncthreads();
  const int t = s_tensor;
  const float cond = sums[3 * t];
  if (!(cond < 0.0f)) return;       // the whole tensor keeps its first-pass value
  const ProjectRec r = recs[t];
  const float curr = __fsqrt_rn(sums[3 * t + 1]), prev = __fsqrt_rn(sums[3 * t + 2]);
  float ratio = 0.0f;
  if (curr != 0.0f) {
    ratio = __fdiv_rn(__fsub_rn(curr, prev), curr);
    ratio = ratio < 0.0f ? 0.0f : (ratio > 1.0f ? 1.0f : ratio);   // NaN stays
  }
  const float coef = __fmul_rn(r.wd, ratio);
  const Span s = span_of(r);
  float* __restrict__ p = r.p + s.run * r.p_stride + s.start;
  const float* __restrict__ pre = r.pre + s.run * r.inner + s.start;
  long long i = 0;
  if (aligned16(p, pre)) {
    const long long nv = s.len >> 2;
    for (long long k = threadIdx.x; k < nv; k += kThreads) {
      float4 P = load4(p + 4 * k);
      const float4 PRE = load4(pre + 4 * k);
      P.x = __fsub_rn(P.x, __fmul_rn(coef, __fsub_rn(P.x, PRE.x)));
      P.y = __fsub_rn(P.y, __fmul_rn(coef, __fsub_rn(P.y, PRE.y)));
      P.z = __fsub_rn(P.z, __fmul_rn(coef, __fsub_rn(P.z, PRE.z)));
      P.w = __fsub_rn(P.w, __fmul_rn(coef, __fsub_rn(P.w, PRE.w)));
      store4(p + 4 * k, P);
    }
    i = 4 * nv;
  }
  for (long long e = i + threadIdx.x; e < s.len; e += kThreads)
    p[e] = __fsub_rn(p[e], __fmul_rn(coef, __fsub_rn(p[e], pre[e])));
}

}  // namespace

// Each entry returns cudaGetLastError() after its launch, or -1 for
// arguments it does not take. `recs` and every buffer are device
// pointers; the wrapper sizes them (partial: one float a chunk, three for
// AdamSPD; rows: one a tensor; sums: three a tensor).

extern "C" int cfa_clip_sumsq(const void* recs, int n, int chunks, void* partial, void* stream) {
  if (n < 1 || chunks < 1) return -1;
  clip_sumsq_kernel<<<chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const GradRec*>(recs), n, static_cast<float*>(partial));
  return (int)cudaGetLastError();
}

extern "C" int cfa_clip_rows(const void* recs, int n, int chunks, const void* partial,
                             void* rows, void* stream) {
  if (n < 1 || chunks < 0) return -1;
  clip_rows_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const GradRec*>(recs), n, chunks, static_cast<const float*>(partial),
      static_cast<float*>(rows));
  return (int)cudaGetLastError();
}

extern "C" int cfa_clip_norm(const void* rows, int n, void* norm, void* stream) {
  if (n < 0) return -1;
  clip_norm_kernel<<<1, kNormThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), n, static_cast<float*>(norm));
  return (int)cudaGetLastError();
}

extern "C" int cfa_clip_scale(const void* recs, int n, int chunks, const void* norm,
                              float max_norm, void* stream) {
  if (n < 1 || chunks < 1) return -1;
  clip_scale_kernel<<<chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const GradRec*>(recs), n, static_cast<const float*>(norm), max_norm);
  return (int)cudaGetLastError();
}

extern "C" int cfa_adamspd_update(const void* recs, int n, int chunks, void* partial,
                                  void* stream) {
  if (n < 1 || chunks < 1) return -1;
  adamspd_update_kernel<<<chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const AdamRec*>(recs), n, static_cast<float*>(partial));
  return (int)cudaGetLastError();
}

extern "C" int cfa_adamspd_sums(const void* recs, int n, int chunks, const void* partial,
                                void* sums, void* stream) {
  if (n < 1 || chunks < 0) return -1;
  adamspd_sums_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const AdamRec*>(recs), n, chunks, static_cast<const float*>(partial),
      static_cast<float*>(sums));
  return (int)cudaGetLastError();
}

extern "C" int cfa_adamspd_project(const void* recs, int n, int chunks, const void* sums,
                                   void* stream) {
  if (n < 1 || chunks < 1) return -1;
  adamspd_project_kernel<<<chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const ProjectRec*>(recs), n, static_cast<const float*>(sums));
  return (int)cudaGetLastError();
}
