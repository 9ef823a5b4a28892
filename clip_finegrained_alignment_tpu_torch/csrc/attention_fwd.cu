// Fused multi-head attention forward for Hopper (sm_90a), bshd layout.
//
// Replaces the Pallas TPU kernel clip_finegrained_alignment_tpu/ops/
// attention.py::_fwd_kernel_bshd (math in _fwd_math): for every (batch,
// head), o = softmax(q * scale * k^T + bias) v with fp32 max, sum and
// accumulation. Same function, not the same blocking: the TPU kernel holds
// the whole padded S x S fp32 score tile for a head group in VMEM, which
// at ViT-B/16 (S=197 padded to 200, 12 heads) is ~1.9 MB, far beyond the
// 227 KB of shared memory a block has here. So this kernel streams keys:
//
//   * one block of 256 threads per (64-row query tile, head, batch);
//   * a loop over 64-key tiles staged in shared memory as fp32
//     (K transposed so that both operand reads are 16-byte vector loads);
//   * online softmax: fp32 running max and sum per row, the fp32 output
//     accumulator in registers (4 rows x Dh/16 columns per thread),
//     rescaled when the max moves; one division by the sum at the end;
//   * keys >= S are excluded inside the kernel (score -inf, exp 0), which
//     is exactly what the TPU wrapper's -1e9 padding keys give after exp;
//   * the optional fp32 bias [B|1, S, S] (head-invariant, as in CLIP's
//     causal and padding masks) is added per (q, k) before the max;
//   * q, k, v are read through their strides as bshd views of the
//     projection outputs, so no transposes are made; o is written
//     [B, S, H, Dh] contiguous in the input type.
//
// q is scaled as the TPU wrapper does it, (q * scale).astype(q.dtype):
// the host passes `scale` already rounded to the input type, the product
// is taken in fp32 and rounded back to the input type. At Dh=64 the scale
// 1/8 is exact. The one deliberate difference from _fwd_math: that kernel
// rounds p = e / s to the input type before p @ v; this one keeps the
// unnormalized weights in fp32 and divides once at the end, so in bf16 it
// is the more exact of the two.
//
// Bound on the card: at B=64, ViT-B/16 vision (S=197, H=12, Dh=64, bf16)
// moves ~77 MB of q/k/v/o for ~7.6 GFLOP, so it is memory-bound at ~23 us
// at 3.35 TB/s; the text tower (S=77, H=8) moves ~20 MB, ~6 us. This first
// version computes on the fp32 CUDA cores (no mma.sync / wgmma, no TMA),
// so it runs well above that bound; what it does about the bytes is read
// q/k/v once per query tile and never write scores or probabilities to
// device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

template <typename T, int DH>
__global__ void __launch_bounds__(NT) attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ bias, T* __restrict__ o, int S, int H,
    int64_t q_sb, int64_t q_ss, int64_t q_sh,
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

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const float* biasb = bias ? bias + b * bias_sb : nullptr;

  for (int i = tid; i < BQ * DH; i += NT) {
    const int r = i / DH, d = i % DH;
    const int row = q0 + r;
    float x = 0.f;
    if (row < S) x = to_f(from_f<T>(to_f(qb[row * q_ss + d]) * scale));
    Qt[d * QSTR + r] = x;
  }

  float m[RQ], l[RQ], acc[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
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
        kx = to_f(kb[key * k_ss + d]);
        vx = to_f(vb[key * v_ss + d]);
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
    T* orow = o + (((int64_t)b * S + row) * H + h) * DH + tx * RD;
#pragma unroll
    for (int j = 0; j < RD; ++j) orow[j] = from_f<T>(acc[i][j] / l[i]);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   void* o, int B, int S, int H,
                   int64_t q_sb, int64_t q_ss, int64_t q_sh,
                   int64_t k_sb, int64_t k_ss, int64_t k_sh,
                   int64_t v_sb, int64_t v_ss, int64_t v_sh,
                   int64_t bias_sb, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_floats<DH>() * sizeof(float);
  // Above 48 KB dynamic shared memory needs the opt-in, which holds for the
  // current device only; it is a cheap host call, so it is made on every
  // launch and holds on whichever device the caller made current.
  const cudaError_t attr = cudaFuncSetAttribute(
      attention_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  attention_fwd_kernel<T, DH><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      bias, static_cast<T*>(o), S, H, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
      v_sb, v_ss, v_sh, bias_sb, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry, loaded with ctypes. Strides are in elements; the last dim
// of q, k, v is contiguous. dtype: 0 = float32, 1 = bfloat16. bias is null
// or a contiguous fp32 [B|1, S, S] with batch stride bias_sb (0 = shared).
// Returns the cudaError_t of the launch, or -1 for an unsupported dtype / Dh.
extern "C" int cfa_attention_fwd(const void* q, const void* k, const void* v,
                                 const void* bias, void* o, int B, int S, int H,
                                 int Dh, int dtype,
                                 long long q_sb, long long q_ss, long long q_sh,
                                 long long k_sb, long long k_ss, long long k_sh,
                                 long long v_sb, long long v_ss, long long v_sh,
                                 long long bias_sb, float scale, void* stream) {
  const float* bp = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CFA_LAUNCH(T, D)                                                     \
  return (int)launch<T, D>(q, k, v, bp, o, B, S, H, q_sb, q_ss, q_sh, k_sb, \
                           k_ss, k_sh, v_sb, v_ss, v_sh, bias_sb, scale, st)
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
