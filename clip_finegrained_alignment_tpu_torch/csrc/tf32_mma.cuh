// fp32-accurate products on the TF32 tensor cores, for Hopper (sm_90a).
// Shared by the SPARC pooling kernels (sparc_common.cuh) and the float32
// attention kernels (attention_tf32.cuh).
//
// An fp32 product a·b is taken as three mma.sync.m16n8k8 TF32 products
// with fp32 sums: each operand x is split into hi = tf32(x) and lo =
// tf32(x - hi) (see split), and lo·hi, hi·lo, hi·hi are added onto one
// accumulator. The lo·lo term left out is below 2^-22 of each product.
// The sums are the tensor cores' own: mma.sync rounds each fp32 result
// mostly toward zero, by about a third of a unit in the last place an
// addition on the H100 (perf/fp32_grad_bias_study.py), so a long sum
// comes out a little small.
//
// Fragments of m16n8k8 TF32 (lane = 4 g + t): A 16 x 8 row-major holds
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B 8 x 8 holds (k = t,
// n = g), (k = t + 4, n = g); the accumulator 16 x 8 holds (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

// hi = x rounded to TF32, to nearest with ties away from zero (what
// cvt.rna.tf32.f32 gives a finite x), and lo = x - hi rounded the same way.
// By integer arithmetic on the bits, four instructions for the pair: ptxas
// lowers cvt.rna to a test for inf and NaN, a select and a mask besides.
// lo keeps its low 13 bits: the tensor core reads a TF32 operand's top 19
// bits only (ptxas's own lowering of cvt.rna relies on that too).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace tf32
