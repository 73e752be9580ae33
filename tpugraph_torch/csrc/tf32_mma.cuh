// TF32 tensor-core helpers shared by sinkhorn_fused.cu and gcn_fused.cu:
// the 3× split that gives an fp32-accurate product on the TF32 tensor
// cores.  x = big + small with big = tf32(x) and small = tf32(x − big);
// a·b ≈ big·big + big·small + small·big, each product exact in fp32 and
// accumulated in fp32 by mma.sync m16n8k8.

#pragma once

#include <stdint.h>

namespace tf32 {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return u;
}

// x = big + small, each a TF32 value (fp32 bits with the low 13 zero)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

}  // namespace tf32
