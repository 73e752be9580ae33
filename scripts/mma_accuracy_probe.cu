// Accuracy probe for the 3x TF32 product of tpugraph_torch/csrc/gcn_fused.cu
// (run by scripts/mma_accuracy_probe.py on an H100): C = A·B with one warp
// per 16 x 8 output tile, mma.sync m16n8k8, in several accumulation modes:
//   0  the kernel's: the three products of each k-step into one accumulator
//   1  fp32 SIMT fma in k order
//   2  each k-step's three products from zero, summed outside in fp32
//   3  big·big and the two small terms in two accumulators
//   4  one TF32 product;  5  one TF32 product, each k-step summed outside
#include <cuda_runtime.h>
#include <stdint.h>
#include "tf32_mma.cuh"
using namespace tf32;

__global__ void probe(const float* A, const float* B, float* C, int M, int N, int K, int mode) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int ntn = N / 8, mtiles = M / 16;
  if (warp >= mtiles * ntn) return;
  const int m0 = (warp / ntn) * 16, n0 = (warp % ntn) * 8;
  const int g = lane >> 2, t = lane & 3;
  float c[4] = {0, 0, 0, 0}, cs[4] = {0, 0, 0, 0}, acc[4] = {0, 0, 0, 0};
  if (mode == 1) {  // fp32 SIMT, k order
    for (int k = 0; k < K; ++k) {
      const float b0 = B[k * N + n0 + 2 * t], b1 = B[k * N + n0 + 2 * t + 1];
      const float a0 = A[(m0 + g) * K + k], a1 = A[(m0 + g + 8) * K + k];
      c[0] = fmaf(a0, b0, c[0]); c[1] = fmaf(a0, b1, c[1]);
      c[2] = fmaf(a1, b0, c[2]); c[3] = fmaf(a1, b1, c[3]);
    }
  } else {
    for (int k0 = 0; k0 < K; k0 += 8) {
      uint32_t ab[4], as[4], bb[2], bs[2];
      split_tf32(A[(m0 + g) * K + k0 + t], ab[0], as[0]);
      split_tf32(A[(m0 + g + 8) * K + k0 + t], ab[1], as[1]);
      split_tf32(A[(m0 + g) * K + k0 + t + 4], ab[2], as[2]);
      split_tf32(A[(m0 + g + 8) * K + k0 + t + 4], ab[3], as[3]);
      split_tf32(B[(k0 + t) * N + n0 + g], bb[0], bs[0]);
      split_tf32(B[(k0 + t + 4) * N + n0 + g], bb[1], bs[1]);
      if (mode == 0) {  // the kernel: one accumulator, small terms first
        mma_tf32(c, ab[0], ab[1], ab[2], ab[3], bs[0], bs[1]);
        mma_tf32(c, as[0], as[1], as[2], as[3], bb[0], bb[1]);
        mma_tf32(c, ab[0], ab[1], ab[2], ab[3], bb[0], bb[1]);
      } else if (mode == 2) {  // each k-step from zero, summed outside in fp32 (RN)
        float z[4] = {0, 0, 0, 0};
        mma_tf32(z, ab[0], ab[1], ab[2], ab[3], bs[0], bs[1]);
        mma_tf32(z, as[0], as[1], as[2], as[3], bb[0], bb[1]);
        mma_tf32(z, ab[0], ab[1], ab[2], ab[3], bb[0], bb[1]);
        for (int i = 0; i < 4; ++i) c[i] += z[i];
      } else if (mode == 3) {  // big and small terms in separate accumulators
        mma_tf32(cs, ab[0], ab[1], ab[2], ab[3], bs[0], bs[1]);
        mma_tf32(cs, as[0], as[1], as[2], as[3], bb[0], bb[1]);
        mma_tf32(c, ab[0], ab[1], ab[2], ab[3], bb[0], bb[1]);
      } else if (mode == 4) {  // one TF32 product
        mma_tf32(c, ab[0], ab[1], ab[2], ab[3], bb[0], bb[1]);
      } else if (mode == 5) {  // big·big only, each k-step summed outside
        float z[4] = {0, 0, 0, 0};
        mma_tf32(z, ab[0], ab[1], ab[2], ab[3], bb[0], bb[1]);
        for (int i = 0; i < 4; ++i) acc[i] += z[i];
      }
    }
    for (int i = 0; i < 4; ++i) c[i] += cs[i] + acc[i];
  }
  C[(m0 + g) * N + n0 + 2 * t] = c[0];
  C[(m0 + g) * N + n0 + 2 * t + 1] = c[1];
  C[(m0 + g + 8) * N + n0 + 2 * t] = c[2];
  C[(m0 + g + 8) * N + n0 + 2 * t + 1] = c[3];
}

extern "C" int run_probe(const float* A, const float* B, float* C, int M, int N, int K, int mode) {
  const int warps = (M / 16) * (N / 8);
  probe<<<(warps + 7) / 8, 256>>>(A, B, C, M, N, K, mode);
  cudaDeviceSynchronize();
  return cudaGetLastError();
}
