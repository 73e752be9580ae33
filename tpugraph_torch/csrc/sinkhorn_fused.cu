// One log-domain Sinkhorn potential update for Hopper (sm_90a), with the
// sqeuclidean cost built tile by tile and never stored:
//
//     f_i = τ·(log μ_i − LSE_j[(g_j − C_ij)/τ]),
//     C_ij = max(‖l_i‖² + ‖r_j‖² − 2·l_i·r_j, 0),   j < C.
//
// Replaces tpugraph/kernels/sinkhorn_pallas.py::_f_update_kernel (and its
// wrapper sinkhorn_potential_update).  The solver alternates the f- and
// g-updates by swapping (l, r); the kernel reads rows of both sides, so
// neither is transposed in device memory.
//
// What bounds it on an H100: 2·Q·C·d operations of fp32 for the dot
// products (4,500 × 4,500 × 128 in config sinkhorn: 5.2 GFLOP, ~77 µs at
// 67 TFLOP/s outside the tensor cores) and Q·C exps; its inputs are under
// 5 MB.  So it is operations-bound.  The products stay in fp32 SIMT on
// purpose: with τ = 0.3 on unit vectors C/τ reaches ~13, and the exp turns
// a TF32 rounding of the dot product into per-mille errors in the plan.
//
// Design, flash-attention-forward shaped:
//
//   * a block of 8 warps owns a strip of 32 query rows (4 per warp) and
//     streams candidate tiles of 128 columns (4 per lane) past it;
//   * the query strip stays in shared memory (transposed, k-major) for the
//     whole launch; each candidate tile is staged in chunks of 32 of d, and
//     each thread accumulates its 4×4 dot products in registers;
//   * each thread folds (g_j − C_ij)/τ of its columns into a running fp32
//     (max, sumexp) per row, so no cost, plan or exp tile reaches memory;
//     the 32 lanes' accumulators of a row are merged by shuffles at the end;
//   * the squared norms are inputs, computed once per solve by the caller;
//   * columns past C are masked out, and the -inf guards of the TPU kernel
//     are kept: a row whose running max is still -inf adds nothing, and an
//     all-masked row ends with lse = log(1e-38), as there.
//
// Known limit, for a later PR: ceil(4,500 / 32) = 141 blocks on 132 SMs is
// one uneven wave; splitting the candidate axis over blocks (with a merge
// of the partial (max, sumexp)) and a tensor-core product with a stated
// error budget are the next steps.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // 32 query rows per block
constexpr int kBC = 32 * 4;                 // 128 candidate columns per tile
constexpr int kKC = 32;                     // d staged in chunks of 32
constexpr int kLStride = kBQ + 4;           // padded, 16-byte aligned rows
constexpr int kRStride = kBC + 4;
constexpr unsigned kFull = 0xffffffffu;

// s·exp(m − m_new), with the -inf guard: an empty accumulator stays empty
__device__ __forceinline__ float rescale(float s, float m, float m_new) {
  return m == -INFINITY ? 0.f : s * expf(m - m_new);
}

__global__ void __launch_bounds__(kThreads)
sinkhorn_update_kernel(const float* __restrict__ l, const float* __restrict__ r,
                       const float* __restrict__ l2, const float* __restrict__ r2,
                       const float* __restrict__ g, const float* __restrict__ log_mu,
                       float tau, int n_q, int n_c, int d, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* l_s = smem;                          // [d_pad][kLStride]: l strip, k-major
  const int d_pad = (d + kKC - 1) / kKC * kKC;
  float* r_s = smem + d_pad * kLStride;       // [kKC][kRStride]: one chunk of a tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ;
  const int d4 = d / 4;

  // the block's query strip, once: float4 loads along d, stored k-major
  for (int i = tid; i < kBQ * (d_pad / 4); i += kThreads) {
    const int q = i / (d_pad / 4), kq = i % (d_pad / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + q < n_q && kq < d4)
      v = __ldg(reinterpret_cast<const float4*>(l + static_cast<long>(q0 + q) * d) + kq);
    l_s[(kq * 4 + 0) * kLStride + q] = v.x;
    l_s[(kq * 4 + 1) * kLStride + q] = v.y;
    l_s[(kq * 4 + 2) * kLStride + q] = v.z;
    l_s[(kq * 4 + 3) * kLStride + q] = v.w;
  }

  const int row_base = warp * kRowsPerWarp;  // this thread's rows, within the strip
  float ql2[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int q = q0 + row_base + i;
    ql2[i] = q < n_q ? __ldg(l2 + q) : 0.f;
  }
  float run_m[kRowsPerWarp], run_s[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    run_m[i] = -INFINITY;
    run_s[i] = 0.f;
  }

  for (int c0 = 0; c0 < n_c; c0 += kBC) {
    float acc[kRowsPerWarp][4] = {};
    for (int k0 = 0; k0 < d_pad; k0 += kKC) {
      __syncthreads();  // the strip is staged; the last chunk's reads are done
      for (int i = tid; i < kBC * (kKC / 4); i += kThreads) {
        const int c = i / (kKC / 4), kq = i % (kKC / 4);
        const int gk4 = k0 / 4 + kq;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c0 + c < n_c && gk4 < d4)
          v = __ldg(reinterpret_cast<const float4*>(r + static_cast<long>(c0 + c) * d) + gk4);
        r_s[(kq * 4 + 0) * kRStride + c] = v.x;
        r_s[(kq * 4 + 1) * kRStride + c] = v.y;
        r_s[(kq * 4 + 2) * kRStride + c] = v.z;
        r_s[(kq * 4 + 3) * kRStride + c] = v.w;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kKC; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(l_s + (k0 + kk) * kLStride + row_base);
        const float4 b = *reinterpret_cast<const float4*>(r_s + kk * kRStride + lane * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }

    // fold this tile's 4 columns per row into the running (max, sumexp)
    float z[kRowsPerWarp][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + lane * 4 + j;
      const bool valid = col < n_c;
      const float gj = valid ? __ldg(g + col) : 0.f;
      const float rj = valid ? __ldg(r2 + col) : 0.f;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float cost = fmaxf(ql2[i] + rj - 2.f * acc[i][j], 0.f);
        z[i][j] = valid ? (gj - cost) / tau : -INFINITY;
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float m_new =
          fmaxf(run_m[i], fmaxf(fmaxf(z[i][0], z[i][1]), fmaxf(z[i][2], z[i][3])));
      if (m_new == -INFINITY) continue;  // nothing valid in this row yet
      float s = rescale(run_s[i], run_m[i], m_new);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (z[i][j] != -INFINITY) s += expf(z[i][j] - m_new);
      run_m[i] = m_new;
      run_s[i] = s;
    }
  }

  // merge the 32 lanes' accumulators of each row, then write f
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    float m = run_m[i], s = run_s[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float m_o = __shfl_xor_sync(kFull, m, off);
      const float s_o = __shfl_xor_sync(kFull, s, off);
      const float m_n = fmaxf(m, m_o);
      if (m_n != -INFINITY) {
        s = rescale(s, m, m_n) + rescale(s_o, m_o, m_n);
        m = m_n;
      }
    }
    const int q = q0 + row_base + i;
    if (lane == 0 && q < n_q) {
      const float safe_m = isfinite(m) ? m : 0.f;
      const float lse = safe_m + logf(fmaxf(s, 1e-38f));
      out[q] = tau * (__ldg(log_mu + q) - lse);
    }
  }
}

}  // namespace

// f (n_q,) float32 from l (n_q, d), r (n_c, d), l2 = ‖l‖² (n_q,),
// r2 = ‖r‖² (n_c,), g (n_c,), log_mu (n_q,); all float32, contiguous, rows
// 16-byte aligned (d % 4 == 0).  Returns the launch's cudaError_t (0 on
// success); the work itself runs asynchronously on `stream`.
extern "C" int sinkhorn_update_forward(const float* l, const float* r, const float* l2,
                                       const float* r2, const float* g, const float* log_mu,
                                       float tau, int n_q, int n_c, int d, float* out,
                                       void* stream) {
  if (n_q <= 0) return cudaSuccess;
  if (d <= 0 || d % 4 != 0 || n_c <= 0) return cudaErrorInvalidValue;
  const int d_pad = (d + kKC - 1) / kKC * kKC;
  const size_t smem = sizeof(float) * (static_cast<size_t>(d_pad) * kLStride + kKC * kRStride);
  cudaError_t err = cudaFuncSetAttribute(sinkhorn_update_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (n_q + kBQ - 1) / kBQ;
  sinkhorn_update_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      l, r, l2, r2, g, log_mu, tau, n_q, n_c, d, out);
  return cudaGetLastError();
}
