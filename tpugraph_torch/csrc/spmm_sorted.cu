// Sorted-segment SpMM for Hopper (sm_90a): out[i] = Σ_{e: dst[e]=i} w[e]·x[src[e]]
// over a (dst, src)-sorted padded edge list, x float32 or bfloat16, d = 128
// or 256, fp32 accumulation and one rounding to x's type at the end.
//
// Replaces the XLA ops of tpugraph/kernels/spmm.py::_segment_spmm (a gather,
// a multiply and a sorted segment_sum); no Pallas kernel exists for it.
// The layers of spmm_impl "sorted" run it twice per layer and step: forward
// over op.fwd, backward over op.bwd (the same edges sorted for Aᵀ).
//
// What bounds it on an H100: bytes.  It must read x, the real edges' (src,
// w) and the row table, and write out (≈ 43 MB for the zh-en adjacency at
// d = 128 in fp32, ≈ 13 µs at 3.35 TB/s); its arithmetic, 2 operations per
// edge and column, is ≈ 1 µs of fp32.  What a kernel actually pays is the
// gather: every edge reads one full row of x, which the 50 MB L2 mostly
// serves, so the time is set by the row loads in flight and by the longest
// row's chain of dependent loads.
//
// Design (the simple one; ROADMAP keeps the redesign): one warp per output
// row, rows taken heaviest first from the host's row table
// (kernels/spmm.py::row_plan: a row pointer over the sorted dst, built
// once per edge list, and the rows ordered by degree), so the hub rows
// start first and overlap the rest.  A warp loads 32 edges' (src, w), one
// per lane, and broadcasts them by shuffles; 8 source rows (4 at d = 256)
// are in flight, each one coalesced 16-byte (fp32) or 8-byte (bf16) load
// per lane.  Each lane sums its columns in edge order, so the result is
// the same from run to run, with no atomics and no zero fill; every row is
// written once, the dump row (the padding's) never.  A hub row's edges
// are one warp's serial chain (the zh-en adjacency's longest row holds
// 3,734 edges): its time is measured beside the bound in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_gather.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
using ell::kFull;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
spmm_sorted_kernel(const T* __restrict__ x, const int* __restrict__ src,
                   const float* __restrict__ ew, const int* __restrict__ rowptr,
                   const int* __restrict__ order, int n_rows, T* __restrict__ out) {
  constexpr int CI = D / 128;
  constexpr int U = 8 / CI;  // source rows in flight per warp
  const int lane = threadIdx.x & 31;
  const int slot = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (slot >= n_rows) return;
  const int row = __ldg(order + slot);
  const int e0 = __ldg(rowptr + row), e1 = __ldg(rowptr + row + 1);
  float acc[CI][4] = {};
  for (int base = e0; base < e1; base += 32) {
    int my_src = 0;
    float my_w = 0.f;
    if (base + lane < e1) {
      my_src = __ldg(src + base + lane);
      my_w = __ldg(ew + base + lane);
    }
    const int n = min(32, e1 - base);
    for (int j = 0; j < n; j += U) {
      float v[U][CI][4];
      float wj[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int s = __shfl_sync(kFull, my_src, j + u);
        wj[u] = __shfl_sync(kFull, my_w, j + u);
        if (j + u < n) {
#pragma unroll
          for (int c = 0; c < CI; ++c)
            ell::load4(x + static_cast<long>(s) * D + c * 128 + lane * 4, v[u][c]);
        } else {
          wj[u] = 0.f;
#pragma unroll
          for (int c = 0; c < CI; ++c) v[u][c][0] = v[u][c][1] = v[u][c][2] = v[u][c][3] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j + u >= n) break;
#pragma unroll
        for (int c = 0; c < CI; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[c][e] = fmaf(wj[u], v[u][c][e], acc[c][e]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < CI; ++c)
    ell::store4(out + static_cast<long>(row) * D + c * 128 + lane * 4, acc[c]);
}

template <typename T, int D>
cudaError_t launch(const void* x, const int* src, const float* ew, const int* rowptr,
                   const int* order, int n_rows, void* out, cudaStream_t stream) {
  const int grid = (n_rows + kWarps - 1) / kWarps;
  spmm_sorted_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), src, ew, rowptr, order, n_rows, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// out (n_rows, d) of x's type = the sorted-segment product.  rowptr
// (n_rows + 1) int32: row i's edges are [rowptr[i], rowptr[i + 1]); order
// (n_rows) int32: the rows, heaviest first.  d is 128 or 256; dtype 0 is
// float32, 1 bfloat16.  One kernel launch; returns its cudaError_t (0 on
// success), and the work itself runs asynchronously on `stream`.
extern "C" int spmm_sorted_forward(const void* x, const int* src, const float* ew,
                                   const int* rowptr, const int* order, int n_rows, void* out,
                                   int d, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows <= 0) return cudaSuccess;
  if (dtype == 0 && d == 128)
    return launch<float, 128>(x, src, ew, rowptr, order, n_rows, out, s);
  if (dtype == 0 && d == 256)
    return launch<float, 256>(x, src, ew, rowptr, order, n_rows, out, s);
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128>(x, src, ew, rowptr, order, n_rows, out, s);
  if (dtype == 1 && d == 256)
    return launch<__nv_bfloat16, 256>(x, src, ew, rowptr, order, n_rows, out, s);
  return cudaErrorInvalidValue;
}
