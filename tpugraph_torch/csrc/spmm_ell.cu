// ELL SpMM for Hopper (sm_90a): out = A·x + diag ⊙ x over a degree-bucketed
// ELL matrix, fp32, written straight to natural row order.
//
// Replaces the XLA ops of tpugraph/kernels/spmm_ell.py::_ell_apply and
// _apply_with_diag (the bucket gathers + K reduction + row_order gather).
// The training path runs it once per GCN layer in the backward, on the
// prebuilt transpose A^T (op.bwd), to form u = A^T·ḡ.
//
// What bounds it on an H100: the bytes it must move are x, out, diag and
// the ELL arrays (~42 MB for the zh-en transpose at d = 128, ~12 µs at
// 3.35 TB/s); its arithmetic, 2 operations per edge and column, is ~1 µs
// of fp32.  So it is bytes-bound, and what a kernel actually pays is the
// gather: every ELL slot reads one full row of x (512 B at d = 128), which
// the 50 MB L2 mostly serves because x (19.5 MB) fits in it.  The design is
// the gather half of gcn_fused.cu without the GEMM:
//
//   * one launch covers every bucket: persistent blocks take tiles of the
//     host's heaviest-first table (kernels/gcn_fused.py::fused_plan, the
//     same table the fused layer walks) from an atomic counter;
//   * one warp per row, 32 slots per chunk broadcast by shuffles, 8 source
//     rows in flight (csrc/ell_gather.cuh); a tile of fewer than 8 rows —
//     the high-K buckets — splits each row's K range over several warps and
//     sums the partials in a fixed order in shared memory;
//   * rows in no bucket are K = 0 tiles (diag·x, or 0 without a diagonal),
//     so every output row is written exactly once: no atomics on out, no
//     zero fill, no row_order gather.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "ell_gather.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int D>
__global__ void __launch_bounds__(kThreads)
spmm_ell_kernel(const float* __restrict__ x, const float* __restrict__ diag,
                const int* __restrict__ rows, const int* __restrict__ idx,
                const float* __restrict__ ew, const int4* __restrict__ tiles, int n_tiles,
                int* __restrict__ counter, float* __restrict__ out) {
  __shared__ __align__(16) float p_s[kWarps * D];  // split-K partials
  __shared__ int s_tile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  while (true) {
    if (tid == 0) s_tile = atomicAdd(counter, 1);
    __syncthreads();  // publishes s_tile
    const int t = s_tile;
    if (t >= n_tiles) break;
    const int4 td = tiles[t];
    const int row0 = td.x, nrows = td.y, k = td.z;
    const long slot0 = td.w;

    if (nrows >= kWarps) {
      for (int r = warp; r < nrows; r += kWarps) {
        float acc[D / 128][4] = {};
        const int row = __ldg(rows + row0 + r);
        ell::gather_slots<float, D>(x, idx, ew, slot0 + static_cast<long>(r) * k,
                                    slot0 + static_cast<long>(r + 1) * k, lane, acc);
        ell::add_diag<float, D>(x, diag, row, lane, acc);
        ell::put_row<D>(out + static_cast<long>(row) * D, lane, acc);
      }
    } else {
      // few long rows: split each row's K range over wpr warps
      const int wpr = kWarps / nrows;
      const int r = warp / wpr, part = warp % wpr;
      if (r < nrows) {
        float acc[D / 128][4] = {};
        const int row = __ldg(rows + row0 + r);
        const int chunk = (k + wpr - 1) / wpr;
        const int s = min(k, part * chunk), e = min(k, s + chunk);
        const long rbase = slot0 + static_cast<long>(r) * k;
        ell::gather_slots<float, D>(x, idx, ew, rbase + s, rbase + e, lane, acc);
        if (part == 0) ell::add_diag<float, D>(x, diag, row, lane, acc);
        ell::put_row<D>(p_s + warp * D, lane, acc);
      }
      __syncthreads();
      for (int i = tid; i < nrows * D; i += kThreads) {
        const int rr = i / D, col = i % D;
        float sum = 0.f;
        for (int p = 0; p < wpr; ++p) sum += p_s[(rr * wpr + p) * D + col];
        out[static_cast<long>(__ldg(rows + row0 + rr)) * D + col] = sum;
      }
    }
    __syncthreads();  // every thread has read s_tile and p_s before the next tile
  }
}

template <int D>
cudaError_t launch(const float* x, const float* diag, const int* rows, const int* idx,
                   const float* ew, const int* tiles, int n_tiles, int* counter, float* out,
                   cudaStream_t stream) {
  auto kern = spmm_ell_kernel<D>;
  cudaError_t err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, 0)) !=
      cudaSuccess)
    return err;
  const int grid = std::max(1, std::min(n_tiles, n_sm * std::max(per_sm, 1)));
  if ((err = cudaMemsetAsync(counter, 0, sizeof(int), stream)) != cudaSuccess) return err;
  kern<<<grid, kThreads, 0, stream>>>(x, diag, rows, idx, ew,
                                      reinterpret_cast<const int4*>(tiles), n_tiles, counter,
                                      out);
  return cudaGetLastError();
}

}  // namespace

// out (n_rows, d) float32 = A·x + diag ⊙ x.  diag may be null.  d is 128 or
// 256.  Returns the launch's cudaError_t (0 on success); the work itself
// runs asynchronously on `stream`.
extern "C" int spmm_ell_forward(const float* x, const float* diag, const int* rows,
                                const int* idx, const float* ew, const int* tiles, int n_tiles,
                                int* counter, float* out, int d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles <= 0) return cudaSuccess;
  if (d == 128) return launch<128>(x, diag, rows, idx, ew, tiles, n_tiles, counter, out, s);
  if (d == 256) return launch<256>(x, diag, rows, idx, ew, tiles, n_tiles, counter, out, s);
  return cudaErrorInvalidValue;
}
