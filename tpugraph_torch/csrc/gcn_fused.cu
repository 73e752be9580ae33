// Fused GCN layer for Hopper (sm_90a): out = (A·x)·W + b over a
// degree-bucketed ELL operator with the diagonal split out.
//
// Replaces tpugraph/kernels/gcn_fused_pallas.py::_bucket_kernel (and its
// wrapper fused_gcn_layer).  Per row r of the layer:
//
//     acc[r]  = Σ_k w[r,k] · x[idx[r,k]]  +  diag[r] · x[r]      (fp32)
//     out[r]  = acc[r] · W + b                                   (cast once)
//
// What bounds it on an H100: the data the function must move is x, out
// and the ELL arrays (~42 MB at zh-en scale, ~12 µs at 3.35 TB/s); its
// arithmetic is the N×d_in×d_out GEMM in fp32 SIMT (~19 µs at 67 TFLOP/s).
// What a straightforward kernel actually pays is the gather: every ELL
// slot reads one full source row of x (307k slots × 512 B ≈ 157 MB per
// layer at zh-en scale), which the 50 MB L2 mostly serves because x
// (19.5 MB) fits in it.  So the design keeps gathered rows in flight and
// never writes the aggregate to device memory:
//
//   * One launch covers every bucket.  The host builds a tile table
//     (row_start, n_rows, K, slot_start) sorted heaviest first; persistent
//     blocks take tiles from an atomic counter, so the few rows with K in
//     the thousands start first and do not trail the launch.
//   * Aggregation: one warp per row (or, for tiles of fewer than 8 rows —
//     the high-K buckets — the row's K range split over several warps and
//     summed in a fixed order in shared memory).  Lanes load 32 (idx, w)
//     pairs at once and broadcast them with shuffles; each source row is one
//     coalesced 16-byte-per-lane load, 8 rows in flight per warp.  K runs in
//     chunks of 32, so nothing is sized by K.
//   * The diagonal is one more slot whose source is the row itself.  Rows
//     with no off-diagonal edge form K = 0 tiles, so every output row is
//     written exactly once, straight to its natural position through the
//     bucket's `rows`: no atomics, no row_order gather.
//   * The (≤32 × d_in) fp32 aggregate stays in shared memory and meets W
//     (staged once per block as fp32) in a register-tiled SIMT product;
//     bias is added and the result cast to x's type on the way out.
//
// bf16 x/W gather in bf16, accumulate in fp32 and cast once at the end, as
// the TPU kernel does.  wgmma/TMA for the GEMM and a split of the longest
// rows over several blocks are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "ell_gather.cuh"

namespace {

using ell::add_diag;
using ell::gather_slots;
using ell::put_row;
using ell::store4;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 32;   // rows per tile at most (host plan agrees)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int D_IN, int D_OUT>
__global__ void __launch_bounds__(kThreads)
gcn_fused_kernel(const T* __restrict__ x, const T* __restrict__ wmat,
                 const float* __restrict__ bias, const float* __restrict__ diag,
                 const int* __restrict__ rows, const int* __restrict__ idx,
                 const float* __restrict__ ew, const int4* __restrict__ tiles,
                 int n_tiles, int* __restrict__ counter, T* __restrict__ out) {
  constexpr int CI = D_IN / 128;
  constexpr int CO = D_OUT / 128;
  constexpr int RPT = kTileRows / kWarps;  // GEMM rows per thread
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // [D_IN][D_OUT]
  float* a_s = w_s + D_IN * D_OUT;               // [kTileRows][D_IN]
  float* p_s = a_s + kTileRows * D_IN;           // [kWarps][D_IN] split-K partials
  __shared__ int s_tile;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < D_IN * D_OUT; i += kThreads) w_s[i] = to_f32(wmat[i]);
  float bv[CO][4];
#pragma unroll
  for (int c = 0; c < CO; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) bv[c][e] = bias ? __ldg(bias + c * 128 + lane * 4 + e) : 0.f;

  while (true) {
    if (tid == 0) s_tile = atomicAdd(counter, 1);
    __syncthreads();  // publishes s_tile; W staged; last tile's a_s reads done
    const int t = s_tile;
    if (t >= n_tiles) break;
    const int4 td = tiles[t];
    const int row0 = td.x, nrows = td.y, k = td.z;
    const long slot0 = td.w;

    // ---- phase 1: aggregate the tile's rows into a_s (fp32) ----
    if (nrows >= kWarps) {
      for (int r = warp; r < nrows; r += kWarps) {
        float acc[CI][4] = {};
        const int row = __ldg(rows + row0 + r);
        gather_slots<T, D_IN>(x, idx, ew, slot0 + static_cast<long>(r) * k,
                              slot0 + static_cast<long>(r + 1) * k, lane, acc);
        add_diag<T, D_IN>(x, diag, row, lane, acc);
        put_row<D_IN>(a_s + r * D_IN, lane, acc);
      }
    } else {
      // few long rows: split each row's K range over wpr warps
      const int wpr = kWarps / nrows;
      const int r = warp / wpr, part = warp % wpr;
      if (r < nrows) {
        float acc[CI][4] = {};
        const int row = __ldg(rows + row0 + r);
        const int chunk = (k + wpr - 1) / wpr;
        const int s = min(k, part * chunk), e = min(k, s + chunk);
        const long rbase = slot0 + static_cast<long>(r) * k;
        gather_slots<T, D_IN>(x, idx, ew, rbase + s, rbase + e, lane, acc);
        if (part == 0) add_diag<T, D_IN>(x, diag, row, lane, acc);
        put_row<D_IN>(p_s + warp * D_IN, lane, acc);
      }
      __syncthreads();
      for (int i = tid; i < nrows * D_IN; i += kThreads) {
        const int rr = i / D_IN, col = i % D_IN;
        float sum = 0.f;
        for (int p = 0; p < wpr; ++p) sum += p_s[(rr * wpr + p) * D_IN + col];
        a_s[rr * D_IN + col] = sum;
      }
    }
    __syncthreads();

    // ---- phase 2: out[rows] = a_s · W + b, 4-column vectors per thread ----
    float acc2[RPT][CO][4] = {};
    for (int kk = 0; kk < D_IN; ++kk) {
      float a[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = a_s[(warp + i * kWarps) * D_IN + kk];
#pragma unroll
      for (int c = 0; c < CO; ++c) {
        const float4 b = *reinterpret_cast<const float4*>(w_s + kk * D_OUT + c * 128 + lane * 4);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          acc2[i][c][0] = fmaf(a[i], b.x, acc2[i][c][0]);
          acc2[i][c][1] = fmaf(a[i], b.y, acc2[i][c][1]);
          acc2[i][c][2] = fmaf(a[i], b.z, acc2[i][c][2]);
          acc2[i][c][3] = fmaf(a[i], b.w, acc2[i][c][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = warp + i * kWarps;
      if (r >= nrows) continue;
      const long orow = __ldg(rows + row0 + r);
#pragma unroll
      for (int c = 0; c < CO; ++c) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = acc2[i][c][e] + bv[c][e];
        store4(out + orow * D_OUT + c * 128 + lane * 4, v);
      }
    }
  }
}

template <typename T, int D_IN, int D_OUT>
cudaError_t launch(const void* x, const void* wmat, const float* bias, const float* diag,
                   const int* rows, const int* idx, const float* ew, const int* tiles,
                   int n_tiles, int* counter, void* out, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * (D_IN * D_OUT + kTileRows * D_IN + kWarps * D_IN);
  auto kern = gcn_fused_kernel<T, D_IN, D_OUT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem)) !=
      cudaSuccess)
    return err;
  const int grid = std::max(1, std::min(n_tiles, n_sm * std::max(per_sm, 1)));
  if ((err = cudaMemsetAsync(counter, 0, sizeof(int), stream)) != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wmat), bias, diag, rows, idx, ew,
      reinterpret_cast<const int4*>(tiles), n_tiles, counter, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d_in, int d_out, const void* x, const void* wmat, const float* bias,
                     const float* diag, const int* rows, const int* idx, const float* ew,
                     const int* tiles, int n_tiles, int* counter, void* out,
                     cudaStream_t stream) {
  if (d_in == 128 && d_out == 128)
    return launch<T, 128, 128>(x, wmat, bias, diag, rows, idx, ew, tiles, n_tiles, counter, out, stream);
  if (d_in == 128 && d_out == 256)
    return launch<T, 128, 256>(x, wmat, bias, diag, rows, idx, ew, tiles, n_tiles, counter, out, stream);
  if (d_in == 256 && d_out == 128)
    return launch<T, 256, 128>(x, wmat, bias, diag, rows, idx, ew, tiles, n_tiles, counter, out, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  bias and diag may be null.  Returns the
// launch's cudaError_t (0 on success); the work itself runs asynchronously on
// `stream`.
extern "C" int gcn_fused_forward(const void* x, const void* wmat, const float* bias,
                                 const float* diag, const int* rows, const int* idx,
                                 const float* ew, const int* tiles, int n_tiles, int* counter,
                                 void* out, int d_in, int d_out, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles <= 0) return cudaSuccess;
  if (dtype == 0)
    return dispatch<float>(d_in, d_out, x, wmat, bias, diag, rows, idx, ew, tiles, n_tiles,
                           counter, out, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(d_in, d_out, x, wmat, bias, diag, rows, idx, ew, tiles,
                                   n_tiles, counter, out, s);
  return cudaErrorInvalidValue;
}
