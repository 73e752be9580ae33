// The reverse of one log-domain Sinkhorn potential update for Hopper
// (sm_90a), over one block of a materialised cost C and its cotangent C̄:
//
//     rows    (an f-update over the block's rows):
//             P_ij = exp((b_j − C_ij)/τ − lse_i),  C̄_ij += ō_i·P_ij,
//             b̄_j = −Σ_i ō_i·P_ij
//     columns (a g-update over its columns):
//             P_ij = exp((b_i − C_ij)/τ − lse_j),  C̄_ij += ō_j·P_ij,
//             b̄_i = −Σ_j ō_j·P_ij
//
// with lse the update's saved log-sum-exp (log m − out/τ).  The block is a
// (Q, C) slice of row stride ld (the ring passes a column slice of a
// rank's rows); C̄ has the same layout and is updated in place.
//
// It replaces no TPU kernel.  It replaces the XLA autodiff of the unrolled
// solver (tpugraph/train/ot.py:24-41, tpugraph/dist/ring.py:432: the
// reverse of each scan step), which the port ran as a chain of torch
// elementwise passes over the S × S block (train/ot.py::_reverse_update,
// dist/ring.py's rows_rev and cols_rev).
//
// What bounds it on an H100: bytes.  Per element it reads C and C̄ and
// writes C̄ (12 bytes; 243 MB at S = 4,500, ≈ 0.073 ms at 3.35 TB/s) and
// does one exp; the partial sums add Q·C/32 or Q·C/256 floats.  41 updates
// a step at n_iters 20.
//
// Design: one thread a column of a 32-row × 256-column tile, so each row
// of the tile is one coalesced 1 KB read of C and of C̄; the tile's row
// values (lse and ō, or b) are staged in shared memory.  The elementwise
// steps are torch's, in its order and rounding ((b − C)/τ − lse, expf, ×ō,
// then C̄ + t), so C̄ agrees with the plain version to an ulp or two of
// exp.  b̄ is reduced in a fixed order with no atomics: rows mode, each
// thread sums its column over the tile's 32 rows; columns mode, each row of
// the tile is summed over its 256 columns by a warp butterfly and then the
// 8 warps in order.  Each tile writes its partial sums to scratch, and a
// second launch adds the tiles' partials of each entry in tile order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTQ = 32;        // rows a tile
constexpr int kTC = 256;       // columns a tile: one a thread
constexpr int kWarps = kTC / 32;
constexpr int kUnroll = 8;     // rows whose loads a thread keeps in flight
constexpr unsigned kFull = 0xffffffffu;

template <bool kRows>
__global__ void __launch_bounds__(kTC)
sinkhorn_reverse_kernel(const float* __restrict__ cost, float* __restrict__ cbar, long ld,
                        int n_q, int n_c, const float* __restrict__ b,
                        const float* __restrict__ lse, const float* __restrict__ obar,
                        float tau, float* __restrict__ partial) {
  __shared__ float s_a[kTQ], s_o[kTQ];  // the tile's rows: (lse, ō) or (b, –)
  __shared__ float s_red[kTQ][kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = blockIdx.x * kTC + tid;
  const int i0 = blockIdx.y * kTQ;
  const int rows = min(kTQ, n_q - i0);
  if (tid < rows) {
    if constexpr (kRows) {
      s_a[tid] = lse[i0 + tid];
      s_o[tid] = obar[i0 + tid];
    } else {
      s_a[tid] = b[i0 + tid];
    }
  }
  __syncthreads();
  const bool valid = j < n_c;
  // the column's values: b_j (rows), or lse_j and ō_j (columns)
  const float cb = valid && kRows ? b[j] : 0.f;
  const float cl = valid && !kRows ? lse[j] : 0.f;
  const float co = valid && !kRows ? obar[j] : 0.f;
  const float* cp = cost + static_cast<long>(i0) * ld + j;
  float* bp = cbar + static_cast<long>(i0) * ld + j;
  float col = 0.f;
  for (int r0 = 0; r0 < kTQ; r0 += kUnroll) {
    float c[kUnroll], cv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool in = valid && r0 + u < rows;
      c[u] = in ? __ldg(cp + (r0 + u) * ld) : 0.f;
      cv[u] = in ? bp[(r0 + u) * ld] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u;
      float t = 0.f;
      if (valid && r < rows) {
        // torch's steps, each rounded (no fused multiply-add)
        if constexpr (kRows) {
          t = __fmul_rn(expf(__fsub_rn(__fdiv_rn(__fsub_rn(cb, c[u]), tau), s_a[r])), s_o[r]);
        } else {
          t = __fmul_rn(expf(__fsub_rn(__fdiv_rn(__fsub_rn(s_a[r], c[u]), tau), cl)), co);
        }
        bp[r * ld] = __fadd_rn(cv[u], t);
      }
      if constexpr (kRows) {
        col += t;
      } else {
        float s = t;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
        if (lane == 0) s_red[r][warp] = s;
      }
    }
  }
  if constexpr (kRows) {
    if (valid) partial[static_cast<long>(blockIdx.y) * n_c + j] = col;
  } else {
    __syncthreads();
    if (tid < rows) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += s_red[tid][w];
      partial[static_cast<long>(blockIdx.x) * n_q + i0 + tid] = s;
    }
  }
}

// out[x] = −Σ_t partial[t][x] over the n_tiles tiles, in tile order
__global__ void __launch_bounds__(256)
sinkhorn_reverse_sum(const float* __restrict__ partial, int n_tiles, int n_out,
                     float* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= n_out) return;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += partial[static_cast<long>(t) * n_out + x];
  out[x] = -s;
}

}  // namespace

// cost, cbar: (n_q, n_c) float32 of row stride ld (elements); b, lse, obar
// float32: rows mode (rows != 0) b (n_c,), lse and obar (n_q,), out (n_c,);
// columns mode b (n_q,), lse and obar (n_c,), out (n_q,).  partial is
// float32 scratch of (tiles along the reduced axis: ceil(n_q / 32) rows
// mode, ceil(n_c / 256) columns) × (out's length).
// Adds ō⊙P to cbar in place and writes out = b̄.  Two kernel launches;
// returns the cudaError_t (0 on success).
extern "C" int sinkhorn_reverse_forward(const float* cost, float* cbar, long ld, int n_q,
                                        int n_c, const float* b, const float* lse,
                                        const float* obar, float tau, int rows,
                                        float* partial, float* out, void* stream) {
  if (n_q <= 0 || n_c <= 0 || ld < n_c) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_c + kTC - 1) / kTC, (n_q + kTQ - 1) / kTQ);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if (rows)
    sinkhorn_reverse_kernel<true><<<grid, kTC, 0, s>>>(cost, cbar, ld, n_q, n_c, b, lse, obar,
                                                       tau, partial);
  else
    sinkhorn_reverse_kernel<false><<<grid, kTC, 0, s>>>(cost, cbar, ld, n_q, n_c, b, lse, obar,
                                                        tau, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_out = rows ? n_c : n_q;
  const int n_tiles = rows ? static_cast<int>(grid.y) : static_cast<int>(grid.x);
  sinkhorn_reverse_sum<<<(n_out + 255) / 256, 256, 0, s>>>(partial, n_tiles, n_out, out);
  return cudaGetLastError();
}
