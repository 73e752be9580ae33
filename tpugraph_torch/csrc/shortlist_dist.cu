// Gathered shortlist distances for Hopper (sm_90a):
//
//     out[i, j] = Σ_c f(q[i, c] − table[idx[i, j], c]),  f = |·| or (·)²
//
// q (S, d) fp32, table (C, d) fp32, idx (S, K) int64, out (S, K) fp32.
//
// Replaces the XLA ops of the JAX package's approximate search paths: the
// gather of each query's shortlisted rows into a (block_q, K, d) tensor and
// its L1 (or squared) reduction, at tpugraph/train/negatives.py:179-180
// (the hubness terms) and :261-262 (the mining rerank),
// train/bootstrap.py:132-137 (the proposals' rerank), train/eval.py:158-159
// (the prefiltered ranks) and serve.py:87-88 (the prefiltered top-k).
// Plain torch builds that tensor: 839 MB per 4,096-query block when mining
// at zh-en scale (K = 200, d = 256).  This kernel never stores it.
//
// What bounds it on an H100: the bytes it must move are q, idx and out once
// and the table once (~44 MB for the zh-en mining shortlist: 7,000 × 200 at
// d = 256 over a 19,000-row table), ~13 µs at 3.35 TB/s; its arithmetic,
// 3 operations per term, is ~16 µs of fp32.  What a kernel pays is the
// gather: every shortlist entry reads one full table row (1 KB at d = 256,
// 1.43 GB for that shortlist), which the 50 MB L2 mostly serves, because
// the table (19.5 MB) fits in it.  So the time is set by how many row loads
// are in flight.
//
// Design (a first, simple one):
//   * one warp per query row; the row's K entries in chunks of 32: each
//     lane loads one entry's index, and the warp takes them kUnroll at a
//     time by shuffles, so kUnroll table rows are in flight per warp;
//   * lanes stride over the width in float4 loads (plain float loads when
//     d % 4 != 0 or a base pointer is not 16-byte aligned), so a warp reads
//     512 contiguous bytes of a row at a time; the query row is re-read from
//     L1 for every group of entries;
//   * each lane keeps kUnroll partial sums; a butterfly of shuffles sums
//     them across the warp, and lane u writes entry u.  Every sum runs in a
//     fixed order, so two launches agree bit for bit;
//   * no shared memory, no atomics, no scratch.  Indices are trusted to lie
//     in [0, C): the callers take them from a top-k over the table.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // table rows in flight per warp
constexpr unsigned kFull = 0xffffffffu;

template <bool kSq>
__device__ __forceinline__ float term(float a, float b) {
  const float t = a - b;
  return kSq ? t * t : fabsf(t);
}

template <bool kSq>
__device__ __forceinline__ float terms(float a, float b) {
  return term<kSq>(a, b);
}

template <bool kSq>
__device__ __forceinline__ float terms(float4 a, float4 b) {
  return ((term<kSq>(a.x, b.x) + term<kSq>(a.y, b.y)) + term<kSq>(a.z, b.z)) +
         term<kSq>(a.w, b.w);
}

// Vec is float4 (d % 4 == 0, aligned) or float; dv = d / (width of Vec)
template <bool kSq, typename Vec>
__global__ void __launch_bounds__(kThreads)
shortlist_dist_kernel(const float* __restrict__ q, const float* __restrict__ table,
                      const long long* __restrict__ idx, float* __restrict__ out, int s, int k,
                      int dv) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= s) return;  // warp-uniform: one row per warp
  const Vec* qrow = reinterpret_cast<const Vec*>(q) + static_cast<size_t>(row) * dv;
  const Vec* tab = reinterpret_cast<const Vec*>(table);
  const long long* irow = idx + static_cast<size_t>(row) * k;
  float* orow = out + static_cast<size_t>(row) * k;
  for (int j0 = 0; j0 < k; j0 += 32) {
    const int n = min(32, k - j0);
    const long long mine = lane < n ? __ldg(irow + j0 + lane) : 0;
    for (int u0 = 0; u0 < n; u0 += kUnroll) {
      const Vec* trow[kUnroll];
      float acc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        // entries past the chunk's end repeat its last one and are not written
        const long long t = __shfl_sync(kFull, mine, min(u0 + u, n - 1));
        trow[u] = tab + static_cast<size_t>(t) * dv;
        acc[u] = 0.f;
      }
      for (int c = lane; c < dv; c += 32) {
        const Vec a = __ldg(qrow + c);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc[u] += terms<kSq>(a, __ldg(trow[u] + c));
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) acc[u] += __shfl_xor_sync(kFull, acc[u], off);
      }
      float mine_out = acc[0];
#pragma unroll
      for (int u = 1; u < kUnroll; ++u) mine_out = lane == u ? acc[u] : mine_out;
      if (lane < kUnroll && u0 + lane < n) orow[j0 + u0 + lane] = mine_out;
    }
  }
}

template <bool kSq>
int launch(const float* q, const float* table, const long long* idx, float* out, int s, int k,
           int d, cudaStream_t stream) {
  const dim3 grid((s + kWarps - 1) / kWarps);
  const bool vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(table) % 16 == 0;
  if (vec4)
    shortlist_dist_kernel<kSq, float4><<<grid, kThreads, 0, stream>>>(q, table, idx, out, s, k,
                                                                      d / 4);
  else
    shortlist_dist_kernel<kSq, float><<<grid, kThreads, 0, stream>>>(q, table, idx, out, s, k, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// sq = 0: cityblock (Σ|·|); sq = 1: sqeuclidean (Σ(·)²).  Returns the CUDA
// error of the launch (0 = success).
extern "C" int shortlist_dist_forward(const float* q, const float* table, const long long* idx,
                                      float* out, int s, int k, int d, int sq, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s <= 0 || k <= 0) return cudaSuccess;
  if (d < 0) return cudaErrorInvalidValue;  // d = 0 writes zeros
  return sq ? launch<true>(q, table, idx, out, s, k, d, st)
            : launch<false>(q, table, idx, out, s, k, d, st);
}
