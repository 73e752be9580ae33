// The gather walk shared by gcn_fused.cu, spmm_ell.cu and spmm_sorted.cu:
// one warp accumulates rows of A·x in registers, 4 columns per lane per
// 128-column chunk (D = 128, 256; at D = 64, a tensor-parallel rank's half
// of a 128-wide layer, 2 columns per lane in one 64-column chunk), walking a work item's slots (walk_slots) 32 at a time,
// across row boundaries, so a run of short rows keeps 8 source rows in
// flight; a finished row goes to the caller's sink.  The ELL kernels walk
// a run of whole rows of one bucket (or one segment of a long row) as
// "virtual slots" (walk_vslots): each row's K ELL slots, then one for the
// split-out diagonal (source the row itself, weight diag[row]).  The sorted
// kernel walks a range of its edge list, keyed by each edge's dst.
//
// Each lane loads one slot's (idx, w) and the warp broadcasts them with
// shuffles, so a row of any K (up to the 3,734 of the zh-en hubs) needs no
// shared memory sized by K.  Each source row is one coalesced load, 16
// bytes per lane in fp32 (8 at D = 64).  Pad slots (idx 0, w 0) read row 0
// and add 0·x[0].

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace ell {

constexpr unsigned kFull = 0xffffffffu;

// A row of D columns as kChunks<D> chunks of kCols<D>, kVec<D> columns per
// lane: 128-column chunks of 4 at D >= 128, one 64-column chunk of 2 at 64.
// The accumulators keep 4 floats per chunk; at D = 64 two are unused.
template <int D>
constexpr int kChunks = D >= 128 ? D / 128 : 1;
template <int D>
constexpr int kVec = D >= 128 ? 4 : D / 32;
template <int D>
constexpr int kCols = 32 * kVec<D>;

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &t.x, 4);
  memcpy(&hi, &t.y, 4);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void load2(const float* p, float v[4]) {
  const float2 t = __ldg(reinterpret_cast<const float2*>(p));
  v[0] = t.x; v[1] = t.y;
}

__device__ __forceinline__ void load2(const __nv_bfloat16* p, float v[4]) {
  const unsigned t = __ldg(reinterpret_cast<const unsigned*>(p));
  __nv_bfloat162 lo;
  memcpy(&lo, &t, 4);
  const float2 a = __bfloat1622float2(lo);
  v[0] = a.x; v[1] = a.y;
}

// kVec<D> columns of one lane: 4 or 2
template <int D, typename T>
__device__ __forceinline__ void load_vec(const T* p, float v[4]) {
  if constexpr (kVec<D> == 4) load4(p, v); else load2(p, v);
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  memcpy(&t.x, &lo, 4);
  memcpy(&t.y, &hi, 4);
  *reinterpret_cast<uint2*>(p) = t;
}

__device__ __forceinline__ void store2(float* p, const float v[4]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, const float v[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  unsigned t;
  memcpy(&t, &lo, 4);
  *reinterpret_cast<unsigned*>(p) = t;
}

template <int D, typename T>
__device__ __forceinline__ void store_vec(T* p, const float v[4]) {
  if constexpr (kVec<D> == 4) store4(p, v); else store2(p, v);
}

// Virtual slot v of a run of rows that starts at rows[pos0], with K ELL
// slots each from slot0: ELL slot k < K of local row r = v / (K + 1), or,
// for k == K, the row's diagonal.  src < 0 means nothing to gather (past
// v1, or no diagonal).  `key` names the row: its natural id (kNatural), or
// its local index r, and then rows[] is read only for the diagonal slot.
template <bool kNatural>
__device__ __forceinline__ void load_vslot(int v, int v1, int pos0, int k_row, long slot0,
                                           const int* __restrict__ rows,
                                           const int* __restrict__ idx,
                                           const float* __restrict__ ew,
                                           const float* __restrict__ diag, int& src, float& w,
                                           int& key) {
  src = -1;
  w = 0.f;
  key = -1;
  if (v >= v1) return;
  const int kp = k_row + 1, r = v / kp, k = v - r * kp;
  const int row = kNatural ? __ldg(rows + pos0 + r) : -1;
  key = kNatural ? row : r;
  if (k < k_row) {
    const long s = slot0 + static_cast<long>(r) * k_row + k;
    src = __ldg(idx + s);
    w = __ldg(ew + s);
  } else if (diag != nullptr) {
    src = kNatural ? row : __ldg(rows + pos0 + r);
    w = __ldg(diag + src);
  }
}

// The slots [v0, v1) of a work item, 32 at a time: each lane loads one
// slot's (source, weight, key) by load(v, src, w, key), which gives src < 0
// for nothing to gather (v ≥ v1 among them); the warp broadcasts them by
// shuffles, and the next 32 load before this chunk's gathers start, so that
// load is off the critical path.  U source rows are in flight per warp: by
// default 8 (4 at D = 256).  When the key changes, sink(key, acc) takes the finished
// row and acc restarts at 0; on return acc holds the last row, whose key is
// `cur` (-1 if the item had no slot).
template <typename T, int D, int U = 8 / kChunks<D>, typename Load, typename Sink>
__device__ __forceinline__ void walk_slots(const T* __restrict__ x, int v0, int v1, int lane,
                                           float (&acc)[kChunks<D>][4], int& cur, Load&& load,
                                           Sink&& sink) {
  constexpr int CI = kChunks<D>, V = kVec<D>;
  cur = -1;
  int nx_src, nx_key;
  float nx_w;
  load(v0 + lane, nx_src, nx_w, nx_key);
  for (int base = v0; base < v1; base += 32) {
    const int my_src = nx_src, my_key = nx_key;
    const float my_w = nx_w;
    if (base + 32 < v1)  // the next chunk's slots, in flight during this chunk's gathers
      load(base + 32 + lane, nx_src, nx_w, nx_key);
    const int n = min(32, v1 - base);
    for (int j = 0; j < n; j += U) {
      float v[U][CI][4];
      float wj[U];
      int kj[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int src = __shfl_sync(kFull, my_src, j + u);
        wj[u] = __shfl_sync(kFull, my_w, j + u);
        kj[u] = __shfl_sync(kFull, my_key, j + u);
        if (j + u < n && src >= 0) {
#pragma unroll
          for (int c = 0; c < CI; ++c)
            load_vec<D>(x + static_cast<long>(src) * D + c * kCols<D> + lane * V, v[u][c]);
        } else {
          wj[u] = 0.f;
#pragma unroll
          for (int c = 0; c < CI; ++c) v[u][c][0] = v[u][c][1] = v[u][c][2] = v[u][c][3] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (j + u >= n) break;
        if (kj[u] != cur) {  // the walk moves on to its next row
          if (cur >= 0) sink(cur, acc);
#pragma unroll
          for (int c = 0; c < CI; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
          cur = kj[u];
        }
#pragma unroll
        for (int c = 0; c < CI; ++c)
#pragma unroll
          for (int e = 0; e < V; ++e) acc[c][e] = fmaf(wj[u], v[u][c][e], acc[c][e]);
      }
    }
  }
}

// The virtual slots [v0, v1) of a run of rows of one ELL bucket (see
// load_vslot), walked by walk_slots with U source rows in flight.
template <typename T, int D, bool kNatural, int U = 8 / kChunks<D>, typename Sink>
__device__ __forceinline__ void walk_vslots(const T* __restrict__ x,
                                            const float* __restrict__ diag,
                                            const int* __restrict__ rows,
                                            const int* __restrict__ idx,
                                            const float* __restrict__ ew, int pos0, int k_row,
                                            long slot0, int v0, int v1, int lane,
                                            float (&acc)[kChunks<D>][4], int& cur, Sink&& sink) {
  walk_slots<T, D, U>(
      x, v0, v1, lane, acc, cur,
      [&](int v, int& src, float& w, int& key) {
        load_vslot<kNatural>(v, v1, pos0, k_row, slot0, rows, idx, ew, diag, src, w, key);
      },
      sink);
}

// One row of D fp32 sums to dst, rounded once to dst's type (float or bf16).
template <int D, typename T>
__device__ __forceinline__ void put_row(T* dst, int lane, const float (&acc)[kChunks<D>][4]) {
#pragma unroll
  for (int c = 0; c < kChunks<D>; ++c) store_vec<D>(dst + c * kCols<D> + lane * kVec<D>, acc[c]);
}

// One segment of a cut row, as the SpMM kernels' work tables cut it: acc
// is published as partial row `part` (rows of D fp32); the row's partials
// are [p0, p1), and its counter picks the last of its segments to finish.
// That one (and only that one) returns true, with the partials summed in
// segment order in sum, so the result does not depend on which segment
// finished last; it leaves the counter at 0 for the next launch.
template <int D>
__device__ __forceinline__ bool sum_segments(float* __restrict__ partial, int part, int p0,
                                             int p1, int* __restrict__ counter, int lane,
                                             const float (&acc)[kChunks<D>][4],
                                             float (&sum)[kChunks<D>][4]) {
  put_row<D>(partial + static_cast<long>(part) * D, lane, acc);
  __threadfence();
  __syncwarp();
  int last = 0;
  if (lane == 0) last = atomicAdd(counter, 1) == p1 - p0 - 1;
  if (!__shfl_sync(kFull, last, 0)) return false;
  if (lane == 0) *counter = 0;  // every segment has counted: ready for the next launch
  __threadfence();
#pragma unroll
  for (int c = 0; c < kChunks<D>; ++c) sum[c][0] = sum[c][1] = sum[c][2] = sum[c][3] = 0.f;
#pragma unroll 4  // loads in flight; the adds stay in segment order
  for (int p = p0; p < p1; ++p)
#pragma unroll
    for (int c = 0; c < kChunks<D>; ++c) {
      const float* row = partial + static_cast<long>(p) * D + c * kCols<D>;
      if constexpr (kVec<D> == 4) {
        const float4 t = __ldcg(reinterpret_cast<const float4*>(row) + lane);
        sum[c][0] += t.x;
        sum[c][1] += t.y;
        sum[c][2] += t.z;
        sum[c][3] += t.w;
      } else {
        const float2 t = __ldcg(reinterpret_cast<const float2*>(row) + lane);
        sum[c][0] += t.x;
        sum[c][1] += t.y;
      }
    }
  return true;
}

}  // namespace ell
