// The gather walk shared by gcn_fused.cu, spmm_ell.cu and spmm_sorted.cu:
// one warp accumulates rows of A·x in registers, walking a work item's
// slots (walk_cols) 32 at a time, across row boundaries, so a
// run of short rows keeps 8 source rows in flight; a finished row goes to
// the caller's sink.  The columns a lane holds are the kernel's layout:
//
//   * at a width with an instance (FixedCols<D>: D = 128, 256, or 64, a
//     tensor-parallel rank's half of a 128-wide layer), 4 columns per lane
//     per 128-column chunk (2 per lane in one 64-column chunk at D = 64);
//   * at any other width d (PanelCols), one 128-column panel of the
//     row per block row of the grid (blockIdx.y), 4 columns per lane, the
//     tail panel masked at d: 16-byte (fp32) or 8-byte (bf16) loads where
//     d % 4 == 0, scalar loads elsewhere.  Each output element still sums
//     its row's slots in slot order.
//
// The ELL kernels walk a run of whole rows of one bucket (or one segment
// of a long row) as "virtual slots" (walk_vslots, load_vslot): each row's K
// ELL slots, then one for the split-out diagonal (source the row itself,
// weight diag[row]).  The sorted kernel walks a range of its edge list,
// keyed by each edge's dst.
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
// load is off the critical path.  U source rows are in flight per warp;
// gather(src, c, v) loads the lane's V columns of chunk c of row src, where
// lane_ok (a lane of a masked panel past d holds nothing: it gathers none
// and sums zeros).  The gathers sit under one condition, so the compiler
// issues the U rows' loads together as predicated loads.  When
// the key changes, sink(key, acc) takes the finished row and acc restarts
// at 0; on return acc holds the last row, whose key is `cur` (-1 if the
// item had no slot).
template <int CI, int V, int U, typename Gather, typename Load, typename Sink>
__device__ __forceinline__ void walk_cols(Gather&& gather, int v0, int v1, int lane,
                                          float (&acc)[CI][4], int& cur, Load&& load,
                                          Sink&& sink, bool lane_ok = true) {
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
        if (j + u < n && src >= 0 && lane_ok) {
#pragma unroll
          for (int c = 0; c < CI; ++c) gather(src, c, v[u][c]);
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

// One row of D fp32 sums to dst, rounded once to dst's type (float or bf16).
template <int D, typename T>
__device__ __forceinline__ void put_row(T* dst, int lane, const float (&acc)[kChunks<D>][4]) {
#pragma unroll
  for (int c = 0; c < kChunks<D>; ++c) store_vec<D>(dst + c * kCols<D> + lane * kVec<D>, acc[c]);
}

// One segment of a cut row, as the SpMM kernels' work tables cut it: acc
// is published as partial row `part` (fp32 rows of `pitch`, the lane's
// chunk c at col + c·32·V); the row's partials are [p0, p1), and its
// counter picks the last of its segments to finish.  That one (and only
// that one) returns true, with the partials summed in segment order in sum,
// so the result does not depend on which segment finished last; it leaves
// the counter at 0 for the next launch.
template <int CI, int V>
__device__ __forceinline__ bool sum_partials(float* __restrict__ partial, long pitch, int col,
                                             int part, int p0, int p1, int* __restrict__ counter,
                                             int lane, const float (&acc)[CI][4],
                                             float (&sum)[CI][4]) {
#pragma unroll
  for (int c = 0; c < CI; ++c) {
    float* dst = partial + part * pitch + col + c * 32 * V;
    if constexpr (V == 4) store4(dst, acc[c]); else store2(dst, acc[c]);
  }
  __threadfence();
  __syncwarp();
  int last = 0;
  if (lane == 0) last = atomicAdd(counter, 1) == p1 - p0 - 1;
  if (!__shfl_sync(kFull, last, 0)) return false;
  if (lane == 0) *counter = 0;  // every segment has counted: ready for the next launch
  __threadfence();
#pragma unroll
  for (int c = 0; c < CI; ++c) sum[c][0] = sum[c][1] = sum[c][2] = sum[c][3] = 0.f;
#pragma unroll 4  // loads in flight; the adds stay in segment order
  for (int p = p0; p < p1; ++p)
#pragma unroll
    for (int c = 0; c < CI; ++c) {
      const float* row = partial + p * pitch + col + c * 32 * V;
      if constexpr (V == 4) {
        const float4 t = __ldcg(reinterpret_cast<const float4*>(row));
        sum[c][0] += t.x;
        sum[c][1] += t.y;
        sum[c][2] += t.z;
        sum[c][3] += t.w;
      } else {
        const float2 t = __ldcg(reinterpret_cast<const float2*>(row));
        sum[c][0] += t.x;
        sum[c][1] += t.y;
      }
    }
  return true;
}

// The columns a lane holds at a width with an instance (D = 64, 128, 256):
// kChunks<D> chunks of kCols<D>, kVec<D> columns a lane; one block row of
// the grid; the cut rows' partials are rows of D, one counter a cut row.
template <int D>
struct FixedCols {
  static constexpr int kCI = kChunks<D>, kV = kVec<D>, kU = 8 / kChunks<D>;
  int lane;

  static __device__ __forceinline__ FixedCols at(int /*d*/, int lane) { return {lane}; }

  static constexpr __device__ bool lane_ok() { return true; }

  template <typename T>
  __device__ __forceinline__ void load(const T* __restrict__ x, int src, int c,
                                       float (&v)[4]) const {
    load_vec<D>(x + static_cast<long>(src) * D + c * kCols<D> + lane * kV, v);
  }

  template <typename T>
  __device__ __forceinline__ void put(T* __restrict__ out, int row,
                                      const float (&a)[kCI][4]) const {
    put_row<D>(out + static_cast<long>(row) * D, lane, a);
  }

  __device__ __forceinline__ bool sum_segments(float* __restrict__ partial, int part, int p0,
                                               int p1, int* __restrict__ counters, int split,
                                               const float (&acc)[kCI][4],
                                               float (&sum)[kCI][4]) const {
    return sum_partials<kCI, kV>(partial, D, lane * kV, part, p0, p1, counters + split, lane,
                                 acc, sum);
  }
};

// The virtual slots [v0, v1) of a run of rows of one ELL bucket (see
// load_vslot) over rows of x of width D, an instance's layout (FixedCols),
// walked by walk_cols with U source rows in flight (by default 8, 4 at
// D = 256).
template <typename T, int D, bool kNatural, int U = 8 / kChunks<D>, typename Sink>
__device__ __forceinline__ void walk_vslots(const T* __restrict__ x,
                                            const float* __restrict__ diag,
                                            const int* __restrict__ rows,
                                            const int* __restrict__ idx,
                                            const float* __restrict__ ew, int pos0, int k_row,
                                            long slot0, int v0, int v1, int lane,
                                            float (&acc)[kChunks<D>][4], int& cur, Sink&& sink) {
  const FixedCols<D> cols{lane};
  walk_cols<kChunks<D>, kVec<D>, U>(
      [&](int src, int c, float (&v)[4]) { cols.load(x, src, c, v); }, v0, v1, lane, acc, cur,
      [&](int v, int& src, float& w, int& key) {
        load_vslot<kNatural>(v, v1, pos0, k_row, slot0, rows, idx, ew, diag, src, w, key);
      },
      sink);
}

__device__ __forceinline__ float ld_elem(const float* p) { return __ldg(p); }

__device__ __forceinline__ float ld_elem(const __nv_bfloat16* p) {
  const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(u) << 16);  // a bf16 is fp32's top half
}

__device__ __forceinline__ void st_elem(float* p, float v) { *p = v; }

__device__ __forceinline__ void st_elem(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The columns a lane holds at any other width d: panel blockIdx.y of
// gridDim.y (each 128 columns of the row, the last one masked at d), 4
// consecutive columns a lane from col = 128·panel + 4·lane.  A row of x or
// out is d wide (its pitch); kVec (d % 4 == 0: every row then starts
// aligned) loads and stores 16 bytes in fp32, 8 in bf16, else one element
// at a time.  A lane past d (lane_ok false) gathers nothing: walk_cols
// folds that into its one condition on a gather, which keeps the loads
// predicated and issued together (a condition inside the gather spread
// them out: the bf16 panels ran 1.7× the instance of the same arithmetic,
// PERF.md §6).  The cut rows' partials are fp32 rows of 128·gridDim.y
// (always aligned), one counter a cut row and panel.
template <bool kVec>
struct PanelCols {
  static constexpr int kCI = 1, kV = 4, kU = 8;
  int lane, d, col, panel, n_panels;

  static __device__ __forceinline__ PanelCols at(int d, int lane) {
    const int panel = static_cast<int>(blockIdx.y);
    return {lane, d, 128 * panel + 4 * lane, panel, static_cast<int>(gridDim.y)};
  }

  __device__ __forceinline__ bool lane_ok() const { return col < d; }

  // a lane_ok lane's columns: all 4 with kVec, else those below d
  template <typename T>
  __device__ __forceinline__ void load(const T* __restrict__ x, int src, int /*c*/,
                                       float (&v)[4]) const {
    const T* p = x + static_cast<long>(src) * d + col;
    if constexpr (kVec) {
      load4(p, v);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = col + e < d ? ld_elem(p + e) : 0.f;
    }
  }

  template <typename T>
  __device__ __forceinline__ void put(T* __restrict__ out, int row,
                                      const float (&a)[kCI][4]) const {
    T* p = out + static_cast<long>(row) * d + col;
    if constexpr (kVec) {
      if (col < d) store4(p, a[0]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col + e < d) st_elem(p + e, a[0][e]);
    }
  }

  __device__ __forceinline__ bool sum_segments(float* __restrict__ partial, int part, int p0,
                                               int p1, int* __restrict__ counters, int split,
                                               const float (&acc)[kCI][4],
                                               float (&sum)[kCI][4]) const {
    return sum_partials<1, 4>(partial, 128L * n_panels, col, part, p0, p1,
                              counters + static_cast<long>(split) * n_panels + panel, lane, acc,
                              sum);
  }
};

}  // namespace ell
