// The ELL gather shared by gcn_fused.cu and spmm_ell.cu: one warp
// accumulates rows of A·x + diag ⊙ x in registers, 4 columns per lane per
// 128-column chunk, walking a run of whole rows of one bucket (or one
// segment of a long row) as "virtual slots": each row's K ELL slots, then
// one for the split-out diagonal (source the row itself, weight
// diag[row]).  32 slots at a time, across row boundaries, so a run of short
// rows keeps 8 source rows in flight; a finished row goes to the caller's
// sink.
//
// Each lane loads one slot's (idx, w) and the warp broadcasts them with
// shuffles, so a row of any K (up to the 3,734 of the zh-en hubs) needs no
// shared memory sized by K.  Each source row is one coalesced
// 16-byte-per-lane load.  Pad slots (idx 0, w 0) read row 0 and add
// 0·x[0].

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace ell {

constexpr unsigned kFull = 0xffffffffu;

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

// The virtual slots [v0, v1) of a run of rows (see load_vslot), 32 at a
// time: each lane loads one slot's (source, weight, key), the warp
// broadcasts them by shuffles, and the next 32 load before this chunk's
// gathers start, so that load is off the critical path.  8 source rows (4
// at D = 256) are in flight per warp.  When the walk moves on to the next
// row, sink(key, acc) takes the finished row and acc restarts at 0; on
// return acc holds the last row, whose key is `cur`.
template <typename T, int D, bool kNatural, typename Sink>
__device__ __forceinline__ void walk_vslots(const T* __restrict__ x,
                                            const float* __restrict__ diag,
                                            const int* __restrict__ rows,
                                            const int* __restrict__ idx,
                                            const float* __restrict__ ew, int pos0, int k_row,
                                            long slot0, int v0, int v1, int lane,
                                            float (&acc)[D / 128][4], int& cur, Sink&& sink) {
  constexpr int CI = D / 128;
  constexpr int U = 8 / CI;  // source rows in flight per warp
  cur = -1;
  int nx_src, nx_key;
  float nx_w;
  load_vslot<kNatural>(v0 + lane, v1, pos0, k_row, slot0, rows, idx, ew, diag, nx_src, nx_w,
                       nx_key);
  for (int base = v0; base < v1; base += 32) {
    const int my_src = nx_src, my_key = nx_key;
    const float my_w = nx_w;
    if (base + 32 < v1)  // the next chunk's slots, in flight during this chunk's gathers
      load_vslot<kNatural>(base + 32 + lane, v1, pos0, k_row, slot0, rows, idx, ew, diag,
                           nx_src, nx_w, nx_key);
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
            load4(x + static_cast<long>(src) * D + c * 128 + lane * 4, v[u][c]);
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
          for (int e = 0; e < 4; ++e) acc[c][e] = fmaf(wj[u], v[u][c][e], acc[c][e]);
      }
    }
  }
}

template <int D>
__device__ __forceinline__ void put_row(float* dst, int lane, const float (&acc)[D / 128][4]) {
#pragma unroll
  for (int c = 0; c < D / 128; ++c) store4(dst + c * 128 + lane * 4, acc[c]);
}

}  // namespace ell
