// The ELL gather shared by gcn_fused.cu and spmm_ell.cu: one warp
// accumulates Σ_k w[s]·x[idx[s]] over a run of slots of one row into
// registers, 4 columns per lane per 128-column chunk.
//
// Slots are walked in chunks of 32: each lane loads one (idx, w) pair and
// the warp broadcasts them with shuffles, so a row of any K (up to the
// 3,734 of the zh-en hubs) needs no shared memory sized by K.  Each source
// row is one coalesced 16-byte-per-lane load; kUnroll rows are in flight
// per warp.  Pad slots (idx 0, w 0) read row 0 and add 0·x[0].

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace ell {

constexpr int kUnroll = 8;  // source rows in flight per warp
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

// acc += Σ_{s in [s0, s1)} w[s] · x[idx[s]] over this lane's CI×4 columns.
template <typename T, int D>
__device__ __forceinline__ void gather_slots(const T* __restrict__ x,
                                             const int* __restrict__ idx,
                                             const float* __restrict__ ew,
                                             long s0, long s1, int lane,
                                             float (&acc)[D / 128][4]) {
  constexpr int CI = D / 128;
  for (long base = s0; base < s1; base += 32) {
    const long rem = s1 - base;
    const int n = rem < 32 ? static_cast<int>(rem) : 32;
    const int my_i = lane < n ? __ldg(idx + base + lane) : 0;
    const float my_w = lane < n ? __ldg(ew + base + lane) : 0.f;
    for (int j = 0; j < n; j += kUnroll) {
      float v[kUnroll][CI][4];
      float wj[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int src = __shfl_sync(kFull, my_i, (j + u) & 31);
        wj[u] = __shfl_sync(kFull, my_w, (j + u) & 31);
        if (j + u < n) {
#pragma unroll
          for (int c = 0; c < CI; ++c)
            load4(x + static_cast<long>(src) * D + c * 128 + lane * 4, v[u][c]);
        } else {
          wj[u] = 0.f;
#pragma unroll
          for (int c = 0; c < CI; ++c)
            v[u][c][0] = v[u][c][1] = v[u][c][2] = v[u][c][3] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int c = 0; c < CI; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[c][e] = fmaf(wj[u], v[u][c][e], acc[c][e]);
    }
  }
}

// acc += diag[row] · x[row]: the split-out diagonal, one more slot whose
// source is the row itself.  No-op when diag is null.
template <typename T, int D>
__device__ __forceinline__ void add_diag(const T* __restrict__ x, const float* __restrict__ diag,
                                         int row, int lane, float (&acc)[D / 128][4]) {
  if (diag == nullptr) return;
  const float d = __ldg(diag + row);
#pragma unroll
  for (int c = 0; c < D / 128; ++c) {
    float v[4];
    load4(x + static_cast<long>(row) * D + c * 128 + lane * 4, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = fmaf(d, v[e], acc[c][e]);
  }
}

template <int D>
__device__ __forceinline__ void put_row(float* dst, int lane, const float (&acc)[D / 128][4]) {
#pragma unroll
  for (int c = 0; c < D / 128; ++c) store4(dst + c * 128 + lane * 4, acc[c]);
}

}  // namespace ell
