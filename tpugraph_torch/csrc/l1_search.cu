// The exact L1 search, for Hopper (sm_90a).  For queries q (Q, d) and
// candidates cands (C, d), both fp32:
//
//   d(i, j) = Σ_c |q[i, c] − cands[j, c]|    in fp32, in the order c = 0, 1, …, d − 1
//   s(i, j) = a·d(i, j) − bias[j]            one fmaf (a = 1, no bias: the raw L1;
//                                            a = 2, bias r: the CSLS score)
//
// The order of the sum depends only on the two rows, never on where the
// pair falls in a tile, so a distance is the same number whatever block of
// candidates it is computed in (the ring's key merge stays exact at any
// number of shards), and two launches agree bit for bit.
//
// 1. l1_topk_forward — per row i, the k ≤ 256 least (s, column) over the C
//    columns, ascending, ties to the lower column; a column with
//    col_mask[j] = 0 or j = exclude[i] scores +inf and keeps its place in
//    that order (a row with fewer than k eligible columns ends with masked
//    ones, lowest column first), and so does a NaN score (a diverged
//    table).  One launch over every query, no (Q, C) tile in device memory.
// 2. l1_count_forward — per row i, the int64 count of columns j ≠ self[i]
//    with s(i, j) < thresh[i] (the true match excluded by index, never by
//    its score).
// 3. l1_tile_forward — the masked (Q, C) score tile (NaN as +inf), for k
//    above the queue (the caller selects with torch.topk).
//
// Replaces XLA ops, not a Pallas kernel: the blockwise L1 tiles and the
// lax.top_k / argmin / rank count over them of tpugraph/train/negatives.py:45
// (blockwise_knn_l1) and :128 (_cand_hubness), train/bootstrap.py:26 (_nn1),
// train/eval.py:25 (_ranks_l1) and :84 (_knn_mean_l1), serve.py:105
// (_topk_blockwise), and the ring bodies of dist/ring.py:40, :258 and :285.
//
// What bounds it on an H100: the Q·C·d terms |a − b|, two fp32 instructions
// each (a subtract, and an add of its absolute value); L1 has no
// tensor-core form.  At 132 SMs × 128 lanes × 1.98 GHz that is ≈ 1.7e13
// terms/s: 0.31 s for one proposal at DWY100K (2 × 100,000² × 256).
//
// Design (a first kernel that is right; making it fast is later work):
//   * a block owns 32 query rows (the strip, fp32 in shared memory, zero
//     past d) and walks the candidates in tiles of 128 rows, each streamed
//     through a two-stage cp.async ring in chunks of 32 of d (rows padded
//     to 36 floats, so a quarter-warp's 16-byte loads of 8 rows fill the 32
//     banks);
//   * 8 score warps: warp w holds rows 4w .. 4w + 3, lane l the columns
//     l, l + 32, l + 64, l + 96 of the tile, a 4 × 4 micro-tile of sums in
//     registers, fed by float4 loads along d (the query rows a broadcast);
//   * the epilogue applies a, the bias, the mask and the exclusion in
//     registers and feeds the entry: for the top-k, a slot of shared memory
//     that 8 selection warps read (topk_queue.cuh: each row's running queue,
//     warp-merged, exact by (score, column)); for the count, a per-thread
//     count of the row, summed over the warp's lanes at the end (no
//     atomics); for the tile, the scores to device memory;
//   * nothing is allocated in the kernel and nothing synchronises with the
//     host, so a launch may sit inside a captured CUDA graph.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_queue.cuh"

namespace {

using namespace topk;

constexpr int kScoreWarps = 8;
constexpr int kScoreThreads = 32 * kScoreWarps;
constexpr int kRowsPerWarp = kBQ / kScoreWarps;  // 4
constexpr int kColsPerLane = kBC / 32;           // 4
constexpr int kKC = 32;                          // d per pipeline chunk
constexpr int kRS = kKC + 4;                     // ring row stride (floats): ≡ 4 mod 32 banks
constexpr int kStages = 2;
constexpr int kMaxD = 512;

enum Mode { kTopk = 0, kCount = 1, kTile = 2 };

template <int kMode>
constexpr int kThreadsOf = kMode == kTopk ? kScoreThreads + 32 * kSelWarps : kScoreThreads;

struct Args {
  const float* q;              // (s, d)
  const float* cands;          // (c, d)
  const float* bias;           // (c,) or null
  const uint8_t* col_mask;     // (c,) or null (top-k and tile)
  const long long* row_col;    // (s,) or null: exclude (top-k, tile) or self (count); < 0 none
  const float* thresh;         // (s,) (count)
  float a;
  int s, c, d, k, kq;
  long long* idx;              // (s, k) (top-k) or the counts (s,) (count)
  float* val;                  // (s, k) (top-k) or the tile (s, c) (tile)
};

// Candidate rows [c0, c0 + kBC) × d-chunk [k0, k0 + kKC) into one ring
// slot; rows past C and columns past d are zero-filled.
__device__ __forceinline__ void load_chunk(float* dst, const float* __restrict__ cands, int c0,
                                           int k0, int n_c, int d, int tid) {
#pragma unroll
  for (int j = 0; j < kBC * (kKC / 4) / kScoreThreads; ++j) {
    const int i = j * kScoreThreads + tid;
    const int row = i / (kKC / 4), f4 = i % (kKC / 4);
    const int col = c0 + row, k = k0 + f4 * 4;
    const bool valid = col < n_c && k < d;
    const float* src = valid ? cands + static_cast<size_t>(col) * d + k : cands;
    cp_async16(dst + row * kRS + f4 * 4, src, valid);
  }
}

__device__ __forceinline__ float l1_add(float acc, float4 x, float4 y) {
  acc += fabsf(x.x - y.x);
  acc += fabsf(x.y - y.y);
  acc += fabsf(x.z - y.z);
  acc += fabsf(x.w - y.w);
  return acc;
}

// One d-chunk of the warp's 4 rows against the lane's 4 columns.
__device__ __forceinline__ void chunk_l1(float (&acc)[kRowsPerWarp][kColsPerLane],
                                         const float* strip, int l_stride, int koff,
                                         const float* rb, int warp, int lane) {
#pragma unroll
  for (int kk = 0; kk < kKC; kk += 4) {
    float4 x[kRowsPerWarp], y[kColsPerLane];
#pragma unroll
    for (int ii = 0; ii < kRowsPerWarp; ++ii)
      x[ii] = *reinterpret_cast<const float4*>(strip + (kRowsPerWarp * warp + ii) * l_stride +
                                               koff + kk);
#pragma unroll
    for (int jj = 0; jj < kColsPerLane; ++jj)
      y[jj] = *reinterpret_cast<const float4*>(rb + (lane + 32 * jj) * kRS + kk);
#pragma unroll
    for (int ii = 0; ii < kRowsPerWarp; ++ii)
#pragma unroll
      for (int jj = 0; jj < kColsPerLane; ++jj) acc[ii][jj] = l1_add(acc[ii][jj], x[ii], y[jj]);
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreadsOf<kMode>, 1) l1_kernel(Args p, int n_slots) {
  constexpr int kThreads = kThreadsOf<kMode>;
  extern __shared__ __align__(16) float smem[];
  __shared__ float thv[kBQ];
  __shared__ int thi[kBQ];
  __shared__ int cnt[kBQ];
  const int d_pad = (p.d + kKC - 1) / kKC * kKC;
  const int l_stride = d_pad;
  float* strip = smem;                       // [kBQ][l_stride]
  float* ring = strip + kBQ * l_stride;      // [kStages][kBC][kRS]
  float* tiles = ring + kStages * kBC * kRS;  // top-k: [n_slots][kBQ][kTStride]
  Rows rs{};
  if constexpr (kMode == kTopk)
    rs = carve_rows(tiles + n_slots * kBQ * kTStride, p.kq, thv, thi, cnt);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ;
  const int n_rows = min(kBQ, p.s - q0);
  const int n_tiles = (p.c + kBC - 1) / kBC;
  const int nkc = d_pad / kKC;

  // the score warps' loads run kStages − 1 chunks ahead of their sums
  int ld_left = n_tiles * nkc, ld_slot = 0, ld_tile = 0, ld_kc = 0;
  auto load_next = [&]() {
    if (ld_left > 0) {
      load_chunk(ring + ld_slot * kBC * kRS, p.cands, ld_tile * kBC, ld_kc * kKC, p.c, p.d, tid);
      --ld_left;
      if (++ld_kc == nkc) {
        ld_kc = 0;
        ++ld_tile;
      }
      if (++ld_slot == kStages) ld_slot = 0;
    }
    cp_async_commit();
  };
  if (warp < kScoreWarps) {
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) load_next();
  }

  // the query rows, zero past S and past d
  const int per_row = d_pad / 4;
  for (int i = tid; i < kBQ * per_row; i += kThreads) {
    const int r = i / per_row, k = (i % per_row) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_rows && k < p.d)
      v = __ldg(reinterpret_cast<const float4*>(p.q + static_cast<size_t>(q0 + r) * p.d + k));
    *reinterpret_cast<float4*>(strip + r * l_stride + k) = v;
  }
  if constexpr (kMode == kTopk) init_rows(rs, p.kq, tid, kThreads);
  __syncthreads();

  if (warp < kScoreWarps) {
    long long row_col[kRowsPerWarp];
    float row_th[kRowsPerWarp];
    int row_cnt[kRowsPerWarp];
#pragma unroll
    for (int ii = 0; ii < kRowsPerWarp; ++ii) {
      const int r = kRowsPerWarp * warp + ii;
      row_col[ii] = r < n_rows && p.row_col != nullptr ? __ldg(p.row_col + q0 + r) : -1;
      row_th[ii] = kMode == kCount && r < n_rows ? __ldg(p.thresh + q0 + r) : 0.f;
      row_cnt[ii] = 0;
    }
    int slot = 0;
    for (int t = 0; t < n_tiles; ++t) {
      const int c0 = t * kBC;
      float acc[kRowsPerWarp][kColsPerLane] = {};
      for (int kc = 0; kc < nkc; ++kc) {
        cp_async_wait<kStages - 2>();
        bar_sync(kBarScore, kScoreThreads);  // this chunk is in; the oldest slot is free
        load_next();
        chunk_l1(acc, strip, l_stride, kc * kKC, ring + slot * kBC * kRS, warp, lane);
        if (++slot == kStages) slot = 0;
      }
      float bias[kColsPerLane];
      bool ok[kColsPerLane];
#pragma unroll
      for (int jj = 0; jj < kColsPerLane; ++jj) {
        const int col = c0 + lane + 32 * jj;
        const bool in = col < p.c;
        ok[jj] = in && (p.col_mask == nullptr || __ldg(p.col_mask + col) != 0);
        bias[jj] = in && p.bias != nullptr ? __ldg(p.bias + col) : 0.f;
      }
      if constexpr (kMode == kCount) {
#pragma unroll
        for (int ii = 0; ii < kRowsPerWarp; ++ii)
#pragma unroll
          for (int jj = 0; jj < kColsPerLane; ++jj) {
            const int col = c0 + lane + 32 * jj;
            const float sc = __fmaf_rn(p.a, acc[ii][jj], -bias[jj]);
            row_cnt[ii] += col < p.c && col != row_col[ii] && sc < row_th[ii];
          }
      } else {
        float* out;
        size_t stride;
        int ts = 0;
        if constexpr (kMode == kTopk) {
          ts = t % n_slots;
          if (t >= n_slots) bar_sync(kBarEmpty + ts, kThreads);
          out = tiles + ts * kBQ * kTStride;
          stride = kTStride;
        } else {
          out = p.val + static_cast<size_t>(q0) * p.c + c0;
          stride = static_cast<size_t>(p.c);
        }
#pragma unroll
        for (int ii = 0; ii < kRowsPerWarp; ++ii) {
          const int r = kRowsPerWarp * warp + ii;
#pragma unroll
          for (int jj = 0; jj < kColsPerLane; ++jj) {
            const int col = c0 + lane + 32 * jj;
            const float sc = __fmaf_rn(p.a, acc[ii][jj], -bias[jj]);
            const float v = ok[jj] && col != row_col[ii] && !isnan(sc) ? sc : INFINITY;
            if (kMode == kTopk || (r < n_rows && col < p.c))
              out[r * stride + lane + 32 * jj] = v;
          }
        }
        if constexpr (kMode == kTopk) bar_arrive(kBarFull + ts, kThreads);
      }
    }
    cp_async_wait<0>();
    if constexpr (kMode == kCount) {
#pragma unroll
      for (int ii = 0; ii < kRowsPerWarp; ++ii) {
        int n = row_cnt[ii];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) n += __shfl_xor_sync(kFull, n, off);
        const int r = kRowsPerWarp * warp + ii;
        if (lane == 0 && r < n_rows) p.idx[q0 + r] = n;
      }
    }
  } else if constexpr (kMode == kTopk) {
    // selection warps: each owns kSelRows rows' queues, thresholds and
    // buffers, so no other warp waits on its merges
    const int r0 = (warp - kScoreWarps) * kSelRows;
    select_rows(tiles, n_slots, n_tiles, p.c, p.k, p.kq, rs, r0, min(r0 + kSelRows, n_rows),
                lane, kThreads);
  }
  if constexpr (kMode == kTopk) {
    __syncthreads();
    for (int i = tid; i < n_rows * p.k; i += kThreads) {
      const int r = i / p.k, j = i % p.k;
      const size_t o = static_cast<size_t>(q0 + r) * p.k + j;
      p.idx[o] = rs.qi[r * p.kq + j];
      p.val[o] = rs.qv[r * p.kq + j];
    }
  }
}

size_t l1_smem(int mode, int d, int kq, int n_slots) {
  const int d_pad = (d + kKC - 1) / kKC * kKC;
  size_t floats = static_cast<size_t>(kBQ) * d_pad + static_cast<size_t>(kStages) * kBC * kRS;
  if (mode != kTopk) return sizeof(float) * floats;
  floats += static_cast<size_t>(n_slots) * kBQ * kTStride;
  return sizeof(float) * floats + queue_smem(kq);
}

template <int kMode>
int launch(const Args& a, cudaStream_t stream) {
  cudaError_t err;
  int dev = 0, limit = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return err;
  const size_t room = static_cast<size_t>(limit) - (2 * sizeof(float) + sizeof(int)) * kBQ;
  // the top-k takes as many score-tile slots as fit, up to 4: they absorb
  // the selection warps' bursts of merges
  int n_slots = kMode == kTopk ? kMaxSlots : 0;
  while (n_slots > 1 && l1_smem(kMode, a.d, a.kq, n_slots) > room) --n_slots;
  const size_t smem = l1_smem(kMode, a.d, a.kq, n_slots);
  if (smem > room) return cudaErrorInvalidValue;
  auto kern = l1_kernel<kMode>;
  if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
    return err;
  kern<<<(a.s + kBQ - 1) / kBQ, kThreadsOf<kMode>, smem, stream>>>(a, n_slots);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int s, int c, int d) { return s < 0 || c < 1 || d < 4 || d > kMaxD || d % 4 != 0; }

}  // namespace

// q (s, d), cands (c, d), bias (c,) float32; col_mask (c,) uint8; exclude
// (s,) int64 (< 0: none); bias, col_mask and exclude may be null.  All
// contiguous and 16-byte aligned, d % 4 == 0, 4 ≤ d ≤ 512, 1 ≤ k ≤ min(kq,
// c), kq a power of two in [32, 256].  Writes idx (s, k) int64 and val
// (s, k) float32.  Each entry is one kernel launch and returns its
// cudaError_t (0 on success).
extern "C" int l1_topk_forward(const float* q, const float* cands, const float* bias,
                               const uint8_t* col_mask, const long long* exclude, float a, int s,
                               int c, int d, int k, int kq, long long* idx, float* val,
                               void* stream) {
  if (bad_shape(s, c, d) || k < 1 || k > kq || kq < 32 || kq > 256 || (kq & (kq - 1)) != 0 ||
      k > c)
    return cudaErrorInvalidValue;
  if (s == 0) return cudaSuccess;
  const Args args{q, cands, bias, col_mask, exclude, nullptr, a, s, c, d, k, kq, idx, val};
  return launch<kTopk>(args, static_cast<cudaStream_t>(stream));
}

// thresh (s,) float32, self_col (s,) int64 (< 0: none; may be null).
// Writes count (s,) int64.
extern "C" int l1_count_forward(const float* q, const float* cands, const float* bias,
                                const float* thresh, const long long* self_col, float a, int s,
                                int c, int d, long long* count, void* stream) {
  if (bad_shape(s, c, d) || thresh == nullptr) return cudaErrorInvalidValue;
  if (s == 0) return cudaSuccess;
  const Args args{q, cands, bias, nullptr, self_col, thresh, a, s, c, d, 0, 0, count, nullptr};
  return launch<kCount>(args, static_cast<cudaStream_t>(stream));
}

// Writes out (s, c) float32: s(i, j), +inf where masked.
extern "C" int l1_tile_forward(const float* q, const float* cands, const float* bias,
                               const uint8_t* col_mask, const long long* exclude, float a, int s,
                               int c, int d, float* out, void* stream) {
  if (bad_shape(s, c, d)) return cudaErrorInvalidValue;
  if (s == 0) return cudaSuccess;
  const Args args{q, cands, bias, col_mask, exclude, nullptr, a, s, c, d, 0, 0, nullptr, out};
  return launch<kTile>(args, static_cast<cudaStream_t>(stream));
}
