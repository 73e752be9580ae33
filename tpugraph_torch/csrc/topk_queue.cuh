// The per-row running top-k that shortlist_dist.cu (select and rerank) and
// l1_search.cu (the exact L1 search) share: a block owns kBQ query rows;
// its score warps leave each kBQ × kBC score tile in one of n_slots slots
// of shared memory, and kSelWarps selection warps, each owning kSelRows
// rows, keep every row's k least entries by the key (score, column).
//
//   * a selection warp compares each of its rows' scores with the row's
//     threshold, the key of the k-th entry of the row's queue (+inf until
//     the queue fills); a warp vote skips a row with no survivor, and
//     survivors go to the row's buffer of kBuf in shared memory;
//   * a full buffer is merged into the row's sorted queue by its warp in
//     registers (shuffles): a bitonic sort of the buffer, the elementwise
//     min of the queue and the reversed buffer (a bitonic sequence holding
//     the least kq of both) and a bitonic merge (the block-select structure
//     of Johnson, Douze and Jégou, "Billion-scale similarity search with
//     GPUs", 2017); the threshold then falls.  No other warp waits on it.
//     After the last tile every buffer is merged;
//   * keys are unique (a column enters a row's buffer at most once), so the
//     result is the exact k least by (score, column) whatever the order of
//     the tiles, and two launches agree bit for bit.  A masked column scores
//     +inf and keeps its place in that order.
//
// Named barriers: 0 is __syncthreads; 1 is the score warps' own; per score
// tile slot (up to 4), "full" (the score warps wrote it) and "empty" (the
// selection warps are done with it).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace topk {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBQ = 32;            // query rows per block
constexpr int kBC = 128;           // candidate columns per score tile
constexpr int kSelWarps = 8;       // selection warps, each owning kBQ / kSelWarps rows
constexpr int kSelRows = kBQ / kSelWarps;
constexpr int kBuf = 128;          // survivors per row between merges
constexpr int kTStride = 128 + 4;  // score-tile row stride (floats): ≡ 4 mod 32 banks
constexpr int kNone = 0x7fffffff;  // the column of an empty queue slot
constexpr int kMaxSlots = 4;
constexpr int kBarScore = 1, kBarFull = 2, kBarEmpty = kBarFull + kMaxSlots;

__device__ __forceinline__ bool key_less(float va, int ia, float vb, int ib) {
  return va < vb || (va == vb && ia < ib);
}

// A queue entry: its score and its column.
struct Key {
  float v;
  int i;
};

__device__ __forceinline__ bool key_less(Key a, Key b) { return key_less(a.v, a.i, b.v, b.i); }

// One step of a bitonic network over N·32 keys held by a warp, element
// e = 32·s + lane in slot s: e and e ^ stride compare-exchange, ascending
// where e & size is 0.  Strides below 32 pair lanes (shuffles), the others
// pair slots of one lane.
template <int N>
__device__ __forceinline__ void bitonic_step(Key (&x)[N], int size, int stride, int lane) {
  if (stride >= 32) {
    const int ds = stride >> 5;
#pragma unroll
    for (int s = 0; s < N; ++s)
      if ((s & ds) == 0 && key_less(x[s + ds], x[s]) == (((32 * s) & size) == 0)) {
        const Key t = x[s];
        x[s] = x[s + ds];
        x[s + ds] = t;
      }
  } else {
#pragma unroll
    for (int s = 0; s < N; ++s) {
      const int e = 32 * s + lane;
      const Key y{__shfl_xor_sync(kFull, x[s].v, stride), __shfl_xor_sync(kFull, x[s].i, stride)};
      // the lower element of an ascending pair keeps the lesser key
      const bool keep_less = ((e & stride) == 0) == ((e & size) == 0);
      if (key_less(y, x[s]) == keep_less) x[s] = y;
    }
  }
}

// Merge a row's n buffered survivors (smem, unsorted) into its sorted queue
// of 32·NQ (smem), by one warp in registers: a bitonic sort of the buffer,
// the elementwise min of the queue and the reversed buffer (a rising then
// falling sequence holding the 32·NQ least of both), a bitonic merge.
// Returns the row's new threshold, the key of queue entry k − 1, in every
// lane.
template <int NQ>
__device__ __noinline__ Key merge_row(float* qv, int* qi, const float* bv, const int* bi, int n,
                                      int k, int lane) {
  constexpr int NB = kBuf / 32;
  Key b[NB], q[NQ];
  __syncwarp();  // the buffer's entries, written by any lane, are in
#pragma unroll
  for (int s = 0; s < NB; ++s) {
    const int e = 32 * s + lane;
    b[s] = e < n ? Key{bv[e], bi[e]} : Key{INFINITY, kNone};
  }
#pragma unroll
  for (int s = 0; s < NQ; ++s) q[s] = Key{qv[32 * s + lane], qi[32 * s + lane]};
  __syncwarp();  // every lane has read the buffer before it is refilled
#pragma unroll
  for (int size = 2; size <= kBuf; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) bitonic_step<NB>(b, size, stride, lane);
#pragma unroll
  for (int s = 0; s < NQ; ++s) {
    const int sb = NQ - 1 - s;  // queue entry 32s + l meets buffer entry 32·sb + 31 − l
    if (sb < NB) {
      const Key y{__shfl_sync(kFull, b[sb].v, 31 - lane), __shfl_sync(kFull, b[sb].i, 31 - lane)};
      if (key_less(y, q[s])) q[s] = y;
    }
  }
#pragma unroll
  for (int stride = 16 * NQ; stride > 0; stride >>= 1)
    bitonic_step<NQ>(q, 64 * NQ, stride, lane);
  Key t{INFINITY, kNone};
#pragma unroll
  for (int s = 0; s < NQ; ++s) {
    qv[32 * s + lane] = q[s].v;
    qi[32 * s + lane] = q[s].i;
    if (s == (k - 1) >> 5) t = q[s];
  }
  return Key{__shfl_sync(kFull, t.v, (k - 1) & 31), __shfl_sync(kFull, t.i, (k - 1) & 31)};
}

__device__ __forceinline__ Key merge_row(float* qv, int* qi, const float* bv, const int* bi,
                                         int n, int k, int kq, int lane) {
  switch (kq) {
    case 32: return merge_row<1>(qv, qi, bv, bi, n, k, lane);
    case 64: return merge_row<2>(qv, qi, bv, bi, n, k, lane);
    case 128: return merge_row<4>(qv, qi, bv, bi, n, k, lane);
    default: return merge_row<8>(qv, qi, bv, bi, n, k, lane);
  }
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared memory of the rows' queues (kq each) and buffers.
__host__ __device__ constexpr size_t queue_smem(int kq) {
  return (sizeof(float) + sizeof(int)) * kBQ * static_cast<size_t>(kq + kBuf);
}

// The rows' state: each row's threshold, the key (value, column) of its
// queue's entry k − 1, and its count of buffered survivors; the queues
// (kq a row, sorted) and the buffers (kBuf a row).
struct Rows {
  float* thv;
  int* thi;
  int* cnt;
  float* qv;
  int* qi;
  float* bv;
  int* bi;
};

// Carve the queues and buffers out of shared memory at `at`; thv, thi and
// cnt are the caller's (kBQ each).
__device__ __forceinline__ Rows carve_rows(float* at, int kq, float* thv, int* thi, int* cnt) {
  Rows r{thv, thi, cnt, at, nullptr, nullptr, nullptr};
  r.qi = reinterpret_cast<int*>(r.qv + kBQ * kq);
  r.bv = reinterpret_cast<float*>(r.qi + kBQ * kq);
  r.bi = reinterpret_cast<int*>(r.bv + kBQ * kBuf);
  return r;
}

// Empty queues, +inf thresholds, empty buffers, by every thread of the
// block (the caller synchronises after).
__device__ __forceinline__ void init_rows(const Rows& r, int kq, int tid, int n_threads) {
  for (int i = tid; i < kBQ * kq; i += n_threads) {
    r.qv[i] = INFINITY;
    r.qi[i] = kNone;
  }
  if (tid < kBQ) {
    r.thv[tid] = INFINITY;
    r.thi[tid] = kNone;
    r.cnt[tid] = 0;
  }
}

// A selection warp's side of the block: rows [r0, r1) of each of n_tiles
// score tiles (tile t in slot t % n_slots, columns t·kBC .. past c
// skipped), then the last merges.  Lane l scans columns 4l .. 4l + 3 of
// each of its rows.  n_threads: the block's threads (every barrier's).
__device__ __forceinline__ void select_rows(const float* tiles, int n_slots, int n_tiles, int c,
                                            int k, int kq, const Rows& rs, int r0, int r1,
                                            int lane, int n_threads) {
  const unsigned below = (1u << lane) - 1;
  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * kBC + 4 * lane, ts = t % n_slots;
    bar_sync(kBarFull + ts, n_threads);
    const float* tile = tiles + ts * kBQ * kTStride + 4 * lane;
#pragma unroll 1
    for (int r = r0; r < r1; ++r) {
      const float4 v4 = *reinterpret_cast<const float4*>(tile + r * kTStride);
      const float v[4] = {v4.x, v4.y, v4.z, v4.w};
      float tv = rs.thv[r];
      int ti = rs.thi[r];
      bool pass[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) pass[h] = c0 + h < c && key_less(v[h], c0 + h, tv, ti);
      if (!__any_sync(kFull, pass[0] || pass[1] || pass[2] || pass[3])) continue;
      float* rbv = rs.bv + r * kBuf;
      int* rbi = rs.bi + r * kBuf;
      int n = rs.cnt[r];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        for (;;) {
          const unsigned ball = __ballot_sync(kFull, pass[h]);
          if (ball == 0) break;
          const int pos = n + __popc(ball & below);
          if (pass[h] && pos < kBuf) {
            rbv[pos] = v[h];
            rbi[pos] = c0 + h;
            pass[h] = false;
          }
          n = min(kBuf, n + __popc(ball));
          if (n < kBuf) break;
          // a full buffer: merge it, and hold what waits to the new threshold
          const Key th = merge_row(rs.qv + r * kq, rs.qi + r * kq, rbv, rbi, kBuf, k, kq, lane);
          tv = th.v;
          ti = th.i;
          n = 0;
#pragma unroll
          for (int h2 = h; h2 < 4; ++h2) pass[h2] = pass[h2] && key_less(v[h2], c0 + h2, tv, ti);
        }
      }
      __syncwarp();  // every lane has read the row's state
      if (lane == 0) {
        rs.thv[r] = tv;
        rs.thi[r] = ti;
        rs.cnt[r] = n;
      }
      __syncwarp();
    }
    if (t + n_slots < n_tiles) bar_arrive(kBarEmpty + ts, n_threads);
  }
  for (int r = r0; r < r1; ++r)
    if (rs.cnt[r] > 0)
      merge_row(rs.qv + r * kq, rs.qi + r * kq, rs.bv + r * kBuf, rs.bi + r * kBuf, rs.cnt[r], k,
                kq, lane);
}

}  // namespace topk
