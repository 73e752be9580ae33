// The exact L1 search, for Hopper (sm_90a).  For queries q (Q, d) and
// candidates cands (C, d), both fp32:
//
//   d(i, j) = Σ_c |q[i, c] − cands[j, c]|    in fp32, in the order c = 0, 1, …, d − 1
//   s(i, j) = a·d(i, j) − bias[j]            one fmaf (a = 1, no bias: the raw L1;
//                                            a = 2, bias r: the CSLS score)
//
// The order of the sum depends only on the two rows, never on where the
// pair falls in a tile or which block computes it, so a distance is the
// same number whatever the work split (the ring's key merge stays exact at
// any number of shards), and two launches agree bit for bit.
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
// terms/s, so the kernel is bound by issue slots: every instruction that is
// not one of those two costs a slot.  The design spends few of them:
//
//   * work that fills whole waves: the (strip of kBQ = 32 queries, tile of
//     kBC = 256 candidates) pairs, strip-major, are cut into `units`
//     contiguous ranges of nearly equal length, one block each (the host's
//     planner gives one unit per resident block, kernels/l1_search.py).  A
//     strip whose tiles span several units is finished by the unit that
//     arrives last (a ticket per strip, reset by that unit): it merges the
//     other units' k keys per row by (score, column), or sums their
//     counts.  Keys are unique and counts integers, so the result does not
//     depend on the units or on the order of arrival;
//   * an 8 × 8 register tile per thread: a score warp holds the strip's 32
//     rows × 64 columns, lane (r, c) = (lane / 8, lane % 8) the rows r + 4i
//     and the columns c + 8j; at each 4 of d it loads 8 query and 8
//     candidate float4s from shared memory (4 and 8 distinct 16-byte rows,
//     the rest broadcast: one wavefront each) for 512 fp32 instructions,
//     512 terms a wavefront against PR 19's 102.  Four score warps a block
//     and two blocks an SM (two a scheduler), 168 registers a thread;
//   * a copy ring of 3–6 stages of 8 of d (the strip's rows, then the
//     tile's), filled by one producer thread with two TMA tensor copies a
//     stage (cp.async.bulk.tensor, zero past S, C and d; 32-byte swizzle,
//     so the score warps' 16-byte loads meet no bank conflict and no row is
//     padded); each stage has a full and an empty mbarrier, so no
//     block-wide barrier runs in the d loop and the copies take no issue
//     slots or load/store pipe from the score warps;
//   * the top-k filter runs in the score warps: each score is compared with
//     its row's threshold key (the k-th entry of the row's queue) before
//     anything is written; the survivors of the 8 lanes that share a row
//     are compacted by a scan of shuffles into the row's buffer of kBuf
//     keys with one shared-memory atomic.  Once a tile, the score warps
//     agree (bar.red.or) whether a buffer overflowed; if one did, every row
//     holding kMergeAt or more is merged into its sorted queue (a bitonic
//     sort and merge by one warp in registers, topk_queue.cuh's structure;
//     merging the nearly full rows with the full ones spreads the merges
//     over the warps and saves later rounds), thresholds fall, and what
//     waited is filtered again and appended.  For k ≤ 32 a piece's first
//     tile seeds each row's queue with its 32 threads' least keys, so the
//     tile does not flood the buffers;
//   * the count adds per thread, then over the row's 8 lanes and the four
//     warps (integers, so any order); the tile writes its scores;
//   * nothing is allocated in the kernel and nothing synchronises with the
//     host (the wrapper allocates the partials and keeps the tickets), so a
//     launch may sit inside a captured CUDA graph.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk_queue.cuh"

namespace {

using topk::bar_sync;
using topk::bitonic_step;
using topk::Key;
using topk::key_less;
using topk::kFull;
using topk::kNone;

constexpr int kBQ = 32;                         // query rows per strip
constexpr int kTR = 8, kTC = 8;                 // a thread's rows and columns
constexpr int kScoreWarps = 4;
constexpr int kWarpCols = 8 * kTC;              // candidate columns per score warp
constexpr int kBC = kScoreWarps * kWarpCols;    // 256 candidate columns per tile
constexpr int kScoreThreads = 32 * kScoreWarps;
constexpr int kThreads = kScoreThreads + 32;    // and the producer warp
constexpr int kKC = 8;                          // d per ring stage
constexpr int kPlanes = kKC / 4;                // a stage: [row][kKC floats], 32-byte swizzled
constexpr int kStageRows = kBQ + kBC;           // the strip's rows, then the tile's
constexpr int kStageFloats = kStageRows * kKC;
constexpr int kBuf = 128;                       // survivors a row holds between merges
constexpr int kMergeAt = kBuf / 4;              // a forced round merges the rows holding this many
constexpr int kMaxD = 512;
constexpr int kMinStages = 2, kMaxStages = 8;
constexpr int kBarScore = 1;                    // the score warps' own barrier
constexpr int kAlign = 1024;                    // the ring's alignment (the copies' swizzle)

static_assert(kTR * 4 == kBQ && kTC * 8 == kWarpCols, "lane (r, c) covers the warp's tile");
static_assert(kKC == 8, "a stage row is one 32-byte swizzle span");

enum Mode { kTopk = 0, kCount = 1, kTile = 2 };

struct Args {
  const float* q;              // (s, d)
  const float* cands;          // (c, d)
  const float* bias;           // (c,) or null
  const uint8_t* col_mask;     // (c,) or null (top-k and tile)
  const long long* row_col;    // (s,) or null: exclude (top-k, tile) or self (count); < 0 none
  const float* thresh;         // (s,) (count)
  float a;
  int s, c, d, k;
  int units, stages;
  long long* idx;              // (s, k) (top-k) or the counts (s,) (count)
  float* val;                  // (s, k) (top-k) or the tile (s, c) (tile)
  float* part_v;               // top-k: [segments][kBQ][k] partial keys' scores
  int* part_i;                 // top-k: their columns; count: [segments][kBQ] partial counts
  int* tickets;                // [strips]: units of the strip done; 0 between launches
};

// ---- the partition: the strips' tiles, strip-major, cut into `units`
// ranges [u·W/G, (u + 1)·W/G); kernels/l1_search.py::segments mirrors it.

__host__ __device__ __forceinline__ long long range_begin(long long b, long long w, long long g) {
  return b * w / g;
}

// The unit whose range holds flat tile u: the largest b with b·W/G ≤ u.
__device__ __forceinline__ int unit_of(long long u, long long w, long long g) {
  return static_cast<int>(((u + 1) * g + w - 1) / w - 1);
}

// ---- mbarriers and barriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
                   smem_u32(b))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* b, int bytes) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
                   smem_u32(b)), "r"(bytes)
               : "memory");
}

// A 2-D box of the tensor map at (x, y) into shared memory, counted on b.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y,
                                         uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(b))
      : "memory");
}

// A barrier of the n threads that returns whether any of them passed true.
__device__ __forceinline__ bool bar_any(int id, int n, bool v) {
  uint32_t out;
  asm volatile(
      "{\n .reg .pred pi, po;\n setp.ne.u32 pi, %1, 0;\n bar.red.or.pred po, %2, %3, pi;\n"
      " selp.u32 %0, 1, 0, po;\n}\n"
      : "=r"(out)
      : "r"(static_cast<uint32_t>(v)), "r"(id), "r"(n)
      : "memory");
  return out != 0;
}

template <int C>
__device__ __forceinline__ float comp(const float4& v) {
  return C == 0 ? v.x : C == 1 ? v.y : C == 2 ? v.z : v.w;
}

// Term c of a query row against the thread's kTC columns: the kTC
// subtracts share the query's value, then each column's sum takes its
// |difference|, so each sum still runs c = 0 … d − 1.
template <int C>
__device__ __forceinline__ void add_term(float (&acc)[kTC], const float4& x,
                                         const float4 (&y)[kTC]) {
  const float xc = comp<C>(x);
  float t[kTC];
#pragma unroll
  for (int jj = 0; jj < kTC; ++jj) t[jj] = xc - comp<C>(y[jj]);
#pragma unroll
  for (int jj = 0; jj < kTC; ++jj) acc[jj] += fabsf(t[jj]);
}

// ---- the rows' queues (top-k)

struct Rows {
  float* thv;  // [kBQ] threshold: the key of queue entry k − 1
  int* thi;
  int* cnt;    // [kBQ] survivors buffered (may pass kBuf: the excess waits)
  float* qv;   // [kBQ][32·NQ] sorted queues
  int* qi;
  float* bv;   // [kBQ][kBuf] buffers
  int* bi;
};

// Merge a row's n buffered survivors (n ≤ 32·NB) into its sorted queue of
// 32·NQ, by one warp in registers (topk_queue.cuh's merge_row, inlined): a
// bitonic sort of the buffer, the elementwise min of the queue and the
// reversed buffer, a bitonic merge.  Returns the row's new threshold in
// every lane.
template <int NQ, int NB>
__device__ __forceinline__ Key merge_into(float* qv, int* qi, const float* bv, const int* bi,
                                          int n, int k, int lane) {
  Key b[NB], q[NQ];
  __syncwarp();
#pragma unroll
  for (int s = 0; s < NB; ++s) {
    const int e = 32 * s + lane;
    b[s] = e < n ? Key{bv[e], bi[e]} : Key{INFINITY, kNone};
  }
#pragma unroll
  for (int s = 0; s < NQ; ++s) q[s] = Key{qv[32 * s + lane], qi[32 * s + lane]};
  __syncwarp();
#pragma unroll
  for (int size = 2; size <= 32 * NB; size <<= 1)
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
  for (int stride = 16 * NQ; stride > 0; stride >>= 1) bitonic_step<NQ>(q, 64 * NQ, stride, lane);
  Key t{INFINITY, kNone};
#pragma unroll
  for (int s = 0; s < NQ; ++s) {
    qv[32 * s + lane] = q[s].v;
    qi[32 * s + lane] = q[s].i;
    if (s == (k - 1) >> 5) t = q[s];
  }
  return Key{__shfl_sync(kFull, t.v, (k - 1) & 31), __shfl_sync(kFull, t.i, (k - 1) & 31)};
}

// Every row holding at least min_n survivors (at most 32·NB) is merged,
// warp w taking rows w, w + 4, …; the caller synchronises the score warps
// before and after.
template <int NQ, int NB = kBuf / 32>
__device__ __forceinline__ void merge_rows(const Rows& rs, int min_n, int k, int warp, int lane) {
  constexpr int kq = 32 * NQ;
  for (int r = warp; r < kBQ; r += kScoreWarps) {
    const int n = rs.cnt[r];
    if (n >= min_n && n > 0) {
      const Key th = merge_into<NQ, NB>(rs.qv + r * kq, rs.qi + r * kq, rs.bv + r * kBuf,
                                        rs.bi + r * kBuf, min(n, 32 * NB), k, lane);
      __syncwarp();
      if (lane == 0) {
        rs.thv[r] = th.v;
        rs.thi[r] = th.i;
        rs.cnt[r] = 0;
      }
    }
  }
}

// Append what is pending (append() returns whether something still waits
// for room); while any score thread waits, merge the full and nearly full
// buffers, lower the thresholds, filter what waits again (refilter()) and
// append it.
template <int NQ, class Append, class Refilter>
__device__ __forceinline__ void drain(const Rows& rs, int k, int warp, int lane, Append append,
                                      Refilter refilter) {
  for (;;) {
    const bool left = append();
    if (!bar_any(kBarScore, kScoreThreads, left)) return;
    merge_rows<NQ>(rs, kMergeAt, k, warp, lane);
    bar_sync(kBarScore, kScoreThreads);
    refilter();
  }
}

// ---- the kernel

template <int kMode, int NQ>
__global__ void __launch_bounds__(kThreads, 2)
    l1_kernel(Args p, const __grid_constant__ CUtensorMap map_q,
              const __grid_constant__ CUtensorMap map_c) {
  constexpr int kq = 32 * NQ;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the ring starts on a 1,024-byte boundary, as the swizzle's addresses assume
  unsigned char* smem = smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  float* ring = reinterpret_cast<float*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * kStageFloats);
  uint64_t* empty = full + p.stages;
  int* flag = reinterpret_cast<int*>(empty + p.stages);  // [4]
  Rows rs;
  int* row_col = flag + 4;                               // [kBQ] exclude / self column (−1: none)
  float* row_th = reinterpret_cast<float*>(row_col + kBQ);  // [kBQ] count: the thresholds
  rs.thv = row_th + kBQ;
  rs.thi = reinterpret_cast<int*>(rs.thv + kBQ);
  rs.cnt = rs.thi + kBQ;
  rs.qv = reinterpret_cast<float*>(rs.cnt + kBQ);
  rs.qi = reinterpret_cast<int*>(rs.qv + kBQ * kq);
  rs.bv = reinterpret_cast<float*>(rs.qi + kBQ * kq);
  rs.bi = reinterpret_cast<int*>(rs.bv + kBQ * kBuf);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (p.c + kBC - 1) / kBC;
  const long long w = static_cast<long long>((p.s + kBQ - 1) / kBQ) * n_tiles;
  const long long g = p.units;
  const long long u0 = range_begin(blockIdx.x, w, g), u1 = range_begin(blockIdx.x + 1, w, g);
  const int nkc = (p.d + kKC - 1) / kKC;

  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kScoreThreads);
    }
  }
  __syncthreads();

  if (warp == kScoreWarps) {
    // the producer: one thread copies each stage's query and candidate
    // rows (zero past S, C and d) as two tensor boxes; the stage's full
    // barrier completes when their bytes have landed
    if (lane == 0) {
      int st = 0, phase = 0, used = 0;
      for (long long u = u0; u < u1; ++u) {
        const int q0 = static_cast<int>(u / n_tiles) * kBQ;
        const int c0 = static_cast<int>(u % n_tiles) * kBC;
        for (int kc = 0; kc < nkc; ++kc) {
          if (used >= p.stages) mbar_wait(empty + st, phase ^ 1);
          float* dst = ring + st * kStageFloats;
          mbar_expect(full + st, kStageFloats * 4);
          tma_load(dst, &map_q, kc * kKC, q0, full + st);
          tma_load(dst + kBQ * kKC, &map_c, kc * kKC, c0, full + st);
          ++used;
          if (++st == p.stages) {
            st = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- the score warps
  const int lr = lane >> 3, lc = lane & 7;
  const int wc = warp * kWarpCols + lc;  // the thread's first column within a tile
  int st = 0, phase = 0;
  int row_cnt[kTR];                      // count: the thread's share of each row's count
  (void)row_cnt;

  for (long long u = u0; u < u1; ++u) {
    const int strip = static_cast<int>(u / n_tiles), t = static_cast<int>(u % n_tiles);
    const int q0 = strip * kBQ, c0 = t * kBC;
    const int n_rows = min(kBQ, p.s - q0);
    const bool seg_first = u == u0 || t == 0;
    const bool seg_last = u == u1 - 1 || t == n_tiles - 1;

    if (seg_first) {
      if (tid < kBQ) {
        row_col[tid] = tid < n_rows && p.row_col != nullptr
                           ? static_cast<int>(max(__ldg(p.row_col + q0 + tid), -1LL))
                           : -1;
        if constexpr (kMode == kCount) row_th[tid] = tid < n_rows ? __ldg(p.thresh + q0 + tid) : 0.f;
      }
      if constexpr (kMode == kCount) {
#pragma unroll
        for (int ii = 0; ii < kTR; ++ii) row_cnt[ii] = 0;
      }
      if constexpr (kMode == kTopk) {
        for (int i = tid; i < kBQ * kq; i += kScoreThreads) {
          rs.qv[i] = INFINITY;
          rs.qi[i] = kNone;
        }
        if (tid < kBQ) {
          rs.thv[tid] = INFINITY;
          rs.thi[tid] = kNone;
          rs.cnt[tid] = 0;
        }
        bar_sync(kBarScore, kScoreThreads);
      } else {
        if (tid < kBQ) rs.cnt[tid] = 0;
        bar_sync(kBarScore, kScoreThreads);
      }
    }

    // the tile's distances: d in stages of kKC, c = 0 … d − 1 in order
    float acc[kTR][kTC];
#pragma unroll
    for (int ii = 0; ii < kTR; ++ii)
#pragma unroll
      for (int jj = 0; jj < kTC; ++jj) acc[ii][jj] = 0.f;
    for (int kc = 0; kc < nkc; ++kc) {
      mbar_wait(full + st, phase);
      // row r's 16-byte piece pl sits at piece pl ^ ((r >> 2) & 1) (the 32-byte swizzle)
      const float4* stage = reinterpret_cast<const float4*>(ring + st * kStageFloats);
#pragma unroll
      for (int pl = 0; pl < kPlanes; ++pl) {
        const float4* xs = stage + 2 * lr;
        const float4* ys = stage + 2 * (kBQ + wc) + (pl ^ ((lc >> 2) & 1));
        float4 y[kTC];
#pragma unroll
        for (int jj = 0; jj < kTC; ++jj) y[jj] = ys[16 * jj];
#pragma unroll
        for (int ii = 0; ii < kTR; ++ii) {
          const float4 x = xs[8 * ii + (pl ^ (ii & 1))];
          add_term<0>(acc[ii], x, y);
          add_term<1>(acc[ii], x, y);
          add_term<2>(acc[ii], x, y);
          add_term<3>(acc[ii], x, y);
        }
      }
      mbar_arrive(empty + st);
      if (++st == p.stages) {
        st = 0;
        phase ^= 1;
      }
    }

    // the epilogue: scores, masks, and the entry's use of them
    float bias[kTC];
    bool ok[kTC];
#pragma unroll
    for (int jj = 0; jj < kTC; ++jj) {
      const int col = c0 + wc + 8 * jj;
      const bool in = col < p.c;
      ok[jj] = in && (p.col_mask == nullptr || __ldg(p.col_mask + col) != 0);
      bias[jj] = in && p.bias != nullptr ? __ldg(p.bias + col) : 0.f;
    }
    if constexpr (kMode == kCount) {
#pragma unroll
      for (int ii = 0; ii < kTR; ++ii) {
        const int r = lr + 4 * ii, self = row_col[r];
        const float th = row_th[r];
#pragma unroll
        for (int jj = 0; jj < kTC; ++jj) {
          const int col = c0 + wc + 8 * jj;
          const float sc = __fmaf_rn(p.a, acc[ii][jj], -bias[jj]);
          row_cnt[ii] += col < p.c && col != self && sc < th;
        }
      }
    } else if constexpr (kMode == kTile) {
#pragma unroll
      for (int ii = 0; ii < kTR; ++ii) {
        const int r = lr + 4 * ii;
        if (r >= n_rows) continue;
        const int ex = row_col[r];
        float* out = p.val + static_cast<size_t>(q0 + r) * p.c;
#pragma unroll
        for (int jj = 0; jj < kTC; ++jj) {
          const int col = c0 + wc + 8 * jj;
          const float sc = __fmaf_rn(p.a, acc[ii][jj], -bias[jj]);
          if (col < p.c) out[col] = ok[jj] && col != ex && !isnan(sc) ? sc : INFINITY;
        }
      }
    } else {
#pragma unroll
      for (int ii = 0; ii < kTR; ++ii) {
        const int ex = row_col[lr + 4 * ii];
#pragma unroll
        for (int jj = 0; jj < kTC; ++jj) {
          const int col = c0 + wc + 8 * jj;
          const float sc = __fmaf_rn(p.a, acc[ii][jj], -bias[jj]);
          acc[ii][jj] = ok[jj] && col != ex && !isnan(sc) ? sc : INFINITY;
        }
      }
      // k ≤ 32, the piece's first tile: each thread's least key of each row
      // (32 a row) seeds the row's queue with one small merge, so the rest of
      // the tile meets a threshold (the k-th of those keys, which k keys
      // stand under) instead of +inf
      uint64_t seeded = 0;
      if constexpr (NQ == 1) {
        if (seg_first) {
#pragma unroll
          for (int ii = 0; ii < kTR; ++ii) {
            const int r = lr + 4 * ii;
            float bv = INFINITY;
            int bc = kNone, bj = -1;
#pragma unroll
            for (int jj = 0; jj < kTC; ++jj) {
              const int col = c0 + wc + 8 * jj;
              if (r < n_rows && col < p.c && key_less(acc[ii][jj], col, bv, bc)) {
                bv = acc[ii][jj];
                bc = col;
                bj = jj;
              }
            }
            if (bj >= 0) {
              const int at = atomicAdd(rs.cnt + r, 1);
              rs.bv[r * kBuf + at] = bv;
              rs.bi[r * kBuf + at] = bc;
              seeded |= 1ull << (8 * ii + bj);
            }
          }
          bar_sync(kBarScore, kScoreThreads);
          merge_rows<NQ, 1>(rs, 1, p.k, warp, lane);
          bar_sync(kBarScore, kScoreThreads);
        }
      }
      // filter by the rows' thresholds (read since the last merge), then
      // append the survivors, 8 lanes a row, one atomic per row and warp
      uint64_t pend = 0;
#pragma unroll
      for (int ii = 0; ii < kTR; ++ii) {
        const int r = lr + 4 * ii;
        const float tv = rs.thv[r];
        const int ti = rs.thi[r];
#pragma unroll
        for (int jj = 0; jj < kTC; ++jj) {
          const int col = c0 + wc + 8 * jj;
          if (r < n_rows && col < p.c && key_less(acc[ii][jj], col, tv, ti))
            pend |= 1ull << (8 * ii + jj);
        }
      }
      pend &= ~seeded;
      auto append = [&]() -> bool {
        if (!__any_sync(kFull, pend != 0)) return false;
#pragma unroll
        for (int ii = 0; ii < kTR; ++ii) {
          const unsigned bits = static_cast<unsigned>(pend >> (8 * ii)) & 0xffu;
          if (!__any_sync(kFull, bits != 0)) continue;
          const int r = lr + 4 * ii;
          const int n = __popc(bits);
          int incl = n;  // inclusive scan over the row's 8 lanes
#pragma unroll
          for (int off = 1; off < 8; off <<= 1) {
            const int v = __shfl_up_sync(kFull, incl, off, 8);
            if (lc >= off) incl += v;
          }
          const int total = __shfl_sync(kFull, incl, 7, 8);
          int base = 0;
          if (lc == 7 && total > 0) base = atomicAdd(rs.cnt + r, total);
          int pos = __shfl_sync(kFull, base, 7, 8) + incl - n;
#pragma unroll
          for (int jj = 0; jj < kTC; ++jj) {
            if ((bits >> jj) & 1u) {
              if (pos < kBuf) {
                rs.bv[r * kBuf + pos] = acc[ii][jj];
                rs.bi[r * kBuf + pos] = c0 + wc + 8 * jj;
                pend &= ~(1ull << (8 * ii + jj));
              }
              ++pos;
            }
          }
        }
        return pend != 0;
      };
      auto refilter = [&]() {
#pragma unroll
        for (int ii = 0; ii < kTR; ++ii) {
          const int r = lr + 4 * ii;
          const float tv = rs.thv[r];
          const int ti = rs.thi[r];
#pragma unroll
          for (int jj = 0; jj < kTC; ++jj)
            if (((pend >> (8 * ii + jj)) & 1ull) &&
                !key_less(acc[ii][jj], c0 + wc + 8 * jj, tv, ti))
              pend &= ~(1ull << (8 * ii + jj));
        }
      };
      drain<NQ>(rs, p.k, warp, lane, append, refilter);
    }

    if (!seg_last) continue;
    if constexpr (kMode == kTile) {
      bar_sync(kBarScore, kScoreThreads);  // the rows' columns are read before the next strip's
      continue;
    }

    // ---- the end of the strip's segment in this unit
    const int b_first = unit_of(static_cast<long long>(strip) * n_tiles, w, g);
    const int b_last = unit_of(static_cast<long long>(strip) * n_tiles + n_tiles - 1, w, g);
    const int n_seg = b_last - b_first + 1;
    const long long seg = static_cast<long long>(strip) + blockIdx.x;  // unique per segment
    if constexpr (kMode == kCount) {
#pragma unroll
      for (int ii = 0; ii < kTR; ++ii) {
        int n = row_cnt[ii];
        n += __shfl_xor_sync(kFull, n, 1);
        n += __shfl_xor_sync(kFull, n, 2);
        n += __shfl_xor_sync(kFull, n, 4);
        if (lc == 0 && n > 0) atomicAdd(rs.cnt + lr + 4 * ii, n);
      }
      bar_sync(kBarScore, kScoreThreads);
      bool last = true;
      if (n_seg > 1) {
        if (tid < n_rows) p.part_i[seg * kBQ + tid] = rs.cnt[tid];
        __threadfence();
        bar_sync(kBarScore, kScoreThreads);
        if (tid == 0) flag[0] = atomicAdd(p.tickets + strip, 1);
        bar_sync(kBarScore, kScoreThreads);
        last = flag[0] == n_seg - 1;
        if (last) {
          __threadfence();
          if (tid == 0) p.tickets[strip] = 0;
        }
      }
      if (last && tid < n_rows) {
        long long n = rs.cnt[tid];
        for (int b = b_first; b <= b_last; ++b)
          if (b != static_cast<int>(blockIdx.x))
            n += __ldcg(p.part_i + (static_cast<long long>(strip) + b) * kBQ + tid);
        p.idx[q0 + tid] = n;
      }
      bar_sync(kBarScore, kScoreThreads);
    } else {
      merge_rows<NQ>(rs, 1, p.k, warp, lane);
      bar_sync(kBarScore, kScoreThreads);
      bool last = true;
      if (n_seg > 1) {
        for (int i = tid; i < n_rows * p.k; i += kScoreThreads) {
          const int r = i / p.k, j = i - r * p.k;
          const size_t o = (static_cast<size_t>(seg) * kBQ + r) * p.k + j;
          p.part_v[o] = rs.qv[r * kq + j];
          p.part_i[o] = rs.qi[r * kq + j];
        }
        __threadfence();
        bar_sync(kBarScore, kScoreThreads);
        if (tid == 0) flag[0] = atomicAdd(p.tickets + strip, 1);
        bar_sync(kBarScore, kScoreThreads);
        last = flag[0] == n_seg - 1;
        if (last) {
          // the other segments' keys, as survivors of one more pass
          __threadfence();
          for (int b = b_first; b <= b_last; ++b) {
            if (b == static_cast<int>(blockIdx.x)) continue;
            const size_t at = (static_cast<size_t>(strip) + b) * kBQ * p.k;
            for (int i0 = 0; i0 < n_rows * p.k; i0 += kScoreThreads) {
              const int i = i0 + tid;
              int r = 0, col = kNone;
              float v = INFINITY;
              bool waiting = false;
              if (i < n_rows * p.k) {
                r = i / p.k;
                v = __ldcg(p.part_v + at + i);
                col = __ldcg(p.part_i + at + i);
                waiting = key_less(v, col, rs.thv[r], rs.thi[r]);
              }
              auto append = [&]() -> bool {
                if (waiting) {
                  const int pos = atomicAdd(rs.cnt + r, 1);
                  if (pos < kBuf) {
                    rs.bv[r * kBuf + pos] = v;
                    rs.bi[r * kBuf + pos] = col;
                    waiting = false;
                  }
                }
                return waiting;
              };
              auto refilter = [&]() {
                waiting = waiting && key_less(v, col, rs.thv[r], rs.thi[r]);
              };
              drain<NQ>(rs, p.k, warp, lane, append, refilter);
            }
          }
          merge_rows<NQ>(rs, 1, p.k, warp, lane);
          bar_sync(kBarScore, kScoreThreads);
          if (tid == 0) p.tickets[strip] = 0;
        }
      }
      if (last) {
        for (int i = tid; i < n_rows * p.k; i += kScoreThreads) {
          const int r = i / p.k, j = i - r * p.k;
          const size_t o = static_cast<size_t>(q0 + r) * p.k + j;
          p.idx[o] = rs.qi[r * kq + j];
          p.val[o] = rs.qv[r * kq + j];
        }
      }
      bar_sync(kBarScore, kScoreThreads);  // the queues are read before the next segment resets them
    }
  }
}

// Dynamic shared memory of one block: room to align the ring, the ring, its
// barriers, the flag and the rows' columns, thresholds and counts; the
// top-k's queues and buffers.
// kernels/l1_search.py::smem_bytes mirrors it.
size_t l1_smem(int mode, int kq, int stages) {
  size_t n = kAlign + static_cast<size_t>(stages) * (kStageFloats * sizeof(float) +
                                                     2 * sizeof(uint64_t)) +
             4 * sizeof(int) + 5 * kBQ * sizeof(int);
  if (mode == kTopk) n += static_cast<size_t>(kBQ) * (kq + kBuf) * (sizeof(float) + sizeof(int));
  return n;
}

template <int kMode, int NQ>
cudaError_t prepare(size_t smem) {
  return cudaFuncSetAttribute(l1_kernel<kMode, NQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// A (rows, d) fp32 matrix as a tensor map of boxes of kKC × box_rows,
// 32-byte swizzled, zero past its rows and d.
int tensor_map(CUtensorMap* map, const float* base, int rows, int d, int box_rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                              reinterpret_cast<void**>(&encode),
                                              cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || encode == nullptr) return cudaErrorNotSupported;
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * sizeof(float)};
  const cuuint32_t box[2] = {kKC, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims,
                            strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int kMode, int NQ>
int launch(const Args& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = prepare<kMode, NQ>(smem);
  if (err != cudaSuccess) return err;
  CUtensorMap map_q, map_c;
  int e = tensor_map(&map_q, a.q, a.s, a.d, kBQ);
  if (e == 0) e = tensor_map(&map_c, a.cands, a.c, a.d, kBC);
  if (e != 0) return e;
  l1_kernel<kMode, NQ><<<a.units, kThreads, smem, stream>>>(a, map_q, map_c);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode, int NQ>
int occupancy(size_t smem, int* out) {
  cudaError_t err = prepare<kMode, NQ>(smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, l1_kernel<kMode, NQ>, kThreads, smem);
}

// The launch of an entry at queue size kq (top-k) with its shared memory checked.
int dispatch(int mode, int kq, const Args& a, cudaStream_t stream, int* blocks) {
  cudaError_t err;
  int dev = 0, limit = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return err;
  const size_t smem = l1_smem(mode, kq, a.stages);
  if (smem > static_cast<size_t>(limit)) return cudaErrorInvalidValue;
  if (mode == kCount)
    return blocks ? occupancy<kCount, 1>(smem, blocks) : launch<kCount, 1>(a, smem, stream);
  if (mode == kTile)
    return blocks ? occupancy<kTile, 1>(smem, blocks) : launch<kTile, 1>(a, smem, stream);
  switch (kq) {
    case 32:
      return blocks ? occupancy<kTopk, 1>(smem, blocks) : launch<kTopk, 1>(a, smem, stream);
    case 64:
      return blocks ? occupancy<kTopk, 2>(smem, blocks) : launch<kTopk, 2>(a, smem, stream);
    case 128:
      return blocks ? occupancy<kTopk, 4>(smem, blocks) : launch<kTopk, 4>(a, smem, stream);
    default:
      return blocks ? occupancy<kTopk, 8>(smem, blocks) : launch<kTopk, 8>(a, smem, stream);
  }
}

bool bad_kq(int kq) { return kq < 32 || kq > 256 || (kq & (kq - 1)) != 0; }

bool bad_shape(int s, int c, int d) { return s < 0 || c < 1 || d < 4 || d > kMaxD || d % 4 != 0; }

// 1 ≤ units ≤ the strips' tiles; stages in [kMinStages, kMaxStages].
bool bad_plan(int s, int c, int units, int stages) {
  const long long w =
      static_cast<long long>((s + kBQ - 1) / kBQ) * ((c + kBC - 1) / kBC);
  return units < 1 || units > w || stages < kMinStages || stages > kMaxStages;
}

}  // namespace

// q (s, d), cands (c, d), bias (c,) float32; col_mask (c,) uint8; exclude
// (s,) int64 (< 0: none); bias, col_mask and exclude may be null.  All
// contiguous and 16-byte aligned, d % 4 == 0, 4 ≤ d ≤ 512, 1 ≤ k ≤ min(kq,
// c), kq a power of two in [32, 256].  `units` blocks (1 ≤ units ≤ the
// strips' tiles, ceil(s/32)·ceil(c/256)) and a ring of `stages` stages.
// part_v (float32) and part_i (int32) hold (s/32 + units) · 32 · k entries
// each (unused when every strip lies in one unit); tickets (int32, one a
// strip) are 0 and left so.  Writes idx (s, k) int64 and val (s, k)
// float32.  Each entry is one kernel launch and returns its cudaError_t (0
// on success).
extern "C" int l1_topk_forward(const float* q, const float* cands, const float* bias,
                               const uint8_t* col_mask, const long long* exclude, float a, int s,
                               int c, int d, int k, int kq, int units, int stages, float* part_v,
                               int* part_i, int* tickets, long long* idx, float* val,
                               void* stream) {
  if (bad_shape(s, c, d) || bad_kq(kq) || k < 1 || k > kq || k > c) return cudaErrorInvalidValue;
  if (s == 0) return cudaSuccess;
  if (bad_plan(s, c, units, stages) || tickets == nullptr) return cudaErrorInvalidValue;
  const Args args{q, cands, bias, col_mask, exclude, nullptr, a, s, c, d, k, units, stages,
                  idx, val, part_v, part_i, tickets};
  return dispatch(kTopk, kq, args, static_cast<cudaStream_t>(stream), nullptr);
}

// thresh (s,) float32, self_col (s,) int64 (< 0: none; may be null);
// part_i (int32) holds (s/32 + units) · 32 entries.  Writes count (s,) int64.
extern "C" int l1_count_forward(const float* q, const float* cands, const float* bias,
                                const float* thresh, const long long* self_col, float a, int s,
                                int c, int d, int units, int stages, int* part_i, int* tickets,
                                long long* count, void* stream) {
  if (bad_shape(s, c, d) || thresh == nullptr) return cudaErrorInvalidValue;
  if (s == 0) return cudaSuccess;
  if (bad_plan(s, c, units, stages) || tickets == nullptr) return cudaErrorInvalidValue;
  const Args args{q, cands, bias, nullptr, self_col, thresh, a, s, c, d, 0, units, stages,
                  count, nullptr, nullptr, part_i, tickets};
  return dispatch(kCount, 32, args, static_cast<cudaStream_t>(stream), nullptr);
}

// Writes out (s, c) float32: s(i, j), +inf where masked.
extern "C" int l1_tile_forward(const float* q, const float* cands, const float* bias,
                               const uint8_t* col_mask, const long long* exclude, float a, int s,
                               int c, int d, int units, int stages, float* out, void* stream) {
  if (bad_shape(s, c, d)) return cudaErrorInvalidValue;
  if (s == 0) return cudaSuccess;
  if (bad_plan(s, c, units, stages)) return cudaErrorInvalidValue;
  const Args args{q, cands, bias, col_mask, exclude, nullptr, a, s, c, d, 0, units, stages,
                  nullptr, out, nullptr, nullptr, nullptr};
  return dispatch(kTile, 32, args, static_cast<cudaStream_t>(stream), nullptr);
}

// The blocks of an entry (0 top-k, 1 count, 2 tile) that one SM holds at
// queue size kq and `stages` stages, into *blocks; and the shared memory
// of one block.  For the host's planner.
extern "C" int l1_blocks_per_sm(int mode, int kq, int stages, int* blocks) {
  if (mode < kTopk || mode > kTile || bad_kq(kq) || stages < kMinStages || stages > kMaxStages ||
      blocks == nullptr)
    return cudaErrorInvalidValue;
  Args args{};
  args.stages = stages;
  return dispatch(mode, kq, args, nullptr, blocks);
}

extern "C" long long l1_smem_bytes(int mode, int kq, int stages) {
  return static_cast<long long>(l1_smem(mode, kq, stages));
}
