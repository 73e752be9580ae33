// The shortlist kernels of the approximate search paths, for Hopper (sm_90a).
//
// 1. shortlist_select_forward — select and rerank in one launch.  For a
//    query block q (S, d) fp32 against cands (C, d) fp32:
//
//      sel[i, j]  = ‖q_i‖² + c2[j] − 2·q_i·c_j        (the expanded form, not clamped)
//      sel[i, j]  = a·sel[i, j] − bias[j]             (CSLS: a = 2, bias = r_sel)
//      sel[i, j]  = +inf where col_mask[j] is 0 or j == exclude[i]
//      sidx[i, :] = the k columns of least sel, ascending by (sel, column)
//      sval[i, :] = sel at those columns
//      dist[i, :] = Σ_c f(q[i, c] − cands[sidx[i, :], c]), f = |·| or (·)²   (optional)
//
//    Replaces the JAX package's composite of XLA ops and approx_min_k:
//    the selection tile, mask, approx_min_k and gather + L1 of
//    tpugraph/train/negatives.py:178 and :260-262 (mining),
//    train/bootstrap.py:125-137 (proposals, bf16 operands), train/eval.py:112-159
//    (prefiltered ranks) and serve.py:85-88 (prefiltered top-k).  No (S, C)
//    tile is ever written to device memory.
//
//    What bounds it on an H100: the S·C·d products.  With fp32 operands they
//    run as a 3× TF32 split (x = big + small, a·b ≈ big·big + big·small +
//    small·big, fp32 accumulation, as sinkhorn_fused.cu), so the bound is
//    3·2·S·C·d at the TF32 rate (≈ 0.41 ms for 7,000 mining queries against
//    19,000 rows at d = 256).  One TF32 product would move the shortlist's
//    sets: near-fp32 scores keep them.  With bf16 operands (the proposals)
//    each product of two bf16 values is exact in fp32, so one bf16 mma with
//    fp32 accumulation gives the plain path's arithmetic.
//
//    Design:
//      * a block owns 32 query rows and is warp-specialised: 8 product warps
//        (2 × 4) each compute a 16 × 32 piece of a 32 × 128 score tile with
//        mma.sync (m16n8k8 TF32 ×3, or m16n8k16 bf16), and 8 selection
//        warps each own 4 of the rows.  The query rows stay in shared memory
//        in fp32; candidate tiles stream through a two-stage cp.async ring
//        in chunks of 32 of d (unpadded rows with a swizzle);
//      * above d = 512 (kResidentD) the strip no longer stays (its 32 rows
//        alone would take 4·32·d bytes, 132 KB at 1,024, beside the queues):
//        it streams too, each ring slot holding the candidate chunk and the
//        strip's chunk of the same 32 of d in the same swizzled layout, so
//        shared memory does not grow with d and any width runs.  A tile's
//        products are still summed over the chunks of d in the same order
//        into the same accumulators, so a score is the resident kernel's
//        arithmetic; the strip is read once a tile (from L2);
//      * the product warps' epilogue applies the norms, a, the bias, the
//        column mask and the exclusion in registers and leaves the tile's
//        scores in one of up to 4 slots of shared memory; named barriers
//        ("full", "empty") per slot hand it to the selection warps, so the
//        products of the next tiles run while the rows are selected;
//      * the selection warps keep each row's running top-k in the warp-merged
//        queue of topk_queue.cuh (the block-select structure of Johnson,
//        Douze and Jégou, 2017): exact by (sel, column) whatever the order
//        of the tiles, so two launches agree bit for bit;
//      * the rerank scores the queue's rows with one warp per query, 8 table
//        rows in flight, float4 loads, the query row from shared memory
//        (from L2 above kResidentD, in the same order of terms).
//
// 2. shortlist_dist_forward — the gathered distances alone, for a shortlist
//    the caller already holds (the unfused route, k above the queue's 256):
//
//      out[i, j] = Σ_c f(q[i, c] − table[idx[i, j], c]),  f = |·| or (·)²
//
//    one warp per query row, its K entries taken 4 at a time (4 table rows in
//    flight), lanes striding over the width in float4 loads.  Every sum runs
//    in a fixed order.  Indices are trusted to lie in [0, C).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"
#include "topk_queue.cuh"

namespace {

using namespace topk;
using tf32::mma_tf32;
using tf32::split_tf32;

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

// One query row's distances to n table rows, by one warp, kUnroll table
// rows in flight: entry u of the row is table row idx_of(u).  qrow and table
// hold Vec elements, dv per row.
template <bool kSq, int kUnroll, typename Vec, typename IdxOf>
__device__ __forceinline__ void row_dists(const Vec* qrow, const Vec* __restrict__ tab, int dv,
                                          int n, IdxOf idx_of, float* __restrict__ orow,
                                          int lane) {
  for (int u0 = 0; u0 < n; u0 += kUnroll) {
    const Vec* trow[kUnroll];
    float acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // entries past the end repeat the last one and are not written
      trow[u] = tab + static_cast<size_t>(idx_of(min(u0 + u, n - 1))) * dv;
      acc[u] = 0.f;
    }
    for (int c = lane; c < dv; c += 32) {
      const Vec a = qrow[c];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc[u] += terms<kSq>(a, __ldg(trow[u] + c));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[u] += __shfl_xor_sync(kFull, acc[u], off);
    }
    float mine = acc[0];
#pragma unroll
    for (int u = 1; u < kUnroll; ++u) mine = lane == u ? acc[u] : mine;
    if (lane < kUnroll && u0 + lane < n) orow[u0 + lane] = mine;
  }
}

// ---------------------------------------------------------------- gather

constexpr int kGatherThreads = 256;
constexpr int kGatherWarps = kGatherThreads / 32;

// Vec is float4 (d % 4 == 0, aligned) or float; dv = d / (width of Vec)
template <bool kSq, typename Vec>
__global__ void __launch_bounds__(kGatherThreads)
shortlist_dist_kernel(const float* __restrict__ q, const float* __restrict__ table,
                      const long long* __restrict__ idx, float* __restrict__ out, int s, int k,
                      int dv) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kGatherWarps + (threadIdx.x >> 5);
  if (row >= s) return;  // warp-uniform: one row per warp
  const Vec* qrow = reinterpret_cast<const Vec*>(q) + static_cast<size_t>(row) * dv;
  const long long* irow = idx + static_cast<size_t>(row) * k;
  float* orow = out + static_cast<size_t>(row) * k;
  for (int j0 = 0; j0 < k; j0 += 32) {
    const int n = min(32, k - j0);
    const long long mine = lane < n ? __ldg(irow + j0 + lane) : 0;
    row_dists<kSq, 4>(qrow, reinterpret_cast<const Vec*>(table), dv, n,
                   [&](int u) { return __shfl_sync(kFull, mine, u); }, orow + j0, lane);
  }
}

template <bool kSq>
int launch_gather(const float* q, const float* table, const long long* idx, float* out, int s,
                  int k, int d, cudaStream_t stream) {
  const dim3 grid((s + kGatherWarps - 1) / kGatherWarps);
  const bool vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(table) % 16 == 0;
  if (vec4)
    shortlist_dist_kernel<kSq, float4><<<grid, kGatherThreads, 0, stream>>>(q, table, idx, out,
                                                                            s, k, d / 4);
  else
    shortlist_dist_kernel<kSq, float><<<grid, kGatherThreads, 0, stream>>>(q, table, idx, out,
                                                                           s, k, d);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- select

constexpr int kWarpsM = 2;     // product warps along the query rows
constexpr int kWarpsN = 4;     // product warps along the candidate columns
constexpr int kMmaWarps = kWarpsM * kWarpsN;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kWarps = kMmaWarps + kSelWarps;
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = kBQ / (16 * kWarpsM);  // m16 tiles per product warp
constexpr int kRows = 2 * kMT;  // fragment rows per thread
constexpr int kKC = 32;        // d per pipeline chunk: a ring row is 128 bytes
constexpr int kStages = 2;     // ring depth: deeper rings measured no faster
constexpr int kPad = 16;       // query-row padding (floats): stride ≡ 16 mod 32 banks
constexpr int kRerankRows = 8;  // table rows in flight per warp in the rerank
constexpr int kResidentD = 512;  // the widest d whose query strip stays in shared memory

struct SelectArgs {
  const float* q;              // (s, d)
  const float* cands;          // (c, d)
  const float* q2;             // (s,)
  const float* c2;             // (c,)
  const float* bias;           // (c,) or null
  const uint8_t* col_mask;     // (c,) or null
  const long long* exclude;    // (s,) or null; -1 = none
  float a;
  int s, c, d, k, kq, rerank;  // rerank: 0 none, 1 cityblock, 2 sqeuclidean
  long long* sidx;             // (s, k)
  float* sval;                 // (s, k)
  float* dist;                 // (s, k) or null
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The ring's 16-byte granule g of candidate row `row` lies at granule
// g ^ 4·(row & 1): the two rows a quarter-warp's fragment loads touch then
// fill all 32 banks, with no padding.
__device__ __forceinline__ int ring_at(int row, int granule) {
  return row * kKC + ((granule ^ ((row & 1) << 2)) << 2);
}

// Candidate rows [c0, c0 + kBC) × d-chunk [k0, k0 + kKC) into one ring
// slot; rows past C and columns past d are zero-filled.
__device__ __forceinline__ void load_chunk(float* dst, const float* __restrict__ cands, int c0,
                                           int k0, int n_c, int d, int tid) {
#pragma unroll
  for (int j = 0; j < kBC * (kKC / 4) / kMmaThreads; ++j) {
    const int i = j * kMmaThreads + tid;
    const int row = i / (kKC / 4), f4 = i % (kKC / 4);
    const int col = c0 + row, k = k0 + f4 * 4;
    const bool valid = col < n_c && k < d;
    const float* src = valid ? cands + static_cast<size_t>(col) * d + k : cands;
    cp_async16(dst + ring_at(row, f4), src, valid);
  }
}

// The strip's rows [q0, q0 + kBQ) × d-chunk [k0, k0 + kKC) into a ring
// slot after its candidate chunk (kStream), one 16-byte copy a product
// thread, in the candidates' swizzled layout; rows past S and columns past
// d are zero-filled.
__device__ __forceinline__ void load_query_chunk(float* dst, const float* __restrict__ q, int q0,
                                                 int k0, int n_q, int d, int tid) {
  static_assert(kBQ * (kKC / 4) == kMmaThreads, "one copy a product thread");
  const int row = tid / (kKC / 4), f4 = tid % (kKC / 4);
  const int qr = q0 + row, k = k0 + f4 * 4;
  const bool valid = qr < n_q && k < d;
  const float* src = valid ? q + static_cast<size_t>(qr) * d + k : q;
  cp_async16(dst + ring_at(row, f4), src, valid);
}

// The floats of one ring slot: the candidate chunk, and with kStream the
// strip's chunk after it.
template <bool kStream>
constexpr int kSlot = (kBC + (kStream ? kBQ : 0)) * kKC;

// This warp's piece of one d-chunk's products: its 32 columns of the tile
// against its 16·kMT rows.  Fragment rows are g and g + 8 of each m-tile;
// the k index of each group of 16 is permuted the same way for both operands
// so every fragment row is one 16-byte shared load.  The strip's rows are
// the resident strip's (row stride l_stride, the chunk at koff) or, with
// kStream, the slot's chunk after the candidates' (rb + kBC·kKC, swizzled).
template <bool kBf16, bool kStream>
__device__ __forceinline__ void chunk_products(float (&acc)[kMT][4][4], const float* strip,
                                               int l_stride, int koff, const float* rb, int wm,
                                               int wn, int gq, int tq) {
#pragma unroll
  for (int kk = 0; kk < kKC; kk += 16) {
    float4 av[kMT][2], bv[4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 16 * kMT + mt * 16 + h * 8 + gq;
        av[mt][h] = kStream ? *reinterpret_cast<const float4*>(rb + kBC * kKC +
                                                               ring_at(row, kk / 4 + tq))
                            : *reinterpret_cast<const float4*>(strip + row * l_stride + koff +
                                                               kk + tq * 4);
      }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      bv[nt] = *reinterpret_cast<const float4*>(rb + ring_at(wn * 32 + nt * 8 + gq, kk / 4 + tq));
    if constexpr (kBf16) {
      // m16n8k16: a = (g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..);
      // b = (2t..2t+1, g), (2t+8.., g); logical k 2t, 2t+1, 2t+8, 2t+9 are
      // d = kk + 4t + 0, 1, 2, 3
      uint32_t a[kMT][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        a[mt][0] = pack_bf16(av[mt][0].x, av[mt][0].y);
        a[mt][1] = pack_bf16(av[mt][1].x, av[mt][1].y);
        a[mt][2] = pack_bf16(av[mt][0].z, av[mt][0].w);
        a[mt][3] = pack_bf16(av[mt][1].z, av[mt][1].w);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        b[nt][0] = pack_bf16(bv[nt].x, bv[nt].y);
        b[nt][1] = pack_bf16(bv[nt].z, bv[nt].w);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[nt][0], b[nt][1]);
    } else {
      // m16n8k8: k-slots t and t+4 of the first k-step are d = kk+4t+{0,1},
      // of the second d = kk+4t+{2,3}
      uint32_t ab[kMT][2][4], as[kMT][2][4], bb[4][4], bs[4][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          split_tf32(av[mt][h].x, ab[mt][h][0], as[mt][h][0]);
          split_tf32(av[mt][h].y, ab[mt][h][1], as[mt][h][1]);
          split_tf32(av[mt][h].z, ab[mt][h][2], as[mt][h][2]);
          split_tf32(av[mt][h].w, ab[mt][h][3], as[mt][h][3]);
        }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        split_tf32(bv[nt].x, bb[nt][0], bs[nt][0]);
        split_tf32(bv[nt].y, bb[nt][1], bs[nt][1]);
        split_tf32(bv[nt].z, bb[nt][2], bs[nt][2]);
        split_tf32(bv[nt].w, bb[nt][3], bs[nt][3]);
      }
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int k0 = 2 * ks, k1 = 2 * ks + 1;  // the small terms first, then big·big
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_tf32(acc[mt][nt], ab[mt][0][k0], ab[mt][1][k0], ab[mt][0][k1], ab[mt][1][k1],
                     bs[nt][k0], bs[nt][k1]);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_tf32(acc[mt][nt], as[mt][0][k0], as[mt][1][k0], as[mt][0][k1], as[mt][1][k1],
                     bb[nt][k0], bb[nt][k1]);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_tf32(acc[mt][nt], ab[mt][0][k0], ab[mt][1][k0], ab[mt][0][k1], ab[mt][1][k1],
                     bb[nt][k0], bb[nt][k1]);
      }
    }
  }
}

// kStream: d > kResidentD, the strip streamed through the ring beside the
// candidates (else resident in shared memory)
template <bool kBf16, bool kStream>
__global__ void __launch_bounds__(kThreads, 1)
shortlist_select_kernel(SelectArgs p, int n_slots) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float thv[kBQ];  // each row's threshold: the key (value, column)
  __shared__ int thi[kBQ];    // of its queue's entry k − 1, +inf until it fills
  __shared__ int cnt[kBQ];    // each row's buffered survivors
  const int d_pad = (p.d + kKC - 1) / kKC * kKC;
  const int l_stride = kStream ? 0 : d_pad + kPad;
  const int kq = p.kq;
  float* strip = smem;                                  // [kBQ][l_stride], none with kStream
  float* ring = strip + kBQ * l_stride;                 // [kStages][kSlot<kStream>]
  float* tiles = ring + kStages * kSlot<kStream>;       // [n_slots][kBQ][kTStride]
  const Rows rs = carve_rows(tiles + n_slots * kBQ * kTStride, kq, thv, thi, cnt);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ;
  const int n_rows = min(kBQ, p.s - q0);
  const int n_tiles = (p.c + kBC - 1) / kBC;
  const int nkc = d_pad / kKC;

  // the product warps' loads run kStages - 1 chunks ahead of their products
  int ld_left = n_tiles * nkc, ld_slot = 0, ld_tile = 0, ld_kc = 0;
  auto load_next = [&]() {
    if (ld_left > 0) {
      float* slot = ring + ld_slot * kSlot<kStream>;
      load_chunk(slot, p.cands, ld_tile * kBC, ld_kc * kKC, p.c, p.d, tid);
      if constexpr (kStream)
        load_query_chunk(slot + kBC * kKC, p.q, q0, ld_kc * kKC, p.s, p.d, tid);
      --ld_left;
      if (++ld_kc == nkc) {
        ld_kc = 0;
        ++ld_tile;
      }
      if (++ld_slot == kStages) ld_slot = 0;
    }
    cp_async_commit();
  };
  if (warp < kMmaWarps) {
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) load_next();
  }

  // the query rows in fp32, zero past S and past d (resident strip only);
  // empty queues
  const int per_row = kStream ? 0 : d_pad / 4;
  for (int i = tid; i < kBQ * per_row; i += kThreads) {
    const int r = i / per_row, k = (i % per_row) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_rows && k < p.d)
      v = __ldg(reinterpret_cast<const float4*>(p.q + static_cast<size_t>(q0 + r) * p.d + k));
    *reinterpret_cast<float4*>(strip + r * l_stride + k) = v;
  }
  init_rows(rs, kq, tid, kThreads);
  __syncthreads();

  if (warp < kMmaWarps) {
    // product warps: each score tile into a slot of shared memory
    const int gq = lane >> 2, tq = lane & 3;  // mma fragment coordinates
    const int wm = warp / kWarpsN, wn = warp % kWarpsN;
    auto row_of = [&](int i) { return wm * 16 * kMT + (i >> 1) * 16 + (i & 1) * 8 + gq; };
    float row_q2[kRows];
    long long row_ex[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = row_of(i);
      row_q2[i] = r < n_rows ? __ldg(p.q2 + q0 + r) : 0.f;
      row_ex[i] = r < n_rows && p.exclude != nullptr ? __ldg(p.exclude + q0 + r) : -1;
    }
    int slot = 0;
    for (int t = 0; t < n_tiles; ++t) {
      const int c0 = t * kBC;
      float acc[kMT][4][4] = {};
      for (int kc = 0; kc < nkc; ++kc) {
        cp_async_wait<kStages - 2>();
        bar_sync(kBarScore, kMmaThreads);  // this chunk is in; the oldest slot is free
        load_next();
        chunk_products<kBf16, kStream>(acc, strip, l_stride, kc * kKC,
                                       ring + slot * kSlot<kStream>, wm, wn, gq, tq);
        if (++slot == kStages) slot = 0;
      }
      // the epilogue: norms, a, bias, mask and exclusion, into a slot for
      // the selection warps (which skip the columns past C)
      float c2[8], b[8];
      bool ok[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c0 + wn * 32 + (j >> 1) * 8 + tq * 2 + (j & 1);
        const bool in = col < p.c;
        ok[j] = in && (p.col_mask == nullptr || __ldg(p.col_mask + col) != 0);
        c2[j] = in ? __ldg(p.c2 + col) : 0.f;
        b[j] = in && p.bias != nullptr ? __ldg(p.bias + col) : 0.f;
      }
      const int ts = t % n_slots;
      if (t >= n_slots) bar_sync(kBarEmpty + ts, kThreads);
      float* tile = tiles + ts * kBQ * kTStride;
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          float v[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = 2 * nt + h;
            const float raw = __fmaf_rn(-2.f, acc[i >> 1][nt][(i & 1) * 2 + h], row_q2[i] + c2[j]);
            const int col = c0 + wn * 32 + nt * 8 + tq * 2 + h;
            v[h] = ok[j] && col != row_ex[i] ? __fmaf_rn(p.a, raw, -b[j]) : INFINITY;
          }
          *reinterpret_cast<float2*>(tile + row_of(i) * kTStride + wn * 32 + nt * 8 + tq * 2) =
              make_float2(v[0], v[1]);
        }
      bar_arrive(kBarFull + ts, kThreads);
    }
    cp_async_wait<0>();
  } else {
    // selection warps: each owns kSelRows rows' queues, thresholds and
    // buffers, so no other warp waits on its merges
    const int r0 = (warp - kMmaWarps) * kSelRows;
    select_rows(tiles, n_slots, n_tiles, p.c, p.k, kq, rs, r0, min(r0 + kSelRows, n_rows), lane,
                kThreads);
  }
  __syncthreads();

  for (int i = tid; i < n_rows * p.k; i += kThreads) {
    const int r = i / p.k, j = i % p.k;
    const size_t o = static_cast<size_t>(q0 + r) * p.k + j;
    p.sidx[o] = rs.qi[r * kq + j];
    p.sval[o] = rs.qv[r * kq + j];
  }
  if (p.rerank == 0) return;
  const float4* tab = reinterpret_cast<const float4*>(p.cands);
  for (int r = warp; r < n_rows; r += kWarps) {
    const float4* qrow = reinterpret_cast<const float4*>(
        kStream ? p.q + static_cast<size_t>(q0 + r) * p.d : strip + r * l_stride);
    const int* rq = rs.qi + r * kq;
    float* orow = p.dist + static_cast<size_t>(q0 + r) * p.k;
    if (p.rerank == 2)
      row_dists<true, kRerankRows>(qrow, tab, p.d / 4, p.k, [&](int u) { return rq[u]; }, orow,
                                   lane);
    else
      row_dists<false, kRerankRows>(qrow, tab, p.d / 4, p.k, [&](int u) { return rq[u]; }, orow,
                                    lane);
  }
}

// Dynamic shared memory of one block; kernels/shortlist_dist.py::select_smem
// mirrors it.  Above kResidentD no term grows with d.
size_t select_smem(int d, int kq, int n_slots) {
  const bool stream = d > kResidentD;
  const int d_pad = (d + kKC - 1) / kKC * kKC;
  return sizeof(float) * (stream ? 0 : static_cast<size_t>(kBQ) * (d_pad + kPad)) +
         sizeof(float) * (static_cast<size_t>(kStages) * (stream ? kSlot<true> : kSlot<false>) +
                          static_cast<size_t>(n_slots) * kBQ * kTStride) +
         queue_smem(kq);
}

// As many score-tile slots as fit, up to 4: they absorb the selection
// warps' bursts of merges.
template <bool kBf16, bool kStream>
int launch_select(const SelectArgs& a, size_t room, cudaStream_t stream) {
  int n_slots = kMaxSlots;
  while (n_slots > 1 && select_smem(a.d, a.kq, n_slots) > room) --n_slots;
  const size_t smem = select_smem(a.d, a.kq, n_slots);
  if (smem > room) return cudaErrorInvalidValue;
  auto kern = shortlist_select_kernel<kBf16, kStream>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<(a.s + kBQ - 1) / kBQ, kThreads, smem, stream>>>(a, n_slots);
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
  return sq ? launch_gather<true>(q, table, idx, out, s, k, d, st)
            : launch_gather<false>(q, table, idx, out, s, k, d, st);
}

// The select-and-rerank launch.  q (s, d), cands (c, d), q2 (s,), c2 (c,)
// float32; bias (c,) float32, col_mask (c,) uint8 and exclude (s,) int64
// may be null; all contiguous, 16-byte aligned, d % 4 == 0, d ≥ 4 (above
// kResidentD = 512 the strip streams);
// 1 ≤ k ≤ min(kq, c), kq a power of two in [32, 256].  bf16 = 1
// rounds both operands of the product to bf16.  rerank: 0 none, 1
// cityblock, 2 sqeuclidean (dist may then be null).  Writes sidx (s, k)
// int64, sval (s, k) and dist (s, k) float32.  One kernel launch; returns
// its cudaError_t (0 on success).
extern "C" int shortlist_select_forward(const float* q, const float* cands, const float* q2,
                                        const float* c2, const float* bias,
                                        const uint8_t* col_mask, const long long* exclude,
                                        float a, int s, int c, int d, int k, int kq, int bf16,
                                        int rerank, long long* sidx, float* sval, float* dist,
                                        void* stream) {
  if (s <= 0) return cudaSuccess;
  if (d < 4 || d % 4 != 0 || k < 1 || k > kq || kq < 32 || kq > 256 ||
      (kq & (kq - 1)) != 0 || k > c || rerank < 0 || rerank > 2 ||
      (rerank != 0 && dist == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err;
  int dev = 0, limit = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return err;
  const size_t room = static_cast<size_t>(limit) - (2 * sizeof(float) + sizeof(int)) * kBQ;
  if (select_smem(d, kq, 1) > room) return cudaErrorInvalidValue;
  const SelectArgs args{q, cands, q2, c2, bias, col_mask, exclude, a, s, c, d, k, kq,
                        rerank, sidx, sval, dist};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d > kResidentD)  // the one choice of the strip's path, by width
    return bf16 ? launch_select<true, true>(args, room, st)
                : launch_select<false, true>(args, room, st);
  return bf16 ? launch_select<true, false>(args, room, st)
              : launch_select<false, false>(args, room, st);
}
