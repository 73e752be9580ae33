// Fused GCN layer for Hopper (sm_90a): out = (A·x)·W + b over a
// degree-bucketed ELL operator with the diagonal split out.
//
// Replaces tpugraph/kernels/gcn_fused_pallas.py::_bucket_kernel (and its
// wrapper fused_gcn_layer).  Per row r of the layer:
//
//     acc[r]  = Σ_k w[r,k] · x[idx[r,k]]  +  diag[r] · x[r]      (fp32)
//     out[r]  = acc[r] · W + b                                   (cast once)
//
// What bounds it on an H100: the data the function must move is x, out
// and the ELL arrays (~42 MB at zh-en scale, ~12 µs at 3.35 TB/s); its
// arithmetic is the N×d_in×d_out product, which this kernel runs as three
// TF32 products on the tensor cores (~7.5 µs at 495 TFLOP/s).  What a
// straightforward kernel actually pays is the gather: every ELL slot reads
// one full source row of x (307k slots × 512 B ≈ 157 MB per layer at zh-en
// scale), which the 50 MB L2 mostly serves because x (19.5 MB) fits in it.
// So the design keeps gathered rows in flight and never writes the
// aggregate to device memory:
//
//   * One launch per call.  Persistent blocks take work units from an
//     atomic counter; the last block to finish resets the counters, so the
//     cached scratch needs no memset.  The units are, in order:
//   * The rows of K > 128 (kernels/spmm_ell.py::SEG_SLOTS; 162 hub rows of
//     K up to 3,734 at zh-en scale), as the segments of the SpMM's
//     segment_plan: at most 128 slots each, one warp each, 8 per unit, so a
//     hub row is spread over many SMs instead of the 8 warps of one block.
//     A segment writes its fp32 partial row to scratch; the row's last
//     segment (a per-row counter, reset here) sums the partials in segment
//     order and computes row·W + b itself, in fp32 SIMT from the block's
//     staged W.
//   * Then the host's tile table (row_start, n_rows, K, slot_start;
//     fused_plan), heaviest first, skipping the tiles of the cut rows.  Each
//     warp takes a contiguous run of a tile's rows and walks their virtual
//     slots (each row's K ELL slots, then one for the diagonal), 32 at a
//     time across row boundaries, with 8 source rows in flight
//     (ell::walk_vslots, shared with spmm_ell.cu): a run of K = 1 rows is
//     one batch of gathers, not one row at a time.
//   * The tile's (≤ 32 × d_in) fp32 aggregate stays in shared memory and
//     meets W (staged once per block, fp32, transposed) on the tensor
//     cores: mma.sync m16n8k8 TF32 as a 3× split (tf32_mma.cuh),
//     x = big + small, a·W ≈ a_big·W_big + a_big·W_small + a_small·W_big in
//     fp32, which keeps fp32's error (one TF32 product alone does not:
//     2⁻¹¹ relative).  Both operands are split in registers as their
//     fragments load; a bf16 W is exact in TF32, so its small half is zero
//     and that product is skipped.  Each warp owns d_out / 8 columns of all
//     the tile's rows; the k index of each group of 16 is permuted alike
//     for both operands so every fragment is one 16-byte shared load, and
//     odd rows swap the halves of each 8-float4 group, which keeps those
//     loads free of bank conflicts without padding.  mma.sync's own adds
//     into its fp32 accumulator lose more than fp32 adds (on the H100 a
//     product of 256 k's took ~10× the error of the same products summed
//     per group outside; at (128, 128) the layer's relative L2 error
//     against float64 was 4.1e-7 inside, 7.2e-8 outside, the plain fp32
//     layer's 9.7e-8), so every fp32 instance sums each group of 16 k's
//     from zero, then adds it in fp32 (kSumOutside; at (128, 128) ptxas
//     keeps the same registers, no spills, and the time did not move).
//     Only the bf16 (128, 128) instance keeps its sum in the accumulator.
//   * Every output row is written exactly once, straight to its natural
//     position: no atomics on out, no zero fill, no row_order gather; every
//     sum runs in a fixed order, so two launches give bit-identical results.
//
// That is the design of the narrow instances, (128, 128), (128, 256) and
// (256, 128), where the whole fp32 Wᵀ (at most 128 KB) fits beside the
// aggregate (gcn_fused_kernel).  One block's gather and product do not
// overlap there (two blocks per SM at (128, 128) overlap each other's).
//
// At d_in = d_out = 256 (gcn_fused_kernel_wide) the fp32 Wᵀ is 256 KB, more
// than a block's 227 KB, and a layer gathers 1 KB a slot.  So:
//
//   * Each tile and each segment is gathered once.  fp32: a cluster of two
//     CTAs (Hopper's distributed shared memory), each staging one
//     128-column panel of Wᵀ (128 KB).  A tile's rows are split over the
//     pair's 16 gather warps; each finished row goes into its own CTA's
//     aggregate buffer and, through the cluster's shared-memory window,
//     into the peer's, so after the pair's barrier both hold the whole tile
//     and each multiplies it by its panel.  bf16: Wᵀ whole in bf16
//     (128 KB), one CTA.
//   * The gather overlaps the product.  8 gather warps aggregate step s's
//     unit into one of two 32 × 256 fp32 buffers while 4 product warps
//     multiply step s − 1's from the other (128 + 64 KB of shared memory);
//     one barrier of the pair (or block) a step hands the buffers over.
//     Rank 0 takes the pair's units a step ahead and writes each, with its
//     tile, into both CTAs, so neither the counter's atomic nor the tile's
//     read waits; the product warps stage W during step 0.
//   * The cut rows (K > 128) are units right after their segments: a
//     segment writes one fp32 partial and counts it; a cut row's unit sums
//     the row's partials in segment order once its counter is full (every
//     segment is taken before it and none waits, so the wait ends) and
//     resets the counter.  fp32 multiplies those rows with row_product, in
//     fp32 SIMT, one row a product warp (a unit is 4 rows, so they spread
//     over the pairs): the arithmetic of the two-panel kernel this one
//     replaced, whose fp32 output it gives bit for bit (a cut row carries
//     the gradient of thousands of rows; on the tensor cores its last bits
//     moved recipe v7r's step check past its limit).  bf16 multiplies them
//     as a tile.
//   * The product splits the aggregate with integer and fp32 adds, not
//     conversions.  fp32: the 3× TF32 product above, big = rna(a) rounded
//     as cvt.rna.tf32 rounds (round half away on the bits), the k order and
//     term order of products16, each group of 16 k's summed outside.  bf16:
//     a = hi + mid + lo, three bf16 terms cut by truncation, exact for a
//     normal fp32 a; each times the bf16 W (exact products) on the bf16
//     tensor cores (m16n8k16), lo first, each group of 16 k's summed
//     outside in fp32: the TPU kernel's fp32 product of the fp32 aggregate
//     (two terms would leave 2⁻¹⁶ of a, about 10× a plain fp32 product's
//     error).  Measured on the H100, mma.sync issues about one product every
//     16 cycles per scheduler, so the product sets a step's time
//     (PERF.md §6).
//
// Every other (d_in, d_out) ≥ 1 takes one of two kernels, by the host plan
// kernels/gcn_fused.py::kernel_plan.  Beyond (256, 256) the fp32 Wᵀ
// (d_in·d_out·4 bytes: 576 KB at 384², 2.25 MB at 768²) fits no block, and
// a tile's aggregate may not either (32 × 1,030 fp32 is 132 KB).  What
// bounds the layer is unchanged: the gather's bytes and the three products.
//
// gcn_fused_kernel_wgmma (namespace wg), wherever d_in ≤ 768 and W does not
// fit whole in half an SM beside a 32-row aggregate:
//
//   * W moves from L2 once per 128 rows.  A cluster of two CTAs takes two
//     64-row units a step (two plan tiles each), and both walk W's chunks
//     in one order: each chunk (64 output columns × 128 bytes of k) is one
//     multicast bulk copy (cp.async.bulk .multicast::cluster), each CTA
//     issuing half, into a ring of slots guarded by mbarriers (full: the
//     chunk's bytes in this CTA; empty: both CTAs' warpgroups are done with
//     the slot).  A prologue launch lays Wᵀ out once per call in the
//     product's layout (wt_layout: K-major rows of 128 bytes, 128-byte
//     swizzle, each group of 16 k's permuted as the aggregate's fragments
//     want), so the bytes arrive ready for wgmma: fp32 as W's big and small
//     TF32 planes (16 KB a chunk; splitting each chunk in the CTAs cost
//     13-17 % of the layer), bf16 as W (8 KB).
//   * The gather overlaps the product.  Warps 0-10 gather the step's unit
//     into one aggregate buffer (64 rows × d_in fp32, in 128-column slabs)
//     while the warpgroup (warps 12-15) multiplies the unit gathered a step
//     before from the other; warp 11 streams W.  Where two buffers do not
//     fit (d_in above 384), one buffer, and the product follows the gather
//     within the step.  One barrier of the cluster a step hands the
//     buffers and the units over.  A warp's walk is latency-bound, so a
//     unit's rows are split over the gather warps by their slots, not
//     their count (a run of long rows held the cluster's barrier), and a
//     walk takes up to three slabs of a row at once.
//   * The product is wgmma m64n64 (k8 TF32, k16 bf16), A (the aggregate)
//     from registers, B (W) from the ring.  fp32: 3× TF32 as above, the
//     aggregate split in registers.  bf16: the aggregate's three bf16 terms
//     times the bf16 W.  Each group of 16 k's is summed from zero and then
//     added in fp32, and waited for before the next (its A registers stay
//     live until it completes).
//   * The units and their order are the layer plan's: groups of cut-row
//     segments, the cut rows 16 at a time (each sums its partials in
//     segment order), then pairs of tiles.  One launch of the layer (after
//     the prologue's), persistent clusters on one counter that the last CTA
//     resets; every row written once, in place, in a fixed order.
//
// gcn_fused_kernel_any (namespace any), the per-tile kernel, everywhere else:
// where W fits whole beside the aggregate in half an SM (staged once per
// block: (50, 300), (64, 64)), and where no layout of the redesign fits
// (d_in above 768).  It keeps the instances' work split and arithmetic and
// bounds what a block holds:
//
//   * The same units from the same layer plan: groups of 8 cut-row
//     segments (one a warp, each a fp32 partial row of d_in rounded up to
//     128 columns), then the cut rows 32 at a time (each waits for its
//     segments, all taken before it, and sums its partials in segment
//     order), then the tiles but those of the cut rows.  Persistent blocks
//     take them from one counter; the last block out resets the counters.
//   * A unit's aggregate is gathered into shared memory one 128-column
//     panel of x at a time (ell::PanelCols: 4 columns a lane, masked at
//     d_in, 16-byte loads where d_in % 4 == 0), `ka` columns of d_in at
//     once: all of d_in up to 1,536 (1,664 with 64-column output panels),
//     else chunk by chunk, gathered again for each output panel.
//   * The product runs in output panels of 64 or 128 columns (8 warps × 1
//     or 2 n-tiles of 8), as the narrow instances multiply: 3× TF32 in
//     fp32, the aggregate's three bf16 terms on the bf16 tensor cores in
//     bf16 (W is staged as fp32 and packed back to bf16 exactly), each
//     group of 16 k's summed outside the accumulator.  Wᵀ is staged whole
//     once a block where it fits beside the aggregate in half an SM's
//     shared memory (two blocks an SM), else 64 k's of one panel at a
//     time, for every unit.
//   * Columns past d_in are zero in the aggregate and in Wᵀ, so the
//     product's k runs to d_in rounded up to 16; columns past d_out are
//     multiplied (a panel's last n-tiles) but never written.  Every row is written
//     once, straight to its natural position, in a fixed order: two
//     launches give the same bits.
//
// bf16 x/W gather in bf16, accumulate in fp32 and cast once at the end, as
// the TPU kernel does.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "ell_gather.cuh"
#include "tf32_mma.cuh"

namespace {

namespace cg = cooperative_groups;
using tf32::mma_tf32;
using tf32::split_tf32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 32;  // rows per tile at most (host plan agrees)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// float4 f of row r of a [rows][D] fp32 array in shared memory.  Odd rows
// swap the halves of each group of 8 float4s, so the 8 lanes of one phase
// of a fragment load (rows 2p and 2p + 1 × 4 consecutive float4s) hit all
// 32 banks.
template <int D, typename F>
__device__ __forceinline__ F* swz(F* base, int r, int f) {
  return base + r * D + ((f ^ ((r & 1) << 2)) << 2);
}

template <int D>
__device__ __forceinline__ void put_row_swz(float* a_s, int r, int lane,
                                            const float (&acc)[D / 128][4]) {
#pragma unroll
  for (int c = 0; c < D / 128; ++c) ell::store4(swz<D>(a_s, r, c * 32 + lane), acc[c]);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// out_row = a · W + b in fp32 SIMT for one row whose aggregate a the warp
// holds in registers (lane L: columns c·128 + 4L .. + 3), W from the
// block's staged Wᵀ.  Lane L writes columns L, L + 32, ...; the k order is
// fixed, so the result does not depend on which warp computes it.
template <typename T, int D_IN, int D_OUT>
__device__ __forceinline__ void row_product(const float* w_s, const float (&a)[D_IN / 128][4],
                                            const float* __restrict__ bias, int lane,
                                            T* __restrict__ out_row) {
  constexpr int JN = D_OUT / 32;
  float o[JN] = {};
#pragma unroll
  for (int c = 0; c < D_IN / 128; ++c)
#pragma unroll 4
    for (int src = 0; src < 32; ++src) {
      const float a0 = __shfl_sync(ell::kFull, a[c][0], src);
      const float a1 = __shfl_sync(ell::kFull, a[c][1], src);
      const float a2 = __shfl_sync(ell::kFull, a[c][2], src);
      const float a3 = __shfl_sync(ell::kFull, a[c][3], src);
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const float4 w = *reinterpret_cast<const float4*>(
            swz<D_IN>(w_s, lane + 32 * j, c * 32 + src));
        o[j] = fmaf(a0, w.x, o[j]);
        o[j] = fmaf(a1, w.y, o[j]);
        o[j] = fmaf(a2, w.z, o[j]);
        o[j] = fmaf(a3, w.w, o[j]);
      }
    }
#pragma unroll
  for (int j = 0; j < JN; ++j)
    store1(out_row + lane + 32 * j, o[j] + (bias ? __ldg(bias + lane + 32 * j) : 0.f));
}

// One group of 16 k's of the 3× TF32 product (2× for an exact bf16 W) into
// acc: a0..a3 = (row g, slot t), (g + 8, t), (g, t + 4), (g + 8, t + 4);
// b0, b1 = (slot t, column g), (t + 4, g).  The small terms first, then
// big·big, each pass over all the accumulators.
template <int NT, bool kWExact>
__device__ __forceinline__ void products16(float (&acc)[2][NT][4], const uint32_t (&ab)[2][2][4],
                                           const uint32_t (&as)[2][2][4],
                                           const uint32_t (&bb)[NT][4],
                                           const uint32_t (&bs)[NT][4], int n_mt) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const int k0 = 2 * ks, k1 = 2 * ks + 1;
    if (!kWExact) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt >= n_mt) break;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_tf32(acc[mt][nt], ab[mt][0][k0], ab[mt][1][k0], ab[mt][0][k1], ab[mt][1][k1],
                   bs[nt][k0], bs[nt][k1]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (mt >= n_mt) break;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_tf32(acc[mt][nt], as[mt][0][k0], as[mt][1][k0], as[mt][0][k1], as[mt][1][k1],
                 bb[nt][k0], bb[nt][k1]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (mt >= n_mt) break;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_tf32(acc[mt][nt], ab[mt][0][k0], ab[mt][1][k0], ab[mt][0][k1], ab[mt][1][k1],
                 bb[nt][k0], bb[nt][k1]);
    }
  }
}

// One segment of a cut row (a work item of kernels/spmm_ell.py::
// segment_plan): its virtual slots into a partial row; the row's last
// segment to finish (a per-row counter, reset here) sums the partials in
// segment order and writes out_row = sum · W + b.
template <typename T, int D_IN, int D_OUT>
__device__ __forceinline__ void hub_segment(const T* __restrict__ x, const float* w_s,
                                            const float* __restrict__ bias,
                                            const float* __restrict__ diag,
                                            const int* __restrict__ rows,
                                            const int* __restrict__ idx,
                                            const float* __restrict__ ew, int4 a, int4 b,
                                            const int* __restrict__ split_p0,
                                            int* __restrict__ seg_counters,
                                            float* __restrict__ partial, int lane,
                                            T* __restrict__ out) {
  constexpr int CI = D_IN / 128;
  const int part = b.z, split = b.w;
  float acc[CI][4] = {};
  int row;  // a segment covers one row: the walk never moves on
  ell::walk_vslots<T, D_IN, true>(x, diag, rows, idx, ew, a.x, a.z, a.w, b.x, b.y, lane, acc,
                                  row, [](int, const float (&)[CI][4]) {});
  ell::put_row<D_IN>(partial + static_cast<long>(part) * D_IN, lane, acc);
  __threadfence();
  __syncwarp();
  const int p0 = __ldg(split_p0 + split), p1 = __ldg(split_p0 + split + 1);
  int* counter = seg_counters + split;
  int last = 0;
  if (lane == 0) last = atomicAdd(counter, 1) == p1 - p0 - 1;
  if (!__shfl_sync(ell::kFull, last, 0)) return;
  if (lane == 0) *counter = 0;  // every segment has counted: ready for the next launch
  __threadfence();
  float sum[CI][4] = {};
  for (int p = p0; p < p1; ++p)
#pragma unroll
    for (int c = 0; c < CI; ++c) {
      const float4 t = __ldcg(
          reinterpret_cast<const float4*>(partial + static_cast<long>(p) * D_IN + c * 128) + lane);
      sum[c][0] += t.x;
      sum[c][1] += t.y;
      sum[c][2] += t.z;
      sum[c][3] += t.w;
    }
  row_product<T, D_IN, D_OUT>(w_s, sum, bias, lane, out + static_cast<long>(row) * D_OUT);
}

template <typename T, int D_IN, int D_OUT>
__global__ void __launch_bounds__(kThreads, D_IN * D_OUT <= 128 * 128 ? 2 : 1)
gcn_fused_kernel(const T* __restrict__ x, const T* __restrict__ wmat,
                 const float* __restrict__ bias, const float* __restrict__ diag,
                 const int* __restrict__ rows, const int* __restrict__ idx,
                 const float* __restrict__ ew, const int4* __restrict__ tiles,
                 int n_tiles, const int4* __restrict__ segs, int n_segs, int k_cut,
                 const int* __restrict__ split_p0, int* __restrict__ counters,
                 float* __restrict__ partial, T* __restrict__ out) {
  constexpr int CI = D_IN / 128;
  constexpr int NW = D_OUT / kWarps;  // output columns per warp
  constexpr int NT = NW / 8;          // their mma n-tiles
  constexpr bool kWExact = sizeof(T) == 2;  // a bf16 W is exact in TF32
  // mma.sync adds into its fp32 accumulator less exactly than an fp32 add
  // (probed on the H100: 10× the error of summing each group outside), so
  // each group of 16 k's is summed outside in fp32; the bf16 (128, 128)
  // instance alone keeps its sum inside.
  constexpr bool kSumOutside = sizeof(T) == 4 || D_IN * D_OUT > 128 * 128;
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // Wᵀ [D_OUT][D_IN], swizzled
  float* a_s = w_s + D_OUT * D_IN;               // [kTileRows][D_IN], swizzled
  __shared__ int s_tile;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // mma fragment coordinates
  const int n0 = warp * NW;                 // the warp's first column

  // Wᵀ into shared memory: each group of 32 threads moves 8 columns × 16 k,
  // so the global reads take whole sectors and the shared writes no
  // conflicts
  for (int i = tid; i < D_OUT * D_IN / 4; i += kThreads) {
    const int grp = i >> 5, l = i & 31;
    const int n = (grp % (D_OUT / 8)) * 8 + (l >> 2), f = (grp / (D_OUT / 8)) * 4 + (l & 3);
    const T* src = wmat + static_cast<long>(f * 4) * D_OUT + n;
    *reinterpret_cast<float4*>(swz<D_IN>(w_s, n, f)) =
        make_float4(to_f32(src[0]), to_f32(src[D_OUT]), to_f32(src[2 * D_OUT]),
                    to_f32(src[3 * D_OUT]));
  }
  float bv[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) bv[nt][e] = bias ? __ldg(bias + n0 + nt * 8 + 2 * tq + e) : 0.f;

  // work units: groups of kWarps cut-row segments (one per warp), then the
  // tiles; a tile of K > k_cut holds rows the segments cover and is skipped
  const int n_groups = (n_segs + kWarps - 1) / kWarps;
  while (true) {
    if (tid == 0) s_tile = atomicAdd(counters, 1);
    __syncthreads();  // publishes s_tile; W staged; the last tile's a_s reads done
    const int u = s_tile;
    if (u >= n_groups + n_tiles) break;
    if (u < n_groups) {
      const int item = u * kWarps + warp;
      if (item < n_segs)
        hub_segment<T, D_IN, D_OUT>(x, w_s, bias, diag, rows, idx, ew, __ldg(segs + 2 * item),
                                    __ldg(segs + 2 * item + 1), split_p0, counters + 2, partial,
                                    lane, out);
      continue;
    }
    const int4 td = __ldg(tiles + (u - n_groups));
    const int row0 = td.x, nrows = td.y, k = td.z;
    const long slot0 = td.w;
    if (k > k_cut) continue;

    // ---- phase 1: aggregate the tile's rows into a_s (fp32) ----
    // a contiguous run of rows per warp (none for some warps of a tile of
    // fewer than 8 rows, a bucket's tail), walked as virtual slots
    const int r0 = warp * nrows / kWarps, r1 = (warp + 1) * nrows / kWarps;
    if (r1 > r0) {
      float acc[CI][4] = {};
      int cur;
      auto sink = [&](int r, const float (&a)[CI][4]) { put_row_swz<D_IN>(a_s, r, lane, a); };
      ell::walk_vslots<T, D_IN, false>(x, diag, rows + row0, idx, ew, 0, k, slot0,
                                       r0 * (k + 1), r1 * (k + 1), lane, acc, cur, sink);
      sink(cur, acc);
    }
    __syncthreads();

    // ---- phase 2: out[rows] = a_s · W + b on the tensor cores, 3× TF32 ----
    // warp: all rows (two m-tiles of 16; one when the tile has ≤ 16) ×
    // columns [n0, n0 + NW).  k-slots t and t + 4 of the first k-step of
    // each group of 16 are d = kk + 4t + {0, 1}, of the second kk + 4t + {2, 3}.
    const int n_mt = nrows > 16 ? 2 : 1;
    float c[2][NT][4] = {};
#pragma unroll 2
    for (int kk = 0; kk < D_IN; kk += 16) {
      uint32_t ab[2][2][4], as[2][2][4];  // [m-tile][row g, g + 8][d]
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt >= n_mt) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 v =
              *reinterpret_cast<const float4*>(swz<D_IN>(a_s, mt * 16 + h * 8 + gq, kk / 4 + tq));
          split_tf32(v.x, ab[mt][h][0], as[mt][h][0]);
          split_tf32(v.y, ab[mt][h][1], as[mt][h][1]);
          split_tf32(v.z, ab[mt][h][2], as[mt][h][2]);
          split_tf32(v.w, ab[mt][h][3], as[mt][h][3]);
        }
      }
      uint32_t bb[NT][4], bs[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float4 v =
            *reinterpret_cast<const float4*>(swz<D_IN>(w_s, n0 + nt * 8 + gq, kk / 4 + tq));
        if (kWExact) {
          bb[nt][0] = __float_as_uint(v.x);
          bb[nt][1] = __float_as_uint(v.y);
          bb[nt][2] = __float_as_uint(v.z);
          bb[nt][3] = __float_as_uint(v.w);
        } else {
          split_tf32(v.x, bb[nt][0], bs[nt][0]);
          split_tf32(v.y, bb[nt][1], bs[nt][1]);
          split_tf32(v.z, bb[nt][2], bs[nt][2]);
          split_tf32(v.w, bb[nt][3], bs[nt][3]);
        }
      }
      if constexpr (kSumOutside) {  // this group's products from zero, then one fp32 add
        float t[2][NT][4] = {};
        products16<NT, kWExact>(t, ab, as, bb, bs, n_mt);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) c[mt][nt][e] += t[mt][nt][e];
      } else {
        products16<NT, kWExact>(c, ab, as, bb, bs, n_mt);
      }
    }
    // c[mt][nt] = (row g, columns 2t, 2t + 1), (row g + 8, the same)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + h * 8 + gq;
        if (r >= nrows) continue;
        const long orow = __ldg(rows + row0 + r);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          store2(out + orow * D_OUT + n0 + nt * 8 + 2 * tq, c[mt][nt][2 * h] + bv[nt][0],
                 c[mt][nt][2 * h + 1] + bv[nt][1]);
      }
  }

  // the last block out resets the counters for the next launch: every
  // block has taken its last tile number by the time it counts itself done
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(counters + 1, 1) == static_cast<int>(gridDim.x) - 1)
      counters[0] = counters[1] = 0;
  }
}

// ---------------------------------------------------------------------------
// (256, 256): gcn_fused_kernel_wide

namespace wide {

constexpr int D = 256;
constexpr int kGatherWarps = 8;
constexpr int kProductWarps = 4;
constexpr int kThreads = 32 * (kGatherWarps + kProductWarps);
constexpr int kNT32 = 16 / kProductWarps;  // n-tiles of a product warp: fp32 (of 128 columns)
constexpr int kNT16 = 32 / kProductWarps;  // bf16 (of 256 columns)
constexpr int kSlots = 3;  // work units in flight: gathered, multiplied, claimed
constexpr int kInFlight = 8;  // source rows a gather warp keeps in flight
constexpr int kWBytes = 128 * 1024;  // an fp32 128-column panel of Wᵀ, or bf16 Wᵀ whole
constexpr int kBufFloats = kTileRows * D;
constexpr size_t kSmem = kWBytes + 2 * sizeof(float) * kBufFloats;

// CTAs that share a tile: two fp32 panels of W, or one bf16 W
template <typename T>
constexpr int kPair = sizeof(T) == 4 ? 2 : 1;
// cut rows a unit: fp32 multiplies them in SIMT, one row a product warp,
// so a unit is that many and the cut rows spread over the pairs; bf16
// multiplies them on the tensor cores as a tile
template <typename T>
constexpr int kHubRows = sizeof(T) == 4 ? kProductWarps : kTileRows;

template <int P>
__device__ __forceinline__ void pair_sync() {
  if constexpr (P == 2) {
    cg::this_cluster().sync();  // arrive.release / wait.acquire: the peer's stores seen
  } else {
    __syncthreads();
  }
}

// x = big + small, each rounded to TF32 as cvt.rna.tf32.f32 rounds (to
// nearest, ties away from zero: add half a TF32 ulp to the magnitude's
// bits and truncate), with one integer add and one mask each
__device__ __forceinline__ uint32_t rna_tf32(uint32_t u) { return (u + 0x1000u) & 0xffffe000u; }

__device__ __forceinline__ void split_tf32_bits(float x, uint32_t& big, uint32_t& small) {
  big = rna_tf32(__float_as_uint(x));
  small = rna_tf32(__float_as_uint(x - __uint_as_float(big)));
}

// (x, y) = hi + mid + lo, three packed bf16 pairs cut by truncation (x's
// top 8 significant bits, the next 8, the last 8: exact for a normal fp32
// x), the first element in the low half
__device__ __forceinline__ void split3_bf16(float x, float y, uint32_t& hi, uint32_t& mid,
                                            uint32_t& lo) {
  constexpr uint32_t kTop = 0xffff0000u;
  const float x1 = x - __uint_as_float(__float_as_uint(x) & kTop);
  const float y1 = y - __uint_as_float(__float_as_uint(y) & kTop);
  const float x2 = x1 - __uint_as_float(__float_as_uint(x1) & kTop);
  const float y2 = y1 - __uint_as_float(__float_as_uint(y1) & kTop);
  hi = __byte_perm(__float_as_uint(x), __float_as_uint(y), 0x7632);
  mid = __byte_perm(__float_as_uint(x1), __float_as_uint(y1), 0x7632);
  lo = __byte_perm(__float_as_uint(x2), __float_as_uint(y2), 0x7632);
}

// 8-byte chunk f (k = 4f .. 4f + 3) of column n of the bf16 Wᵀ [D][D]:
// columns n .. n + 3 shift their chunks by 4 apart, so the 16 lanes of one
// phase of a fragment load (4 columns × 4 chunks) hit all 32 banks
__device__ __forceinline__ int wchunk(int n, int f) { return n * (D / 4) + (f ^ ((n & 3) << 2)); }

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The unit claimed as u, or the first after it that is not a tile of the
// cut rows (taken from the counter in turn)
__device__ __forceinline__ int past_cut_tiles(int u, int* counter, const int4* __restrict__ tiles,
                                              int n_groups, int n_tiles, int k_cut) {
  while (u >= n_groups && u - n_groups < n_tiles && __ldg(tiles + (u - n_groups)).z > k_cut)
    u = atomicAdd(counter, 1);
  return u;
}

// mma.sync m16n8k8 TF32 as tf32::mma_tf32, and m16n8k16 bf16, without
// `volatile`, so the compiler may interleave independent products
__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The fp32 product warp: rows [0, nrows) of the tile × columns
// [n0, n0 + 8·NT) of the CTA's panel, 3× TF32 with the k order and the
// term order of gcn_fused_kernel (products16): each term's products over
// all (m-tile, n-tile) pairs back to back, so no product waits on the one
// before it; each group of 16 k's summed from zero, then added in fp32.
template <int NT>
__device__ __forceinline__ void product(const float* a_s, const float* w_s, int n0, int lane,
                                        int nrows, float (&acc)[2][NT][4]) {
  const int gq = lane >> 2, tq = lane & 3;
  const int n_mt = nrows > 16 ? 2 : 1;
#pragma unroll 1
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t ab[2][2][4], as[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (mt >= n_mt) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v =
            *reinterpret_cast<const float4*>(swz<D>(a_s, mt * 16 + h * 8 + gq, kk / 4 + tq));
        split_tf32_bits(v.x, ab[mt][h][0], as[mt][h][0]);
        split_tf32_bits(v.y, ab[mt][h][1], as[mt][h][1]);
        split_tf32_bits(v.z, ab[mt][h][2], as[mt][h][2]);
        split_tf32_bits(v.w, ab[mt][h][3], as[mt][h][3]);
      }
    }
    uint32_t bb[NT][4], bs[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float4 v =
          *reinterpret_cast<const float4*>(swz<D>(w_s, n0 + nt * 8 + gq, kk / 4 + tq));
      split_tf32_bits(v.x, bb[nt][0], bs[nt][0]);
      split_tf32_bits(v.y, bb[nt][1], bs[nt][1]);
      split_tf32_bits(v.z, bb[nt][2], bs[nt][2]);
      split_tf32_bits(v.w, bb[nt][3], bs[nt][3]);
    }
    float t[2][NT][4] = {};
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int k0 = 2 * ks, k1 = 2 * ks + 1;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt >= n_mt) break;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_tf32(t[mt][nt], ab[mt][0][k0], ab[mt][1][k0], ab[mt][0][k1], ab[mt][1][k1],
                   bs[nt][k0], bs[nt][k1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt >= n_mt) break;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_tf32(t[mt][nt], as[mt][0][k0], as[mt][1][k0], as[mt][0][k1], as[mt][1][k1],
                   bb[nt][k0], bb[nt][k1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt >= n_mt) break;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_tf32(t[mt][nt], ab[mt][0][k0], ab[mt][1][k0], ab[mt][0][k1], ab[mt][1][k1],
                   bb[nt][k0], bb[nt][k1]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += t[mt][nt][e];
  }
}

// The bf16 product warp: rows [0, nrows) × columns [n0, n0 + 8·NT) of W,
// in parts of at most 32 columns (registers).  m16n8k16 wants (row g, k 2t,
// 2t + 1, 2t + 8, 2t + 9) of A and the same k of column g of B; the k index
// of each group of 16 is permuted alike for both so that those are
// d = kk + 4t .. + 3, one 16-byte load of the aggregate and one 8-byte load
// of Wᵀ.  Each term (lo, mid, hi) over all the half's (m-tile, n-tile)
// pairs back to back; each group of 16 k's summed from zero, then added.
template <int NT>
__device__ __forceinline__ void product(const float* a_s, const uint2* w_s, int n0, int lane,
                                        int nrows, float (&acc)[2][NT][4]) {
  constexpr int NH = NT < 4 ? NT : 4;  // n-tiles of a part
  const int gq = lane >> 2, tq = lane & 3;
  const int n_mt = nrows > 16 ? 2 : 1;
#pragma unroll 1
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t a[2][3][4];  // [m-tile][hi, mid, lo][fragment register]
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (mt >= n_mt) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v =
            *reinterpret_cast<const float4*>(swz<D>(a_s, mt * 16 + h * 8 + gq, kk / 4 + tq));
        split3_bf16(v.x, v.y, a[mt][0][h], a[mt][1][h], a[mt][2][h]);
        split3_bf16(v.z, v.w, a[mt][0][h + 2], a[mt][1][h + 2], a[mt][2][h + 2]);
      }
    }
#pragma unroll
    for (int half = 0; half < NT / NH; ++half) {
      uint2 b[NH];
#pragma unroll
      for (int nt = 0; nt < NH; ++nt)
        b[nt] = w_s[wchunk(n0 + (half * NH + nt) * 8 + gq, kk / 4 + tq)];
      float t[2][NH][4] = {};
#pragma unroll
      for (int term = 2; term >= 0; --term)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (mt >= n_mt) break;
#pragma unroll
          for (int nt = 0; nt < NH; ++nt)
            mma_bf16(t[mt][nt], a[mt][term][0], a[mt][term][1], a[mt][term][2], a[mt][term][3],
                     b[nt].x, b[nt].y);
        }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NH; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][half * NH + nt][e] += t[mt][nt][e];
    }
  }
}

// acc (row g / g + 8 of each m-tile, columns 2t, 2t + 1 of each n-tile) + b
// to the tile's rows of out, from column col0
template <typename T, int NT>
__device__ __forceinline__ void store_rows(const float (&acc)[2][NT][4], const int* orows,
                                           int nrows, const float* __restrict__ bias, int col0,
                                           int lane, T* __restrict__ out) {
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + h * 8 + gq;
      if (r >= nrows) continue;
      T* orow = out + static_cast<long>(orows[r]) * D + col0 + 2 * tq;  // global or shared
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float b0 = bias ? __ldg(bias + col0 + nt * 8 + 2 * tq) : 0.f;
        const float b1 = bias ? __ldg(bias + col0 + nt * 8 + 2 * tq + 1) : 0.f;
        store2(orow + nt * 8, acc[mt][nt][2 * h] + b0, acc[mt][nt][2 * h + 1] + b1);
      }
    }
}

// Work units, in the order they are taken: groups of the pair's gather
// warps' count of cut-row segments (one per warp), the cut rows kHubRows at
// a time (hub: (split, natural row) each; they wait for their segments,
// all taken before them), then the tiles (those of K > k_cut skipped).
// counters: [0] the unit counter, [1] CTAs done, then one per cut row.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
gcn_fused_kernel_wide(const T* __restrict__ x, const T* __restrict__ wmat,
                      const float* __restrict__ bias, const float* __restrict__ diag,
                      const int* __restrict__ rows, const int* __restrict__ idx,
                      const float* __restrict__ ew, const int4* __restrict__ tiles, int n_tiles,
                      const int4* __restrict__ segs, int n_segs, int k_cut,
                      const int* __restrict__ split_p0, const int2* __restrict__ hub, int n_hub,
                      int* __restrict__ counters, float* __restrict__ partial,
                      T* __restrict__ out) {
  constexpr int P = kPair<T>;
  constexpr int J = P * kGatherWarps;  // the pair's gather warps
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // fp32 panel [128][D] or bf16 [D][D], Wᵀ
  float* a_s = w_s + kWBytes / 4;                // two [kTileRows][D] fp32 aggregates
  __shared__ int s_unit[kSlots];
  __shared__ int4 s_td[kSlots];              // each slot's tile (row_start, n_rows, K, slot)
  __shared__ int s_hub_rows[2][kTileRows];  // each buffer's cut rows, natural ids

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int rank = 0;
  float* a_peer = a_s;  // the same buffers in the peer CTA's shared memory
  int* unit_peer = s_unit;
  int4* td_peer = s_td;
  int* hub_peer = &s_hub_rows[0][0];
  if constexpr (P == 2) {
    cg::cluster_group cl = cg::this_cluster();
    rank = static_cast<int>(cl.block_rank());
    a_peer = cl.map_shared_rank(a_s, rank ^ 1);
    unit_peer = cl.map_shared_rank(s_unit, rank ^ 1);
    td_peer = cl.map_shared_rank(s_td, rank ^ 1);
    hub_peer = cl.map_shared_rank(&s_hub_rows[0][0], rank ^ 1);
  }

  const int n_groups = (n_segs + J - 1) / J;
  constexpr int H = kHubRows<T>;
  const int tile0 = n_groups + (n_hub + H - 1) / H;  // the first tile's unit
  const int total = tile0 + n_tiles;
  int* seg_counters = counters + 2;
  // rank 0's first product thread takes the units for the pair, one step
  // ahead: the unit of step s + 1 was taken in step s - 1 and its tile is
  // read during step s, so neither the atomic nor that read waits
  const bool claimer = rank == 0 && tid == kGatherWarps * 32;
  auto take = [&]() { return atomicAdd(counters, 1); };
  auto tile_of = [&](int u) {
    return u >= tile0 && u < total ? __ldg(tiles + (u - tile0)) : make_int4(0, 0, 0, 0);
  };
  auto publish = [&](int slot, int u, int4 td) {
    s_unit[slot] = u;
    s_td[slot] = td;
    if constexpr (P == 2) {
      unit_peer[slot] = u;
      td_peer[slot] = td;
    }
  };
  int next = total;  // claimer: the unit of the next step
  if (claimer) {
    int u = take();
    int4 td = tile_of(u);
    while (u >= tile0 && u < total && td.z > k_cut) td = tile_of(u = take());
    publish(0, u, td);
    if (u < total) next = take();
  }
  pair_sync<P>();

  // Step s: the gather warps aggregate unit g (slot s % 3) into buffer
  // s & 1 while the product warps multiply unit p, gathered in step s - 1,
  // from buffer (s - 1) & 1 (in step 0 they stage W instead), and the
  // claimer publishes the unit of step s + 1 (total once past the end).
  // Both CTAs of a pair read the same units, so they take the same steps.
  for (int s = 0;; ++s) {
    const int g = s_unit[s % kSlots];
    const int p = s > 0 ? s_unit[(s + kSlots - 1) % kSlots] : -1;
    if (p >= total) break;
    int4 td_next;
    int after = total;
    if (claimer) {  // both in flight while the claimer's warp works
      td_next = tile_of(next);
      if (next < total) after = take();
    }
    if (warp < kGatherWarps) {
      const int j = rank * kGatherWarps + warp;  // the warp among the pair's
      float* buf = a_s + (s & 1) * kBufFloats;
      float* buf_peer = a_peer + (s & 1) * kBufFloats;
      auto sink = [&](int r, const float (&a)[2][4]) {
        put_row_swz<D>(buf, r, lane, a);
        if constexpr (P == 2) put_row_swz<D>(buf_peer, r, lane, a);
      };
      if (g < n_groups) {  // one segment a warp: its partial, then its count
        const int item = g * J + j;
        if (item < n_segs) {
          const int4 sa = __ldg(segs + 2 * item), sb = __ldg(segs + 2 * item + 1);
          float acc[2][4] = {};
          int row;
          ell::walk_vslots<T, D, true, kInFlight>(x, diag, rows, idx, ew, sa.x, sa.z, sa.w, sb.x,
                                                  sb.y, lane, acc, row,
                                                  [](int, const float (&)[2][4]) {});
          ell::put_row<D>(partial + static_cast<long>(sb.z) * D, lane, acc);
          __threadfence();
          __syncwarp();
          if (lane == 0) atomicAdd(seg_counters + sb.w, 1);
        }
      } else if (g < tile0) {  // cut rows: each row's partials, in segment order
        const int h0 = (g - n_groups) * H;
        const int nrows = min(H, n_hub - h0);
        for (int r = j * nrows / J; r < (j + 1) * nrows / J; ++r) {
          const int2 hr = __ldg(hub + h0 + r);  // (split, natural row)
          const int p0 = __ldg(split_p0 + hr.x), p1 = __ldg(split_p0 + hr.x + 1);
          if (lane == 0) {
            int* counter = seg_counters + hr.x;
            for (long spin = 0; ld_acquire(counter) < p1 - p0; ++spin) {
              if (spin > (1l << 24)) __trap();  // a segment that never counts: fail, not hang
              __nanosleep(64);
            }
            *counter = 0;  // every segment has counted: ready for the next launch
            s_hub_rows[s & 1][r] = hr.y;
            if constexpr (P == 2) hub_peer[(s & 1) * kTileRows + r] = hr.y;
          }
          __syncwarp();
          __threadfence();
          float sum[2][4] = {};
#pragma unroll 4  // loads in flight; the adds stay in segment order
          for (int q = p0; q < p1; ++q)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float4 t = __ldcg(
                  reinterpret_cast<const float4*>(partial + static_cast<long>(q) * D + c * 128) +
                  lane);
              sum[c][0] += t.x;
              sum[c][1] += t.y;
              sum[c][2] += t.z;
              sum[c][3] += t.w;
            }
          sink(r, sum);
        }
      } else if (g < total) {  // a run of the tile's rows a warp
        const int4 td = s_td[s % kSlots];
        const int nrows = td.y, k = td.z;
        const int r0 = j * nrows / J, r1 = (j + 1) * nrows / J;
        if (r1 > r0) {
          float acc[2][4] = {};
          int cur;
          ell::walk_vslots<T, D, false, kInFlight>(x, diag, rows + td.x, idx, ew, 0, k, td.w,
                                                   r0 * (k + 1), r1 * (k + 1), lane, acc, cur,
                                                   sink);
          sink(cur, acc);
        }
      }
    } else if (s == 0) {  // W into shared memory, once, while step 0 gathers
      // a lane takes a block of 4 k's × 4 (fp32) or 8 (bf16) columns: one
      // 16-byte load from each of the 4 rows of W, then one chunk of Wᵀ
      // per column; the lanes of a warp take 32 consecutive chunks of the
      // same columns, so the shared stores do not conflict
      const int pt = tid - kGatherWarps * 32;
      constexpr int kPT = kProductWarps * 32;
      if constexpr (P == 2) {  // the rank's 128 columns, fp32 (as gcn_fused_kernel stages them)
        const float* w0 = reinterpret_cast<const float*>(wmat) + rank * 128;
        for (int i = pt; i < (D / 4) * (128 / 4); i += kPT) {
          const int f = i % (D / 4), n = (i / (D / 4)) * 4;  // k = 4f .. 4f + 3
          float4 v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = __ldg(reinterpret_cast<const float4*>(w0 + static_cast<long>(4 * f + e) * D + n));
          *reinterpret_cast<float4*>(swz<D>(w_s, n, f)) = make_float4(v[0].x, v[1].x, v[2].x, v[3].x);
          *reinterpret_cast<float4*>(swz<D>(w_s, n + 1, f)) = make_float4(v[0].y, v[1].y, v[2].y, v[3].y);
          *reinterpret_cast<float4*>(swz<D>(w_s, n + 2, f)) = make_float4(v[0].z, v[1].z, v[2].z, v[3].z);
          *reinterpret_cast<float4*>(swz<D>(w_s, n + 3, f)) = make_float4(v[0].w, v[1].w, v[2].w, v[3].w);
        }
      } else {  // whole, bf16, 4 k's of a column a chunk
        uint2* wb = reinterpret_cast<uint2*>(w_s);
        for (int i = pt; i < (D / 4) * (D / 8); i += kPT) {
          const int f = i % (D / 4), n = (i / (D / 4)) * 8;
          uint4 v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = __ldg(reinterpret_cast<const uint4*>(wmat + static_cast<long>(4 * f + e) * D + n));
          const uint32_t* r0 = reinterpret_cast<const uint32_t*>(&v[0]);
          const uint32_t* r1 = reinterpret_cast<const uint32_t*>(&v[1]);
          const uint32_t* r2 = reinterpret_cast<const uint32_t*>(&v[2]);
          const uint32_t* r3 = reinterpret_cast<const uint32_t*>(&v[3]);
#pragma unroll
          for (int c = 0; c < 8; ++c) {  // column n + c: the low or high bf16 of each row's word
            const uint32_t sel = c & 1 ? 0x7632 : 0x5410;
            wb[wchunk(n + c, f)] = make_uint2(__byte_perm(r0[c / 2], r1[c / 2], sel),
                                              __byte_perm(r2[c / 2], r3[c / 2], sel));
          }
        }
      }
    } else if (P == 2 && p >= n_groups && p < tile0) {
      // fp32 cut rows: row_product in fp32 SIMT on the rank's panel, one
      // row a warp, as the narrow instances (and this one before) multiply
      // them: a cut row carries the gradient of thousands of rows, so its
      // bits are kept
      const int r = warp - kGatherWarps;
      const float* buf = a_s + ((s - 1) & 1) * kBufFloats;
      if (r < min(H, n_hub - (p - n_groups) * H)) {
        float a[2][4];
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const float4 v = *reinterpret_cast<const float4*>(swz<D>(buf, r, cc * 32 + lane));
          a[cc][0] = v.x;
          a[cc][1] = v.y;
          a[cc][2] = v.z;
          a[cc][3] = v.w;
        }
        row_product<T, D, 128>(w_s, a, bias ? bias + rank * 128 : nullptr, lane,
                               out + static_cast<long>(s_hub_rows[(s - 1) & 1][r]) * D +
                                   rank * 128);
      }
    } else if (p >= n_groups) {  // a tile, or bf16 cut rows, to multiply
      const int c = warp - kGatherWarps;
      const float* buf = a_s + ((s - 1) & 1) * kBufFloats;
      int nrows;
      const int* orows;
      if (p >= tile0) {
        const int4 td = s_td[(s + kSlots - 1) % kSlots];
        nrows = td.y;
        orows = rows + td.x;
      } else {
        nrows = min(H, n_hub - (p - n_groups) * H);
        orows = s_hub_rows[(s - 1) & 1];
      }
      if constexpr (P == 2) {
        float acc[2][kNT32][4] = {};
        product<kNT32>(buf, w_s, c * kNT32 * 8, lane, nrows, acc);
        store_rows<T, kNT32>(acc, orows, nrows, bias, rank * 128 + c * kNT32 * 8, lane, out);
      } else {
        float acc[2][kNT16][4] = {};
        product<kNT16>(buf, reinterpret_cast<const uint2*>(w_s), c * kNT16 * 8, lane, nrows, acc);
        store_rows<T, kNT16>(acc, orows, nrows, bias, c * kNT16 * 8, lane, out);
      }
    }
    if (claimer) {  // past the tiles of the cut rows (they head the tile table)
      while (next >= tile0 && next < total && td_next.z > k_cut) {
        next = after;
        td_next = tile_of(next);
        after = next < total ? take() : total;
      }
      publish((s + 1) % kSlots, next, td_next);
      next = after;
    }
    pair_sync<P>();
  }

  // the last CTA out resets the counters for the next launch: every claim
  // was made before its pair's last step
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(counters + 1, 1) == static_cast<int>(gridDim.x) - 1)
      counters[0] = counters[1] = 0;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* wmat, const float* bias, const float* diag,
                   const int* rows, const int* idx, const float* ew, const int* tiles,
                   int n_tiles, const int* segs, int n_segs, int k_cut, const int* split_p0,
                   const int* hub, int n_hub, int* counters, float* partial, void* out,
                   cudaStream_t stream) {
  constexpr int P = kPair<T>;
  auto kern = gcn_fused_kernel_wide<T>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  int dev = 0, n_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  int pairs = 0;  // pairs (or CTAs) resident at once
  if constexpr (P == 2) {
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cfg.gridDim = dim3(n_sm / P * P);
    if ((err = cudaOccupancyMaxActiveClusters(&pairs, kern, &cfg)) != cudaSuccess) return err;
  } else {
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&pairs, kern, kThreads, kSmem)) !=
        cudaSuccess)
      return err;
    pairs *= n_sm;
  }
  if (pairs < 1) return cudaErrorInvalidConfiguration;  // raised by the wrapper, no fallback
  const int units = (n_segs + P * kGatherWarps - 1) / (P * kGatherWarps) + n_tiles +
                    (n_hub + kHubRows<T> - 1) / kHubRows<T>;
  cfg.gridDim = dim3(P * std::max(1, std::min(units, pairs)));
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(x), static_cast<const T*>(wmat),
                           bias, diag, rows, idx, ew, reinterpret_cast<const int4*>(tiles),
                           n_tiles, reinterpret_cast<const int4*>(segs), n_segs, k_cut, split_p0,
                           reinterpret_cast<const int2*>(hub), n_hub, counters, partial,
                           static_cast<T*>(out));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace wide

// ---------------------------------------------------------------------------
// Any other (d_in, d_out): gcn_fused_kernel_any

namespace any {

constexpr int kPanel = 128;  // columns of a gather panel (ell::PanelCols: 4 a lane)
constexpr int kWChunk = 64;  // k's of Wᵀ staged at a time when W is not resident

// float4 f of row r of an fp32 array of `pitch` floats (a multiple of 32)
// in shared memory, swizzled as swz: odd rows swap the halves of each group
// of 8 float4s
template <typename F>
__device__ __forceinline__ F* swzp(F* base, int pitch, int r, int f) {
  return base + r * pitch + ((f ^ ((r & 1) << 2)) << 2);
}

// Wᵀ rows [n0, n0 + rows) (columns of W) × k's [k0, k0 + kcols) into w_s as
// fp32 (pitch kcols, swizzled), zero past d_in and d_out; rows a multiple of
// 8 and kcols of 32.  Each group of 32 threads moves 8 columns × 16 k's.
template <typename T>
__device__ __forceinline__ void stage_wt(float* w_s, const T* __restrict__ wmat, int d_in,
                                         int d_out, int n0, int k0, int rows, int kcols,
                                         int tid) {
  const int nf = kcols / 4;
  for (int i = tid; i < rows * nf; i += kThreads) {
    const int grp = i >> 5, l = i & 31;
    const int n = (grp % (rows / 8)) * 8 + (l >> 2), f = (grp / (rows / 8)) * 4 + (l & 3);
    const int col = n0 + n, k = k0 + 4 * f;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = col < d_out && k + e < d_in
                 ? ell::ld_elem(wmat + static_cast<long>(k + e) * d_out + col)
                 : 0.f;
    *reinterpret_cast<float4*>(swzp(w_s, kcols, n, f)) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// c += rows [0, 16·n_mt) of the aggregate × NT n-tiles of Wᵀ from row wrow,
// over `len` k's (a multiple of 16) from float4 fa of a_s's rows and fw of
// w_s's: the k order of gcn_fused_kernel (k-slots t, t + 4 of a k-step are
// d = kk + 4t + 2ks + {0, 1}), each group of 16 k's summed from zero, then
// added in fp32.  fp32: 3× TF32 (small terms first, then big·big), as
// products16.  bf16: the aggregate's three bf16 terms (lo, mid, hi) times
// the bf16 W on the bf16 tensor cores (m16n8k16), as the (256, 256) bf16
// instance multiplies; W is staged as fp32 and packed back to bf16 exactly.
template <typename T, int NT>
__device__ __forceinline__ void product(float (&c)[2][NT][4], const float* a_s, int pa, int fa,
                                        const float* w_s, int pw, int wrow, int fw, int len,
                                        int n_mt, int lane) {
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll 1
  for (int kk = 0; kk < len; kk += 16) {
    float4 av[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        av[mt][h] = mt < n_mt ? *reinterpret_cast<const float4*>(
                                    swzp(a_s, pa, mt * 16 + h * 8 + gq, fa + kk / 4 + tq))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 bv[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      bv[nt] = *reinterpret_cast<const float4*>(
          swzp(w_s, pw, wrow + nt * 8 + gq, fw + kk / 4 + tq));
    float t[2][NT][4] = {};
    if constexpr (sizeof(T) == 4) {
      uint32_t ab[2][2][4], as[2][2][4], bb[NT][4], bs[NT][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          wide::split_tf32_bits(av[mt][h].x, ab[mt][h][0], as[mt][h][0]);
          wide::split_tf32_bits(av[mt][h].y, ab[mt][h][1], as[mt][h][1]);
          wide::split_tf32_bits(av[mt][h].z, ab[mt][h][2], as[mt][h][2]);
          wide::split_tf32_bits(av[mt][h].w, ab[mt][h][3], as[mt][h][3]);
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        wide::split_tf32_bits(bv[nt].x, bb[nt][0], bs[nt][0]);
        wide::split_tf32_bits(bv[nt].y, bb[nt][1], bs[nt][1]);
        wide::split_tf32_bits(bv[nt].z, bb[nt][2], bs[nt][2]);
        wide::split_tf32_bits(bv[nt].w, bb[nt][3], bs[nt][3]);
      }
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int k0 = 2 * ks, k1 = 2 * ks + 1;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (mt >= n_mt) break;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            wide::mma_tf32(t[mt][nt], ab[mt][0][k0], ab[mt][1][k0], ab[mt][0][k1], ab[mt][1][k1],
                           bs[nt][k0], bs[nt][k1]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (mt >= n_mt) break;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            wide::mma_tf32(t[mt][nt], as[mt][0][k0], as[mt][1][k0], as[mt][0][k1], as[mt][1][k1],
                           bb[nt][k0], bb[nt][k1]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (mt >= n_mt) break;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            wide::mma_tf32(t[mt][nt], ab[mt][0][k0], ab[mt][1][k0], ab[mt][0][k1], ab[mt][1][k1],
                           bb[nt][k0], bb[nt][k1]);
        }
      }
    } else {
      uint32_t a[2][3][4];  // [m-tile][hi, mid, lo][fragment register]
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          wide::split3_bf16(av[mt][h].x, av[mt][h].y, a[mt][0][h], a[mt][1][h], a[mt][2][h]);
          wide::split3_bf16(av[mt][h].z, av[mt][h].w, a[mt][0][h + 2], a[mt][1][h + 2],
                            a[mt][2][h + 2]);
        }
      uint32_t b[NT][2];  // the staged values are bf16, so their top halves are exact
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        b[nt][0] = __byte_perm(__float_as_uint(bv[nt].x), __float_as_uint(bv[nt].y), 0x7632);
        b[nt][1] = __byte_perm(__float_as_uint(bv[nt].z), __float_as_uint(bv[nt].w), 0x7632);
      }
#pragma unroll
      for (int term = 2; term >= 0; --term)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (mt >= n_mt) break;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            wide::mma_bf16(t[mt][nt], a[mt][term][0], a[mt][term][1], a[mt][term][2],
                           a[mt][term][3], b[nt][0], b[nt][1]);
        }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[mt][nt][e] += t[mt][nt][e];
  }
}

// One segment of a cut row (segment_plan's item a, b): its virtual slots
// walked once per 128-column panel of d_in, its fp32 partial row (pitch kp,
// zero past d_in) written, then counted.
template <typename T, bool kVec>
__device__ __forceinline__ void segment(const T* __restrict__ x, const float* __restrict__ diag,
                                        const int* __restrict__ rows, const int* __restrict__ idx,
                                        const float* __restrict__ ew, int4 a, int4 b, int d_in,
                                        int kp, float* __restrict__ partial,
                                        int* __restrict__ seg_counters, int lane) {
  for (int q = 0; q < kp / kPanel; ++q) {
    const ell::PanelCols<kVec> cols{lane, d_in, kPanel * q + 4 * lane, q, kp / kPanel};
    float acc[1][4] = {};
    int row;  // a segment covers one row: the walk never moves on
    ell::walk_cols<1, 4, 8>(
        [&](int src, int c, float (&v)[4]) { cols.load(x, src, c, v); }, b.x, b.y, lane, acc, row,
        [&](int v, int& src, float& w, int& key) {
          ell::load_vslot<true>(v, b.y, a.x, a.z, a.w, rows, idx, ew, diag, src, w, key);
        },
        [](int, const float (&)[1][4]) {}, cols.lane_ok());
    ell::store4(partial + static_cast<long>(b.z) * kp + cols.col, acc[0]);
  }
  __threadfence();
  __syncwarp();
  if (lane == 0) atomicAdd(seg_counters + b.w, 1);
}

// Rows [r0, r1) of a tile (K slots each from slot0, then the diagonal),
// columns [ka0, ka0 + ka) ∩ [0, kp) of their aggregate into a_s (pitch ka),
// one 128-column panel at a time, each row's slots summed in slot order.
template <typename T, bool kVec>
__device__ __forceinline__ void gather_tile(const T* __restrict__ x,
                                            const float* __restrict__ diag,
                                            const int* __restrict__ rows,
                                            const int* __restrict__ idx,
                                            const float* __restrict__ ew, int k, long slot0,
                                            int r0, int r1, int d_in, int kp, int ka0, int ka,
                                            float* a_s, int lane) {
  const int q0 = ka0 / kPanel, q1 = min(ka0 + ka, kp) / kPanel;
  const int v1 = r1 * (k + 1);
  for (int q = q0; q < q1; ++q) {
    const ell::PanelCols<kVec> cols{lane, d_in, kPanel * q + 4 * lane, q, kp / kPanel};
    const int f = (q - q0) * 32 + lane;
    auto sink = [&](int r, const float (&v)[1][4]) { ell::store4(swzp(a_s, ka, r, f), v[0]); };
    float acc[1][4] = {};
    int cur;
    ell::walk_cols<1, 4, 8>(
        [&](int src, int c, float (&v)[4]) { cols.load(x, src, c, v); }, r0 * (k + 1), v1, lane,
        acc, cur,
        [&](int v, int& src, float& w, int& key) {
          ell::load_vslot<false>(v, v1, 0, k, slot0, rows, idx, ew, diag, src, w, key);
        },
        sink, cols.lane_ok());
    sink(cur, acc);
  }
}

// Work units, in the order they are taken: groups of kWarps cut-row
// segments (one a warp), the cut rows kTileRows at a time (each waits for
// its segments, all taken before it, then sums its partials in segment
// order), then the tiles (those of K > k_cut skipped).  A unit's rows are
// aggregated into a_s (ka columns of d_in at a time: all of them once when
// ka covers d_in, else again for each output panel) and multiplied by W
// panel by panel (NP = 64·NT columns, NT n-tiles a warp), W resident
// (w_res: Wᵀ whole, staged once per block) or streamed kWChunk k's at a
// time.  counters: [0] the unit counter, [1] blocks done, then one per cut
// row.
template <typename T, int NT, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
gcn_fused_kernel_any(const T* __restrict__ x, const T* __restrict__ wmat,
                     const float* __restrict__ bias, const float* __restrict__ diag,
                     const int* __restrict__ rows, const int* __restrict__ idx,
                     const float* __restrict__ ew, const int4* __restrict__ tiles, int n_tiles,
                     const int4* __restrict__ segs, int n_segs, int k_cut,
                     const int* __restrict__ split_p0, const int2* __restrict__ hub, int n_hub,
                     int* __restrict__ counters, float* __restrict__ partial,
                     T* __restrict__ out, int d_in, int d_out, int ka, int w_res) {
  constexpr int NP = 8 * kWarps * NT;  // output columns of a panel
  extern __shared__ float4 smem4[];
  const int kp = (d_in + kPanel - 1) / kPanel * kPanel;  // the partials' pitch
  const int kpad = (d_in + 15) / 16 * 16;                 // the product's k's
  const int n_ach = (kp + ka - 1) / ka;
  const int n_pan = (d_out + NP - 1) / NP;
  const int pw = w_res ? (d_in + 31) / 32 * 32 : kWChunk;  // w_s's pitch
  float* a_s = reinterpret_cast<float*>(smem4);  // [kTileRows][ka], swizzled
  float* w_s = a_s + kTileRows * ka;             // Wᵀ [n_pan·NP][pw] or [NP][kWChunk]
  __shared__ int s_unit[2];
  __shared__ int s_orow[kTileRows];  // the unit's rows, natural ids

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  if (w_res) stage_wt<T>(w_s, wmat, d_in, d_out, 0, 0, n_pan * NP, pw, tid);
  const int n_groups = (n_segs + kWarps - 1) / kWarps;
  const int tile0 = n_groups + (n_hub + kTileRows - 1) / kTileRows;
  const int total = tile0 + n_tiles;
  int* seg_counters = counters + 2;

  for (int it = 0;; ++it) {
    if (tid == 0) s_unit[it & 1] = atomicAdd(counters, 1);
    __syncthreads();  // publishes the unit; W staged; the last unit's reads of a_s done
    const int u = s_unit[it & 1];
    if (u >= total) break;
    if (u < n_groups) {
      const int item = u * kWarps + warp;
      if (item < n_segs)
        segment<T, kVec>(x, diag, rows, idx, ew, __ldg(segs + 2 * item),
                         __ldg(segs + 2 * item + 1), d_in, kp, partial, seg_counters, lane);
      continue;
    }
    const bool cut = u < tile0;
    int nrows, h0 = 0, k = 0;
    int4 td = make_int4(0, 0, 0, 0);
    if (cut) {
      h0 = (u - n_groups) * kTileRows;
      nrows = min(kTileRows, n_hub - h0);
      if (tid < nrows) {  // one thread a cut row: wait for its segments
        const int2 hr = __ldg(hub + h0 + tid);  // (split, natural row)
        const int want = __ldg(split_p0 + hr.x + 1) - __ldg(split_p0 + hr.x);
        int* counter = seg_counters + hr.x;
        for (long spin = 0; wide::ld_acquire(counter) < want; ++spin) {
          if (spin > (1l << 24)) __trap();  // a segment that never counts: fail, not hang
          __nanosleep(64);
        }
        *counter = 0;  // every segment has counted: ready for the next launch
        __threadfence();
        s_orow[tid] = hr.y;
      }
    } else {
      td = __ldg(tiles + (u - tile0));
      if (td.z > k_cut) continue;
      nrows = td.y;
      k = td.z;
      if (tid < nrows) s_orow[tid] = __ldg(rows + td.x + tid);
    }
    const int n_mt = nrows > 16 ? 2 : 1;
    for (int p = 0; p < n_pan; ++p) {
      float c[2][NT][4] = {};
      for (int ac = 0; ac < n_ach; ++ac) {
        const int ka0 = ac * ka;
        if (n_ach > 1 || p == 0) {
          __syncthreads();  // the last product's reads of a_s done
          if (cut) {  // a warp a row: its partials in segment order
            const int q0 = ka0 / kPanel, q1 = min(ka0 + ka, kp) / kPanel;
            for (int r = warp; r < nrows; r += kWarps) {
              const int split = __ldg(&hub[h0 + r].x);
              const int p0 = __ldg(split_p0 + split), p1 = __ldg(split_p0 + split + 1);
              for (int q = q0; q < q1; ++q) {
                float s[4] = {};
#pragma unroll 4  // loads in flight; the adds stay in segment order
                for (int pp = p0; pp < p1; ++pp) {
                  const float4 v = __ldcg(reinterpret_cast<const float4*>(
                                              partial + static_cast<long>(pp) * kp + kPanel * q) +
                                          lane);
                  s[0] += v.x;
                  s[1] += v.y;
                  s[2] += v.z;
                  s[3] += v.w;
                }
                ell::store4(swzp(a_s, ka, r, (q - q0) * 32 + lane), s);
              }
            }
          } else {  // a contiguous run of the tile's rows a warp
            const int r0 = warp * nrows / kWarps, r1 = (warp + 1) * nrows / kWarps;
            if (r1 > r0)
              gather_tile<T, kVec>(x, diag, rows + td.x, idx, ew, k, td.w, r0, r1, d_in, kp, ka0,
                                   ka, a_s, lane);
          }
          __syncthreads();
        }
        const int kend = min(ka0 + ka, kpad);
        if (w_res) {
          product<T, NT>(c, a_s, ka, 0, w_s, pw, p * NP + warp * 8 * NT, ka0 / 4, kend - ka0,
                         n_mt, lane);
        } else {
          for (int k0 = ka0; k0 < kend; k0 += kWChunk) {
            __syncthreads();  // the last chunk's reads done
            stage_wt<T>(w_s, wmat, d_in, d_out, p * NP, k0, NP, kWChunk, tid);
            __syncthreads();
            product<T, NT>(c, a_s, ka, (k0 - ka0) / 4, w_s, kWChunk, warp * 8 * NT, 0,
                           min(kWChunk, kend - k0), n_mt, lane);
          }
        }
      }
      // c[mt][nt] = (row g, columns 2t, 2t + 1), (row g + 8, the same)
      const int col0 = p * NP + warp * 8 * NT + 2 * tq;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 16 + h * 8 + gq;
          if (r >= nrows) continue;
          T* orow = out + static_cast<long>(s_orow[r]) * d_out;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int col = col0 + nt * 8;
            if (col >= d_out) continue;
            const float v0 = c[mt][nt][2 * h] + (bias ? __ldg(bias + col) : 0.f);
            if (col + 1 < d_out) {
              const float v1 = c[mt][nt][2 * h + 1] + (bias ? __ldg(bias + col + 1) : 0.f);
              if (d_out % 2 == 0) {
                store2(orow + col, v0, v1);
              } else {
                store1(orow + col, v0);
                store1(orow + col + 1, v1);
              }
            } else {
              store1(orow + col, v0);
            }
          }
        }
    }
  }

  // the last block out resets the counters for the next launch: every
  // block has taken its last unit by the time it counts itself done
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(counters + 1, 1) == static_cast<int>(gridDim.x) - 1)
      counters[0] = counters[1] = 0;
  }
}

// The shared memory a launch needs: the aggregate's kTileRows × ka fp32,
// then Wᵀ whole (w_res) or one chunk of kWChunk k's × one panel, fp32
__host__ __device__ constexpr long smem_bytes(int d_in, int d_out, int ka, int nt, int w_res) {
  return 4L * kTileRows * ka +
         (w_res ? 4L * ((d_out + 64 * nt - 1) / (64 * nt)) * 64 * nt * ((d_in + 31) / 32 * 32)
                : 4L * 64 * nt * kWChunk);
}

template <typename T, int NT, bool kVec>
cudaError_t launch(const void* x, const void* wmat, const float* bias, const float* diag,
                   const int* rows, const int* idx, const float* ew, const int* tiles,
                   int n_tiles, const int* segs, int n_segs, int k_cut, const int* split_p0,
                   const int* hub, int n_hub, int* counters, float* partial, void* out, int d_in,
                   int d_out, int ka, int w_res, int smem, cudaStream_t stream) {
  auto kern = gcn_fused_kernel_any<T, NT, kVec>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;  // raised by the wrapper, no fallback
  const int units = (n_segs + kWarps - 1) / kWarps + (n_hub + kTileRows - 1) / kTileRows + n_tiles;
  const int grid = std::max(1, std::min(units, n_sm * per_sm));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wmat), bias, diag, rows, idx, ew,
      reinterpret_cast<const int4*>(tiles), n_tiles, reinterpret_cast<const int4*>(segs), n_segs,
      k_cut, split_p0, reinterpret_cast<const int2*>(hub), n_hub, counters, partial,
      static_cast<T*>(out), d_in, d_out, ka, w_res);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int nt, int d_in, const void* x, const void* wmat, const float* bias,
                     const float* diag, const int* rows, const int* idx, const float* ew,
                     const int* tiles, int n_tiles, const int* segs, int n_segs, int k_cut,
                     const int* split_p0, const int* hub, int n_hub, int* counters,
                     float* partial, void* out, int d_out, int ka, int w_res, int smem,
                     cudaStream_t stream) {
#define GCN_ANY_LAUNCH(NT, VEC)                                                                \
  launch<T, NT, VEC>(x, wmat, bias, diag, rows, idx, ew, tiles, n_tiles, segs, n_segs, k_cut, \
                     split_p0, hub, n_hub, counters, partial, out, d_in, d_out, ka, w_res,    \
                     smem, stream)
  const bool vec = d_in % 4 == 0;  // every row of x starts 16-byte (fp32) or 8-byte aligned
  if (nt == 1) return vec ? GCN_ANY_LAUNCH(1, true) : GCN_ANY_LAUNCH(1, false);
  if (nt == 2) return vec ? GCN_ANY_LAUNCH(2, true) : GCN_ANY_LAUNCH(2, false);
  return cudaErrorInvalidValue;
#undef GCN_ANY_LAUNCH
}

}  // namespace any

// ---------------------------------------------------------------------------
// The redesigned any-width kernel: gcn_fused_kernel_wgmma

namespace wg {

// Warps 0-10 gather, warp 11 streams W, warps 12-15 (one warpgroup,
// wgmma's 64 rows) multiply
constexpr int kGatherWarps = 11;
constexpr int kProducerWarp = kGatherWarps;
constexpr int kProductWarp0 = 12;
constexpr int kProductWarps = 4;
constexpr int kThreads = (kProductWarp0 + kProductWarps) * 32;
constexpr int kRows = 64;       // rows of a unit: two plan tiles of kTileRows
constexpr int kCluster = 2;     // CTAs that share each W chunk (one multicast copy)
constexpr int kN = 64;          // output columns of a product pass (wgmma's N)
constexpr int kSlab = 128;      // aggregate columns of a slab (one gather panel)
constexpr int kSlabFloats = kRows * kSlab;  // 32 KB
constexpr int kPlaneBytes = kN * 128;       // 64 rows of Wᵀ × 128 bytes of k: 8 KB
constexpr int kMaxStages = 16;
// cut rows a unit: each sums its segments' partials alone, so few rows a
// unit spread those sums over many CTAs (64 left one CTA the layer's tail)
constexpr int kHubRows = 16;
constexpr int kUnitSlots = 3;  // step bases in flight: gathered, multiplied, claimed
constexpr int kProductBar = 1, kGatherBar = 2;  // named barriers (0 is __syncthreads)

// k's of a W chunk: one 128-byte row of the swizzle atom, 32 TF32 or 64 bf16
template <typename T>
constexpr int kChunkK = 128 / static_cast<int>(sizeof(T));
// a W chunk: fp32 W's big and small TF32 planes (the prologue splits W once
// a call, so no CTA splits a chunk it receives), or the bf16 W's one plane
template <typename T>
constexpr int kChunkBytes = sizeof(T) == 4 ? 2 * kPlaneBytes : kPlaneBytes;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// arrive on the barrier at bar's offset in CTA `cta` of the cluster.  The
// release is the CTA's (as CUTLASS's ClusterBarrier arrives): it publishes
// nothing to the peer, only that a slot's reads are done, and a release at
// the cluster's scope first drains the thread's stores to global memory,
// which stalled the warpgroup at every W chunk
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\nmapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}" ::"r"(smem_u32(bar)),
      "r"(cta)
      : "memory");
}

// wait for the phase of `parity` to complete; a barrier that never does
// (a lost arrival) traps rather than hangs
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  for (long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1l << 24)) __trap();
  }
}

// `bytes` from global src into shared dst of every CTA in `mask`, each
// copy's bytes counted on the barrier at bar's offset in that CTA
__device__ __forceinline__ void bulk_multicast(void* dst, const void* src, uint32_t bytes,
                                               uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// ties the registers to the asm statements around them, so the compiler
// neither reads the accumulator before the wait nor moves a write past it
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// B operand descriptor: K-major, 128-byte swizzle, 8-row groups 1,024
// bytes apart; p lies in a 1,024-byte aligned tile (plus a k offset)
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

#define GCN_WG_D32                                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define GCN_WG_OUT32(d)                                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 × 64, fp32) = [d +] A · B: A (64 × 8 TF32) from the warpgroup's
// registers, a0..a3 = (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of
// the warp's 16 rows; B (8 × 64) by its descriptor
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " GCN_WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : GCN_WG_OUT32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(scale_d));
}

// d (64 × 64, fp32) = [d +] A · B: A (64 × 16 bf16) from registers, a0..a3 =
// (row g, k 2t, 2t + 1), (g + 8, 2t, 2t + 1), (g, 2t + 8, 2t + 9),
// (g + 8, 2t + 8, 2t + 9); B (16 × 64) K-major by its descriptor
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " GCN_WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : GCN_WG_OUT32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(scale_d));
}

#undef GCN_WG_OUT32
#undef GCN_WG_D32

// The column of d_in held at k position `pos` of a chunk's 128-byte row of
// Wᵀ: each group of 16 k's is permuted so that a lane's four aggregate
// columns kk + 4t .. + 3 are one 16-byte load and its fragment registers
// (TF32: k t, t + 4 of k-steps 0 and 1; bf16: k 2t, 2t + 1, 2t + 8, 2t + 9)
// take them in order, as gcn_fused_kernel permutes both operands
template <typename T>
__host__ __device__ constexpr int k_of(int pos) {
  const int j = pos % 16;
  return pos / 16 * 16 + (sizeof(T) == 4 ? 4 * (j % 4) + 2 * (j / 8) + (j % 8) / 4
                                         : 4 * ((j % 8) / 2) + 2 * (j / 8) + j % 2);
}

template <typename T>
struct Bits;
template <>
struct Bits<float> {
  using type = uint32_t;
};
template <>
struct Bits<__nv_bfloat16> {
  using type = uint16_t;
};

// The prologue: Wᵀ into the product's layout, once per call.  Chunk
// (panel p, k-chunk c) holds columns [64p, 64p + 64) of W (rows n of Wᵀ) ×
// k's [c·CK, c·CK + CK), each row 128 bytes in k_of order, the 16-byte
// pieces of row n swizzled by n % 8 (Swizzle<3, 4, 3>, as wgmma reads a
// 128-byte-swizzled K-major tile); zero past d_in and d_out.  fp32: two
// such planes, big = W rounded to TF32 and small = W − big rounded to TF32
// (wide::split_tf32_bits); bf16: W.  One thread an element, stores
// coalesced.
template <typename T>
__global__ void wt_layout(const T* __restrict__ wmat, T* __restrict__ wt, int d_in, int d_out,
                          int n_kc, long n_elems) {
  using B = typename Bits<T>::type;
  constexpr int E = static_cast<int>(sizeof(T));
  constexpr int kPer = kPlaneBytes / E;                  // elements a plane
  constexpr int kPlanes = kChunkBytes<T> / kPlaneBytes;  // planes a chunk
  const B* w = reinterpret_cast<const B*>(wmat);
  B* o = reinterpret_cast<B*>(wt);
  for (long e = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x; e < n_elems;
       e += static_cast<long>(gridDim.x) * blockDim.x) {
    const long chunk = e / (kPer * kPlanes);
    const int plane = static_cast<int>(e / kPer % kPlanes);
    const int b = static_cast<int>(e % kPer) * E;  // byte in the plane
    const int pan = static_cast<int>(chunk / n_kc), c = static_cast<int>(chunk % n_kc);
    const int n = b / 128, piece = ((b % 128) / 16) ^ (n & 7);
    const int k = c * kChunkK<T> + k_of<T>((piece * 16 + b % 16) / E), col = pan * kN + n;
    B v = k < d_in && col < d_out ? w[static_cast<long>(k) * d_out + col] : B(0);
    if constexpr (kPlanes == 2) {
      uint32_t big, small;
      wide::split_tf32_bits(__uint_as_float(v), big, small);
      v = plane == 0 ? big : small;
    }
    o[e] = v;
  }
}

// The unit kinds, in the order the counter hands them out: groups of
// kGatherWarps cut-row segments, the cut rows kHubRows at a time, then pairs of
// plan tiles (a tile of K > k_cut holds cut rows and is skipped)
struct Units {
  int n_groups, tile0, total;
  const int4* tiles;
  int n_tiles, k_cut;

  __device__ __forceinline__ bool tile_ok(int t) const {
    return t < n_tiles && __ldg(&tiles[t].z) <= k_cut;
  }
  // whether unit u has rows to multiply
  __device__ __forceinline__ bool product(int u) const {
    if (u < n_groups || u >= total) return false;
    if (u < tile0) return true;
    return tile_ok(2 * (u - tile0)) || tile_ok(2 * (u - tile0) + 1);
  }
};

// This CTA's share of a W chunk: its 1/kCluster of chunk `q` of the step
// into ring slot `slot` of every CTA of the cluster, counted on each one's
// full barrier (which expects the whole chunk: every CTA's share)
template <typename T>
__device__ __forceinline__ void issue_chunk(uint8_t* ring, uint64_t* full, const uint8_t* wt,
                                           long q, int slot, int rank) {
  constexpr int kShare = kChunkBytes<T> / kCluster;
  mbar_expect_tx(&full[slot], kChunkBytes<T>);
  bulk_multicast(ring + slot * kChunkBytes<T> + rank * kShare,
                 wt + q * kChunkBytes<T> + rank * kShare, kShare, &full[slot],
                 (1 << kCluster) - 1);
}

// One group of 16 k's (columns kk.. of the aggregate, k-steps `step0`.. of
// the chunk's rows) into tmp from zero: fp32 3× TF32, small terms first,
// then big·big, per k-step (W's big plane at `chunk`, its small plane at
// `small`); bf16 the aggregate's three bf16 terms (lo, mid, hi) times the
// bf16 W.  Committed as one wgmma group.
template <typename T>
__device__ __forceinline__ void group(float (&tmp)[32], const float* agg, int kk, int r0, int tq,
                                      const uint8_t* chunk, const uint8_t* small, int step0) {
  const float* slab = agg + (kk / kSlab) * kSlabFloats;
  const int f = (kk % kSlab) / 4 + tq;
  const float4 v0 = *reinterpret_cast<const float4*>(any::swzp(slab, kSlab, r0, f));
  const float4 v1 = *reinterpret_cast<const float4*>(any::swzp(slab, kSlab, r0 + 8, f));
  if constexpr (sizeof(T) == 4) {
    uint32_t ab[2][4], as[2][4];  // [row g, g + 8][component]
    wide::split_tf32_bits(v0.x, ab[0][0], as[0][0]);
    wide::split_tf32_bits(v0.y, ab[0][1], as[0][1]);
    wide::split_tf32_bits(v0.z, ab[0][2], as[0][2]);
    wide::split_tf32_bits(v0.w, ab[0][3], as[0][3]);
    wide::split_tf32_bits(v1.x, ab[1][0], as[1][0]);
    wide::split_tf32_bits(v1.y, ab[1][1], as[1][1]);
    wide::split_tf32_bits(v1.z, ab[1][2], as[1][2]);
    wide::split_tf32_bits(v1.w, ab[1][3], as[1][3]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int k0 = 2 * ks, k1 = 2 * ks + 1;
      const int off = (step0 + ks) * 32;  // the k-step's 32 bytes of the rows
      const uint64_t db = desc_sw128(chunk + off), ds = desc_sw128(small + off);
      wgmma_tf32(tmp, ab[0][k0], ab[1][k0], ab[0][k1], ab[1][k1], ds, ks);
      wgmma_tf32(tmp, as[0][k0], as[1][k0], as[0][k1], as[1][k1], db, 1);
      wgmma_tf32(tmp, ab[0][k0], ab[1][k0], ab[0][k1], ab[1][k1], db, 1);
    }
  } else {
    uint32_t a[3][4];  // [hi, mid, lo][fragment register]
    wide::split3_bf16(v0.x, v0.y, a[0][0], a[1][0], a[2][0]);
    wide::split3_bf16(v1.x, v1.y, a[0][1], a[1][1], a[2][1]);
    wide::split3_bf16(v0.z, v0.w, a[0][2], a[1][2], a[2][2]);
    wide::split3_bf16(v1.z, v1.w, a[0][3], a[1][3], a[2][3]);
    const uint64_t db = desc_sw128(chunk + step0 * 32);
    wgmma_fence();
#pragma unroll
    for (int term = 2; term >= 0; --term)
      wgmma_bf16(tmp, a[term][0], a[term][1], a[term][2], a[term][3], db, term != 2);
  }
  wgmma_commit();
}

// The product warpgroup's work on the W chunks [i0, i0 + n_pan·n_kc) of a
// step, output panel by panel (kN columns): each chunk waited for,
// multiplied when `mine` (this CTA's unit has rows), then released to both
// CTAs' producers.  acc = Σ over the panel's groups of 16 k's, each
// group's products summed from zero in tmp, then added in fp32 (the tensor
// cores' own adds lose more than fp32's; this file's header).  A group's A
// fragments are registers, which a wgmma reads until it completes, so a
// group is waited for before the next one is loaded (two groups in flight
// made ptxas serialise them, and ran slower: PERF.md §6).  fp32 reads W's
// big and small TF32 planes as the prologue laid them out.
template <typename T>
__device__ __forceinline__ void product(uint8_t* ring, uint64_t* full,
                                        uint64_t* empty, int stages, long i0, int n_pan,
                                        int n_kc, int kpad, const float* agg, const int* orow,
                                        bool mine, const float* __restrict__ bias, int d_out,
                                        T* __restrict__ out, int pt) {
  constexpr int G = kChunkK<T> / 16;  // groups of 16 k's a chunk
  const int lane = pt & 31, w4 = pt >> 5, tq = lane & 3;
  const int r0 = 16 * w4 + (lane >> 2);  // the lane's rows r0, r0 + 8 of the unit
  float tmp[32];                         // wgmma's scale-d 0 restarts each group
#pragma unroll
  for (int e = 0; e < 32; ++e) tmp[e] = 0.f;
  for (int pan = 0; pan < n_pan; ++pan) {
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    float2 bv[kN / 8];  // the lane's bias, loaded before the products hide its latency
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int col = pan * kN + 8 * j + 2 * tq;
      bv[j].x = mine && bias && col < d_out ? __ldg(bias + col) : 0.f;
      bv[j].y = mine && bias && col + 1 < d_out ? __ldg(bias + col + 1) : 0.f;
    }
    for (int c = 0; c < n_kc; ++c) {
      const long i = i0 + static_cast<long>(pan) * n_kc + c;
      const int slot = static_cast<int>(i % stages);
      mbar_wait(&full[slot], static_cast<uint32_t>((i / stages) & 1));
      if (mine) {
        const uint8_t* chunk = ring + slot * kChunkBytes<T>;
        for (int gi = 0; gi < G; ++gi) {
          const int kk = c * kChunkK<T> + gi * 16;  // the group's first column of d_in
          if (kk >= kpad) break;
          group<T>(tmp, agg, kk, r0, tq, chunk, chunk + kPlaneBytes,
                   sizeof(T) == 4 ? 2 * gi : gi);
          wgmma_wait0();
          fence_regs(tmp);
#pragma unroll
          for (int e = 0; e < 32; ++e) acc[e] += tmp[e];
        }
      }
      named_sync(kProductBar, kProductWarps * 32);  // every warp's products of the chunk done
      if (pt == 0)
        for (int r = 0; r < kCluster; ++r) mbar_arrive_cluster(&empty[slot], r);
    }
    if (!mine) continue;
    // acc[4j + e]: rows r0 (e < 2), r0 + 8; columns 8j + 2t + e % 2 of the panel
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = orow[r0 + 8 * h];
      if (row < 0) continue;
      T* orow_p = out + static_cast<long>(row) * d_out;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const int col = pan * kN + 8 * j + 2 * tq;
        if (col >= d_out) continue;
        const float v0 = acc[4 * j + 2 * h] + bv[j].x;
        if (col + 1 < d_out) {
          const float v1 = acc[4 * j + 2 * h + 1] + bv[j].y;
          if (d_out % 2 == 0) {
            store2(orow_p + col, v0, v1);
          } else {
            store1(orow_p + col, v0);
            store1(orow_p + col + 1, v1);
          }
        } else {
          store1(orow_p + col, v0);
        }
      }
    }
  }
}

// Rows [r0, r1) of a tile (K slots each from slot0, then the diagonal),
// CI slabs [q0, q0 + CI) of their aggregate in one walk: a lane's 4 columns
// from 128·(q0 + c) + 4·lane of each, 16-byte loads (d_in % 4 == 0); only
// the row's last slab may pass d_in, and there a lane past it loads column
// 0 and keeps zero, so the loads stay unconditional and issue together.  A
// warp's walk is latency-bound: one walk over CI slabs takes CI× fewer
// dependent steps than a walk a slab (any::gather_tile).
template <typename T, int CI>
__device__ __forceinline__ void gather_slabs(const T* __restrict__ x,
                                             const float* __restrict__ diag,
                                             const int* __restrict__ rows,
                                             const int* __restrict__ idx,
                                             const float* __restrict__ ew, int k, long slot0,
                                             int r0, int r1, int d_in, int q0, float* agg,
                                             int lane) {
  constexpr int U = CI == 1 ? 8 : CI == 2 ? 4 : 3;  // source rows in flight
  bool ok[CI];
  int col[CI];
#pragma unroll
  for (int c = 0; c < CI; ++c) {
    col[c] = (q0 + c) * kSlab + 4 * lane;
    ok[c] = col[c] < d_in;
    if (!ok[c]) col[c] = 0;
  }
  auto sink = [&](int r, const float (&v)[CI][4]) {
#pragma unroll
    for (int c = 0; c < CI; ++c)
      ell::store4(any::swzp(agg + (q0 + c) * kSlabFloats, kSlab, r, lane), v[c]);
  };
  const int v1 = r1 * (k + 1);
  float acc[CI][4] = {};
  int cur;
  ell::walk_cols<CI, 4, U>(
      [&](int src, int c, float (&v)[4]) {
        ell::load4(x + static_cast<long>(src) * d_in + col[c], v);
        if (!ok[c]) v[0] = v[1] = v[2] = v[3] = 0.f;
      },
      r0 * (k + 1), v1, lane, acc, cur,
      [&](int v, int& src, float& w, int& key) {
        ell::load_vslot<false>(v, v1, 0, k, slot0, rows, idx, ew, diag, src, w, key);
      },
      sink);
  sink(cur, acc);
}

// The gather warps' work on unit u into the aggregate `agg` (n_slab slabs
// of kRows × kSlab fp32) and its rows' natural ids into orow (-1: no row):
// a segment group (one segment a warp: its partial, then its count),
// kHubRows cut rows (each waits for its segments, then sums its partials in
// segment order), or a pair of tiles (tile h's rows from row 32h; the pair's rows in
// turn split into one contiguous run a warp, of about equal slots, within
// one tile or across the two).
template <typename T, bool kVec>
__device__ __forceinline__ void gather(const Units& un, int u, const T* __restrict__ x,
                                       const float* __restrict__ diag,
                                       const int* __restrict__ rows, const int* __restrict__ idx,
                                       const float* __restrict__ ew,
                                       const int4* __restrict__ segs, int n_segs,
                                       const int* __restrict__ split_p0,
                                       const int2* __restrict__ hub, int n_hub,
                                       int* __restrict__ seg_counters,
                                       float* __restrict__ partial, int d_in, int n_slab,
                                       float* agg, int* orow, int gt) {
  const int lane = gt & 31, warp = gt >> 5;
  const int kp = n_slab * kSlab;
  if (u >= un.total) return;
  if (u < un.n_groups) {
    const int item = u * kGatherWarps + warp;
    if (item < n_segs)
      any::segment<T, kVec>(x, diag, rows, idx, ew, __ldg(segs + 2 * item),
                            __ldg(segs + 2 * item + 1), d_in, kp, partial, seg_counters, lane);
    return;
  }
  if (u < un.tile0) {
    const int h0 = (u - un.n_groups) * kHubRows, nrows = min(kHubRows, n_hub - h0);
    if (gt < kRows) {
      int orig = -1;
      if (gt < nrows) {  // one thread a cut row: wait for its segments
        const int2 hr = __ldg(hub + h0 + gt);  // (split, natural row)
        const int want = __ldg(split_p0 + hr.x + 1) - __ldg(split_p0 + hr.x);
        int* counter = seg_counters + hr.x;
        for (long spin = 0; wide::ld_acquire(counter) < want; ++spin) {
          if (spin > (1l << 24)) __trap();  // a segment that never counts: fail, not hang
          __nanosleep(64);
        }

        *counter = 0;  // every segment has counted: ready for the next launch
        __threadfence();
        orig = hr.y;
      }
      orow[gt] = orig;
    }
    named_sync(kGatherBar, kGatherWarps * 32);
    for (int r = warp; r < nrows; r += kGatherWarps) {
      const int split = __ldg(&hub[h0 + r].x);
      const int p0 = __ldg(split_p0 + split), p1 = __ldg(split_p0 + split + 1);
      for (int q = 0; q < n_slab; ++q) {
        float s[4] = {};
#pragma unroll 8  // loads in flight; the adds stay in segment order
        for (int pp = p0; pp < p1; ++pp) {
          const float4 v = __ldcg(
              reinterpret_cast<const float4*>(partial + static_cast<long>(pp) * kp + kSlab * q) +
              lane);
          s[0] += v.x;
          s[1] += v.y;
          s[2] += v.z;
          s[3] += v.w;
        }
        ell::store4(any::swzp(agg + q * kSlabFloats, kSlab, r, lane), s);
      }
    }
    return;
  }
  int4 td[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = 2 * (u - un.tile0) + h;
    td[h] = un.tile_ok(t) ? __ldg(un.tiles + t) : make_int4(0, 0, 0, 0);
    if (warp == h)
      for (int r = lane; r < kTileRows; r += 32)
        orow[h * kTileRows + r] = r < td[h].y ? __ldg(rows + td[h].x + r) : -1;
  }
  // the rows split by their slots (K + 1 a row), not their count: a warp's
  // walk is latency-bound, so a run of long rows beside short ones held
  // the whole cluster at the step's barrier
  const long va = static_cast<long>(td[0].y) * (td[0].z + 1);
  const long vt = va + static_cast<long>(td[1].y) * (td[1].z + 1);
  auto bound = [&](int w) {  // the first row of warp w's run, rounded to the nearest row
    const long t = w * vt / kGatherWarps;
    if (t <= va) return static_cast<int>((t + td[0].z / 2) / (td[0].z + 1));
    return td[0].y + static_cast<int>((t - va + td[1].z / 2) / (td[1].z + 1));
  };
  const int v0 = bound(warp), v1 = bound(warp + 1);
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the warp's run within tile h (rows of the pair from h·td[0].y)
    const int base = h ? td[0].y : 0;
    const int r0 = max(v0 - base, 0), r1 = min(v1 - base, td[h].y);
    if (r1 <= r0) continue;
    float* agg_h = agg + h * kTileRows * kSlab;
    if constexpr (kVec) {  // up to three slabs a walk
      for (int q = 0; q < n_slab; q += 3) {
        const int n = min(3, n_slab - q);
        if (n == 3)
          gather_slabs<T, 3>(x, diag, rows + td[h].x, idx, ew, td[h].z, td[h].w, r0, r1, d_in,
                             q, agg_h, lane);
        else if (n == 2)
          gather_slabs<T, 2>(x, diag, rows + td[h].x, idx, ew, td[h].z, td[h].w, r0, r1, d_in,
                             q, agg_h, lane);
        else
          gather_slabs<T, 1>(x, diag, rows + td[h].x, idx, ew, td[h].z, td[h].w, r0, r1, d_in,
                             q, agg_h, lane);
      }
    } else {  // element by element at a tail of d_in % 4: a walk a slab
      for (int q = 0; q < n_slab; ++q)
        any::gather_tile<T, kVec>(x, diag, rows + td[h].x, idx, ew, td[h].z, td[h].w, r0, r1,
                                  d_in, kp, q * kSlab, kSlab, agg_h + q * kSlabFloats, lane);
    }
  }
}

// Persistent clusters of kCluster CTAs.  Each step a cluster takes
// kCluster consecutive units from the counter (rank 0 claims the next
// step's during this one and writes it into both CTAs), one a CTA.  The
// gather warps aggregate the step's unit into aggregate buffer s % bufs
// while the product warpgroup multiplies the one gathered a step before
// (bufs = 2), or after it within the step (bufs = 1: a second barrier of
// the cluster between the two).  Where either unit of the step it
// multiplies has rows, both CTAs walk the W chunks of every output panel
// and k-chunk in the same order: a chunk is one multicast copy of the
// prologue's layout, each CTA issuing half, into a ring of `stages` slots;
// a slot is refilled once both CTAs' warpgroups have released it (with
// bufs = 2 the producer goes on into the next step's first chunks).  One
// barrier of the cluster a step hands the aggregate buffers and the units
// over.  counters: [0] the unit counter, [1] CTAs done, then one per cut
// row.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
gcn_fused_kernel_wgmma(const T* __restrict__ x, const uint8_t* __restrict__ wt,
                       const float* __restrict__ bias, const float* __restrict__ diag,
                       const int* __restrict__ rows, const int* __restrict__ idx,
                       const float* __restrict__ ew, const int4* __restrict__ tiles, int n_tiles,
                       const int4* __restrict__ segs, int n_segs, int k_cut,
                       const int* __restrict__ split_p0, const int2* __restrict__ hub, int n_hub,
                       int* __restrict__ counters, float* __restrict__ partial,
                       T* __restrict__ out, int d_in, int d_out, int bufs, int stages) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  float* agg = reinterpret_cast<float*>(ring + stages * kChunkBytes<T>);
  __shared__ uint64_t full[kMaxStages], empty[kMaxStages];
  __shared__ int s_unit[kUnitSlots];
  __shared__ int s_orow[2][kRows];

  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int tid = threadIdx.x, warp = tid >> 5;
  const int n_slab = (d_in + kSlab - 1) / kSlab;
  const int kpad = (d_in + 15) / 16 * 16;
  const int n_pan = (d_out + kN - 1) / kN, n_kc = (d_in + kChunkK<T> - 1) / kChunkK<T>;
  const int n_groups = (n_segs + kGatherWarps - 1) / kGatherWarps;
  const int tile0 = n_groups + (n_hub + kHubRows - 1) / kHubRows;
  const Units un{n_groups, tile0, tile0 + (n_tiles + 1) / 2, tiles, n_tiles, k_cut};
  int* seg_counters = counters + 2;
  auto publish = [&](int slot, int u) {  // the claimer's unit for a step, into every CTA
    for (int r = 0; r < kCluster; ++r) cl.map_shared_rank(s_unit, r)[slot] = u;
  };
  const int producer_warp = kProducerWarp;
  const bool claimer = rank == 0 && tid == producer_warp * 32;
  const bool lag = bufs == 2;  // the product a step behind the gather
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (claimer) {
    publish(0, atomicAdd(counters, kCluster));
  }
  cl.sync();

  long chunk0 = 0;  // W chunks walked before this step, the same in both CTAs
  const long step_chunks = static_cast<long>(n_pan) * n_kc;
  const long ahead = step_chunks < stages ? step_chunks : stages;  // bufs = 1: before the barrier
  auto walks = [&](int b) {  // whether any unit of the step at b has rows to multiply
    bool any = false;
    for (int r = 0; r < kCluster; ++r) any = any || (b >= 0 && un.product(b + r));
    return any;
  };
  long issued = 0;  // the producer: W chunks issued so far
  // the chunks [start + from, start + to) of the step whose chunks start at
  // `start`, those not issued yet
  auto produce = [&](long start, long from, long to) {
    for (long i = issued > start + from ? issued : start + from; i < start + to; ++i, issued = i) {
      const int slot = static_cast<int>(i % stages);
      if (i >= stages) {  // the slot's last chunk released by both CTAs' warpgroups
        mbar_wait(&empty[slot], static_cast<uint32_t>((i / stages - 1) & 1));
      }
      issue_chunk<T>(ring, full, wt, i - start, slot, rank);
    }
  };
  auto multiply = [&](int b, int buf, int obuf) {
    product<T>(ring, full, empty, stages, chunk0, n_pan, n_kc, kpad,
               agg + static_cast<long>(buf) * n_slab * kSlabFloats, s_orow[obuf],
               un.product(b + rank), bias, d_out, out, tid - kProductWarp0 * 32);
  };
  for (int s = 0;; ++s) {
    const int g = s_unit[s % kUnitSlots];  // the step base gathered now
    const int p = lag ? (s > 0 ? s_unit[(s + kUnitSlots - 1) % kUnitSlots] : -1) : g;
    if (p >= un.total) break;
    int nxt = un.total;
    if (claimer && g < un.total) nxt = atomicAdd(counters, kCluster);  // read at the step's end
    const bool walk = walks(p);
    if (warp < kGatherWarps) {
      gather<T, kVec>(un, g + rank, x, diag, rows, idx, ew, segs, n_segs, split_p0, hub, n_hub,
                      seg_counters, partial, d_in, n_slab,
                      agg + static_cast<long>(s % bufs) * n_slab * kSlabFloats, s_orow[s % 2], tid);
    } else if (warp >= kProductWarp0) {
      if (lag && walk) multiply(p, (s + 1) % 2, (s + 1) % 2);
    } else if (tid == producer_warp * 32) {
      // with bufs = 1 only what the ring holds, so the producer never
      // waits on the warpgroup across the barrier below; with bufs = 2 the
      // step's chunks, then the first of the next step's (its product is
      // the unit gathered now): their slots free up within this step
      if (walk) produce(chunk0, 0, lag ? step_chunks : ahead);
      if (lag && walks(g)) produce(chunk0 + (walk ? step_chunks : 0), 0, ahead);
    }
    if (!lag) {
      cl.sync();  // the unit gathered: multiply it
      if (walk) {
        if (warp >= kProductWarp0) multiply(p, 0, s % 2);
        if (tid == producer_warp * 32) produce(chunk0, ahead, step_chunks);
      }
    }
    if (walk) chunk0 += step_chunks;
    if (claimer) {
      publish((s + 1) % kUnitSlots, nxt);
    }
    cl.sync();
  }

  // the last CTA out resets the counters for the next launch: every claim
  // was made before its cluster's last step
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(counters + 1, 1) == static_cast<int>(gridDim.x) - 1)
      counters[0] = counters[1] = 0;
  }
}

// Dynamic shared memory of a launch: 1 KB to align the swizzled W ring,
// `stages` W chunks (two planes in fp32), then `bufs` aggregates of n_slab
// slabs
__host__ __device__ constexpr long smem_bytes(int d_in, int dtype, int bufs, int stages) {
  return 1024L + static_cast<long>(stages) * (dtype == 0 ? 2 : 1) * kPlaneBytes +
         static_cast<long>(bufs) * ((d_in + kSlab - 1) / kSlab) * kSlabFloats * 4;
}

template <typename T, bool kVec>
cudaError_t launch(const void* x, const void* wmat, const float* bias, const float* diag,
                   const int* rows, const int* idx, const float* ew, const int* tiles,
                   int n_tiles, const int* segs, int n_segs, int k_cut, const int* split_p0,
                   const int* hub, int n_hub, int* counters, float* partial, void* out, int d_in,
                   int d_out, void* wt, int bufs, int stages, int smem, cudaStream_t stream) {
  const int n_kc = (d_in + kChunkK<T> - 1) / kChunkK<T>, n_pan = (d_out + kN - 1) / kN;
  const long n_elems = static_cast<long>(n_pan) * n_kc * kChunkBytes<T> / sizeof(T);
  const int pro_blocks = static_cast<int>(std::min<long>((n_elems + 255) / 256, 4096));
  wt_layout<T><<<pro_blocks, 256, 0, stream>>>(static_cast<const T*>(wmat), static_cast<T*>(wt),
                                                d_in, d_out, n_kc, n_elems);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kern = gcn_fused_kernel_wgmma<T, kVec>;
  if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
      cudaSuccess)
    return err;
  int dev = 0, n_sm = 0, clusters = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(n_sm / kCluster * kCluster);
  if ((err = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg)) != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;  // raised by the wrapper, no fallback
  const int units = (n_segs + kGatherWarps - 1) / kGatherWarps +
                    (n_hub + kHubRows - 1) / kHubRows + (n_tiles + 1) / 2;
  cfg.gridDim = dim3(kCluster * std::max(1, std::min((units + kCluster - 1) / kCluster, clusters)));
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(x),
                           static_cast<const uint8_t*>(wt), bias, diag, rows, idx, ew,
                           reinterpret_cast<const int4*>(tiles), n_tiles,
                           reinterpret_cast<const int4*>(segs), n_segs, k_cut, split_p0,
                           reinterpret_cast<const int2*>(hub), n_hub, counters, partial,
                           static_cast<T*>(out), d_in, d_out, bufs, stages);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace wg

template <typename T, int D_IN, int D_OUT>
cudaError_t launch(const void* x, const void* wmat, const float* bias, const float* diag,
                   const int* rows, const int* idx, const float* ew, const int* tiles,
                   int n_tiles, const int* segs, int n_segs, int k_cut, const int* split_p0,
                   int* counters, float* partial, void* out, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * (D_IN * D_OUT + kTileRows * D_IN);
  auto kern = gcn_fused_kernel<T, D_IN, D_OUT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem)) !=
      cudaSuccess)
    return err;
  const int units = (n_segs + kWarps - 1) / kWarps + n_tiles;
  const int grid = std::max(1, std::min(units, n_sm * std::max(per_sm, 1)));
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wmat), bias, diag, rows, idx, ew,
      reinterpret_cast<const int4*>(tiles), n_tiles, reinterpret_cast<const int4*>(segs), n_segs,
      k_cut, split_p0, counters, partial, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d_in, int d_out, const void* x, const void* wmat, const float* bias,
                     const float* diag, const int* rows, const int* idx, const float* ew,
                     const int* tiles, int n_tiles, const int* segs, int n_segs, int k_cut,
                     const int* split_p0, const int* hub, int n_hub, int* counters,
                     float* partial, void* out, cudaStream_t stream) {
  if (d_in == 128 && d_out == 128)
    return launch<T, 128, 128>(x, wmat, bias, diag, rows, idx, ew, tiles, n_tiles, segs, n_segs, k_cut, split_p0, counters, partial, out, stream);
  if (d_in == 128 && d_out == 256)
    return launch<T, 128, 256>(x, wmat, bias, diag, rows, idx, ew, tiles, n_tiles, segs, n_segs, k_cut, split_p0, counters, partial, out, stream);
  if (d_in == 256 && d_out == 128)
    return launch<T, 256, 128>(x, wmat, bias, diag, rows, idx, ew, tiles, n_tiles, segs, n_segs, k_cut, split_p0, counters, partial, out, stream);
  if (d_in == 256 && d_out == 256)
    return wide::launch<T>(x, wmat, bias, diag, rows, idx, ew, tiles, n_tiles, segs, n_segs, k_cut, split_p0, hub, n_hub, counters, partial, out, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  bias and diag may be null.  tiles is
// the (n_tiles, 4) table of kernels/spmm_ell.py::fused_plan; segs the
// (n_segs, 8) items of segment_plan that cover the rows of K > k_cut (their
// tiles are skipped), split_p0 (n_split + 1) each cut row's first partial;
// hub the (n_hub, 2) (cut row, natural row) pairs whose segments are all in
// segs (read at d_in = d_out = 256 only).  counters is (2 + n_split,) int
// scratch, zero on entry and left zero on exit, and partial
// (split_p0[n_split], d_in) float32 scratch.  One kernel launch; returns its
// cudaError_t (0 on success), and the work itself runs asynchronously on
// `stream`.
extern "C" int gcn_fused_forward(const void* x, const void* wmat, const float* bias,
                                 const float* diag, const int* rows, const int* idx,
                                 const float* ew, const int* tiles, int n_tiles, const int* segs,
                                 int n_segs, int k_cut, const int* split_p0, const int* hub,
                                 int n_hub, int* counters, float* partial, void* out, int d_in,
                                 int d_out, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles + n_segs <= 0) return cudaSuccess;
  if (dtype == 0)
    return dispatch<float>(d_in, d_out, x, wmat, bias, diag, rows, idx, ew, tiles, n_tiles, segs,
                           n_segs, k_cut, split_p0, hub, n_hub, counters, partial, out, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(d_in, d_out, x, wmat, bias, diag, rows, idx, ew, tiles,
                                   n_tiles, segs, n_segs, k_cut, split_p0, hub, n_hub, counters,
                                   partial, out, s);
  return cudaErrorInvalidValue;
}

// Any (d_in, d_out) ≥ 1 on gcn_fused_kernel_any, by the host plan of
// kernels/gcn_fused.py::kernel_plan: ka the aggregate's columns held at
// once (a multiple of 128), nt the n-tiles of a warp (output panels of
// 64·nt columns), w_res whether Wᵀ is staged whole, smem the block's
// dynamic shared memory (at least what those need).  The other arguments
// are gcn_fused_forward's; hub is read at every width, counters is
// (2 + n_split,) and partial (split_p0[n_split], ceil(d_in / 128)·128)
// float32.  One kernel launch; returns its cudaError_t.
extern "C" int gcn_fused_any_forward(const void* x, const void* wmat, const float* bias,
                                     const float* diag, const int* rows, const int* idx,
                                     const float* ew, const int* tiles, int n_tiles,
                                     const int* segs, int n_segs, int k_cut, const int* split_p0,
                                     const int* hub, int n_hub, int* counters, float* partial,
                                     void* out, int d_in, int d_out, int dtype, int ka, int nt,
                                     int w_res, int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles + n_segs <= 0) return cudaSuccess;
  if (d_in < 1 || d_out < 1 || ka < any::kPanel || ka % any::kPanel || (nt != 1 && nt != 2) ||
      smem < any::smem_bytes(d_in, d_out, ka, nt, w_res))
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return any::dispatch<float>(nt, d_in, x, wmat, bias, diag, rows, idx, ew, tiles, n_tiles,
                                segs, n_segs, k_cut, split_p0, hub, n_hub, counters, partial, out,
                                d_out, ka, w_res, smem, s);
  if (dtype == 1)
    return any::dispatch<__nv_bfloat16>(nt, d_in, x, wmat, bias, diag, rows, idx, ew, tiles,
                                        n_tiles, segs, n_segs, k_cut, split_p0, hub, n_hub,
                                        counters, partial, out, d_out, ka, w_res, smem, s);
  return cudaErrorInvalidValue;
}

// Any (d_in, d_out) with d_in ≤ 768 on gcn_fused_kernel_wgmma, by the host
// plan of kernels/gcn_fused.py::kernel_plan: bufs the aggregate buffers (2:
// the gather a step ahead of the product), stages the W ring's slots, smem
// the block's dynamic shared memory (at least wg::smem_bytes).  wt is the
// prologue's scratch, ceil(d_out / 64)·ceil(d_in / (128 / element size))
// chunks of 16 KB (fp32: two planes) or 8 KB (bf16), 16-byte aligned; the other arguments are
// gcn_fused_any_forward's.  Two launches (the W prologue, then the layer);
// returns the first cudaError_t.
extern "C" int gcn_fused_wgmma_forward(const void* x, const void* wmat, const float* bias,
                                       const float* diag, const int* rows, const int* idx,
                                       const float* ew, const int* tiles, int n_tiles,
                                       const int* segs, int n_segs, int k_cut,
                                       const int* split_p0, const int* hub, int n_hub,
                                       int* counters, float* partial, void* out, int d_in,
                                       int d_out, int dtype, void* wt, int bufs, int stages,
                                       int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles + n_segs <= 0) return cudaSuccess;
  if (d_in < 1 || d_out < 1 || (bufs != 1 && bufs != 2) || stages < 2 ||
      stages > wg::kMaxStages || smem < wg::smem_bytes(d_in, dtype, bufs, stages) ||
      reinterpret_cast<uintptr_t>(wt) % 16)
    return cudaErrorInvalidValue;
  const bool vec = d_in % 4 == 0;
#define GCN_WG_LAUNCH(T, VEC)                                                                  \
  wg::launch<T, VEC>(x, wmat, bias, diag, rows, idx, ew, tiles, n_tiles, segs, n_segs, k_cut, \
                     split_p0, hub, n_hub, counters, partial, out, d_in, d_out, wt, bufs,     \
                     stages, smem, s)
  if (dtype == 0) return vec ? GCN_WG_LAUNCH(float, true) : GCN_WG_LAUNCH(float, false);
  if (dtype == 1)
    return vec ? GCN_WG_LAUNCH(__nv_bfloat16, true) : GCN_WG_LAUNCH(__nv_bfloat16, false);
#undef GCN_WG_LAUNCH
  return cudaErrorInvalidValue;
}

// The launch's clusters on this card at `smem` (cudaOccupancyMaxActiveClusters).
// Returns the clusters, or minus a cudaError_t.
extern "C" int gcn_fused_wgmma_probe(int dtype, int smem) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = wg::kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(wg::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int dev = 0, n_sm = 0, clusters = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cfg.gridDim = dim3(n_sm / wg::kCluster * wg::kCluster);
  auto f32 = wg::gcn_fused_kernel_wgmma<float, true>;
  auto b16 = wg::gcn_fused_kernel_wgmma<__nv_bfloat16, true>;
  if (err == cudaSuccess)
    err = dtype == 0 ? cudaFuncSetAttribute(f32, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
                     : cudaFuncSetAttribute(b16, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = dtype == 0 ? cudaOccupancyMaxActiveClusters(&clusters, f32, &cfg)
                     : cudaOccupancyMaxActiveClusters(&clusters, b16, &cfg);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}
