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
