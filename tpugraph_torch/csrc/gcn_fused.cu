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
//   * At d_in = d_out = 256 the staged Wᵀ (256 KB in fp32) and the
//     aggregate (32 KB) do not fit in a block's 227 KB, so each block owns
//     one 128-column panel of W for its whole life (NP = 2 panels, 128 KB
//     staged once, 160 KB in all): block b takes panel b % 2, and each
//     panel's blocks walk the whole work table from the panel's own
//     counter, writing only its columns.  A tile's gather (and a hub row's
//     segments, whose partials and row counters are kept per panel) is
//     thus done twice; x (38,000 × 1 KB at zh-en scale) fits in the 50 MB
//     L2, so the second gather mostly reads L2.
//
// bf16 x/W gather in bf16, accumulate in fp32 and cast once at the end, as
// the TPU kernel does.  The gather and the product of one block do not
// overlap (two blocks per SM at d_in = d_out = 128 overlap each other's).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "ell_gather.cuh"
#include "tf32_mma.cuh"

namespace {

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
template <typename T, int D_IN, int D_OUT, int NP>
__device__ __forceinline__ void hub_segment(const T* __restrict__ x, const float* w_s,
                                            const float* __restrict__ bias,
                                            const float* __restrict__ diag,
                                            const int* __restrict__ rows,
                                            const int* __restrict__ idx,
                                            const float* __restrict__ ew, int4 a, int4 b,
                                            const int* __restrict__ split_p0,
                                            int* __restrict__ seg_counters,
                                            float* __restrict__ partial, int panel, int lane,
                                            T* __restrict__ out) {
  constexpr int CI = D_IN / 128;
  constexpr int DP = D_OUT / NP;
  const int part = b.z, split = b.w;
  float acc[CI][4] = {};
  int row;  // a segment covers one row: the walk never moves on
  ell::walk_vslots<T, D_IN, true>(x, diag, rows, idx, ew, a.x, a.z, a.w, b.x, b.y, lane, acc,
                                  row, [](int, const float (&)[CI][4]) {});
  ell::put_row<D_IN>(partial + (static_cast<long>(part) * NP + panel) * D_IN, lane, acc);
  __threadfence();
  __syncwarp();
  const int p0 = __ldg(split_p0 + split), p1 = __ldg(split_p0 + split + 1);
  int* counter = seg_counters + split * NP + panel;
  int last = 0;
  if (lane == 0) last = atomicAdd(counter, 1) == p1 - p0 - 1;
  if (!__shfl_sync(ell::kFull, last, 0)) return;
  if (lane == 0) *counter = 0;  // every segment has counted: ready for the next launch
  __threadfence();
  float sum[CI][4] = {};
  for (int p = p0; p < p1; ++p)
#pragma unroll
    for (int c = 0; c < CI; ++c) {
      const float4 t = __ldcg(reinterpret_cast<const float4*>(
                                  partial + (static_cast<long>(p) * NP + panel) * D_IN + c * 128) +
                              lane);
      sum[c][0] += t.x;
      sum[c][1] += t.y;
      sum[c][2] += t.z;
      sum[c][3] += t.w;
    }
  row_product<T, D_IN, DP>(w_s, sum, bias ? bias + panel * DP : nullptr, lane,
                          out + static_cast<long>(row) * D_OUT + panel * DP);
}

template <typename T, int D_IN, int D_OUT, int NP>
__global__ void __launch_bounds__(kThreads, D_IN * (D_OUT / NP) <= 128 * 128 ? 2 : 1)
gcn_fused_kernel(const T* __restrict__ x, const T* __restrict__ wmat,
                 const float* __restrict__ bias, const float* __restrict__ diag,
                 const int* __restrict__ rows, const int* __restrict__ idx,
                 const float* __restrict__ ew, const int4* __restrict__ tiles,
                 int n_tiles, const int4* __restrict__ segs, int n_segs, int k_cut,
                 const int* __restrict__ split_p0, int* __restrict__ counters,
                 float* __restrict__ partial, T* __restrict__ out) {
  constexpr int CI = D_IN / 128;
  constexpr int DP = D_OUT / NP;    // the block's panel of output columns
  constexpr int NW = DP / kWarps;   // output columns per warp
  constexpr int NT = NW / 8;        // their mma n-tiles
  constexpr bool kWExact = sizeof(T) == 2;  // a bf16 W is exact in TF32
  // mma.sync adds into its fp32 accumulator less exactly than an fp32 add
  // (probed on the H100: 10× the error of summing each group outside), so
  // each group of 16 k's is summed outside in fp32; the bf16 (128, 128)
  // instance alone keeps its sum inside.
  constexpr bool kSumOutside = sizeof(T) == 4 || D_IN * DP > 128 * 128;
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // the panel of Wᵀ [DP][D_IN], swizzled
  float* a_s = w_s + DP * D_IN;                  // [kTileRows][D_IN], swizzled
  __shared__ int s_tile;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // mma fragment coordinates
  const int panel = NP > 1 ? static_cast<int>(blockIdx.x) % NP : 0;
  const int c0 = panel * DP;  // the panel's first column of out
  const int n0 = warp * NW;   // the warp's first column within the panel

  // the panel of Wᵀ into shared memory: each group of 32 threads moves 8
  // columns × 16 k, so the global reads take whole sectors and the shared
  // writes no conflicts
  for (int i = tid; i < DP * D_IN / 4; i += kThreads) {
    const int grp = i >> 5, l = i & 31;
    const int n = (grp % (DP / 8)) * 8 + (l >> 2), f = (grp / (DP / 8)) * 4 + (l & 3);
    const T* src = wmat + static_cast<long>(f * 4) * D_OUT + c0 + n;
    *reinterpret_cast<float4*>(swz<D_IN>(w_s, n, f)) =
        make_float4(to_f32(src[0]), to_f32(src[D_OUT]), to_f32(src[2 * D_OUT]),
                    to_f32(src[3 * D_OUT]));
  }
  float bv[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      bv[nt][e] = bias ? __ldg(bias + c0 + n0 + nt * 8 + 2 * tq + e) : 0.f;

  // work units: groups of kWarps cut-row segments (one per warp), then the
  // tiles; a tile of K > k_cut holds rows the segments cover and is skipped.
  // Each panel's blocks take every unit from the panel's own counter.
  const int n_groups = (n_segs + kWarps - 1) / kWarps;
  while (true) {
    if (tid == 0) s_tile = atomicAdd(counters + panel, 1);
    __syncthreads();  // publishes s_tile; W staged; the last tile's a_s reads done
    const int u = s_tile;
    if (u >= n_groups + n_tiles) break;
    if (u < n_groups) {
      const int item = u * kWarps + warp;
      if (item < n_segs)
        hub_segment<T, D_IN, D_OUT, NP>(x, w_s, bias, diag, rows, idx, ew,
                                        __ldg(segs + 2 * item), __ldg(segs + 2 * item + 1),
                                        split_p0, counters + NP + 1, partial, panel, lane, out);
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
          store2(out + orow * D_OUT + c0 + n0 + nt * 8 + 2 * tq, c[mt][nt][2 * h] + bv[nt][0],
                 c[mt][nt][2 * h + 1] + bv[nt][1]);
      }
  }

  // the last block out resets the counters for the next launch: every
  // block has taken its last tile number by the time it counts itself done
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(counters + NP, 1) == static_cast<int>(gridDim.x) - 1)
      for (int p = 0; p <= NP; ++p) counters[p] = 0;
  }
}

template <typename T, int D_IN, int D_OUT, int NP = 1>
cudaError_t launch(const void* x, const void* wmat, const float* bias, const float* diag,
                   const int* rows, const int* idx, const float* ew, const int* tiles,
                   int n_tiles, const int* segs, int n_segs, int k_cut, const int* split_p0,
                   int* counters, float* partial, void* out, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * (D_IN * (D_OUT / NP) + kTileRows * D_IN);
  auto kern = gcn_fused_kernel<T, D_IN, D_OUT, NP>;
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
  // every panel gets the same number of blocks, at least one
  const int units = (n_segs + kWarps - 1) / kWarps + n_tiles;
  const int grid = NP * std::max(1, std::min(units, n_sm * std::max(per_sm, 1) / NP));
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
                     const int* split_p0, int* counters, float* partial, void* out,
                     cudaStream_t stream) {
  if (d_in == 128 && d_out == 128)
    return launch<T, 128, 128>(x, wmat, bias, diag, rows, idx, ew, tiles, n_tiles, segs, n_segs, k_cut, split_p0, counters, partial, out, stream);
  if (d_in == 128 && d_out == 256)
    return launch<T, 128, 256>(x, wmat, bias, diag, rows, idx, ew, tiles, n_tiles, segs, n_segs, k_cut, split_p0, counters, partial, out, stream);
  if (d_in == 256 && d_out == 128)
    return launch<T, 256, 128>(x, wmat, bias, diag, rows, idx, ew, tiles, n_tiles, segs, n_segs, k_cut, split_p0, counters, partial, out, stream);
  if (d_in == 256 && d_out == 256)  // two panels of 128 columns (kernels/gcn_fused.py::PANELS)
    return launch<T, 256, 256, 2>(x, wmat, bias, diag, rows, idx, ew, tiles, n_tiles, segs, n_segs, k_cut, split_p0, counters, partial, out, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  bias and diag may be null.  tiles is
// the (n_tiles, 4) table of kernels/spmm_ell.py::fused_plan; segs the
// (n_segs, 8) items of segment_plan that cover the rows of K > k_cut (their
// tiles are skipped), split_p0 (n_split + 1) each cut row's first partial.
// With NP panels (1, or 2 at d_in = d_out = 256), counters is
// (NP + 1 + NP·n_split,) int scratch, zero on entry and left zero on exit,
// and partial (split_p0[n_split]·NP, d_in) float32 scratch.  One kernel
// launch; returns its cudaError_t (0 on success), and the work itself runs
// asynchronously on `stream`.
extern "C" int gcn_fused_forward(const void* x, const void* wmat, const float* bias,
                                 const float* diag, const int* rows, const int* idx,
                                 const float* ew, const int* tiles, int n_tiles, const int* segs,
                                 int n_segs, int k_cut, const int* split_p0, int* counters,
                                 float* partial, void* out, int d_in, int d_out, int dtype,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles + n_segs <= 0) return cudaSuccess;
  if (dtype == 0)
    return dispatch<float>(d_in, d_out, x, wmat, bias, diag, rows, idx, ew, tiles, n_tiles, segs,
                           n_segs, k_cut, split_p0, counters, partial, out, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(d_in, d_out, x, wmat, bias, diag, rows, idx, ew, tiles,
                                   n_tiles, segs, n_segs, k_cut, split_p0, counters, partial,
                                   out, s);
  return cudaErrorInvalidValue;
}
