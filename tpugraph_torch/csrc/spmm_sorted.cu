// Sorted-segment SpMM for Hopper (sm_90a): out[i] = Σ_{e: dst[e]=i} w[e]·x[src[e]]
// over a (dst, src)-sorted padded edge list, x float32 or bfloat16, any
// d ≥ 1 (instances at 64, 128 and 256, 64 a tensor-parallel rank's
// half of a 128-wide layer; 128-column panels of the row over the grid's
// second axis at every other d, ell_gather.cuh's PanelCols), fp32
// accumulation and one rounding to x's type at the end.
//
// Replaces the XLA ops of tpugraph/kernels/spmm.py::_segment_spmm (a gather,
// a multiply and a sorted segment_sum); no Pallas kernel exists for it.
// The layers of spmm_impl "sorted" run it twice per layer and step: forward
// over op.fwd, backward over op.bwd (the same edges sorted for Aᵀ).
//
// What bounds it on an H100: bytes.  It must read x and the real edges'
// (src, dst, w), and write out (≈ 44 MB for the zh-en adjacency at d = 128
// in fp32, ≈ 13 µs at 3.35 TB/s); its arithmetic, 2 operations per edge
// and column, is ≈ 1 µs of fp32.  What a kernel actually pays is the
// gather: every edge reads one full row of x, which the 50 MB L2 mostly
// serves, so the time is set by the row loads in flight and by the longest
// chain of dependent loads.
//
// Design: a warp-sized work item per run of rows or row segment, from the
// host's work table (kernels/spmm.py::segment_plan, built once per edge
// list, heaviest first), as spmm_ell.cu does for the ELL layout:
//
//   * the edges are dst-sorted, so a run of consecutive whole rows is one
//     contiguous edge range; short rows are packed, several to an item, up
//     to PACK_SLOTS = 32 slots (a row costs its edges plus one for its
//     write), so most items are one chunk of 32 edges;
//   * a row of more than SEG_EDGES = 96 edges is cut into balanced segments
//     of at most 96, each an item of its own, so a hub row (3,735 edges in
//     the zh-en adjacency) is spread over 39 warps on any SMs instead of
//     being one warp's serial chain;
//   * a warp loads the (src, w, dst) of 32 edges, one per lane, broadcasts
//     them by shuffles and loads the next 32 before this chunk's gathers;
//     8 source rows (4 at d = 256) are in flight, each one coalesced
//     16-byte (fp32) or 8-byte (bf16) load per lane.  This walk is
//     ell::walk_slots (ell_gather.cuh), keyed by each edge's dst;
//   * a segment writes its partial row to fp32 scratch; the last segment of
//     a row to finish (a per-row counter) sums the row's partials in segment
//     order and writes the row, so the result is bit-identical from run to
//     run;
//   * every output row is written exactly once, the dump row (the
//     padding's) never: no atomics on out, no zero fill.  A packed item
//     writes each of its rows, those with no edge as 0;
//   * at a width without an instance each item runs once per 128-column
//     panel, as spmm_ell.cu's panels do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ell_gather.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// Cols: ell::FixedCols<D> at a width with an instance, else ell::PanelCols<d % 4 == 0>
// (one 128-column panel of the row per block row of the grid)
template <typename T, typename Cols>
__global__ void __launch_bounds__(kThreads)
spmm_sorted_kernel(const T* __restrict__ x, const int* __restrict__ src,
                   const float* __restrict__ ew, const int* __restrict__ dst,
                   const int4* __restrict__ items, int n_items, const int* __restrict__ split_p0,
                   int* __restrict__ counters, float* __restrict__ partial, T* __restrict__ out,
                   int d) {
  constexpr int CI = Cols::kCI;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= n_items) return;
  const Cols cols = Cols::at(d, lane);
  // (rows [r0, r1), edges [e0, e1)), (partial index or -1, cut-row index or -1)
  const int4 a = __ldg(items + 2 * item), b = __ldg(items + 2 * item + 1);
  const int r1 = a.y, e0 = a.z, e1 = a.w, part = b.x, split = b.y;

  const float zero[CI][4] = {};
  int next = a.x;  // the item's first row not yet written
  auto put = [&](int row, const float (&v)[CI][4]) {  // rows next..row-1 have no edge
    for (; next < row; ++next) cols.put(out, next, zero);
    cols.put(out, row, v);
    next = row + 1;
  };
  float acc[CI][4] = {};
  int cur;  // the row acc belongs to
  ell::walk_cols<CI, Cols::kV, Cols::kU>(
      [&](int s, int c, float (&v)[4]) { cols.load(x, s, c, v); }, e0, e1, lane, acc, cur,
      [&](int e, int& s, float& w, int& key) {
        s = -1;
        w = 0.f;
        key = -1;
        if (e < e1) {
          s = __ldg(src + e);
          w = __ldg(ew + e);
          key = __ldg(dst + e);
        }
      },
      put, cols.lane_ok());
  if (part < 0) {
    if (cur >= 0) put(cur, acc);
    while (next < r1) put(next, zero);
    return;
  }

  // one segment of a long row: publish the partial; the row's last segment
  // to arrive sums all of them in segment order
  float sum[CI][4];
  if (cols.sum_segments(partial, part, __ldg(split_p0 + split), __ldg(split_p0 + split + 1),
                        counters, split, acc, sum))
    cols.put(out, a.x, sum);
}

template <typename T, typename Cols>
cudaError_t launch(const void* x, const int* src, const float* ew, const int* dst,
                   const int* items, int n_items, const int* split_p0, int* counters,
                   float* partial, void* out, int d, int n_panels, cudaStream_t stream) {
  const dim3 grid((n_items + kWarps - 1) / kWarps, n_panels);
  spmm_sorted_kernel<T, Cols><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), src, ew, dst, reinterpret_cast<const int4*>(items), n_items,
      split_p0, counters, partial, static_cast<T*>(out), d);
  return cudaGetLastError();
}

}  // namespace

// out (n_rows, d) of x's type = the sorted-segment product.  items is the
// (n_items, 8) int32 work table (kernels/spmm.py::segment_plan); split_p0
// (n_split + 1) the first partial of each cut row; counters (n_split·P) int
// scratch, zero on entry and left zero on exit; partial (split_p0[n_split],
// W) float32 scratch, with (W, P) = (d, 1) at an instance's width (64, 128,
// 256), else (128·P, ceil(d / 128)).  d is any width ≥ 1; dtype 0
// is float32, 1 bfloat16.  One kernel launch; returns its cudaError_t (0 on
// success), and the work itself runs asynchronously on `stream`.
extern "C" int spmm_sorted_forward(const void* x, const int* src, const float* ew,
                                   const int* dst, const int* items, int n_items,
                                   const int* split_p0, int* counters, float* partial,
                                   void* out, int d, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_items <= 0) return cudaSuccess;
  if (d < 1 || dtype < 0 || dtype > 1) return cudaErrorInvalidValue;
#define SPMM_SORTED_LAUNCH(T, COLS, P) \
  launch<T, COLS>(x, src, ew, dst, items, n_items, split_p0, counters, partial, out, d, P, s)
  if (dtype == 0 && d == 64) return SPMM_SORTED_LAUNCH(float, ell::FixedCols<64>, 1);
  if (dtype == 0 && d == 128) return SPMM_SORTED_LAUNCH(float, ell::FixedCols<128>, 1);
  if (dtype == 0 && d == 256) return SPMM_SORTED_LAUNCH(float, ell::FixedCols<256>, 1);
  if (dtype == 1 && d == 64) return SPMM_SORTED_LAUNCH(__nv_bfloat16, ell::FixedCols<64>, 1);
  if (dtype == 1 && d == 128) return SPMM_SORTED_LAUNCH(__nv_bfloat16, ell::FixedCols<128>, 1);
  if (dtype == 1 && d == 256) return SPMM_SORTED_LAUNCH(__nv_bfloat16, ell::FixedCols<256>, 1);
  const int panels = (d + 127) / 128;
  if (d % 4 == 0)
    return dtype == 0 ? SPMM_SORTED_LAUNCH(float, ell::PanelCols<true>, panels)
                      : SPMM_SORTED_LAUNCH(__nv_bfloat16, ell::PanelCols<true>, panels);
  return dtype == 0 ? SPMM_SORTED_LAUNCH(float, ell::PanelCols<false>, panels)
                    : SPMM_SORTED_LAUNCH(__nv_bfloat16, ell::PanelCols<false>, panels);
#undef SPMM_SORTED_LAUNCH
}
