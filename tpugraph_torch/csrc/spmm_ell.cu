// ELL SpMM for Hopper (sm_90a): out = A·x + diag ⊙ x over a degree-bucketed
// ELL matrix, written straight to natural row order.  x and out are fp32,
// or both bf16 (bf16 training): the products and sums are fp32 either way,
// the cut rows' partials too, and a bf16 row is rounded once, at the end.
// Any width d ≥ 1: instances at 64, 128 and 256, and 128-column
// panels of the row over the grid's second axis at every other d (the
// GCN layer's forward at widths without a fused instance, and its
// backward, run here; ell_gather.cuh's FixedCols and PanelCols).
//
// Replaces the XLA ops of tpugraph/kernels/spmm_ell.py::_ell_apply and
// _apply_with_diag (the bucket gathers + K reduction + row_order gather).
// The training path runs it once per GCN layer in the backward, on the
// prebuilt transpose A^T (op.bwd), to form u = A^T·ḡ, in the cotangent's
// type (fp32, or bf16 under param_dtype="bfloat16").
//
// What bounds it on an H100: the bytes it must move are x, out, diag and
// the ELL arrays (~42 MB for the zh-en transpose at d = 128, ~12 µs at
// 3.35 TB/s); its arithmetic, 2 operations per edge and column, is ~1 µs
// of fp32.  So it is bytes-bound, and what a kernel actually pays is the
// gather: every ELL slot reads one full row of x (512 B at d = 128, ~157 MB
// for the zh-en transpose), which the 50 MB L2 mostly serves because x
// (19.5 MB) fits in it.  What sets the time is how many of those row loads
// are in flight, and how long the longest chain of dependent loads is.
//
// Design: a warp-sized work item per row run or row segment, from the host's
// segment table (kernels/spmm_ell.py::segment_plan, heaviest first):
//
//   * every row is a list of "virtual slots": its K ELL slots, then one for
//     the split-out diagonal (source = the row itself, weight diag[row]);
//   * short rows are packed, several rows per item, up to 64 virtual slots;
//     a row whose K exceeds the segment cap (128) is cut into segments of at
//     most cap slots, each an item of its own, so a 3,734-slot hub row is
//     spread over 30 warps on any SMs instead of the 8 warps of one block;
//   * a warp loads the (source, weight, row) of 32 virtual slots, one per
//     lane, and broadcasts them by shuffles; the next 32 are loaded before
//     this chunk's gathers start, so that load is off the critical path;
//     8 source rows (4 at d = 256) are in flight per warp: at 79 registers
//     that leaves room for more warps per SM, which measured faster on the
//     H100 than 16 rows per warp at 127 registers.  This walk is
//     ell::walk_vslots (ell_gather.cuh), shared with gcn_fused.cu;
//   * a segment writes its partial row to fp32 scratch; the last segment of
//     a row to finish (a per-row counter) sums the row's partials in segment
//     order and writes the row, so the result does not depend on which
//     segment finished last and is bit-identical from run to run;
//   * every output row is written exactly once: no atomics on out, no zero
//     fill, no row_order gather.  Rows in no bucket are items of diagonal
//     slots only (0 without a diagonal);
//   * at a width without an instance each item runs once per 128-column
//     panel (blockIdx.y), the tail panel masked at d, 8 source rows in
//     flight; a cut row's partials are then rows of 128·panels (aligned for
//     any d), with one counter per cut row and panel.  A panel's columns
//     are summed in the same slot order as an instance's, so the sums per
//     element are the instance's arithmetic.

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
spmm_ell_kernel(const T* __restrict__ x, const float* __restrict__ diag,
                const int* __restrict__ rows, const int* __restrict__ idx,
                const float* __restrict__ ew, const int4* __restrict__ items, int n_items,
                const int* __restrict__ split_p0, int* __restrict__ counters,
                float* __restrict__ partial, T* __restrict__ out, int d) {
  constexpr int CI = Cols::kCI;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= n_items) return;
  const Cols cols = Cols::at(d, lane);
  // (first row's position in rows, rows, K, first slot), (virtual slots
  // [v0, v1), partial index or -1, split-row index or -1)
  const int4 a = __ldg(items + 2 * item), b = __ldg(items + 2 * item + 1);
  const int pos0 = a.x, k_row = a.z;
  const long slot0 = a.w;
  const int v0 = b.x, v1 = b.y, part = b.z, split = b.w;

  float acc[CI][4] = {};
  int cur;  // the row acc belongs to
  ell::walk_cols<CI, Cols::kV, Cols::kU>(
      [&](int src, int c, float (&v)[4]) { cols.load(x, src, c, v); }, v0, v1, lane, acc, cur,
      [&](int v, int& src, float& w, int& key) {
        ell::load_vslot<true>(v, v1, pos0, k_row, slot0, rows, idx, ew, diag, src, w, key);
      },
      [&](int row, const float (&a)[CI][4]) {  // a packed item moves on to its next row
        cols.put(out, row, a);
      },
      cols.lane_ok());
  if (part < 0) {
    cols.put(out, cur, acc);
    return;
  }

  // one segment of a long row: publish the partial; the row's last segment
  // to arrive sums all of them in segment order
  float sum[CI][4];
  if (cols.sum_segments(partial, part, __ldg(split_p0 + split), __ldg(split_p0 + split + 1),
                        counters, split, acc, sum))
    cols.put(out, cur, sum);
}

template <typename T, typename Cols>
cudaError_t launch(const void* x, const float* diag, const int* rows, const int* idx,
                   const float* ew, const int* items, int n_items, const int* split_p0,
                   int* counters, float* partial, void* out, int d, int n_panels,
                   cudaStream_t stream) {
  const dim3 grid((n_items + kWarps - 1) / kWarps, n_panels);
  spmm_ell_kernel<T, Cols><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), diag, rows, idx, ew, reinterpret_cast<const int4*>(items),
      n_items, split_p0, counters, partial, static_cast<T*>(out), d);
  return cudaGetLastError();
}

}  // namespace

// out (n_rows, d) of x's type = A·x + diag ⊙ x.  diag may be null.  d is
// any width ≥ 1: 64 (a tensor-parallel rank's half of a 128-wide
// layer), 128 and 256 have instances, any other d runs in 128-column
// panels; dtype 0 is float32, 1 bfloat16.  items is the (n_items, 8) int32
// segment table; split_p0 (n_split + 1) the first partial of each cut row;
// counters (n_split·P) int scratch, zero on entry and left zero on exit,
// and partial (split_p0[n_split], W) float32 scratch, with (W, P) = (d, 1)
// at an instance's width, else (128·P, ceil(d / 128)).  One kernel launch;
// returns its cudaError_t (0 on success), and the work itself runs
// asynchronously on `stream`.
extern "C" int spmm_ell_forward(const void* x, const float* diag, const int* rows,
                                const int* idx, const float* ew, const int* items, int n_items,
                                const int* split_p0, int* counters, float* partial, void* out,
                                int d, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_items <= 0) return cudaSuccess;
  if (d < 1 || dtype < 0 || dtype > 1) return cudaErrorInvalidValue;
#define SPMM_ELL_LAUNCH(T, COLS, P) \
  launch<T, COLS>(x, diag, rows, idx, ew, items, n_items, split_p0, counters, partial, out, d, P, s)
  if (dtype == 0 && d == 64) return SPMM_ELL_LAUNCH(float, ell::FixedCols<64>, 1);
  if (dtype == 0 && d == 128) return SPMM_ELL_LAUNCH(float, ell::FixedCols<128>, 1);
  if (dtype == 0 && d == 256) return SPMM_ELL_LAUNCH(float, ell::FixedCols<256>, 1);
  if (dtype == 1 && d == 64) return SPMM_ELL_LAUNCH(__nv_bfloat16, ell::FixedCols<64>, 1);
  if (dtype == 1 && d == 128) return SPMM_ELL_LAUNCH(__nv_bfloat16, ell::FixedCols<128>, 1);
  if (dtype == 1 && d == 256) return SPMM_ELL_LAUNCH(__nv_bfloat16, ell::FixedCols<256>, 1);
  const int panels = (d + 127) / 128;
  if (d % 4 == 0)
    return dtype == 0 ? SPMM_ELL_LAUNCH(float, ell::PanelCols<true>, panels)
                      : SPMM_ELL_LAUNCH(__nv_bfloat16, ell::PanelCols<true>, panels);
  return dtype == 0 ? SPMM_ELL_LAUNCH(float, ell::PanelCols<false>, panels)
                    : SPMM_ELL_LAUNCH(__nv_bfloat16, ell::PanelCols<false>, panels);
#undef SPMM_ELL_LAUNCH
}
