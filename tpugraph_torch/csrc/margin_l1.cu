// The L1 margin ranking loss for Hopper (sm_90a), forward and a fixed-order
// backward, over an entity table emb (N, d) fp32, pairs (S, 2) and k
// negatives a side (S, k), int64:
//
//     d⁺_i = |e_l − e_r|₁,  h^r_ij = ReLU(d⁺_i + γ − |e_l − emb[neg_r_ij]|₁),
//                           h^l_ij = ReLU(d⁺_i + γ − |emb[neg_l_ij] − e_r|₁),
//     L = 0.5·Σ_i w_i Σ_j (h^r_ij + h^l_ij) / D,  D = S·k (no weights) or
//                                                 max(Σ w, 1e-9)·k.
//
// It replaces no TPU kernel.  It replaces the XLA ops of
// tpugraph/train/losses.py::margin_align_loss (two (S, k, d) gathers, |a − b|
// and the sums) and of its autodiff (the scatter of the signs into the
// table), which the port ran as a torch composite with an index_put backward.
//
// What bounds it on an H100: bytes.  The forward reads 2·S·k negative rows
// (3.58 GB at v7r on dwy100k_dist: S 17,500, k 100, d 256, ≈ 1.07 ms at
// 3.35 TB/s; the 205 MB table does not fit the 50 MB L2, zh-en's 38.9 MB
// mostly does) and does 3 operations an element.  The backward reads the
// same rows again and writes the table's gradient once.
//
// Design:
//
//   * forward: one warp a pair row.  The two pair rows stay in registers,
//     each negative row is read once (d/32 elements a lane, float4 where d is
//     a multiple of 128), |a − b| is summed a lane in element order, then
//     across the warp by a butterfly: a distance depends only on its two
//     rows, so a negative that is the positive partner (the pool-of-one
//     fill) reads d⁻ = d⁺ bit for bit.  The hinge stays in registers; what
//     is kept is one byte an entry (bit 0 the right side's hinge, bit 1 the
//     left's, set where the hinge's argument is ≥ 0, as torch's clamp_min
//     passes the gradient, and cleared for a negative that is the pair's own
//     partner: there h = γ whatever the rows, so the entry has no gradient)
//     and one partial sum a row.  A second launch of one block sums the
//     row partials (and the weights) in a fixed order, with no atomics.
//   * backward: one warp a table row r.  Its contributions are listed, in
//     record order, by an index the wrapper builds on the device (a stable
//     sort of the rows every record touches: S pair-left, S pair-right,
//     S·k right-side and S·k left-side negative records).  A negative
//     record adds c_i·sign(e_pair − x_r); a pair record adds
//     c_i·(A_i·sign(x_r − other) − Σ_j sign(x_r − emb[neg_own_ij])), with
//     A_i the row's active entries and the sum over its own side's active
//     ones, exact small integers in fp32 before the one product with
//     c_i = ḡ·0.5/D·w_i.  A row's records are cut, in order, into items
//     of 32 (kSeg), one warp an item, so a hub row that thousands of
//     records reach (hard negatives crowd on hubs) spreads over many warps:
//     one warp a row took 24 ms at v7r on dwy100k_dist.  An item sums its
//     records in order; a row of one item is written by it, a longer row's
//     items leave partials that a second launch adds in item order.  Every
//     row of the table is written once (0 where nothing reaches it), so
//     two calls are equal bit for bit.  A lane holds one record's metadata
//     and the warp keeps 8 rows in flight (4 at d = 256, 2 at 512).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSumThreads = 1024;
constexpr int kSeg = 32;  // records an item of the backward: a longer row spans items
constexpr unsigned kFull = 0xffffffffu;

// A row of width D as a lane's share: D/32 floats a lane; float4 loads when
// D is a multiple of 128 (element (c·32 + lane)·4 + t), else scalar loads
// (element t·32 + lane; lanes past D read nothing).
template <int D>
struct Row {
  static constexpr int kPer = D >= 32 ? D / 32 : 1;
  static constexpr bool kVec = D % 128 == 0;
  // rows a warp loads before it sums them (registers: 8 at d ≤ 128, 2 at 512)
  static constexpr int kFly = D <= 128 ? 8 : D == 256 ? 4 : 2;
  float v[kPer];

  __device__ __forceinline__ void load(const float* __restrict__ row, int lane) {
    if constexpr (kVec) {
#pragma unroll
      for (int c = 0; c < kPer / 4; ++c) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(row) + c * 32 + lane);
        v[4 * c] = q.x;
        v[4 * c + 1] = q.y;
        v[4 * c + 2] = q.z;
        v[4 * c + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int t = 0; t < kPer; ++t) v[t] = t * 32 + lane < D ? __ldg(row + t * 32 + lane) : 0.f;
    }
  }

  __device__ __forceinline__ void store(float* __restrict__ row, int lane) const {
    if constexpr (kVec) {
#pragma unroll
      for (int c = 0; c < kPer / 4; ++c)
        reinterpret_cast<float4*>(row)[c * 32 + lane] =
            make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
    } else {
#pragma unroll
      for (int t = 0; t < kPer; ++t)
        if (t * 32 + lane < D) row[t * 32 + lane] = v[t];
    }
  }
};

// Σ over the warp by a butterfly: every lane ends with the same value, and
// the order of the adds is fixed
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <int D>
__device__ __forceinline__ float l1(const Row<D>& a, const Row<D>& b) {
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < Row<D>::kPer; ++t) s += fabsf(a.v[t] - b.v[t]);
  return warp_sum(s);
}

// sign(a − b) with sign(0) = 0 (torch's and jnp.abs's derivative at 0)
__device__ __forceinline__ float sgn(float a, float b) {
  return static_cast<float>((a > b) - (a < b));
}

// ReLU that keeps a NaN (torch's clamp_min), so a diverged table shows in the loss
__device__ __forceinline__ float relu(float x) { return x < 0.f ? 0.f : x; }

template <int D>
__global__ void __launch_bounds__(kThreads)
margin_l1_kernel_fwd(const float* __restrict__ emb, const int64_t* __restrict__ pairs,
                     const int64_t* __restrict__ neg_l, const int64_t* __restrict__ neg_r,
                     const float* __restrict__ w, float gamma, int n_pairs, int k,
                     uint8_t* __restrict__ flags, float* __restrict__ row_sum) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n_pairs) return;
  const int64_t il = __ldg(pairs + 2 * i), ir = __ldg(pairs + 2 * i + 1);
  Row<D> a, b;
  a.load(emb + il * D, lane);
  b.load(emb + ir * D, lane);
  const float thr = l1(a, b) + gamma;
  const int64_t* nr = neg_r + static_cast<long>(i) * k;
  const int64_t* nl = neg_l + static_cast<long>(i) * k;
  float acc = 0.f;
  for (int j0 = 0; j0 < k; j0 += 32) {
    // a lane reads one entry's two ids; the warp then walks them in order
    const int jl = j0 + lane;
    const int64_t my_r = jl < k ? __ldg(nr + jl) : 0, my_l = jl < k ? __ldg(nl + jl) : 0;
    const int n = min(32, k - j0);
    uint8_t my_flag = 0;
    for (int u = 0; u < n; u += 2) {
      const bool two = u + 1 < n;
      const int64_t r0 = __shfl_sync(kFull, my_r, u), l0 = __shfl_sync(kFull, my_l, u);
      const int64_t r1 = __shfl_sync(kFull, my_r, two ? u + 1 : u);
      const int64_t l1i = __shfl_sync(kFull, my_l, two ? u + 1 : u);
      Row<D> x0, y0, x1, y1;  // two entries' rows in flight
      x0.load(emb + r0 * D, lane);
      y0.load(emb + l0 * D, lane);
      if (two) {
        x1.load(emb + r1 * D, lane);
        y1.load(emb + l1i * D, lane);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 1 && !two) break;
        const Row<D>& xr = h ? x1 : x0;
        const Row<D>& yl = h ? y1 : y0;
        const float hr = thr - l1(a, xr);
        const float hl = thr - l1(yl, b);
        acc += relu(hr) + relu(hl);
        const int64_t rr = h ? r1 : r0, ll = h ? l1i : l0;
        const uint8_t f = static_cast<uint8_t>((hr >= 0.f && rr != ir) |
                                               ((hl >= 0.f && ll != il) << 1));
        if (lane == u + h) my_flag = f;
      }
    }
    if (lane < n) flags[static_cast<long>(i) * k + j0 + lane] = my_flag;
  }
  if (lane == 0) row_sum[i] = w != nullptr ? __ldg(w + i) * acc : acc;
}

// (loss, D): the row partials and the weights summed by one block in a
// fixed order (a thread's strided run, then a tree in shared memory)
__global__ void __launch_bounds__(kSumThreads)
margin_sum_kernel(const float* __restrict__ row_sum, const float* __restrict__ w, int n_pairs,
                  int k, float* __restrict__ loss, float* __restrict__ denom_out) {
  __shared__ float s_h[kSumThreads], s_w[kSumThreads];
  const int tid = threadIdx.x;
  float h = 0.f, ws = 0.f;
  for (int i = tid; i < n_pairs; i += kSumThreads) {
    h += row_sum[i];
    if (w != nullptr) ws += __ldg(w + i);
  }
  s_h[tid] = h;
  s_w[tid] = ws;
  __syncthreads();
  for (int o = kSumThreads / 2; o > 0; o >>= 1) {
    if (tid < o) {
      s_h[tid] += s_h[tid + o];
      s_w[tid] += s_w[tid + o];
    }
    __syncthreads();
  }
  if (tid == 0) {
    const float denom = w != nullptr ? fmaxf(s_w[0], 1e-9f) * static_cast<float>(k)
                                     : static_cast<float>(static_cast<long long>(n_pairs) * k);
    loss[0] = 0.5f * s_h[0] / denom;
    denom_out[0] = denom;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
margin_l1_kernel_bwd(const float* __restrict__ emb, const int64_t* __restrict__ pairs,
                     const int64_t* __restrict__ neg_l, const int64_t* __restrict__ neg_r,
                     const float* __restrict__ w, const uint8_t* __restrict__ flags,
                     const float* __restrict__ denom, const float* __restrict__ grad,
                     const int64_t* __restrict__ order, const int64_t* __restrict__ row_ptr,
                     const int64_t* __restrict__ item_ptr, int n_items, int n_rows,
                     int n_pairs, int k, float* __restrict__ partial, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int it = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (it >= n_items || it >= __ldg(item_ptr + n_rows)) return;
  // the item's row: the last r with item_ptr[r] ≤ it (every row has an item)
  int lo = 0, hi = n_rows;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(item_ptr + mid) <= it) lo = mid; else hi = mid;
  }
  const int r = lo;
  const long i0 = __ldg(item_ptr + r), n_seg = __ldg(item_ptr + r + 1) - i0;
  const float g = __ldg(grad) * 0.5f / __ldg(denom);
  const long sk = static_cast<long>(n_pairs) * k;
  Row<D> x, acc;
  x.load(emb + static_cast<long>(r) * D, lane);
#pragma unroll
  for (int t = 0; t < Row<D>::kPer; ++t) acc.v[t] = 0.f;
  const long p0 = __ldg(row_ptr + r) + (it - i0) * kSeg;
  const long p1 = min(__ldg(row_ptr + r + 1), p0 + kSeg);
  for (long base = p0; base < p1; base += 32) {
    // lane u: record base + u → (kind, other row, coefficient); kind 0 a
    // negative record to add c·sign(other − x), 1 inactive, 2 a pair record
    int kind = 1;
    int64_t other = 0;
    float coef = 0.f;
    int pair = 0;
    if (base + lane < p1) {
      const long p = __ldg(order + base + lane);
      if (p < 2L * n_pairs) {
        pair = static_cast<int>(p < n_pairs ? p : p - n_pairs);
        const bool left = p < n_pairs;
        kind = 2;
        other = __ldg(pairs + 2 * pair + (left ? 1 : 0));
        // the side whose negatives pair with this row: right-side entries
        // for e_l (bit 0), left-side ones for e_r (bit 1); carried in `pair`'s sign bit
        if (!left) pair = -pair - 1;
      } else {
        const long q = p - 2L * n_pairs;
        const bool right_side = q < sk;  // an entry of neg_r: pairs with e_l
        const long e = right_side ? q : q - sk;
        const int i = static_cast<int>(e / k);
        if (__ldg(flags + e) & (right_side ? 1 : 2)) {
          kind = 0;
          other = __ldg(pairs + 2 * i + (right_side ? 0 : 1));
          coef = w != nullptr ? g * __ldg(w + i) : g;
        }
      }
    }
    const int n = static_cast<int>(min(32L, p1 - base));
    for (int u = 0; u < n;) {
      const int ku = __shfl_sync(kFull, kind, u);
      if (ku == 2) {  // a pair record: its k entries, in order
        const int pu = __shfl_sync(kFull, pair, u);
        const int64_t ou = __shfl_sync(kFull, other, u);
        const bool left = pu >= 0;
        const int i = left ? pu : -pu - 1;
        const int64_t* negs = (left ? neg_r : neg_l) + static_cast<long>(i) * k;
        const uint8_t bit = left ? 1 : 2;
        Row<D> o;
        o.load(emb + ou * D, lane);
        Row<D> ssum;
#pragma unroll
        for (int t = 0; t < Row<D>::kPer; ++t) ssum.v[t] = 0.f;
        int cnt = 0;
        for (int j0 = 0; j0 < k; j0 += 32) {
          const int jl = j0 + lane;
          const uint8_t f = jl < k ? __ldg(flags + static_cast<long>(i) * k + jl) : 0;
          const int64_t nid = (f & bit) ? __ldg(negs + jl) : -1;
          cnt += __popc(__ballot_sync(kFull, f & 1)) + __popc(__ballot_sync(kFull, f & 2));
          unsigned mine = __ballot_sync(kFull, nid >= 0);
          while (mine) {  // the active entries of this side, in order, Row<D>::kFly rows at a time
            int64_t ids[Row<D>::kFly];
            int m = 0;
#pragma unroll
            for (int t = 0; t < Row<D>::kFly; ++t) {
              ids[t] = -1;
              if (mine) {
                const int src = __ffs(mine) - 1;
                mine &= mine - 1;
                ids[t] = __shfl_sync(kFull, nid, src);
                m = t + 1;
              }
            }
            Row<D> nrow[Row<D>::kFly];
#pragma unroll
            for (int t = 0; t < Row<D>::kFly; ++t)
              if (t < m) nrow[t].load(emb + ids[t] * D, lane);
#pragma unroll
            for (int t = 0; t < Row<D>::kFly; ++t)
              if (t < m) {
#pragma unroll
                for (int e = 0; e < Row<D>::kPer; ++e) ssum.v[e] += sgn(x.v[e], nrow[t].v[e]);
              }
          }
        }
        const float c = w != nullptr ? g * __ldg(w + i) : g;
        const float fc = static_cast<float>(cnt);
#pragma unroll
        for (int e = 0; e < Row<D>::kPer; ++e)
          acc.v[e] += c * (fc * sgn(x.v[e], o.v[e]) - ssum.v[e]);
        ++u;
        continue;
      }
      // a run of negative records up to the next pair record: Row<D>::kFly rows at a time
      int64_t ids[Row<D>::kFly];
      float cs[Row<D>::kFly];
      int m = 0;
#pragma unroll
      for (int t = 0; t < Row<D>::kFly; ++t) {
        ids[t] = -1;
        cs[t] = 0.f;
        if (u < n && __shfl_sync(kFull, kind, u) != 2) {
          const int kt = __shfl_sync(kFull, kind, u);
          const int64_t ot = __shfl_sync(kFull, other, u);
          const float ct = __shfl_sync(kFull, coef, u);
          if (kt == 0) {
            ids[t] = ot;
            cs[t] = ct;
          }
          ++u;
          m = t + 1;
        }
      }
      Row<D> prow[Row<D>::kFly];
#pragma unroll
      for (int t = 0; t < Row<D>::kFly; ++t)
        if (t < m && ids[t] >= 0) prow[t].load(emb + ids[t] * D, lane);
#pragma unroll
      for (int t = 0; t < Row<D>::kFly; ++t)
        if (t < m && ids[t] >= 0) {
#pragma unroll
          for (int e = 0; e < Row<D>::kPer; ++e) acc.v[e] += cs[t] * sgn(prow[t].v[e], x.v[e]);
        }
    }
  }
  // a row of one item is written here; a longer row's items leave partials
  acc.store(n_seg == 1 ? out + static_cast<long>(r) * D : partial + static_cast<long>(it) * D,
            lane);
}

// The rows of several items: their partials summed in item order, written once
template <int D>
__global__ void __launch_bounds__(kThreads)
margin_l1_combine(const int64_t* __restrict__ item_ptr, const float* __restrict__ partial,
                  int n_rows, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= n_rows) return;
  const long i0 = __ldg(item_ptr + r), i1 = __ldg(item_ptr + r + 1);
  if (i1 - i0 < 2) return;
  Row<D> acc, part;
  acc.load(partial + i0 * D, lane);
  for (long i = i0 + 1; i < i1; ++i) {
    part.load(partial + i * D, lane);
#pragma unroll
    for (int t = 0; t < Row<D>::kPer; ++t) acc.v[t] += part.v[t];
  }
  acc.store(out + static_cast<long>(r) * D, lane);
}

template <int D>
cudaError_t launch_fwd(const float* emb, const int64_t* pairs, const int64_t* neg_l,
                       const int64_t* neg_r, const float* w, float gamma, int n_pairs, int k,
                       uint8_t* flags, float* row_sum, float* loss, float* denom,
                       cudaStream_t s) {
  margin_l1_kernel_fwd<D><<<(n_pairs + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      emb, pairs, neg_l, neg_r, w, gamma, n_pairs, k, flags, row_sum);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  margin_sum_kernel<<<1, kSumThreads, 0, s>>>(row_sum, w, n_pairs, k, loss, denom);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const float* emb, const int64_t* pairs, const int64_t* neg_l,
                       const int64_t* neg_r, const float* w, const uint8_t* flags,
                       const float* denom, const float* grad, const int64_t* order,
                       const int64_t* row_ptr, const int64_t* item_ptr, int n_items,
                       int n_rows, int n_pairs, int k, float* partial, float* out,
                       cudaStream_t s) {
  margin_l1_kernel_bwd<D><<<(n_items + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      emb, pairs, neg_l, neg_r, w, flags, denom, grad, order, row_ptr, item_ptr, n_items,
      n_rows, n_pairs, k, partial, out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  margin_l1_combine<D><<<(n_rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(item_ptr, partial,
                                                                          n_rows, out);
  return cudaGetLastError();
}

}  // namespace

#define MARGIN_WIDTHS(X) X(16) X(32) X(64) X(128) X(256) X(512)

// Forward.  emb (n_rows, d) float32, rows 16-byte aligned; pairs (n_pairs, 2),
// neg_l and neg_r (n_pairs, k) int64; w (n_pairs,) float32 or null.  Writes
// flags (n_pairs, k) uint8, row_sum (n_pairs,) float32 scratch, loss (1,)
// and denom (1,) float32 (D).  Two kernel launches (the rows, then the
// fixed-order sum); returns the cudaError_t (0 on success).  d is one of
// 16, 32, 64, 128, 256 and 512.
extern "C" int margin_l1_forward(const float* emb, const int64_t* pairs, const int64_t* neg_l,
                                 const int64_t* neg_r, const float* w, float gamma,
                                 int n_pairs, int k, int d, uint8_t* flags, float* row_sum,
                                 float* loss, float* denom, void* stream) {
  if (n_pairs <= 0 || k <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MARGIN_FWD(D)                                                                  \
  if (d == D)                                                                          \
    return launch_fwd<D>(emb, pairs, neg_l, neg_r, w, gamma, n_pairs, k, flags, row_sum, \
                         loss, denom, s);
  MARGIN_WIDTHS(MARGIN_FWD)
#undef MARGIN_FWD
  return cudaErrorInvalidValue;
}

// Backward.  out (n_rows, d) float32 = ∂L/∂emb · ḡ, every row written once;
// denom is the forward's D (1,), grad the upstream ḡ (1,), both float32;
// order (2·n_pairs + 2·n_pairs·k,) int64 the records sorted stably by the
// row they reach, row_ptr (n_rows + 1,) int64 each row's first record;
// item_ptr (n_rows + 1,) int64 each row's first item (an item is 32 of its
// records, a row at least one); n_items bounds item_ptr[n_rows] (the
// grid); partial (n_items, d) float32 scratch.  Two kernel launches (the
// items, then the rows of several items); returns the cudaError_t.
extern "C" int margin_l1_backward(const float* emb, const int64_t* pairs, const int64_t* neg_l,
                                  const int64_t* neg_r, const float* w, const uint8_t* flags,
                                  const float* denom, const float* grad, const int64_t* order,
                                  const int64_t* row_ptr, const int64_t* item_ptr, int n_items,
                                  int n_rows, int n_pairs, int k, int d, float* partial,
                                  float* out, void* stream) {
  if (n_pairs <= 0 || k <= 0 || n_rows <= 0 || n_items < n_rows) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MARGIN_BWD(D)                                                                     \
  if (d == D)                                                                             \
    return launch_bwd<D>(emb, pairs, neg_l, neg_r, w, flags, denom, grad, order, row_ptr, \
                         item_ptr, n_items, n_rows, n_pairs, k, partial, out, s);
  MARGIN_WIDTHS(MARGIN_BWD)
#undef MARGIN_BWD
  return cudaErrorInvalidValue;
}
