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
// What bounds it on an H100:
//
//   * forward: the row gather.  It reads 2·S·k negative rows (3.58 GB at v7r
//     on dwy100k_dist: S 17,500, k 100, d 256, ≈ 1.07 ms at 3.35 TB/s; the
//     205 MB table does not fit the 50 MB L2, zh-en's 38.9 MB mostly does)
//     and does 3 operations an element.  `margin_l1_gather` reads the same
//     rows in the same order and only sums them: its time is the forward's
//     floor on the card.
//   * backward: what the forward leaves for it, and the gradient.  It reads
//     the sign planes of the active records (8·⌈d/32⌉ bytes each from
//     d = 128 on, 64 at d = 256; 32 below), the 2·S pair vectors (d floats
//     each) and the index (4 bytes a record, 8 a row, 16 a work item), and
//     writes the table's gradient once (205 MB at v7r).  It reads no table
//     row.
//
// Design:
//
//   * forward: one warp a pair row.  The two pair rows stay in registers,
//     each negative row is read once (d/32 elements a lane, float4 where d is
//     a multiple of 128), |a − b| is summed a lane in element order, then
//     across the warp by a butterfly: a distance depends only on its two
//     rows, so a negative that is the positive partner (the pool-of-one
//     fill) reads d⁻ = d⁺ bit for bit.  Per entry it keeps one byte (bit 0
//     the right side's hinge, bit 1 the left's, set where the hinge's
//     argument is ≥ 0, as torch's clamp_min passes the gradient, and cleared
//     for a negative that is the pair's own partner: there h = γ whatever the
//     rows, so the entry has no gradient) and one partial sum a row; a second
//     launch of one block sums the row partials (and the weights) in a fixed
//     order, with no atomics.  What the backward needs it writes from the
//     rows it already holds:
//       - sign planes: for each active record (an entry's right-side record
//         reaches neg_r_ij with sign(e_l − n), its left-side one neg_l_ij
//         with sign(e_r − n)), the sign as two bit planes, "e > n" and
//         "e < n" (sign(0) = 0), 2 bits an element.  Each lane keeps the
//         bits of its own elements (the Row<D> register slots) and the 32
//         lanes store them as one coalesced write; inactive records write
//         nothing.  (A ballot a slot stores the same 2 bits, but inside the
//         record's branch the compiler wraps every vote in a collective
//         sequence, which cost more than the lanes' own stores; PERF.md §6.)
//       - pair vectors: for each pair record (e_l, then e_r) the vector
//         A_i·sign(x − partner) − Σ_j sign(x − n_ij) over its side's active
//         entries, A_i the row's active entries on both sides: exact small
//         integers in fp32.
//   * backward: one warp an item of a table row r.  Its contributions are
//     listed, in record order, by an index built once per batch of
//     negatives (a stable sort of the rows every record touches: S
//     pair-left, S pair-right, S·k right-side and S·k left-side negative
//     records).  A negative record adds c_i·(its sign from the planes); a
//     pair record adds c_i·(its pair vector); c_i = ḡ·0.5/D·w_i.  Each
//     product and each sum is the float operation of the version that
//     gathered the rows again, in its order, so the gradient is that
//     version's bit for bit.  A row's records are cut, in order, into items
//     of 32 (kSeg), one warp an item, so a hub row that thousands of records
//     reach spreads over many warps.  An item sums its records in order; a
//     row of one item is written by it, a longer row's items leave partials
//     that a second launch adds in item order.  Every row of the table is
//     written once (0 where nothing reaches it), so two calls are equal bit
//     for bit.  A lane holds one record's metadata; the warp then loads its
//     own bits of 8 records' planes at once (coalesced) and adds the
//     records in order.  An item reads its row and records from the index
//     in one load (no search), so a warp waits on four dependent loads.
//     The combine loads a hub row's partials 8 at a time (16 at d ≤ 128, 4
//     at 512) and adds them in order.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSumThreads = 1024;
constexpr int kSeg = 32;  // records an item of the backward: a longer row spans items
static_assert(kSeg == 32, "an item's records are one a lane");
constexpr unsigned kFull = 0xffffffffu;

// A row of width D as a lane's share: D/32 floats a lane; float4 loads when
// D is a multiple of 128 (element (c·32 + lane)·4 + t), else scalar loads
// (element t·32 + lane; lanes past D read nothing).
template <int D>
struct Row {
  static constexpr int kPer = D >= 32 ? D / 32 : 1;
  static constexpr bool kVec = D % 128 == 0;
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

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int t = 0; t < kPer; ++t) v[t] = 0.f;
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

// A record's sign planes as the lanes hold them: bit t of a lane's value
// is "e > n" at its element of slot t, bit kPer + t "e < n" (sign(0) = 0);
// the 32 lanes' values lie in lane order, so a record is one coalesced
// store and one coalesced load, and a lane reads only its own bits.  8
// bits a lane up to d = 128, 16 at 256, 32 at 512: 8·⌈d/32⌉ bytes a record
// from d = 128 on (64 at d = 256), 32 below.
template <int D>
struct Signs {
  static constexpr int kPer = Row<D>::kPer;
  using Bits = std::conditional_t<(kPer <= 4), uint8_t,
                                  std::conditional_t<(kPer == 8), uint16_t, uint32_t>>;
  static constexpr int kBytes = 32 * sizeof(Bits);

  // the lane's sign at slot t, as sgn() gives it
  static __device__ __forceinline__ float at(uint32_t m, int t) {
    return (m & (1u << t)) ? 1.f : ((m & (1u << (kPer + t))) ? -1.f : 0.f);
  }
};

// An active record's planes of sign(p − n), each lane storing its own bits
// (no vote: the branch around this is the warp's, but the compiler cannot
// know it, and a ballot there costs a collective sequence), and the signs
// added to the lane's running integer sums
template <int D>
__device__ __forceinline__ void put_signs(const Row<D>& p, const Row<D>& n,
                                          uint8_t* __restrict__ rec, int lane, int* sum) {
  constexpr int kPer = Row<D>::kPer;
  uint32_t m = 0;
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const bool gt = p.v[t] > n.v[t], lt = p.v[t] < n.v[t];
    m |= (static_cast<uint32_t>(gt) << t) | (static_cast<uint32_t>(lt) << (kPer + t));
    sum[t] += gt - lt;
  }
  reinterpret_cast<typename Signs<D>::Bits*>(rec)[lane] =
      static_cast<typename Signs<D>::Bits>(m);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
margin_l1_kernel_fwd(const float* __restrict__ emb, const int64_t* __restrict__ pairs,
                     const int64_t* __restrict__ neg_l, const int64_t* __restrict__ neg_r,
                     const float* __restrict__ w, float gamma, int n_pairs, int k,
                     uint8_t* __restrict__ flags, float* __restrict__ row_sum,
                     uint8_t* __restrict__ planes, float* __restrict__ vecs) {
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
  const long sk = static_cast<long>(n_pairs) * k;
  // Σ sign(e_l − n) over the right side's active entries, Σ sign(e_r − n)
  // over the left side's, and the row's active entries
  constexpr int kPer = Row<D>::kPer;
  int sum_r[kPer], sum_l[kPer];
#pragma unroll
  for (int t = 0; t < kPer; ++t) sum_r[t] = sum_l[t] = 0;
  int active = 0;
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
        // the hinges are the same on every lane: the branches are the warp's
        const bool act_r = hr >= 0.f && rr != ir, act_l = hl >= 0.f && ll != il;
        const long e = static_cast<long>(i) * k + j0 + u + h;
        if (act_r) put_signs(a, xr, planes + e * Signs<D>::kBytes, lane, sum_r);
        if (act_l) put_signs(b, yl, planes + (sk + e) * Signs<D>::kBytes, lane, sum_l);
        active += act_r + act_l;
        if (lane == u + h) my_flag = static_cast<uint8_t>(act_r | (act_l << 1));
      }
    }
    if (lane < n) flags[static_cast<long>(i) * k + j0 + lane] = my_flag;
  }
  if (lane == 0) row_sum[i] = w != nullptr ? __ldg(w + i) * acc : acc;
  const float fc = static_cast<float>(active);
  Row<D> vec;
#pragma unroll
  for (int t = 0; t < kPer; ++t) vec.v[t] = fc * sgn(a.v[t], b.v[t]) - static_cast<float>(sum_r[t]);
  vec.store(vecs + static_cast<long>(i) * D, lane);
#pragma unroll
  for (int t = 0; t < kPer; ++t) vec.v[t] = fc * sgn(b.v[t], a.v[t]) - static_cast<float>(sum_l[t]);
  vec.store(vecs + (static_cast<long>(n_pairs) + i) * D, lane);
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
margin_l1_kernel_bwd(const float* __restrict__ w, const uint8_t* __restrict__ flags,
                     const uint8_t* __restrict__ planes, const float* __restrict__ vecs,
                     const float* __restrict__ denom, const float* __restrict__ grad,
                     const int4* __restrict__ items, const int32_t* __restrict__ order,
                     int n_items, int n_rows, int n_pairs, int k, float* __restrict__ partial,
                     float* __restrict__ out) {
  using Bits = typename Signs<D>::Bits;
  constexpr int kBatch = 8;  // records whose planes a warp loads at once
  const int lane = threadIdx.x & 31;
  const int it = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (it >= n_items) return;
  // the item: its row (n_rows past the last item), its first record's place
  // in the order, its records, whether its row spans several items
  const int4 item = __ldg(items + it);
  const int r = item.x, p0 = item.y, n = item.z;
  if (r >= n_rows) return;
  const float g = __ldg(grad) * 0.5f / __ldg(denom);
  const long sk = static_cast<long>(n_pairs) * k;
  // lane u: record p0 + u → its kind (0 an active negative record, 1 an
  // inactive one, 2 a pair record), its coefficient, and where its planes
  // (a negative record) or its vector (a pair record) lie
  int kind = 1;
  long at = 0;
  float coef = 0.f;
  if (lane < n) {
    const int p = __ldg(order + p0 + lane);
    if (p < 2 * n_pairs) {
      kind = 2;
      at = static_cast<long>(p) * D;
      coef = w != nullptr ? g * __ldg(w + (p < n_pairs ? p : p - n_pairs)) : g;
    } else {
      const long q = static_cast<long>(p) - 2L * n_pairs;
      const bool right_side = q < sk;  // an entry of neg_r: its sign is e_l's
      const long e = right_side ? q : q - sk;
      if (__ldg(flags + e) & (right_side ? 1 : 2)) {
        kind = 0;
        at = q * Signs<D>::kBytes;
        coef = w != nullptr ? g * __ldg(w + e / k) : g;
      }
    }
  }
  Row<D> acc;
  acc.zero();
  for (int u0 = 0; u0 < n; u0 += kBatch) {
    // each lane's bits of kBatch records, loaded at once, and their
    // coefficients (the shuffles outside any branch: in one, the compiler
    // wraps each in a collective sequence)
    int kinds[kBatch];
    uint32_t bits[kBatch];
    float cs[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      kinds[j] = __shfl_sync(kFull, kind, u0 + j);
      cs[j] = __shfl_sync(kFull, coef, u0 + j);
      const long at_j = __shfl_sync(kFull, at, u0 + j);
      bits[j] = kinds[j] == 0 ? __ldg(reinterpret_cast<const Bits*>(planes + at_j) + lane) : 0u;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {  // the records in order
      if (kinds[j] == 1) continue;
      const float c = cs[j];
      if (kinds[j] == 2) {  // a pair record: its vector
        Row<D> vec;
        vec.load(vecs + __shfl_sync(kFull, at, u0 + j), lane);
#pragma unroll
        for (int e = 0; e < Row<D>::kPer; ++e) acc.v[e] += c * vec.v[e];
      } else {  // an active negative record: its signs
#pragma unroll
        for (int e = 0; e < Row<D>::kPer; ++e) acc.v[e] += c * Signs<D>::at(bits[j], e);
      }
    }
  }
  // a row of one item is written here; a longer row's items leave partials
  acc.store(item.w ? partial + static_cast<long>(it) * D : out + static_cast<long>(r) * D,
            lane);
}

// The rows of several items: their partials summed in item order, written
// once.  A hub row has hundreds of items: their partials are loaded
// kBatch at a time, so that the row waits on one load in kBatch, and added
// one by one, in order.
template <int D>
__global__ void __launch_bounds__(kThreads)
margin_l1_combine(const int32_t* __restrict__ item_ptr, const float* __restrict__ partial,
                  int n_rows, float* __restrict__ out) {
  constexpr int kBatch = D <= 128 ? 16 : D == 256 ? 8 : 4;  // deeper costs every row registers
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= n_rows) return;
  const long i0 = __ldg(item_ptr + r), i1 = __ldg(item_ptr + r + 1);
  if (i1 - i0 < 2) return;
  Row<D> acc;
  acc.load(partial + i0 * D, lane);
  for (long i = i0 + 1; i < i1; i += kBatch) {
    Row<D> part[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (i + b < i1) part[b].load(partial + (i + b) * D, lane);
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (i + b < i1) {
#pragma unroll
        for (int t = 0; t < Row<D>::kPer; ++t) acc.v[t] += part[b].v[t];
      }
  }
  acc.store(out + static_cast<long>(r) * D, lane);
}

// The forward's gather alone (a yardstick): the 2·S·k negative rows read in
// the forward's order, two entries in flight, their elements summed; one
// float a pair row
template <int D>
__global__ void __launch_bounds__(kThreads)
margin_gather_only(const float* __restrict__ emb, const int64_t* __restrict__ neg_l,
                   const int64_t* __restrict__ neg_r, int n_pairs, int k,
                   float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n_pairs) return;
  const int64_t* nr = neg_r + static_cast<long>(i) * k;
  const int64_t* nl = neg_l + static_cast<long>(i) * k;
  float acc = 0.f;
  for (int j0 = 0; j0 < k; j0 += 32) {
    const int jl = j0 + lane;
    const int64_t my_r = jl < k ? __ldg(nr + jl) : 0, my_l = jl < k ? __ldg(nl + jl) : 0;
    const int n = min(32, k - j0);
    for (int u = 0; u < n; u += 2) {
      const bool two = u + 1 < n;
      const int64_t r0 = __shfl_sync(kFull, my_r, u), l0 = __shfl_sync(kFull, my_l, u);
      const int64_t r1 = __shfl_sync(kFull, my_r, two ? u + 1 : u);
      const int64_t l1i = __shfl_sync(kFull, my_l, two ? u + 1 : u);
      Row<D> x0, y0, x1, y1;
      x0.load(emb + r0 * D, lane);
      y0.load(emb + l0 * D, lane);
      if (two) {
        x1.load(emb + r1 * D, lane);
        y1.load(emb + l1i * D, lane);
      }
#pragma unroll
      for (int t = 0; t < Row<D>::kPer; ++t) acc += x0.v[t] + y0.v[t];
      if (two) {
#pragma unroll
        for (int t = 0; t < Row<D>::kPer; ++t) acc += x1.v[t] + y1.v[t];
      }
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) out[i] = acc;
}

// The backward's index from the records' rows sorted stably (keys, R of
// them, and their records, order): thread p ≤ R writes order[p] as int32,
// row_ptr[r] = p for the rows r in (keys[p − 1], keys[p]] (the rows after
// the last key for p = R), and each row's items, max(1, ⌈records / 32⌉),
// into counts[r + 1] (counts[0] = 0): a row's records end where a binary
// search of its key's end finds them
__global__ void __launch_bounds__(kThreads)
margin_index_rows(const int32_t* __restrict__ keys, const int64_t* __restrict__ order,
                  int n_records, int n_rows, int32_t* __restrict__ order32,
                  int32_t* __restrict__ row_ptr, int32_t* __restrict__ counts) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p > n_records) return;
  if (p < n_records) order32[p] = static_cast<int32_t>(__ldg(order + p));
  if (p == 0) counts[0] = 0;
  const int lo = p == 0 ? -1 : __ldg(keys + p - 1);
  const int hi = p == n_records ? n_rows : __ldg(keys + p);
  if (hi == lo) return;  // not the first record of a row
  // (a key outside [0, n_rows) reaches no row, as searchsorted places it)
  for (int r = max(lo + 1, 0); r <= min(hi, n_rows); ++r) row_ptr[r] = p;
  // the rows no record reaches: one item each
  for (int r = max(lo + 1, 0); r < min(hi, n_rows); ++r) counts[r + 1] = 1;
  if (p < n_records && hi >= 0 && hi < n_rows) {
    int a = p, b = n_records;  // the row's records: [p, the first key above hi)
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (__ldg(keys + mid) <= hi) a = mid + 1; else b = mid;
    }
    counts[hi + 1] = max(1, (a - p + kSeg - 1) / kSeg);
  }
}

// The index's items from each row's first item (item_ptr, the counts'
// inclusive sum): thread it < n_items writes item it's (row, first
// record's place, records, 1 where its row spans several items), row
// n_rows and zeros past the last item; the first n_rows + 1 threads copy
// item_ptr into the index
__global__ void __launch_bounds__(kThreads)
margin_index_items(const int32_t* __restrict__ item_ptr, int n_items, int n_rows,
                   const int32_t* __restrict__ row_ptr, int32_t* __restrict__ index_item_ptr,
                   int4* __restrict__ items) {
  const int it = blockIdx.x * kThreads + threadIdx.x;
  if (it <= n_rows) index_item_ptr[it] = __ldg(item_ptr + it);
  if (it >= n_items) return;
  int a = 0, b = n_rows + 1;  // the rows r with item_ptr[r] ≤ it: [0, a)
  while (a < b) {
    const int mid = (a + b) >> 1;
    if (__ldg(item_ptr + mid) <= it) a = mid + 1; else b = mid;
  }
  const int r = a - 1;
  if (r >= n_rows) {
    items[it] = make_int4(n_rows, 0, 0, 0);
    return;
  }
  const int i0 = __ldg(item_ptr + r);
  const int first = __ldg(row_ptr + r) + (it - i0) * kSeg;
  const int count = max(0, min(__ldg(row_ptr + r + 1) - first, kSeg));
  items[it] = make_int4(r, first, count, __ldg(item_ptr + r + 1) - i0 > 1);
}

template <int D>
cudaError_t launch_fwd(const float* emb, const int64_t* pairs, const int64_t* neg_l,
                       const int64_t* neg_r, const float* w, float gamma, int n_pairs, int k,
                       uint8_t* flags, float* row_sum, uint8_t* planes, float* vecs,
                       float* loss, float* denom, cudaStream_t s) {
  margin_l1_kernel_fwd<D><<<(n_pairs + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      emb, pairs, neg_l, neg_r, w, gamma, n_pairs, k, flags, row_sum, planes, vecs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  margin_sum_kernel<<<1, kSumThreads, 0, s>>>(row_sum, w, n_pairs, k, loss, denom);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const float* w, const uint8_t* flags, const uint8_t* planes,
                       const float* vecs, const float* denom, const float* grad,
                       const int32_t* index, int n_items, int n_rows, int n_pairs, int k,
                       float* partial, float* out, cudaStream_t s) {
  const long n_records = 2L * n_pairs + 2L * n_pairs * k;
  const int4* items = reinterpret_cast<const int4*>(index);
  const int32_t* order = index + 4L * n_items;
  const int32_t* item_ptr = order + n_records + n_rows + 1;
  margin_l1_kernel_bwd<D><<<(n_items + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      w, flags, planes, vecs, denom, grad, items, order, n_items, n_rows, n_pairs, k, partial,
      out);
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
// flags (n_pairs, k) uint8; row_sum (n_pairs,) float32 scratch; planes
// (2·n_pairs·k, 32·b) uint8, 4-byte aligned, b = 1 byte a lane up to d =
// 128, 2 at 256, 4 at 512: the sign planes of the active records
// (right-side entries i·k + j first, then the left side's; an inactive
// record's left as it was; see Signs); vecs (2·n_pairs, d) float32, the pair
// vectors (e_l's, then e_r's); loss (1,) and denom (1,) float32 (D).  Two
// kernel launches (the rows, then the fixed-order sum); returns the
// cudaError_t (0 on success).  d is one of 16, 32, 64, 128, 256 and 512.
extern "C" int margin_l1_forward(const float* emb, const int64_t* pairs, const int64_t* neg_l,
                                 const int64_t* neg_r, const float* w, float gamma,
                                 int n_pairs, int k, int d, uint8_t* flags, float* row_sum,
                                 uint8_t* planes, float* vecs, float* loss, float* denom,
                                 void* stream) {
  if (n_pairs <= 0 || k <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MARGIN_FWD(D)                                                                  \
  if (d == D)                                                                          \
    return launch_fwd<D>(emb, pairs, neg_l, neg_r, w, gamma, n_pairs, k, flags, row_sum, \
                         planes, vecs, loss, denom, s);
  MARGIN_WIDTHS(MARGIN_FWD)
#undef MARGIN_FWD
  return cudaErrorInvalidValue;
}

// Backward.  out (n_rows, d) float32 = ∂L/∂emb · ḡ, every row written once;
// w, flags, planes and vecs as the forward left them, denom its D (1,), grad
// the upstream ḡ (1,), both float32.  index (4·n_items + R + 2·(n_rows + 1),)
// int32, 16-byte aligned, R = 2·n_pairs + 2·n_pairs·k: each item's (row,
// first record's place in the order, records, 1 where its row spans
// several items) (n_items × 4; row n_rows past the last item; an item is
// up to 32 of a row's records, a row at least one item), the records
// sorted stably by the row they reach (R), each row's first record and
// each row's first item (n_rows + 1 each); n_items = n_rows + ceil(R / 32)
// bounds the items (the grid); partial (n_items, d) float32 scratch.  Two
// kernel launches (the items, then the rows of several items); returns
// the cudaError_t.
extern "C" int margin_l1_backward(const float* w, const uint8_t* flags, const uint8_t* planes,
                                  const float* vecs, const float* denom, const float* grad,
                                  const int32_t* index, int n_items, int n_rows, int n_pairs,
                                  int k, int d, float* partial, float* out, void* stream) {
  if (n_pairs <= 0 || k <= 0 || n_rows <= 0 || n_items < n_rows) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MARGIN_BWD(D)                                                                     \
  if (d == D)                                                                             \
    return launch_bwd<D>(w, flags, planes, vecs, denom, grad, index, n_items, n_rows,      \
                         n_pairs, k, partial, out, s);
  MARGIN_WIDTHS(MARGIN_BWD)
#undef MARGIN_BWD
  return cudaErrorInvalidValue;
}

// The backward's index, in two launches around the caller's inclusive sum
// of counts (n_rows + 1,) int32 into item_ptr (n_rows + 1,) int32.  index
// as margin_l1_backward takes it; keys (R,) int32 the records' rows sorted
// stably, order (R,) int64 their records; n_items = n_rows + ceil(R / 32).
// Rows: writes the index's order and row_ptr, and counts.  Items: writes
// the index's items and item_ptr.  Each returns the cudaError_t.
extern "C" int margin_l1_index_rows(const int32_t* keys, const int64_t* order, int n_records,
                                    int n_rows, int n_items, int32_t* index, int32_t* counts,
                                    void* stream) {
  if (n_records <= 0 || n_rows <= 0) return cudaErrorInvalidValue;
  int32_t* order32 = index + 4L * n_items;
  margin_index_rows<<<n_records / kThreads + 1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      keys, order, n_records, n_rows, order32, order32 + n_records, counts);
  return cudaGetLastError();
}

extern "C" int margin_l1_index_items(const int32_t* item_ptr, int n_records, int n_rows,
                                     int n_items, int32_t* index, void* stream) {
  if (n_records <= 0 || n_rows <= 0 || n_items < n_rows) return cudaErrorInvalidValue;
  const int32_t* row_ptr = index + 4L * n_items + n_records;
  margin_index_items<<<n_items / kThreads + 1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      item_ptr, n_items, n_rows, row_ptr, const_cast<int32_t*>(row_ptr) + n_rows + 1,
      reinterpret_cast<int4*>(index));
  return cudaGetLastError();
}

// The gather alone: out (n_pairs,) float32, each pair row's 2·k negative
// rows summed.  One kernel launch; returns the cudaError_t.
extern "C" int margin_l1_gather(const float* emb, const int64_t* neg_l, const int64_t* neg_r,
                                int n_pairs, int k, int d, float* out, void* stream) {
  if (n_pairs <= 0 || k <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MARGIN_GATHER(D)                                                                \
  if (d == D) {                                                                        \
    margin_gather_only<D><<<(n_pairs + kWarps - 1) / kWarps, kThreads, 0, s>>>(          \
        emb, neg_l, neg_r, n_pairs, k, out);                                            \
    return cudaGetLastError();                                                          \
  }
  MARGIN_WIDTHS(MARGIN_GATHER)
#undef MARGIN_GATHER
  return cudaErrorInvalidValue;
}
