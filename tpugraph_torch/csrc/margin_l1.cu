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
//     above 256) and adds them in order.
//   * widths: instances at d = 16, 32, 64, 128, 256, 384 and 512 (float4
//     rows where 128 divides d); every other d ≤ 512 runs on the masked
//     instance of the next width in 32, 64, 128, 192, …, 512 (scalar rows,
//     the lanes' elements past d read as 0 and never written), whose
//     distances, planes, pair vectors and gradient are those of the d-wide
//     rows: a masked element adds |0 − 0| = 0 and a sign of 0.
//   * above 512 (the slab kernels): a lane holds at most 16 elements of a
//     row, so a row is cut into column slabs of 512, each in the masked
//     512 instance's layout (element 512·s + 32·t + lane at slot t; the
//     last slab masked at d), and every loop runs over the slabs in column
//     order.  The forward reads each negative row once: for each entry it
//     walks the slabs of its rows, adding |a − b| to the lane's sum in
//     column order (a distance still depends only on its two rows, so the
//     partner's d⁻ is d⁺ bit for bit), and writes each slab's sign planes
//     (128 bytes a slab: the 512 instance's words, slab after slab) before
//     it knows whether the record is active, so every record's planes are
//     written.  A second walk of the pair row, slab by slab, sums the
//     active records' signs from the planes it wrote (its own lane's words:
//     no row is read again) into the pair vectors.  The pair rows are read
//     again per entry, from L1, instead of held in registers, so no width
//     is refused.  The backward and the combine walk the slabs of an item
//     or row in turn, each record's planes and vector by slab; each
//     element's sum is the same records in the same order, so the gradient
//     is still the contributions summed in the index's order, bit for bit.

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

// A row as a lane's share: D/32 floats a lane.  At an instance's width
// (kExact: the row is D wide) float4 loads when D is a multiple of 128
// (element (c·32 + lane)·4 + t), else scalar loads (element t·32 + lane;
// lanes past D read nothing).  A masked instance (kExact false) holds a row
// of any width d ≤ D in the scalar layout, elements past d read as 0 and
// never stored: |0 − 0| adds 0 to a distance and sign(0 − 0) = 0 to a
// gradient, so the loss and gradient are those of the d-wide rows.
template <int D, bool kExact = true>
struct Row {
  static constexpr int kPer = D >= 32 ? D / 32 : 1;
  static constexpr bool kVec = kExact && D % 128 == 0;
  float v[kPer];

  // row: the row's first element; d its width (D at an instance's width)
  __device__ __forceinline__ void load(const float* __restrict__ row, int lane, int d) {
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
      const int n = kExact ? D : d;
#pragma unroll
      for (int t = 0; t < kPer; ++t) v[t] = t * 32 + lane < n ? __ldg(row + t * 32 + lane) : 0.f;
    }
  }

  __device__ __forceinline__ void store(float* __restrict__ row, int lane, int d) const {
    if constexpr (kVec) {
#pragma unroll
      for (int c = 0; c < kPer / 4; ++c)
        reinterpret_cast<float4*>(row)[c * 32 + lane] =
            make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
    } else {
      const int n = kExact ? D : d;
#pragma unroll
      for (int t = 0; t < kPer; ++t)
        if (t * 32 + lane < n) row[t * 32 + lane] = v[t];
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

template <int D, bool E>
__device__ __forceinline__ float l1(const Row<D, E>& a, const Row<D, E>& b) {
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < Row<D, E>::kPer; ++t) s += fabsf(a.v[t] - b.v[t]);
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
// bits a lane up to d = 128, 16 up to 256, 32 up to 512: 32 bytes a record
// up to d = 128, 64 up to 256, 128 up to 512.
template <int D>
struct Signs {
  static constexpr int kPer = Row<D>::kPer;
  using Bits = std::conditional_t<(kPer <= 4), uint8_t,
                                  std::conditional_t<(kPer <= 8), uint16_t, uint32_t>>;
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
template <int D, bool E>
__device__ __forceinline__ void put_signs(const Row<D, E>& p, const Row<D, E>& n,
                                          uint8_t* __restrict__ rec, int lane, int* sum) {
  constexpr int kPer = Row<D, E>::kPer;
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

// E: an instance's width (the table is D wide), or a masked instance (d ≤ D)
template <int D, bool E>
__global__ void __launch_bounds__(kThreads)
margin_l1_kernel_fwd(const float* __restrict__ emb, const int64_t* __restrict__ pairs,
                     const int64_t* __restrict__ neg_l, const int64_t* __restrict__ neg_r,
                     const float* __restrict__ w, float gamma, int n_pairs, int k, int d_in,
                     uint8_t* __restrict__ flags, float* __restrict__ row_sum,
                     uint8_t* __restrict__ planes, float* __restrict__ vecs) {
  const int d = E ? D : d_in;  // the table's width: its row pitch
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n_pairs) return;
  const int64_t il = __ldg(pairs + 2 * i), ir = __ldg(pairs + 2 * i + 1);
  Row<D, E> a, b;
  a.load(emb + il * d, lane, d);
  b.load(emb + ir * d, lane, d);
  const float thr = l1(a, b) + gamma;
  const int64_t* nr = neg_r + static_cast<long>(i) * k;
  const int64_t* nl = neg_l + static_cast<long>(i) * k;
  const long sk = static_cast<long>(n_pairs) * k;
  // Σ sign(e_l − n) over the right side's active entries, Σ sign(e_r − n)
  // over the left side's, and the row's active entries
  constexpr int kPer = Row<D, E>::kPer;
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
      Row<D, E> x0, y0, x1, y1;  // two entries' rows in flight
      x0.load(emb + r0 * d, lane, d);
      y0.load(emb + l0 * d, lane, d);
      if (two) {
        x1.load(emb + r1 * d, lane, d);
        y1.load(emb + l1i * d, lane, d);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 1 && !two) break;
        const Row<D, E>& xr = h ? x1 : x0;
        const Row<D, E>& yl = h ? y1 : y0;
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
  Row<D, E> vec;
#pragma unroll
  for (int t = 0; t < kPer; ++t) vec.v[t] = fc * sgn(a.v[t], b.v[t]) - static_cast<float>(sum_r[t]);
  vec.store(vecs + static_cast<long>(i) * d, lane, d);
#pragma unroll
  for (int t = 0; t < kPer; ++t) vec.v[t] = fc * sgn(b.v[t], a.v[t]) - static_cast<float>(sum_l[t]);
  vec.store(vecs + (static_cast<long>(n_pairs) + i) * d, lane, d);
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

template <int D, bool E>
__global__ void __launch_bounds__(kThreads)
margin_l1_kernel_bwd(const float* __restrict__ w, const uint8_t* __restrict__ flags,
                     const uint8_t* __restrict__ planes, const float* __restrict__ vecs,
                     const float* __restrict__ denom, const float* __restrict__ grad,
                     const int4* __restrict__ items, const int32_t* __restrict__ order,
                     int n_items, int n_rows, int n_pairs, int k, int d_in,
                     float* __restrict__ partial, float* __restrict__ out) {
  using Bits = typename Signs<D>::Bits;
  const int d = E ? D : d_in;
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
      at = static_cast<long>(p) * d;
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
  Row<D, E> acc;
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
        Row<D, E> vec;
        vec.load(vecs + __shfl_sync(kFull, at, u0 + j), lane, d);
#pragma unroll
        for (int e = 0; e < Row<D, E>::kPer; ++e) acc.v[e] += c * vec.v[e];
      } else {  // an active negative record: its signs
#pragma unroll
        for (int e = 0; e < Row<D, E>::kPer; ++e) acc.v[e] += c * Signs<D>::at(bits[j], e);
      }
    }
  }
  // a row of one item is written here; a longer row's items leave partials
  acc.store(item.w ? partial + static_cast<long>(it) * d : out + static_cast<long>(r) * d,
            lane, d);
}

// The rows of several items: their partials summed in item order, written
// once.  A hub row has hundreds of items: their partials are loaded
// kBatch at a time, so that the row waits on one load in kBatch, and added
// one by one, in order.
template <int D, bool E>
__global__ void __launch_bounds__(kThreads)
margin_l1_combine(const int32_t* __restrict__ item_ptr, const float* __restrict__ partial,
                  int n_rows, int d_in, float* __restrict__ out) {
  constexpr int kBatch = D <= 128 ? 16 : D <= 256 ? 8 : 4;  // deeper costs every row registers
  const int d = E ? D : d_in;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= n_rows) return;
  const long i0 = __ldg(item_ptr + r), i1 = __ldg(item_ptr + r + 1);
  if (i1 - i0 < 2) return;
  Row<D, E> acc;
  acc.load(partial + i0 * d, lane, d);
  for (long i = i0 + 1; i < i1; i += kBatch) {
    Row<D, E> part[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (i + b < i1) part[b].load(partial + (i + b) * d, lane, d);
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (i + b < i1) {
#pragma unroll
        for (int t = 0; t < Row<D, E>::kPer; ++t) acc.v[t] += part[b].v[t];
      }
  }
  acc.store(out + static_cast<long>(r) * d, lane, d);
}

// The forward's gather alone (a yardstick): the 2·S·k negative rows read in
// the forward's order, two entries in flight, their elements summed; one
// float a pair row
template <int D, bool E>
__global__ void __launch_bounds__(kThreads)
margin_gather_only(const float* __restrict__ emb, const int64_t* __restrict__ neg_l,
                   const int64_t* __restrict__ neg_r, int n_pairs, int k, int d_in,
                   float* __restrict__ out) {
  const int d = E ? D : d_in;
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
      Row<D, E> x0, y0, x1, y1;
      x0.load(emb + r0 * d, lane, d);
      y0.load(emb + l0 * d, lane, d);
      if (two) {
        x1.load(emb + r1 * d, lane, d);
        y1.load(emb + l1i * d, lane, d);
      }
#pragma unroll
      for (int t = 0; t < Row<D, E>::kPer; ++t) acc += x0.v[t] + y0.v[t];
      if (two) {
#pragma unroll
        for (int t = 0; t < Row<D, E>::kPer; ++t) acc += x1.v[t] + y1.v[t];
      }
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) out[i] = acc;
}

// ---- rows wider than 512: column slabs of kSlab in the masked 512
// instance's layout (Slab), walked in column order

constexpr int kSlab = 512;
constexpr int kSlabBytes = Signs<kSlab>::kBytes;  // a slab's planes: 32 lanes × 4 bytes
using Slab = Row<kSlab, false>;
static_assert(Slab::kPer == 16 && Signs<kSlab>::kPer == 16, "a lane holds 16 of a slab");

__device__ __forceinline__ int n_slabs(int d) { return (d + kSlab - 1) / kSlab; }

// slab s of a d-wide row: its first element and its width
__device__ __forceinline__ void load_slab(Slab& r, const float* __restrict__ row, int s, int d,
                                          int lane) {
  r.load(row + s * kSlab, lane, min(kSlab, d - s * kSlab));
}

__device__ __forceinline__ void store_slab(const Slab& r, float* __restrict__ row, int s, int d,
                                           int lane) {
  r.store(row + s * kSlab, lane, min(kSlab, d - s * kSlab));
}

// Σ_t |a_t − b_t| added to the lane's running sum, slot by slot
__device__ __forceinline__ void add_l1(float& acc, const Slab& a, const Slab& b) {
#pragma unroll
  for (int t = 0; t < Slab::kPer; ++t) acc += fabsf(a.v[t] - b.v[t]);
}

// the lane's word of a slab's planes of sign(p − n) (bit t "p > n", bit 16 + t "p < n")
__device__ __forceinline__ uint32_t slab_signs(const Slab& p, const Slab& n) {
  uint32_t m = 0;
#pragma unroll
  for (int t = 0; t < Slab::kPer; ++t)
    m |= (static_cast<uint32_t>(p.v[t] > n.v[t]) << t) |
         (static_cast<uint32_t>(p.v[t] < n.v[t]) << (Slab::kPer + t));
  return m;
}

__global__ void __launch_bounds__(kThreads)
margin_l1_slabs_fwd(const float* __restrict__ emb, const int64_t* __restrict__ pairs,
                    const int64_t* __restrict__ neg_l, const int64_t* __restrict__ neg_r,
                    const float* __restrict__ w, float gamma, int n_pairs, int k, int d,
                    uint8_t* __restrict__ flags, float* __restrict__ row_sum,
                    uint8_t* __restrict__ planes, float* __restrict__ vecs) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= n_pairs) return;
  const int ns = n_slabs(d);
  const long rec_bytes = static_cast<long>(ns) * kSlabBytes;
  const int64_t il = __ldg(pairs + 2 * i), ir = __ldg(pairs + 2 * i + 1);
  const float* ea = emb + il * d;
  const float* eb = emb + ir * d;
  float pos = 0.f;
  for (int s = 0; s < ns; ++s) {
    Slab a, b;
    load_slab(a, ea, s, d, lane);
    load_slab(b, eb, s, d, lane);
    add_l1(pos, a, b);
  }
  const float thr = warp_sum(pos) + gamma;
  const int64_t* nr = neg_r + static_cast<long>(i) * k;
  const int64_t* nl = neg_l + static_cast<long>(i) * k;
  const long sk = static_cast<long>(n_pairs) * k;
  int active = 0;
  float acc = 0.f;
  for (int j0 = 0; j0 < k; j0 += 32) {
    const int jl = j0 + lane;
    const int64_t my_r = jl < k ? __ldg(nr + jl) : 0, my_l = jl < k ? __ldg(nl + jl) : 0;
    const int n = min(32, k - j0);
    uint8_t my_flag = 0;
    for (int u = 0; u < n; u += 2) {
      const bool two = u + 1 < n;
      const int64_t r0 = __shfl_sync(kFull, my_r, u), l0 = __shfl_sync(kFull, my_l, u);
      const int64_t r1 = __shfl_sync(kFull, my_r, two ? u + 1 : u);
      const int64_t l1i = __shfl_sync(kFull, my_l, two ? u + 1 : u);
      const long e0 = static_cast<long>(i) * k + j0 + u;
      float dr[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};  // the lane's sums, column order
      for (int s = 0; s < ns; ++s) {
        Slab a, b, x0, y0, x1, y1;  // two entries' rows in flight
        load_slab(a, ea, s, d, lane);
        load_slab(b, eb, s, d, lane);
        load_slab(x0, emb + r0 * d, s, d, lane);
        load_slab(y0, emb + l0 * d, s, d, lane);
        if (two) {
          load_slab(x1, emb + r1 * d, s, d, lane);
          load_slab(y1, emb + l1i * d, s, d, lane);
        }
        add_l1(dr[0], a, x0);
        add_l1(dl[0], y0, b);
        uint8_t* at = planes + e0 * rec_bytes + s * kSlabBytes;
        reinterpret_cast<uint32_t*>(at)[lane] = slab_signs(a, x0);
        reinterpret_cast<uint32_t*>(at + sk * rec_bytes)[lane] = slab_signs(b, y0);
        if (two) {
          add_l1(dr[1], a, x1);
          add_l1(dl[1], y1, b);
          reinterpret_cast<uint32_t*>(at + rec_bytes)[lane] = slab_signs(a, x1);
          reinterpret_cast<uint32_t*>(at + (sk + 1) * rec_bytes)[lane] = slab_signs(b, y1);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 1 && !two) break;
        const float hr = thr - warp_sum(dr[h]);
        const float hl = thr - warp_sum(dl[h]);
        acc += relu(hr) + relu(hl);
        const int64_t rr = h ? r1 : r0, ll = h ? l1i : l0;
        const bool act_r = hr >= 0.f && rr != ir, act_l = hl >= 0.f && ll != il;
        active += act_r + act_l;
        if (lane == u + h) my_flag = static_cast<uint8_t>(act_r | (act_l << 1));
      }
    }
    if (lane < n) flags[static_cast<long>(i) * k + j0 + lane] = my_flag;
  }
  if (lane == 0) row_sum[i] = w != nullptr ? __ldg(w + i) * acc : acc;
  // the pair vectors, slab by slab: the active records' signs from the
  // planes just written (each lane its own words and its own entries'
  // flags, so its own stores), as exact integer sums
  const float fc = static_cast<float>(active);
  for (int s = 0; s < ns; ++s) {
    int sum_r[Slab::kPer], sum_l[Slab::kPer];
#pragma unroll
    for (int t = 0; t < Slab::kPer; ++t) sum_r[t] = sum_l[t] = 0;
    for (int j0 = 0; j0 < k; j0 += 32) {
      const int n = min(32, k - j0);
      const int my_flag = lane < n ? flags[static_cast<long>(i) * k + j0 + lane] : 0;
      for (int u = 0; u < n; ++u) {
        const int f = __shfl_sync(kFull, my_flag, u);
        const long e = static_cast<long>(i) * k + j0 + u;
        const uint8_t* at = planes + e * rec_bytes + s * kSlabBytes;
        const uint32_t mr = f & 1 ? reinterpret_cast<const uint32_t*>(at)[lane] : 0u;
        const uint32_t ml = f & 2 ? reinterpret_cast<const uint32_t*>(at + sk * rec_bytes)[lane]
                                  : 0u;
#pragma unroll
        for (int t = 0; t < Slab::kPer; ++t) {
          sum_r[t] += static_cast<int>((mr >> t) & 1u) - static_cast<int>((mr >> (16 + t)) & 1u);
          sum_l[t] += static_cast<int>((ml >> t) & 1u) - static_cast<int>((ml >> (16 + t)) & 1u);
        }
      }
    }
    Slab a, b, vec;
    load_slab(a, ea, s, d, lane);
    load_slab(b, eb, s, d, lane);
#pragma unroll
    for (int t = 0; t < Slab::kPer; ++t)
      vec.v[t] = fc * sgn(a.v[t], b.v[t]) - static_cast<float>(sum_r[t]);
    store_slab(vec, vecs + static_cast<long>(i) * d, s, d, lane);
#pragma unroll
    for (int t = 0; t < Slab::kPer; ++t)
      vec.v[t] = fc * sgn(b.v[t], a.v[t]) - static_cast<float>(sum_l[t]);
    store_slab(vec, vecs + (static_cast<long>(n_pairs) + i) * d, s, d, lane);
  }
}

__global__ void __launch_bounds__(kThreads)
margin_l1_slabs_bwd(const float* __restrict__ w, const uint8_t* __restrict__ flags,
                    const uint8_t* __restrict__ planes, const float* __restrict__ vecs,
                    const float* __restrict__ denom, const float* __restrict__ grad,
                    const int4* __restrict__ items, const int32_t* __restrict__ order,
                    int n_items, int n_rows, int n_pairs, int k, int d,
                    float* __restrict__ partial, float* __restrict__ out) {
  constexpr int kBatch = 8;  // records whose planes a warp loads at once
  const int lane = threadIdx.x & 31;
  const int it = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (it >= n_items) return;
  const int4 item = __ldg(items + it);
  const int r = item.x, p0 = item.y, n = item.z;
  if (r >= n_rows) return;
  const int ns = n_slabs(d);
  const long rec_bytes = static_cast<long>(ns) * kSlabBytes;
  const float g = __ldg(grad) * 0.5f / __ldg(denom);
  const long sk = static_cast<long>(n_pairs) * k;
  // lane u: record p0 + u → its kind (0 an active negative record, 1 an
  // inactive one, 2 a pair record), its coefficient, and where its planes
  // or its vector begin
  int kind = 1;
  long at = 0;
  float coef = 0.f;
  if (lane < n) {
    const int p = __ldg(order + p0 + lane);
    if (p < 2 * n_pairs) {
      kind = 2;
      at = static_cast<long>(p) * d;
      coef = w != nullptr ? g * __ldg(w + (p < n_pairs ? p : p - n_pairs)) : g;
    } else {
      const long q = static_cast<long>(p) - 2L * n_pairs;
      const bool right_side = q < sk;
      const long e = right_side ? q : q - sk;
      if (__ldg(flags + e) & (right_side ? 1 : 2)) {
        kind = 0;
        at = q * rec_bytes;
        coef = w != nullptr ? g * __ldg(w + e / k) : g;
      }
    }
  }
  float* dst = item.w ? partial + static_cast<long>(it) * d : out + static_cast<long>(r) * d;
  for (int s = 0; s < ns; ++s) {
    Slab acc;
    acc.zero();
    for (int u0 = 0; u0 < n; u0 += kBatch) {
      int kinds[kBatch];
      uint32_t bits[kBatch];
      float cs[kBatch];
      long ats[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        kinds[j] = __shfl_sync(kFull, kind, u0 + j);
        cs[j] = __shfl_sync(kFull, coef, u0 + j);
        ats[j] = __shfl_sync(kFull, at, u0 + j);
        bits[j] = kinds[j] == 0
                      ? __ldg(reinterpret_cast<const uint32_t*>(planes + ats[j] + s * kSlabBytes) +
                              lane)
                      : 0u;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {  // the records in order
        if (kinds[j] == 1) continue;
        const float c = cs[j];
        if (kinds[j] == 2) {
          Slab vec;
          load_slab(vec, vecs + ats[j], s, d, lane);
#pragma unroll
          for (int e = 0; e < Slab::kPer; ++e) acc.v[e] += c * vec.v[e];
        } else {
#pragma unroll
          for (int e = 0; e < Slab::kPer; ++e) acc.v[e] += c * Signs<kSlab>::at(bits[j], e);
        }
      }
    }
    store_slab(acc, dst, s, d, lane);
  }
}

__global__ void __launch_bounds__(kThreads)
margin_l1_slabs_combine(const int32_t* __restrict__ item_ptr, const float* __restrict__ partial,
                        int n_rows, int d, float* __restrict__ out) {
  constexpr int kBatch = 4;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= n_rows) return;
  const long i0 = __ldg(item_ptr + r), i1 = __ldg(item_ptr + r + 1);
  if (i1 - i0 < 2) return;
  for (int s = 0; s < n_slabs(d); ++s) {
    Slab acc;
    load_slab(acc, partial + i0 * d, s, d, lane);
    for (long i = i0 + 1; i < i1; i += kBatch) {
      Slab part[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (i + b < i1) load_slab(part[b], partial + (i + b) * d, s, d, lane);
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (i + b < i1) {
#pragma unroll
          for (int t = 0; t < Slab::kPer; ++t) acc.v[t] += part[b].v[t];
        }
    }
    store_slab(acc, out + static_cast<long>(r) * d, s, d, lane);
  }
}

__global__ void __launch_bounds__(kThreads)
margin_slabs_gather_only(const float* __restrict__ emb, const int64_t* __restrict__ neg_l,
                         const int64_t* __restrict__ neg_r, int n_pairs, int k, int d,
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
      for (int s = 0; s < n_slabs(d); ++s) {
        Slab x0, y0, x1, y1;
        load_slab(x0, emb + r0 * d, s, d, lane);
        load_slab(y0, emb + l0 * d, s, d, lane);
        if (two) {
          load_slab(x1, emb + r1 * d, s, d, lane);
          load_slab(y1, emb + l1i * d, s, d, lane);
        }
#pragma unroll
        for (int t = 0; t < Slab::kPer; ++t) acc += x0.v[t] + y0.v[t];
        if (two) {
#pragma unroll
          for (int t = 0; t < Slab::kPer; ++t) acc += x1.v[t] + y1.v[t];
        }
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

template <int D, bool E>
cudaError_t launch_fwd(const float* emb, const int64_t* pairs, const int64_t* neg_l,
                       const int64_t* neg_r, const float* w, float gamma, int n_pairs, int k,
                       int d, uint8_t* flags, float* row_sum, uint8_t* planes, float* vecs,
                       float* loss, float* denom, cudaStream_t s) {
  margin_l1_kernel_fwd<D, E><<<(n_pairs + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      emb, pairs, neg_l, neg_r, w, gamma, n_pairs, k, d, flags, row_sum, planes, vecs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  margin_sum_kernel<<<1, kSumThreads, 0, s>>>(row_sum, w, n_pairs, k, loss, denom);
  return cudaGetLastError();
}

cudaError_t launch_slabs_fwd(const float* emb, const int64_t* pairs, const int64_t* neg_l,
                             const int64_t* neg_r, const float* w, float gamma, int n_pairs,
                             int k, int d, uint8_t* flags, float* row_sum, uint8_t* planes,
                             float* vecs, float* loss, float* denom, cudaStream_t s) {
  margin_l1_slabs_fwd<<<(n_pairs + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      emb, pairs, neg_l, neg_r, w, gamma, n_pairs, k, d, flags, row_sum, planes, vecs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  margin_sum_kernel<<<1, kSumThreads, 0, s>>>(row_sum, w, n_pairs, k, loss, denom);
  return cudaGetLastError();
}

template <int D, bool E>
cudaError_t launch_bwd(const float* w, const uint8_t* flags, const uint8_t* planes,
                       const float* vecs, const float* denom, const float* grad,
                       const int32_t* index, int n_items, int n_rows, int n_pairs, int k, int d,
                       float* partial, float* out, cudaStream_t s) {
  const long n_records = 2L * n_pairs + 2L * n_pairs * k;
  const int4* items = reinterpret_cast<const int4*>(index);
  const int32_t* order = index + 4L * n_items;
  const int32_t* item_ptr = order + n_records + n_rows + 1;
  margin_l1_kernel_bwd<D, E><<<(n_items + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      w, flags, planes, vecs, denom, grad, items, order, n_items, n_rows, n_pairs, k, d, partial,
      out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  margin_l1_combine<D, E><<<(n_rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      item_ptr, partial, n_rows, d, out);
  return cudaGetLastError();
}

cudaError_t launch_slabs_bwd(const float* w, const uint8_t* flags, const uint8_t* planes,
                             const float* vecs, const float* denom, const float* grad,
                             const int32_t* index, int n_items, int n_rows, int n_pairs, int k,
                             int d, float* partial, float* out, cudaStream_t s) {
  const long n_records = 2L * n_pairs + 2L * n_pairs * k;
  const int4* items = reinterpret_cast<const int4*>(index);
  const int32_t* order = index + 4L * n_items;
  const int32_t* item_ptr = order + n_records + n_rows + 1;
  margin_l1_slabs_bwd<<<(n_items + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      w, flags, planes, vecs, denom, grad, items, order, n_items, n_rows, n_pairs, k, d, partial,
      out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  margin_l1_slabs_combine<<<(n_rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(item_ptr, partial,
                                                                             n_rows, d, out);
  return cudaGetLastError();
}

}  // namespace

// The instances: at these widths the table is D wide (E true); every other
// width d ≤ 512 takes the masked instance of the least MASKED_WIDTHS entry
// ≥ d (32, then the multiples of 64), its elements past d zero; every
// width above 512 the slab kernels.
#define MARGIN_WIDTHS(X) X(16) X(32) X(64) X(128) X(256) X(384) X(512)
#define MASKED_WIDTHS(X) X(32) X(64) X(128) X(192) X(256) X(320) X(384) X(448) X(512)

static int masked_width(int d) { return d <= 32 ? 32 : (d + 63) / 64 * 64; }

// Forward.  emb (n_rows, d) float32, rows 16-byte aligned; pairs (n_pairs, 2),
// neg_l and neg_r (n_pairs, k) int64; w (n_pairs,) float32 or null.  Writes
// flags (n_pairs, k) uint8; row_sum (n_pairs,) float32 scratch; planes
// (2·n_pairs·k, 32·b) uint8, 4-byte aligned, b = 1 byte a lane up to d =
// 128, 2 up to 256, 4 up to 512 (of the instance's width): the sign planes
// of the active records (right-side entries i·k + j first, then the left
// side's; an inactive record's left as it was; see Signs); above 512 b =
// 4·ceil(d / 512), a record's slabs' planes one after another, and every
// record's written; vecs (2·n_pairs, d) float32, the pair vectors (e_l's,
// then e_r's); loss (1,) and denom (1,) float32 (D).  Two kernel launches
// (the rows, then the fixed-order sum); returns the cudaError_t (0 on
// success).  d is any width ≥ 1.
extern "C" int margin_l1_forward(const float* emb, const int64_t* pairs, const int64_t* neg_l,
                                 const int64_t* neg_r, const float* w, float gamma,
                                 int n_pairs, int k, int d, uint8_t* flags, float* row_sum,
                                 uint8_t* planes, float* vecs, float* loss, float* denom,
                                 void* stream) {
  if (n_pairs <= 0 || k <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MARGIN_FWD(D, E, W)                                                               \
  if (W == D)                                                                             \
    return launch_fwd<D, E>(emb, pairs, neg_l, neg_r, w, gamma, n_pairs, k, d, flags, row_sum, \
                            planes, vecs, loss, denom, s);
#define MARGIN_FWD_EXACT(D) MARGIN_FWD(D, true, d)
#define MARGIN_FWD_MASKED(D) MARGIN_FWD(D, false, masked_width(d))
  MARGIN_WIDTHS(MARGIN_FWD_EXACT)
  if (d < 1) return cudaErrorInvalidValue;
  if (d > kSlab)
    return launch_slabs_fwd(emb, pairs, neg_l, neg_r, w, gamma, n_pairs, k, d, flags, row_sum,
                            planes, vecs, loss, denom, s);
  MASKED_WIDTHS(MARGIN_FWD_MASKED)
#undef MARGIN_FWD_MASKED
#undef MARGIN_FWD_EXACT
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
#define MARGIN_BWD(D, E, W)                                                              \
  if (W == D)                                                                            \
    return launch_bwd<D, E>(w, flags, planes, vecs, denom, grad, index, n_items, n_rows, \
                            n_pairs, k, d, partial, out, s);
#define MARGIN_BWD_EXACT(D) MARGIN_BWD(D, true, d)
#define MARGIN_BWD_MASKED(D) MARGIN_BWD(D, false, masked_width(d))
  MARGIN_WIDTHS(MARGIN_BWD_EXACT)
  if (d < 1) return cudaErrorInvalidValue;
  if (d > kSlab)
    return launch_slabs_bwd(w, flags, planes, vecs, denom, grad, index, n_items, n_rows, n_pairs,
                            k, d, partial, out, s);
  MASKED_WIDTHS(MARGIN_BWD_MASKED)
#undef MARGIN_BWD_MASKED
#undef MARGIN_BWD_EXACT
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
#define MARGIN_GATHER(D, E, W)                                                          \
  if (W == D) {                                                                        \
    margin_gather_only<D, E><<<(n_pairs + kWarps - 1) / kWarps, kThreads, 0, s>>>(       \
        emb, neg_l, neg_r, n_pairs, k, d, out);                                         \
    return cudaGetLastError();                                                          \
  }
#define MARGIN_GATHER_EXACT(D) MARGIN_GATHER(D, true, d)
#define MARGIN_GATHER_MASKED(D) MARGIN_GATHER(D, false, masked_width(d))
  MARGIN_WIDTHS(MARGIN_GATHER_EXACT)
  if (d < 1) return cudaErrorInvalidValue;
  if (d > kSlab) {
    margin_slabs_gather_only<<<(n_pairs + kWarps - 1) / kWarps, kThreads, 0, s>>>(
        emb, neg_l, neg_r, n_pairs, k, d, out);
    return cudaGetLastError();
  }
  MASKED_WIDTHS(MARGIN_GATHER_MASKED)
#undef MARGIN_GATHER_MASKED
#undef MARGIN_GATHER_EXACT
#undef MARGIN_GATHER
  return cudaErrorInvalidValue;
}
