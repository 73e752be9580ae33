// One log-domain Sinkhorn potential update for Hopper (sm_90a), with the
// sqeuclidean cost built tile by tile and never stored:
//
//     f_i = τ·(log μ_i − LSE_j[(g_j − C_ij)/τ]),
//     C_ij = max(‖l_i‖² + ‖r_j‖² − 2·l_i·r_j, 0),   j < C.
//
// Replaces tpugraph/kernels/sinkhorn_pallas.py::_f_update_kernel (and its
// wrapper sinkhorn_potential_update).  The solver alternates the f- and
// g-updates by swapping (l, r); the kernel reads rows of both sides, so
// neither is transposed in device memory.
//
// What bounds it on an H100: the Q·C·d dot products (4,500 × 4,500 × 128 in
// config sinkhorn) and Q·C exps; its inputs are under 5 MB.  The products
// run on the tensor cores as a 3× TF32 split, x = big + small with
// big = tf32(x), small = tf32(x − big), and l·r ≈ big·big + big·small +
// small·big accumulated in fp32: three m16n8k8 TF32 products per fp32 one,
// so the bound is 3·2·Q·C·d at the TF32 rate (~31 µs at 495 TFLOP/s).  One
// TF32 product alone is not enough: C/τ reaches ~80 at τ = 0.05 on unit
// rows, and exp turns TF32's 2⁻¹¹ rounding of the dot product into errors
// far above the 1e-4 tolerance; the split keeps fp32's error.  mma.sync
// rather than wgmma: each warp splits its candidate fragments in registers
// as it loads them, so shared memory holds one fp32 copy of each candidate
// tile and needs no wgmma descriptors.  The price is mma.sync's rate: the
// two extra products of the split cost most of the gap to 1× TF32 (PERF.md
// §6), so wgmma over split tiles is the next step.
//
// Design, flash-attention-forward shaped, and persistent:
//
//   * the work is Q/64 query strips × C/128 candidate tiles, laid out strip
//     by strip; one block per SM takes an equal run of that sequence
//     (±1 tile), so the grid is one even wave with no tail; a block's run
//     crosses at most a few strip boundaries, and each piece of a strip it
//     covers is one "split" of that strip's candidate axis;
//   * the strip is split into (big, small) when the block reaches it and
//     stays in shared memory; candidate tiles stream through a cp.async
//     ring (3 stages, 2 at the widest d) in chunks of 64 of d, continuing
//     across strip boundaries, so the next chunk's load overlaps this one's
//     products and the tile's epilogue;
//   * 8 warps as 2 × 4, each a 32 × 32 piece of the 64 × 128 tile with
//     mma.sync m16n8k8 TF32; the k index of each group of 16 is permuted the
//     same way for both operands so every fragment is one 16-byte shared
//     load (the rows are padded by 16 floats, which keeps them free of bank
//     conflicts);
//   * the epilogue works in base 2: z·log₂e = g_j·(log₂e/τ) − C_ij·(log₂e/τ)
//     with the constant precomputed, exp2f, and one rescale of the running
//     sum per row per tile;
//   * each (row, split) leaves a partial (max, sumexp) in scratch; the last
//     block of a strip to finish (a per-strip counter) merges the partials
//     in split order, so the result does not depend on which block finished
//     last, and resets the counter, so a call is one launch;
//   * the -inf guards of the TPU kernel are kept: columns past C carry
//     z = -inf, a split with no valid column contributes (-inf, 0), and an
//     all-masked row ends with lse = log(1e-38).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;        // query rows per strip
constexpr int kBC = 128;       // candidate columns per tile
constexpr int kKC = 64;        // d per pipeline chunk
constexpr int kPad = 16;       // row padding (floats): stride ≡ 16 mod 32 banks
constexpr int kRStride = kKC + kPad;
constexpr int kWarpsN = 4;     // warps along the candidate axis
constexpr int kStrip4 = 8;     // float4 loads in flight per thread while staging a strip
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return u;
}

// x = big + small, each a TF32 value (fp32 bits with the low 13 zero)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// merge (m2, s2) into (m, s) — base-2 running max and sum — with the -inf guard
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  const float safe = mn == -INFINITY ? 0.f : mn;
  s = s * exp2f(m - safe) + s2 * exp2f(m2 - safe);
  m = mn;
}

// The block whose run holds work unit u: block b runs [b·total/G, (b+1)·total/G).
__device__ __forceinline__ int owner(int u, int total, int grid) {
  return static_cast<int>(((u + 1LL) * grid - 1) / total);
}

// The candidate rows [c0, c0 + kBC) × d-chunk [k0, k0 + kKC) into one ring
// slot; rows past C and columns past d are zero-filled.
__device__ __forceinline__ void load_chunk(float* dst, const float* __restrict__ r, int c0,
                                           int k0, int n_c, int d, int tid) {
#pragma unroll
  for (int j = 0; j < kBC * (kKC / 4) / kThreads; ++j) {
    const int i = j * kThreads + tid;
    const int row = i / (kKC / 4), f4 = i % (kKC / 4);
    const int col = c0 + row, k = k0 + f4 * 4;
    const bool valid = col < n_c && k < d;
    const float* src = valid ? r + static_cast<long>(col) * d + k : r;
    cp_async16(dst + row * kRStride + f4 * 4, src, valid);
  }
}

// The query rows [q0, q0 + kBQ) split into (big, small) halves in shared
// memory; rows past Q and columns past d are zero.
__device__ __forceinline__ void stage_strip(uint32_t* l_big, uint32_t* l_small,
                                            const float* __restrict__ l, int q0, int n_q, int d,
                                            int d_pad, int l_stride, int tid) {
  const int per_row = d_pad / 4, n4 = kBQ * per_row;
  for (int i0 = 0; i0 < n4; i0 += kStrip4 * kThreads) {
    float4 v[kStrip4];
#pragma unroll
    for (int j = 0; j < kStrip4; ++j) {  // every load first, then the splits
      const int i = i0 + j * kThreads + tid;
      const int q = i / per_row, k = (i % per_row) * 4;
      v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < n4 && q0 + q < n_q && k < d)
        v[j] = __ldg(reinterpret_cast<const float4*>(l + static_cast<long>(q0 + q) * d + k));
    }
#pragma unroll
    for (int j = 0; j < kStrip4; ++j) {
      const int i = i0 + j * kThreads + tid;
      if (i >= n4) break;
      const int q = i / per_row, k = (i % per_row) * 4;
      uint4 b, s;
      split_tf32(v[j].x, b.x, s.x);
      split_tf32(v[j].y, b.y, s.y);
      split_tf32(v[j].z, b.z, s.z);
      split_tf32(v[j].w, b.w, s.w);
      *reinterpret_cast<uint4*>(l_big + q * l_stride + k) = b;
      *reinterpret_cast<uint4*>(l_small + q * l_stride + k) = s;
    }
  }
}

template <int kStages>
__global__ void __launch_bounds__(kThreads, 1)
sinkhorn_update_kernel(const float* __restrict__ l, const float* __restrict__ r,
                       const float* __restrict__ l2, const float* __restrict__ r2,
                       const float* __restrict__ g, const float* __restrict__ log_mu,
                       float tau, int n_q, int n_c, int d, int max_splits,
                       float2* __restrict__ partial, int* __restrict__ counters,
                       float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int d_pad = (d + kKC - 1) / kKC * kKC;
  const int l_stride = d_pad + kPad;
  uint32_t* l_big = reinterpret_cast<uint32_t*>(smem);    // [kBQ][l_stride]
  uint32_t* l_small = l_big + kBQ * l_stride;              // [kBQ][l_stride]
  float* ring = reinterpret_cast<float*>(l_small + kBQ * l_stride);  // [kStages][kBC][kRStride]
  float2* red = reinterpret_cast<float2*>(ring + kStages * kBC * kRStride);  // [kWarpsN][kBQ]
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;  // mma fragment coordinates
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int n_tiles = (n_c + kBC - 1) / kBC;
  const int total = (n_q + kBQ - 1) / kBQ * n_tiles;  // the host keeps it below 2^28
  const int grid = gridDim.x, blk = blockIdx.x;
  const int u0 = static_cast<int>(static_cast<long long>(blk) * total / grid);
  const int u1 = static_cast<int>(static_cast<long long>(blk + 1) * total / grid);
  const int nkc = d_pad / kKC;
  const float k2 = kLog2e / tau;

  // the loads run kStages - 1 chunks ahead of the products: the next
  // chunk to load is d-chunk ld_kc of tile ld_tile, into ring slot ld_slot
  int ld_left = (u1 - u0) * nkc, ld_slot = 0, ld_tile = u0 % n_tiles, ld_kc = 0;
  auto load_next = [&]() {
    if (ld_left > 0) {
      load_chunk(ring + ld_slot * kBC * kRStride, r, ld_tile * kBC, ld_kc * kKC, n_c, d, tid);
      --ld_left;
      if (++ld_kc == nkc) {
        ld_kc = 0;
        if (++ld_tile == n_tiles) ld_tile = 0;
      }
      if (++ld_slot == kStages) ld_slot = 0;
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load_next();

  int slot = 0;  // the ring slot of the chunk the products read
  for (int u = u0; u < u1;) {
    // one split: this block's units of one strip
    const int strip = u / n_tiles;
    const int split_end = min(u1, (strip + 1) * n_tiles);
    const int q0 = strip * kBQ;
    __syncthreads();  // the last split is done with the strip, red and s_last
    stage_strip(l_big, l_small, l, q0, n_q, d, d_pad, l_stride, tid);

    // this thread's 4 rows (fragment rows g and g + 8 of two m-tiles) and
    // 8 columns (2 of each of four n-tiles)
    float row_l2[4], run_m[4], run_s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + wm * 32 + (i >> 1) * 16 + (i & 1) * 8 + gq;
      row_l2[i] = q < n_q ? __ldg(l2 + q) : 0.f;
      run_m[i] = -INFINITY;
      run_s[i] = 0.f;
    }

    for (; u < split_end; ++u) {
      const int c0 = (u - strip * n_tiles) * kBC;
      float acc[2][4][4] = {};
      float col_gk[8], col_r2[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c0 + wn * 32 + (j >> 1) * 8 + tq * 2 + (j & 1);
        const bool valid = col < n_c;
        col_gk[j] = valid ? __ldg(g + col) * k2 : -INFINITY;
        col_r2[j] = valid ? __ldg(r2 + col) : 0.f;
      }
      for (int kc = 0; kc < nkc; ++kc) {
        cp_async_wait<kStages - 2>();
        __syncthreads();  // this chunk (and the strip) is in; the oldest slot is free
        load_next();
        const float* rb_s = ring + slot * kBC * kRStride;
        if (++slot == kStages) slot = 0;
#pragma unroll
        for (int kk = 0; kk < kKC; kk += 16) {
          // k-slots t and t+4 of the first k-step are d = kk+4t+{0,1}, of the
          // second d = kk+4t+{2,3}: one 16-byte load per fragment row
          uint32_t ab[2][2][4], as[2][2][4];  // [m-tile][row g, g + 8][d]
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int off =
                  (wm * 32 + mt * 16 + h * 8 + gq) * l_stride + kc * kKC + kk + tq * 4;
              const uint4 vb = *reinterpret_cast<const uint4*>(l_big + off);
              const uint4 vs = *reinterpret_cast<const uint4*>(l_small + off);
              ab[mt][h][0] = vb.x; ab[mt][h][1] = vb.y; ab[mt][h][2] = vb.z; ab[mt][h][3] = vb.w;
              as[mt][h][0] = vs.x; as[mt][h][1] = vs.y; as[mt][h][2] = vs.z; as[mt][h][3] = vs.w;
            }
          uint32_t bb[4][4], bs[4][4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const float4 v = *reinterpret_cast<const float4*>(
                rb_s + (wn * 32 + nt * 8 + gq) * kRStride + kk + tq * 4);
            split_tf32(v.x, bb[nt][0], bs[nt][0]);
            split_tf32(v.y, bb[nt][1], bs[nt][1]);
            split_tf32(v.z, bb[nt][2], bs[nt][2]);
            split_tf32(v.w, bb[nt][3], bs[nt][3]);
          }
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            // a0..a3 = (row g, slot t), (g + 8, t), (g, t + 4), (g + 8, t + 4);
            // b0, b1 = (slot t, column g), (t + 4, g).  The small terms first,
            // then big·big, each pass over all 8 accumulators.
            const int k0 = 2 * ks, k1 = 2 * ks + 1;
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
                mma_tf32(acc[mt][nt], ab[mt][0][k0], ab[mt][1][k0], ab[mt][0][k1], ab[mt][1][k1],
                         bs[nt][k0], bs[nt][k1]);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
                mma_tf32(acc[mt][nt], as[mt][0][k0], as[mt][1][k0], as[mt][0][k1], as[mt][1][k1],
                         bb[nt][k0], bb[nt][k1]);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
                mma_tf32(acc[mt][nt], ab[mt][0][k0], ab[mt][1][k0], ab[mt][0][k1], ab[mt][1][k1],
                         bb[nt][k0], bb[nt][k1]);
          }
        }
      }

      // fold the tile's 8 columns per row into the running (max, sumexp)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int mt = i >> 1, h = i & 1;
        float z[8];
        float mx = run_m[i];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float dot = acc[mt][j >> 1][h * 2 + (j & 1)];
          const float cost = fmaxf(fmaf(-2.f, dot, row_l2[i] + col_r2[j]), 0.f);
          z[j] = fmaf(-cost, k2, col_gk[j]);
          mx = fmaxf(mx, z[j]);
        }
        const float safe = mx == -INFINITY ? 0.f : mx;
        float s = run_s[i] * exp2f(run_m[i] - safe);
#pragma unroll
        for (int j = 0; j < 8; ++j) s += exp2f(z[j] - safe);
        run_m[i] = mx;
        run_s[i] = s;
      }
    }

    // the split's partial: merge the 4 lanes of each fragment row, then the
    // 4 warps along the candidate axis, in a fixed order
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float m_o = __shfl_xor_sync(kFull, run_m[i], off);
        const float s_o = __shfl_xor_sync(kFull, run_s[i], off);
        merge(run_m[i], run_s[i], m_o, s_o);
      }
      if (tq == 0)
        red[wn * kBQ + wm * 32 + (i >> 1) * 16 + (i & 1) * 8 + gq] =
            make_float2(run_m[i], run_s[i]);
    }
    __syncthreads();
    const int first = strip * n_tiles;
    const int split0 = owner(first, total, grid);  // the strip's first split's block
    const int n_split = owner(first + n_tiles - 1, total, grid) - split0 + 1;
    float2* strip_part = partial + static_cast<long>(strip) * max_splits * kBQ;
    if (tid < kBQ) {
      float m = -INFINITY, s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarpsN; ++w) merge(m, s, red[w * kBQ + tid].x, red[w * kBQ + tid].y);
      strip_part[(blk - split0) * kBQ + tid] = make_float2(m, s);
    }

    // the last split of this strip to finish merges every split, in order
    __threadfence();
    __syncthreads();
    if (tid == 0) s_last = atomicAdd(counters + strip, 1) == n_split - 1;
    __syncthreads();
    if (s_last && tid == 0) counters[strip] = 0;  // every split has counted: ready for the next launch
    if (s_last && tid < kBQ && q0 + tid < n_q) {
      __threadfence();
      float m = -INFINITY, s = 0.f;
      for (int sp = 0; sp < n_split; ++sp) {
        const float2 p = __ldcg(strip_part + sp * kBQ + tid);
        merge(m, s, p.x, p.y);
      }
      const float safe = m == -INFINITY ? 0.f : m;
      const float lse = safe * kLn2 + logf(fmaxf(s, 1e-38f));
      out[q0 + tid] = tau * (__ldg(log_mu + q0 + tid) - lse);
    }
  }
  cp_async_wait<0>();
}

size_t smem_bytes(int d, int stages) {
  const int d_pad = (d + kKC - 1) / kKC * kKC;
  return sizeof(float) * (2 * static_cast<size_t>(kBQ) * (d_pad + kPad) +
                          static_cast<size_t>(stages) * kBC * kRStride) +
         sizeof(float2) * kWarpsN * kBQ;
}

template <int kStages>
cudaError_t launch(const float* l, const float* r, const float* l2, const float* r2,
                   const float* g, const float* log_mu, float tau, int n_q, int n_c, int d,
                   int grid, int max_splits, float2* partial, int* counters, float* out,
                   cudaStream_t stream) {
  auto kern = sinkhorn_update_kernel<kStages>;
  const size_t smem = smem_bytes(d, kStages);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, stream>>>(l, r, l2, r2, g, log_mu, tau, n_q, n_c, d, max_splits,
                                         partial, counters, out);
  return cudaGetLastError();
}

}  // namespace

// f (n_q,) float32 from l (n_q, d), r (n_c, d), l2 = ‖l‖² (n_q,),
// r2 = ‖r‖² (n_c,), g (n_c,), log_mu (n_q,); all float32, contiguous, rows
// 16-byte aligned (d % 4 == 0, d ≤ 256: the strip's two halves and a
// 2-stage ring fill 218 KB of shared memory at 256).  `grid` blocks share
// the ceil(n_q / 64) × ceil(n_c / 128) work units evenly (grid ≤ units);
// partial is (ceil(n_q / 64), max_splits, 64) float2 scratch, where
// max_splits bounds the blocks any strip is shared by, and counters
// (ceil(n_q / 64),) int scratch, zero on entry and left zero on exit.  One
// kernel launch; returns its cudaError_t (0 on success), and the work itself
// runs asynchronously on `stream`.
extern "C" int sinkhorn_update_forward(const float* l, const float* r, const float* l2,
                                       const float* r2, const float* g, const float* log_mu,
                                       float tau, int n_q, int n_c, int d, int grid,
                                       int max_splits, void* partial, int* counters, float* out,
                                       void* stream) {
  if (n_q <= 0) return cudaSuccess;
  const long long units = static_cast<long long>((n_q + kBQ - 1) / kBQ) * ((n_c + kBC - 1) / kBC);
  if (d <= 0 || d % 4 != 0 || d > 256 || n_c <= 0 || grid <= 0 || grid > units ||
      units >= (1LL << 28) || max_splits <= 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  int dev = 0, limit = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return err;
  float2* part = static_cast<float2*>(partial);
  if (smem_bytes(d, 3) <= static_cast<size_t>(limit))
    return launch<3>(l, r, l2, r2, g, log_mu, tau, n_q, n_c, d, grid, max_splits, part,
                     counters, out, s);
  return launch<2>(l, r, l2, r2, g, log_mu, tau, n_q, n_c, d, grid, max_splits, part, counters,
                   out, s);
}
