// Native graph builder: triples -> weighted, normalized, (dst,src)-sorted COO.
//
// The port's own copy of the JAX package's host builder
// (tpugraph/native/graphbuild.cpp): the full adjacency pipeline (funifun
// relation-functionality weighting, duplicate accumulation, self-loops,
// degree normalization, CSR-order sort) in one pass over the edge list.
// It runs on the host, not on the card.
//
// C ABI exposed for ctypes (tpugraph_torch/native/__init__.py); semantics
// match tpugraph_torch.sparse.build.coo_from_triples + coo_normalize, which
// tests/test_torch_native.py asserts.  Built with g++ at first use
// (native/__init__.py::build).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>

namespace {

struct Edge {
  int64_t key;  // dst * n_ent + src
  double w;
};

}  // namespace

extern "C" {

// Pass 1: count output edges after dedup (+ optional self loops).
// Pass 2 (emit=1): fill src/dst/w output arrays (caller-allocated, size from
// pass 1).  Returns the deduplicated edge count, or -1 on bad args.
//
// weighting: 0 = uniform (binary), 1 = funifun (floor w_min)
// norm:      0 = none, 1 = rw (D^-1 A), 2 = sym (D_in^-1/2 A D_out^-1/2)
int64_t build_adjacency_coo(
    const int32_t* triples,  // (n_triples, 3) row-major [h, r, t]
    int64_t n_triples,
    int64_t n_ent,
    int64_t n_rel,
    int32_t weighting,
    double w_min,
    int32_t self_loops,
    double self_loop_w,
    int32_t norm,
    int32_t emit,
    int64_t out_capacity,
    int64_t* out_src,
    int64_t* out_dst,
    double* out_w) {
  if (n_ent <= 0 || n_triples < 0) return -1;

  // Entity-id bounds: EVERY downstream structure indexes by h/t — the
  // (dst*n_ent + src) sort key, the funifun per-relation histograms, and
  // the degree accumulators — so an out-of-range id from a malformed
  // dataset would be an out-of-bounds WRITE (heap corruption), not a wrong
  // answer.  Reject up front; the ctypes wrapper turns -1 into a
  // ValueError.
  for (int64_t i = 0; i < n_triples; ++i) {
    const int32_t h = triples[3 * i], t = triples[3 * i + 2];
    if (h < 0 || h >= n_ent || t < 0 || t >= n_ent) return -1;
  }

  // relation functionality stats
  std::vector<double> fun, ifun;
  if (weighting == 1) {
    std::vector<int64_t> counts(n_rel, 0);
    std::vector<int64_t> hr(n_triples), tr(n_triples);
    for (int64_t i = 0; i < n_triples; ++i) {
      const int32_t h = triples[3 * i], r = triples[3 * i + 1], t = triples[3 * i + 2];
      if (r < 0 || r >= n_rel) return -1;
      counts[r]++;
      hr[i] = (int64_t)r * n_ent + h;
      tr[i] = (int64_t)r * n_ent + t;
    }
    std::sort(hr.begin(), hr.end());
    std::sort(tr.begin(), tr.end());
    std::vector<int64_t> nheads(n_rel, 0), ntails(n_rel, 0);
    for (int64_t i = 0; i < n_triples; ++i) {
      if (i == 0 || hr[i] != hr[i - 1]) nheads[hr[i] / n_ent]++;
      if (i == 0 || tr[i] != tr[i - 1]) ntails[tr[i] / n_ent]++;
    }
    fun.resize(n_rel);
    ifun.resize(n_rel);
    for (int64_t r = 0; r < n_rel; ++r) {
      fun[r] = counts[r] ? (double)nheads[r] / counts[r] : 0.0;
      ifun[r] = counts[r] ? (double)ntails[r] / counts[r] : 0.0;
    }
  }

  // expand triples to directed message edges (skip reflexive)
  std::vector<Edge> edges;
  edges.reserve(2 * n_triples);
  for (int64_t i = 0; i < n_triples; ++i) {
    const int64_t h = triples[3 * i], r = triples[3 * i + 1], t = triples[3 * i + 2];
    if (h == t) continue;
    const double wht = weighting == 1 ? ifun[r] : 1.0;
    const double wth = weighting == 1 ? fun[r] : 1.0;
    edges.push_back({t * n_ent + h, wht});  // h -> t  (dst=t, src=h)
    edges.push_back({h * n_ent + t, wth});  // t -> h
  }

  // sort by (dst, src) key and accumulate duplicates
  std::sort(edges.begin(), edges.end(),
            [](const Edge& a, const Edge& b) { return a.key < b.key; });
  int64_t m = 0;
  for (int64_t i = 0; i < (int64_t)edges.size();) {
    int64_t j = i;
    double acc = 0.0;
    while (j < (int64_t)edges.size() && edges[j].key == edges[i].key) acc += edges[j++].w;
    if (weighting == 1) acc = std::max(acc, w_min);
    else acc = 1.0;  // uniform: binary adjacency
    edges[m++] = {edges[i].key, acc};
    i = j;
  }
  edges.resize(m);

  if (self_loops) {
    for (int64_t v = 0; v < n_ent; ++v) edges.push_back({v * n_ent + v, self_loop_w});
    std::sort(edges.begin(), edges.end(),
              [](const Edge& a, const Edge& b) { return a.key < b.key; });
  }
  const int64_t total = (int64_t)edges.size();
  if (!emit) return total;
  if (out_capacity < total) return -1;

  // normalization degrees
  std::vector<double> deg_in, deg_out;
  if (norm != 0) {
    deg_in.assign(n_ent, 0.0);
    deg_out.assign(n_ent, 0.0);
    for (const Edge& e : edges) {
      deg_in[e.key / n_ent] += e.w;
      deg_out[e.key % n_ent] += e.w;
    }
  }
  for (int64_t i = 0; i < total; ++i) {
    const int64_t dst = edges[i].key / n_ent, src = edges[i].key % n_ent;
    double w = edges[i].w;
    if (norm == 1) {
      w = deg_in[dst] > 0 ? w / deg_in[dst] : 0.0;
    } else if (norm == 2) {
      const double a = deg_in[dst] > 0 ? 1.0 / std::sqrt(deg_in[dst]) : 0.0;
      const double b = deg_out[src] > 0 ? 1.0 / std::sqrt(deg_out[src]) : 0.0;
      w = w * a * b;
    }
    out_src[i] = src;
    out_dst[i] = dst;
    out_w[i] = w;
  }
  return total;
}

}  // extern "C"
