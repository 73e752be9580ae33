"""The approximate ring stages of the distributed trainer
(``tpugraph_torch/dist/ring.py``: ``ring_knn(approx=True)``,
``ring_hits_at_k(approx_k=...)`` and the hubness pair
``_ring_hubness_approx``) on one gloo rank holding the shards:

* against the JAX ring on the conftest's 8 virtual devices (its
  ``approx_min_k`` is exact on the CPU): the same sets on ≥ 99 % of rows,
  Hits@k and MRR within 1e-3, raw and CSLS, both mining metrics;
* at 1, 3 and 8 shards against the port's single-device approximate
  callers (``blockwise_knn_l1(approx=True)``, ``hits_at_k(approx_k=...)``)
  and the exact ring at the JAX tests' thresholds and shapes: mining
  recall ≥ 0.8 (``tests/test_ring.py:113-142``), Hits@k and MRR within
  0.02 at ``tests/test_eval_approx.py:37-46``'s 600 pairs and shortlists
  of 128; the hubness pair equal to the single-device one;
* a pool smaller than k: a numpy oracle (the JAX ring's 1e17 sentinel rows
  come back as out-of-range ids there, ROADMAP.md Queue C 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugraph.dist.mesh import make_mesh as jax_make_mesh
from tpugraph.dist.ring import ring_hits_at_k as jax_ring_hits
from tpugraph.dist.ring import ring_knn as jax_ring_knn
from tpugraph_torch.dist import ring
from tpugraph_torch.dist.mesh import make_mesh
from tpugraph_torch.train.eval import hits_at_k
from tpugraph_torch.train.negatives import _hubness_both_approx, blockwise_knn_l1

CPU = torch.device("cpu")


def _recall(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean([len(set(x) & set(y)) / len(y) for x, y in zip(a, b)]))


def _same_rows(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean([set(x) == set(y) for x, y in zip(a, b)]))


def _mining_data(seed: int = 5):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((96, 16)).astype(np.float32)
    c = rng.standard_normal((640, 16)).astype(np.float32)
    c[:8] *= 0.05  # hub rows: CSLS must demote them
    return q, c, rng.integers(0, 640, 96)


@pytest.mark.parametrize("csls_k", [0, 5])
@pytest.mark.parametrize("metric", ["cityblock", "sqeuclidean"])
@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_ring_knn_approx_matches_jax_and_single_device(n_shards, metric, csls_k):
    q, c, ex = _mining_data()
    tq, tc, tex = torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(ex)
    kw = dict(metric=metric, csls_k=csls_k)
    with make_mesh(n_shards, CPU) as mesh:
        got = ring.ring_knn(tq, tc, tex, 8, mesh, approx=True, **kw).numpy()
        exact = ring.ring_knn(tq, tc, tex, 8, mesh, **kw).numpy()
    single = blockwise_knn_l1(tq, tc, tex, 8, approx=True, **kw).numpy()
    assert not (got == ex[:, None]).any()
    assert _recall(got, exact) >= 0.8
    assert _recall(got, single) >= 0.8
    if n_shards == 8:  # the JAX ring's hops are the same eight blocks
        want = np.asarray(jax_ring_knn(jnp.asarray(q), jnp.asarray(c),
                                       jnp.asarray(ex, dtype=jnp.int32), 8,
                                       jax_make_mesh(8, 1), approx=True, **kw))
        assert _same_rows(got, want) >= 0.99


def _eval_data(seed: int = 8):
    """``tests/test_ring.py``'s ring-eval data: 120 test pairs of 400 rows,
    hubs among the right rows."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((200, 16)).astype(np.float32)
    emb = np.concatenate([base, base + 0.3 * rng.standard_normal((200, 16)).astype(np.float32)])
    emb[200:208] *= 0.05  # hubs
    pairs = np.stack([rng.choice(200, 120, replace=False),
                      200 + rng.choice(200, 120, replace=False)], 1).astype(np.int32)
    return emb, pairs


@pytest.mark.parametrize("csls_k", [0, 7])
def test_ring_hits_approx_matches_jax(csls_k):
    emb, pairs = _eval_data()
    with make_mesh(8, CPU) as mesh:
        got = ring.ring_hits_at_k(torch.from_numpy(emb), pairs, mesh, csls_k=csls_k,
                                  approx_k=16)
    want = jax_ring_hits(jnp.asarray(emb), pairs, jax_make_mesh(8, 1), csls_k=csls_k,
                         approx_k=16)
    for k in ("hits@1", "hits@10", "mrr", "hits@1_l2r", "mrr_r2l"):
        assert got[k] == pytest.approx(want[k], abs=1e-3), k


def _trained_like(seed: int, n_test: int, dim: int, noise: float):
    """``tests/test_eval_approx.py``'s data: matched entities as noisy
    copies, the first 5 % of the right rows hubs."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n_test, dim)).astype(np.float32)
    left = base + noise * rng.normal(size=(n_test, dim)).astype(np.float32)
    right = base + noise * rng.normal(size=(n_test, dim)).astype(np.float32)
    right[: n_test // 20] *= 0.05
    pairs = np.stack([np.arange(n_test), n_test + np.arange(n_test)], 1)
    return np.concatenate([left, right], 0), pairs


@pytest.mark.parametrize("csls_k", [0, 10])
@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_ring_hits_approx_tracks_the_single_device_eval_and_exact(n_shards, csls_k):
    """At the single-device approximate test's shape (600 pairs, d 48,
    shortlists of 128): within its 0.02 of the exact ring and of the
    single-device ``hits_at_k(approx_k=128)``."""
    emb, pairs = _trained_like(1, 600, 48, 0.8)
    te = torch.from_numpy(emb)
    with make_mesh(n_shards, CPU) as mesh:
        got = ring.ring_hits_at_k(te, pairs, mesh, csls_k=csls_k, approx_k=128)
        exact = ring.ring_hits_at_k(te, pairs, mesh, csls_k=csls_k)
    single = hits_at_k(te, pairs, csls_k=csls_k, approx_k=128)
    for k in ("hits@1", "hits@10", "mrr"):
        assert got[k] == pytest.approx(exact[k], abs=0.02), k
        assert got[k] == pytest.approx(single[k], abs=0.02), k


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_ring_hubness_approx_equals_the_single_device_pair(n_shards):
    """Each candidate's csls_k nearest queries by d₂, merged over the query
    blocks, are the single-device selection over the whole pool: the same
    (r_sq, r_l1) up to the sums' order; padding rows 0."""
    emb, pairs = _eval_data(9)
    q, cands = torch.from_numpy(emb[pairs[:, 0]]), torch.from_numpy(emb[pairs[:, 1]])
    want = _hubness_both_approx(q, cands, 7)
    with make_mesh(n_shards, CPU) as mesh:
        r_sq, r_l1 = ring._ring_hubness_approx(cands, q, 7, mesh)
    for got, w in zip((r_sq, r_l1), want):
        torch.testing.assert_close(got[:len(w)], w, rtol=1e-5, atol=1e-5)
        assert not got[len(w):].any()


def _oracle_knn(q: np.ndarray, c: np.ndarray, ex: np.ndarray, k: int,
                metric: str) -> np.ndarray:
    """The k nearest real candidates by ``metric`` in float64, the partner
    masked, the columns past the pool filled with the row's best."""
    diff = q[:, None, :].astype(np.float64) - c[None, :, :]
    d = np.abs(diff).sum(-1) if metric == "cityblock" else (diff * diff).sum(-1)
    d[np.arange(len(q)), ex] = np.inf
    d = np.concatenate([d, np.full((len(q), max(0, k - c.shape[0])), np.inf)], axis=1)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    ok = np.take_along_axis(d, order, 1) < np.inf
    return np.where(ok, order, order[:, :1])


@pytest.mark.parametrize("metric", ["cityblock", "sqeuclidean"])
def test_a_pool_smaller_than_k_fills_with_the_best(metric):
    """Three candidates for k = 5 over 8 shards (five blocks hold only
    padding): the port masks padding by index and fills, where the JAX ring
    returns its sentinel rows' ids (ROADMAP.md Queue C 3)."""
    q, c, ex = _mining_data(1)
    c3, ex3 = c[:3], ex % 3
    with make_mesh(8, CPU) as mesh:
        got = ring.ring_knn(torch.from_numpy(q), torch.from_numpy(c3), torch.from_numpy(ex3), 5,
                            mesh, metric=metric, approx=True).numpy()
    np.testing.assert_array_equal(got, _oracle_knn(q, c3, ex3, 5, metric))
    assert got.max() < 3 and not (got == ex3[:, None]).any()
