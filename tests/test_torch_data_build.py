"""Port parity: synthetic data, adjacency build and ELL operator
(tpugraph_torch.data / sparse) against the JAX package on identical seeds."""

import numpy as np
import pytest

from tpugraph import native
from tpugraph.data.synthetic import synthetic_align_task as jax_task
from tpugraph.sparse.build import build_adjacency as jax_build_adjacency
from tpugraph.sparse.build import coo_from_triples as jax_coo
from tpugraph.sparse.build import coo_normalize as jax_norm
from tpugraph.sparse.ell import build_ell_operator as jax_ell_operator
from tpugraph_torch.data.synthetic import synthetic_align_task
from tpugraph_torch.sparse.build import build_adjacency, coo_from_triples, coo_normalize
from tpugraph_torch.sparse.ell import build_ell, build_ell_operator


@pytest.mark.parametrize("seed,kw", [
    (0, {}),
    (3, {"n_pairs": 150, "attr_coverage": 0.6}),
    (7, {"alpha": 1.2, "noise_frac": 0.0}),
])
def test_synthetic_task_identical(seed, kw):
    a = jax_task(seed=seed, n_ent=300, n_rel=11, n_triples=1200, **kw)
    b = synthetic_align_task(seed=seed, n_ent=300, n_rel=11, n_triples=1200, **kw)
    np.testing.assert_array_equal(a.merged_triples, b.merged_triples)
    np.testing.assert_array_equal(a.merged_attr_triples, b.merged_attr_triples)
    np.testing.assert_array_equal(a.train_pairs, b.train_pairs)
    np.testing.assert_array_equal(a.test_pairs, b.test_pairs)
    assert (a.n_ent, a.n_rel, a.n_attr, a.name) == (b.n_ent, b.n_rel, b.n_attr, b.name)


def _assert_ell_equal(jm, tm):
    assert (jm.n_rows, jm.nnz, jm.n_cols) == (tm.n_rows, tm.nnz, tm.n_cols)
    np.testing.assert_array_equal(np.asarray(jm.row_order), tm.row_order.numpy())
    assert [b.k for b in jm.buckets] == [b.k for b in tm.buckets]
    for jb, tb in zip(jm.buckets, tm.buckets):
        np.testing.assert_array_equal(np.asarray(jb.rows), tb.rows.numpy())
        np.testing.assert_array_equal(np.asarray(jb.idx), tb.idx.numpy())
        np.testing.assert_array_equal(np.asarray(jb.w), tb.w.numpy())


@pytest.mark.parametrize("weighting", ["uniform", "funifun"])
@pytest.mark.parametrize("norm", ["sym", "rw", "none"])
def test_build_adjacency_matches(weighting, norm):
    task = synthetic_align_task(seed=1, n_ent=250, n_rel=9, n_triples=900)
    tri = task.merged_triples
    kw = dict(n_rel=task.n_rel, weighting=weighting)
    # COO weights are exact: same float64 numpy arithmetic
    s1, d1, w1 = jax_coo(task.n_ent, tri, **kw)
    s2, d2, w2 = coo_from_triples(task.n_ent, tri, **kw)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(jax_norm(s1, d1, w1, task.n_ent, norm),
                                  coo_normalize(s2, d2, w2, task.n_ent, norm))
    # and agree with the native builder to its own tolerance
    if native.available():
        ns, nd, nw = native.native_coo_from_triples(task.n_ent, tri, norm=norm, **kw)
        order = np.lexsort((s2, d2))
        np.testing.assert_array_equal(s2[order], ns)
        np.testing.assert_array_equal(d2[order], nd)
        np.testing.assert_allclose(coo_normalize(s2, d2, w2, task.n_ent, norm)[order], nw,
                                   rtol=1e-6)

    jop = jax_build_adjacency(task.n_ent, tri, norm=norm, use_native=False, fmt="ell", **kw)
    top = build_adjacency(task.n_ent, tri, norm=norm, use_native=False, **kw)
    _assert_ell_equal(jop.fwd, top.fwd)
    _assert_ell_equal(jop.bwd, top.bwd)
    np.testing.assert_array_equal(np.asarray(jop.diag), top.diag.numpy())
    assert jop.n_diag == top.n_diag and jop.nnz == top.nnz


def test_ell_operator_without_split_and_rectangular():
    rng = np.random.default_rng(4)
    src = rng.integers(0, 40, 300)
    dst = rng.integers(0, 25, 300)
    w = rng.standard_normal(300)
    jop = jax_ell_operator(src, dst, w, 25, n_cols=40)
    top = build_ell_operator(src, dst, w, 25, n_cols=40)
    _assert_ell_equal(jop.fwd, top.fwd)
    _assert_ell_equal(jop.bwd, top.bwd)
    assert top.diag is None


def test_build_ell_rejects_out_of_range_ids():
    src = np.array([0, 5])
    dst = np.array([1, 2])
    with pytest.raises(ValueError, match="out of range"):
        build_ell(src, dst, np.ones(2), n_rows=4)
    with pytest.raises(ValueError, match="out of range"):
        build_ell(np.array([-1, 0]), dst, np.ones(2), n_rows=4)
