"""The distributed trainer's host builders against the JAX package, array
for array: ``partition_edges`` (ungrouped and grouped), ``build_halo_ell``
and ``build_attr_incidence_ell``, at 1, 2 and 8 shards; and each shard's
cut of the stacked ELL (``StackedEll.shard``) against the stack's own
apply."""

import numpy as np
import pytest
import torch

from tpugraph.sparse.halo_ell import build_attr_incidence_ell as jax_attr_incidence
from tpugraph.sparse.halo_ell import build_halo_ell as jax_build_halo_ell
from tpugraph.sparse.partition import partition_edges as jax_partition_edges
from tpugraph_torch.dist.mp_worker import halo_graph
from tpugraph_torch.kernels.spmm_ell import apply_with_diag
from tpugraph_torch.sparse.build import coo_to_dense
from tpugraph_torch.sparse.halo_ell import build_attr_incidence_ell, build_halo_ell
from tpugraph_torch.sparse.partition import partition_edges

ARRAYS = ("loc_src", "loc_dst", "loc_w", "bnd_src", "bnd_dst", "bnd_w", "send_idx", "send_mask")
SCALARS = ("n_shards", "n_loc", "halo_b", "nnz", "n_rows", "n_groups", "has_halo")


def _two_components(n=96, t=400, seed=5):
    """A graph whose two halves share no edge (the grouped layout's input)."""
    src, dst, w = halo_graph(n // 2, t // 2, seed)
    return (np.concatenate([src, src + n // 2]), np.concatenate([dst, dst + n // 2]),
            np.concatenate([w, w]), n)


def _same(a, b, what):
    b = np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def _same_stacked(m, jm, what):
    assert len(m.buckets) == len(jm.buckets), what
    for i, (b, jb) in enumerate(zip(m.buckets, jm.buckets)):
        assert b.k == jb.k, f"{what} bucket {i}"
        _same(b.idx, jb.idx, f"{what} bucket {i} idx")
        _same(b.w, jb.w, f"{what} bucket {i} w")
    _same(m.row_order, jm.row_order, f"{what} row_order")
    assert (m.n_rows, m.nnz, m.n_cols) == (jm.n_rows, jm.nnz, jm.n_cols), what


@pytest.mark.parametrize("n_shards,n_groups", [(1, 1), (2, 1), (8, 1), (2, 2), (8, 2)])
def test_partition_and_halo_ell_equal_jax(n_shards, n_groups):
    src, dst, w, n = _two_components() if n_groups > 1 else (*halo_graph(), 96)
    hg = partition_edges(src, dst, w, n, n_shards, n_groups=n_groups)
    jhg = jax_partition_edges(src, dst, w, n, n_shards, n_groups=n_groups)
    for a in ARRAYS:
        _same(getattr(hg, a), getattr(jhg, a), a)
    for a in SCALARS:
        assert getattr(hg, a) == getattr(jhg, a), a
    assert hg.has_halo == (n_shards > n_groups)

    he, jhe = build_halo_ell(hg), jax_build_halo_ell(jhg)
    for name in ("loc", "bnd"):
        op, jop = getattr(he, name), getattr(jhe, name)
        _same_stacked(op.fwd, jop.fwd, f"{name}.fwd")
        _same_stacked(op.bwd, jop.bwd, f"{name}.bwd")
        if jop.diag is None:
            assert op.diag is None
        else:
            _same(op.diag, jop.diag, f"{name}.diag")
        assert op.n_diag == jop.n_diag
    for a in ("send_idx", "send_mask"):
        _same(getattr(he, a), getattr(jhe, a), a)
    for a in SCALARS:
        assert getattr(he, a) == getattr(jhe, a), a


def test_grouped_partition_refuses_a_crossing_edge():
    src, dst, w = halo_graph()
    with pytest.raises(ValueError, match="component-aligned"):
        partition_edges(src, dst, w, 96, 8, n_groups=2)
    with pytest.raises(ValueError, match="must divide"):
        partition_edges(src, dst, w, 96, 8, n_groups=3)


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_attr_incidence_equals_jax(n_shards):
    rng = np.random.default_rng(2)
    n_ent, n_attr = 96, 20
    triples = np.stack([rng.integers(0, n_ent, 400), rng.integers(0, n_attr, 400)], 1)
    n_loc = -(-n_ent // n_shards)
    inc = build_attr_incidence_ell(triples, n_ent, n_attr, n_shards, n_loc)
    jinc = jax_attr_incidence(triples, n_ent, n_attr, n_shards, n_loc)
    _same_stacked(inc.fwd, jinc.fwd, "fwd")
    _same_stacked(inc.bwd, jinc.bwd, "bwd")
    assert inc.diag is None and jinc.diag is None


@pytest.mark.parametrize("n_shards", [2, 8])
def test_each_shard_cut_applies_its_rows_of_the_graph(n_shards):
    """Shard s's local operator (with the diagonal) and boundary operator,
    and their transposes, as the port's EllMatrix: their plain apply
    equals the dense blocks of A (rows of shard s; columns: its own rows,
    or the receive buffer's slots through send_idx)."""
    src, dst, w = halo_graph()
    n = 96
    hg = partition_edges(src, dst, w, n, n_shards)
    he = build_halo_ell(hg)
    a = np.zeros((hg.n_loc * n_shards,) * 2)
    a[:n, :n] = coo_to_dense(src, dst, w, n, n)
    rng = np.random.default_rng(0)
    nl = hg.n_loc
    for s in range(n_shards):
        rows = slice(s * nl, (s + 1) * nl)
        loc, bnd = he.loc.shard(s), he.bnd.shard(s)
        # the receive buffer's slot (o, j) holds global row o·n_loc + send_idx[o, s, j]
        slot_rows = (np.arange(n_shards)[:, None] * nl + hg.send_idx[:, s]).reshape(-1)
        live = hg.send_mask[:, s].reshape(-1) > 0
        a_loc = a[rows, rows]
        a_bnd = np.where(live[None, :], a[rows][:, slot_rows], 0.0)
        for m, diag, dense in ((loc.fwd, loc.diag, a_loc), (loc.bwd, loc.diag, a_loc.T),
                               (bnd.fwd, None, a_bnd), (bnd.bwd, None, a_bnd.T)):
            x = torch.from_numpy(rng.standard_normal((m.n_cols, 4)).astype(np.float32))
            got = apply_with_diag(m, diag, x).numpy()
            want = dense @ x.numpy().astype(np.float64)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
