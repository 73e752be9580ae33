"""Ring mining and ring eval of the distributed trainer against the JAX
package's ``ring_knn`` / ``ring_hits_at_k`` (on the conftest's 8 virtual
CPU devices) and the port's single-device ``blockwise_knn_l1`` /
``hits_at_k``, at 1, 3 and 8 shards on one gloo rank: the same sorted id
sets, Hits@k and MRR within abs 1e-6.  Sizes that S does not divide."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugraph.dist.mesh import make_mesh as jax_make_mesh
from tpugraph.dist.ring import ring_hits_at_k as jax_ring_hits
from tpugraph.dist.ring import ring_knn as jax_ring_knn
from tpugraph_torch.dist import ring
from tpugraph_torch.dist.mesh import make_mesh
from tpugraph_torch.train.eval import dist_tile, hits_at_k
from tpugraph_torch.train.negatives import blockwise_knn_l1


def _data(seed=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((37, 8)).astype(np.float32)
    c = rng.standard_normal((101, 8)).astype(np.float32)
    ex = rng.integers(0, 101, 37)
    return q, c, ex


@pytest.mark.parametrize("metric", ["cityblock", "sqeuclidean"])
@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_ring_knn_matches_jax_and_blockwise(n_shards, metric):
    q, c, ex = _data()
    tq, tc, tex = torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(ex)
    with make_mesh(n_shards, torch.device("cpu")) as mesh:
        got = ring.ring_knn(tq, tc, tex, 5, mesh, metric=metric).numpy()
    want = blockwise_knn_l1(tq, tc, tex, 5, block_c=32, metric=metric).numpy()
    np.testing.assert_array_equal(np.sort(got, 1), np.sort(want, 1))
    if n_shards == 8:  # the JAX ring on the conftest's eight devices
        jax_got = np.asarray(jax_ring_knn(jnp.asarray(q), jnp.asarray(c),
                                          jnp.asarray(ex, dtype=jnp.int32), 5,
                                          jax_make_mesh(8, 1), metric=metric))
        np.testing.assert_array_equal(np.sort(got, 1), np.sort(jax_got, 1))
    assert not (got == ex[:, None]).any()


def test_ring_knn_ties_go_to_the_lower_index_and_small_pools_fill():
    """Duplicate candidates tie exactly: each row is the k least by
    (distance, global index) at every shard count, so of a duplicate pair
    cut by the k-th place the lower index stays.  A pool smaller than k
    fills the missing columns with the row's best, as
    ``blockwise_knn_l1`` does."""
    q, c, ex = _data(2)
    c[50:] = c[:51]  # candidate 50 + i duplicates candidate i
    tq, tc, tex = torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(ex % 50)
    d = dist_tile(tq, tc).numpy()
    d[np.arange(len(q)), ex % 50] = np.inf
    idx = np.broadcast_to(np.arange(len(c)), d.shape)
    want = np.stack([i[np.lexsort((i, r))][:5] for i, r in zip(idx, d)])
    for s in (1, 4, 8):
        with make_mesh(s, torch.device("cpu")) as mesh:
            got = ring.ring_knn(tq, tc, tex, 5, mesh)
            tiny = ring.ring_knn(tq, tc[:3], tex % 3, 5, mesh)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(s))
        np.testing.assert_array_equal(
            tiny.numpy(), blockwise_knn_l1(tq, tc[:3], tex % 3, 5).numpy())


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_ring_hits_matches_jax_and_blockwise(n_shards):
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((300, 16)).astype(np.float32)
    pairs = np.stack([rng.choice(150, 83, replace=False),
                      150 + rng.choice(150, 83, replace=False)], axis=1).astype(np.int32)
    with make_mesh(n_shards, torch.device("cpu")) as mesh:
        got = ring.ring_hits_at_k(torch.from_numpy(emb), pairs, mesh)
    want = hits_at_k(torch.from_numpy(emb), pairs, block_c=64)
    jax_want = jax_ring_hits(jnp.asarray(emb), pairs, jax_make_mesh(8, 1))
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
        assert got[k] == pytest.approx(jax_want[k], abs=1e-6), k


def test_unported_ring_stages_refuse():
    q, c, ex = map(torch.from_numpy, _data())
    with make_mesh(2, torch.device("cpu")) as mesh:
        for kw in (dict(csls_k=5), dict(approx=True)):
            with pytest.raises(NotImplementedError, match="ROADMAP.md"):
                ring.ring_knn(q, c, ex, 5, mesh, **kw)
        for kw in (dict(csls_k=5), dict(approx_k=16)):
            with pytest.raises(NotImplementedError, match="ROADMAP.md"):
                ring.ring_hits_at_k(c, np.array([[0, 60]]), mesh, **kw)
    for fn in (ring.ring_sinkhorn_align_loss, ring.ring_sinkhorn_potentials):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            fn(c, c, None)
