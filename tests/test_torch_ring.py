"""Ring mining, ring eval and the ring Sinkhorn OT of the distributed
trainer against the JAX package's ``ring_knn`` / ``ring_hits_at_k`` /
``ring_sinkhorn_potentials`` / ``ring_sinkhorn_align_loss`` (on the
conftest's 8 virtual CPU devices) and the port's single-device
``blockwise_knn_l1`` / ``hits_at_k`` / ``sinkhorn_potentials`` /
``sinkhorn_align_loss``, at 1, 3 and 8 shards on one gloo rank: the same
sorted id sets, Hits@k and MRR within abs 1e-6, raw and CSLS; the OT
within the JAX package's own bounds (``tests/test_ring.py``: potentials
rtol 1e-4 / atol 1e-5, loss rel 1e-4, gradient rtol 1e-3 / atol 1e-5).
Sizes that S does not divide, and 9 pairs on 8 shards."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugraph.dist.mesh import make_mesh as jax_make_mesh
from tpugraph.dist.ring import ring_hits_at_k as jax_ring_hits
from tpugraph.dist.ring import ring_knn as jax_ring_knn
from tpugraph.dist.ring import ring_sinkhorn_align_loss as jax_ring_ot_loss
from tpugraph.dist.ring import ring_sinkhorn_potentials as jax_ring_potentials
from tpugraph_torch.dist import ring
from tpugraph_torch.dist.mesh import make_mesh
from tpugraph_torch.dist.mp_worker import ot_pairs_of
from tpugraph_torch.kernels.sddmm import pairwise_dist
from tpugraph_torch.kernels.sinkhorn import sinkhorn_potentials
from tpugraph_torch.train.eval import dist_tile, hits_at_k
from tpugraph_torch.train.negatives import blockwise_knn_l1
from tpugraph_torch.train.ot import sinkhorn_align_loss


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


@pytest.mark.parametrize("metric", ["cityblock", "sqeuclidean"])
@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_ring_knn_csls_matches_jax_and_blockwise(n_shards, metric):
    q, c, ex = _data(3)
    c[:6] *= 0.05  # hub rows: CSLS must demote them
    tq, tc, tex = torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(ex)
    with make_mesh(n_shards, torch.device("cpu")) as mesh:
        got = ring.ring_knn(tq, tc, tex, 5, mesh, metric=metric, csls_k=7).numpy()
    want = blockwise_knn_l1(tq, tc, tex, 5, block_c=101, metric=metric, csls_k=7).numpy()
    np.testing.assert_array_equal(np.sort(got, 1), np.sort(want, 1))
    if n_shards == 8:
        jax_got = np.asarray(jax_ring_knn(jnp.asarray(q), jnp.asarray(c),
                                          jnp.asarray(ex, dtype=jnp.int32), 5,
                                          jax_make_mesh(8, 1), metric=metric, csls_k=7))
        np.testing.assert_array_equal(np.sort(got, 1), np.sort(jax_got, 1))


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_ring_hits_csls_matches_jax_and_blockwise(n_shards):
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((300, 16)).astype(np.float32)
    pairs = np.stack([rng.choice(150, 83, replace=False),
                      150 + rng.choice(150, 83, replace=False)], axis=1).astype(np.int32)
    with make_mesh(n_shards, torch.device("cpu")) as mesh:
        got = ring.ring_hits_at_k(torch.from_numpy(emb), pairs, mesh, csls_k=10)
    want = hits_at_k(torch.from_numpy(emb), pairs, block_c=64, csls_k=10)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    if n_shards == 8:
        jax_want = jax_ring_hits(jnp.asarray(emb), pairs, jax_make_mesh(8, 1), csls_k=10)
        for k in want:
            assert got[k] == pytest.approx(jax_want[k], abs=1e-6), k


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


@pytest.mark.parametrize("s", [45, 9])
@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_ring_sinkhorn_potentials_match_jax_and_single_device(n_shards, s):
    rng = np.random.default_rng(2)
    l = rng.standard_normal((s, 8)).astype(np.float32)
    r = rng.standard_normal((s, 8)).astype(np.float32)
    tl, tr = torch.from_numpy(l), torch.from_numpy(r)
    with make_mesh(n_shards, torch.device("cpu")) as mesh:
        f, g = ring.ring_sinkhorn_potentials(tl, tr, mesh, tau=0.1, n_iters=25)
    cost = pairwise_dist(_unit(tl), _unit(tr), metric="sqeuclidean")
    tol = dict(rtol=1e-4, atol=1e-5)
    for got, want in zip((f, g), sinkhorn_potentials(cost, tau=0.1, n_iters=25)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)
    if n_shards == 8:
        jf, jg = jax_ring_potentials(jnp.asarray(l), jnp.asarray(r), jax_make_mesh(8, 1),
                                     tau=0.1, n_iters=25)
        np.testing.assert_allclose(f.numpy(), np.asarray(jf), **tol)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **tol)


@pytest.mark.parametrize("s", [37, 9])
@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_ring_sinkhorn_loss_and_grad_match_jax_and_single_device(n_shards, s):
    """Value and gradient (the exact gradient of the unrolled solver) of
    the ring loss, one rank holding the shards; 9 pairs on 8 shards leave
    shards without a real row."""
    emb, pairs = ot_pairs_of(s, 3)
    x = emb.clone().requires_grad_()
    with make_mesh(n_shards, torch.device("cpu")) as mesh:
        got = ring.ring_sinkhorn_align_loss(x, pairs, mesh, tau=0.1, n_iters=12)
        got.backward()  # the backward's passes and gathers run on the group
    y = emb.clone().requires_grad_()
    want = sinkhorn_align_loss(y, pairs, tau=0.1, n_iters=12)
    want.backward()
    assert torch.isfinite(x.grad).all()
    assert got.item() == pytest.approx(want.item(), rel=1e-4)
    tol = dict(rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), **tol)
    if n_shards == 8:
        mesh8, jp = jax_make_mesh(8, 1), jnp.asarray(pairs.numpy(), dtype=jnp.int32)

        def jax_loss(e):
            return jax_ring_ot_loss(e, jp, mesh8, tau=0.1, n_iters=12)

        j_val, j_grad = jax.jit(jax.value_and_grad(jax_loss))(jnp.asarray(emb.numpy()))
        assert got.item() == pytest.approx(float(j_val), rel=1e-4)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_grad), **tol)


def test_unported_ring_stages_refuse():
    q, c, ex = map(torch.from_numpy, _data())
    with make_mesh(2, torch.device("cpu")) as mesh:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            ring.ring_knn(q, c, ex, 5, mesh, approx=True)
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            ring.ring_hits_at_k(c, np.array([[0, 60]]), mesh, approx_k=16)
        with pytest.raises(ValueError, match="n_iters"):
            ring.ring_sinkhorn_align_loss(c, torch.tensor([[0, 60]]), mesh, n_iters=0)
        with pytest.raises(ValueError, match="n_iters"):
            ring.ring_sinkhorn_potentials(c, c, mesh, n_iters=0)
