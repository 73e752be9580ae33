"""The OT head's reverse update (``kernels/sinkhorn_fused.py::sinkhorn_reverse``,
the hand kernel ``csrc/sinkhorn_reverse.cu`` on the card) on the host: its
plain version in both modes and on a strided column block against
``train/ot.py::_reverse_update``; the kernel's per-tile partial sums of b̄,
replayed in torch, against the one-pass sum (rel 1e-6); the whole sweep
against ``jax.grad`` of the JAX package's ``sinkhorn_align_loss`` (value
rel 1e-3, gradient relative L2 1e-3: ``tests/test_torch_sinkhorn.py``'s
bounds) and the ring's at 1, 3 and 8 shards against ``jax.grad`` of
``ring_sinkhorn_align_loss`` (gradient rtol 1e-3 / atol 1e-5:
``tests/test_ring.py``'s bounds)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugraph.dist.mesh import make_mesh as jax_make_mesh
from tpugraph.dist.ring import ring_sinkhorn_align_loss as jax_ring_ot_loss
from tpugraph.train.ot import sinkhorn_align_loss as jax_sinkhorn_loss
from tpugraph_torch.dist import ring
from tpugraph_torch.dist.mesh import make_mesh
from tpugraph_torch.dist.mp_worker import ot_pairs_of
from tpugraph_torch.kernels import sinkhorn_fused
from tpugraph_torch.train.ot import _reverse_update, sinkhorn_align_loss

TAU = 0.1


def _block(seed: int, q: int, c: int, rows: bool, extra: int = 0):
    """A cost (q, c + extra) of unit rows' squared distances, C̄ beside it,
    and an update's b, out (its potentials) and ō for a (q, c) block."""
    rng = np.random.default_rng(seed)
    l = rng.standard_normal((q, 8))
    r = rng.standard_normal((c + extra, 8))
    l /= np.linalg.norm(l, axis=1, keepdims=True)
    r /= np.linalg.norm(r, axis=1, keepdims=True)
    cost = np.maximum(2.0 - 2.0 * l @ r.T, 0.0)
    n_b, n_o = (c, q) if rows else (q, c)
    b = 0.1 * rng.standard_normal(n_b)
    out = 0.1 * rng.standard_normal(n_o)
    ob = rng.standard_normal(n_o) / n_o
    cbar = 1e-3 * rng.standard_normal(cost.shape)
    return [torch.from_numpy(a.astype(np.float32)) for a in (cost, cbar, b, out, ob)]


@pytest.mark.parametrize("rows", [True, False])
@pytest.mark.parametrize("strided", [False, True])
def test_block_update_plain_matches_reverse_update(rows, strided):
    """The plain version on a column block of a wider C̄ (offset 5, the
    ring's layout) against ``_reverse_update`` on a contiguous copy: the
    same C̄ and b̄; the columns outside the block untouched; both within
    rel 1e-6 of float64."""
    q, c, off = 37, 50, 5 if strided else 0
    cost, cbar, b, out, ob = _block(1, q, c, rows, extra=12 if strided else 0)
    log_m = -math.log(q)
    lse = log_m - out / TAU
    whole = cbar.clone()
    got = sinkhorn_fused.sinkhorn_reverse_plain(whole[:, off:off + c], cost[:, off:off + c], b,
                                                lse, ob, TAU, rows)
    blk = cbar[:, off:off + c].clone()
    want = _reverse_update(blk, cost[:, off:off + c].contiguous(), b, out, ob, log_m, TAU, rows)
    assert torch.equal(got, want) and torch.equal(whole[:, off:off + c], blk)
    outside = torch.ones_like(cbar, dtype=torch.bool)
    outside[:, off:off + c] = False
    assert torch.equal(whole[outside], cbar[outside])
    c64 = cost[:, off:off + c].double()
    z = ((b.double()[None, :] if rows else b.double()[:, None]) - c64) / TAU
    p = torch.exp(z - (lse.double()[:, None] if rows else lse.double()[None, :]))
    t = p * (ob.double()[:, None] if rows else ob.double()[None, :])
    b64 = -t.sum(0 if rows else 1)
    assert float((got.double() - b64).norm() / b64.norm()) < 1e-6
    c_want = cbar[:, off:off + c].double() + t
    assert float((blk.double() - c_want).norm() / c_want.norm()) < 1e-6


@pytest.mark.parametrize("rows", [True, False])
def test_the_kernels_tile_sums_replay_the_one_pass_sum(rows):
    """b̄ as the kernel sums it: each tile of REV_TILE_Q rows (rows mode) or
    REV_TILE_C columns (columns mode) sums its part in order, then the
    tiles' partials are added in tile order; within rel 1e-6 of the
    one-pass sum, on a block that neither tile divides."""
    q, c = 3 * sinkhorn_fused.REV_TILE_Q + 7, 2 * sinkhorn_fused.REV_TILE_C + 9
    cost, cbar, b, out, ob = _block(2, q, c, rows)
    lse = -math.log(q) - out / TAU
    want_c = cbar.clone()
    want = sinkhorn_fused.sinkhorn_reverse_plain(want_c, cost, b, lse, ob, TAU, rows)
    if rows:
        t = ((b[None, :] - cost) / TAU - lse[:, None]).exp() * ob[:, None]
        tiles = t.split(sinkhorn_fused.REV_TILE_Q, dim=0)
        partial = [tile.cumsum(0)[-1] for tile in tiles]  # a thread's column, row by row
    else:
        t = ((b[:, None] - cost) / TAU - lse[None, :]).exp() * ob[None, :]
        tiles = t.split(sinkhorn_fused.REV_TILE_C, dim=1)
        # a tile's row: each warp's 32 columns, then the 8 warps in order
        partial = [torch.stack([w.sum(1) for w in tile.split(32, dim=1)]).cumsum(0)[-1]
                   for tile in tiles]
    got = -torch.stack(partial).cumsum(0)[-1]
    assert len(tiles) > 1
    assert float((got - want).norm() / want.norm()) < 1e-6
    assert torch.equal(cbar + t, want_c)


@pytest.mark.parametrize("tau", [0.1, 0.3])
def test_the_sweep_matches_jax(tau):
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((160, 24)).astype(np.float32)
    pairs = np.stack([rng.permutation(80)[:48], 80 + rng.permutation(80)[:48]], 1)
    jfn = lambda e: jax_sinkhorn_loss(e, jnp.asarray(pairs, dtype=jnp.int32), tau=tau,
                                      n_iters=12, block_q=16)
    want, g_want = jax.value_and_grad(jfn)(jnp.asarray(emb))
    e = torch.from_numpy(emb).requires_grad_(True)
    got = sinkhorn_align_loss(e, torch.from_numpy(pairs).long(), tau=tau, n_iters=12)
    got.backward()
    g_want = np.asarray(g_want)
    assert got.item() == pytest.approx(float(want), rel=1e-3)
    assert np.linalg.norm(e.grad.numpy() - g_want) / np.linalg.norm(g_want) < 1e-3


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_the_ring_sweep_matches_jax(n_shards):
    emb, pairs = ot_pairs_of(37, 3)
    x = emb.clone().requires_grad_()
    with make_mesh(n_shards, torch.device("cpu")) as mesh:
        got = ring.ring_sinkhorn_align_loss(x, pairs, mesh, tau=TAU, n_iters=12)
        got.backward()
    jp = jnp.asarray(pairs.numpy(), dtype=jnp.int32)
    jmesh = jax_make_mesh(n_shards, 1)

    def jax_loss(e):
        return jax_ring_ot_loss(e, jp, jmesh, tau=TAU, n_iters=12)

    j_val, j_grad = jax.jit(jax.value_and_grad(jax_loss))(jnp.asarray(emb.numpy()))
    assert got.item() == pytest.approx(float(j_val), rel=1e-4)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_grad), rtol=1e-3, atol=1e-5)
