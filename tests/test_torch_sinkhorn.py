"""Port parity for the OT head: pairwise distances, the Sinkhorn solver,
the fused potential update's plain version and the Sinkhorn loss
(tpugraph_torch) against the JAX package on the same inputs.

Torch runs on one thread here: its threaded CPU reductions change the
summation order from run to run, and exp(−C/τ) amplifies that.  The CUDA
kernel itself is held against the plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugraph.kernels.sddmm import pairwise_dist as jax_pairwise_dist
from tpugraph.kernels.sinkhorn import sinkhorn_plan as jax_sinkhorn_plan
from tpugraph.kernels.sinkhorn import sinkhorn_potentials as jax_sinkhorn_potentials
from tpugraph.kernels.sinkhorn_pallas import sinkhorn_potential_update as jax_pallas_update
from tpugraph.train.ot import sinkhorn_align_loss as jax_sinkhorn_loss
from tpugraph_torch.kernels import sinkhorn_fused
from tpugraph_torch.kernels.sddmm import pairwise_dist
from tpugraph_torch.kernels.sinkhorn import sinkhorn_plan, sinkhorn_potentials
from tpugraph_torch.kernels.sinkhorn_fused import (sinkhorn_potential_update,
                                                   sinkhorn_potentials_fused,
                                                   sinkhorn_update_plain)
from tpugraph_torch.train.ot import sinkhorn_align_loss, sinkhorn_align_loss_plain


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("metric", ["sqeuclidean", "cityblock"])
def test_pairwise_dist_matches_jax(metric):
    rng = np.random.default_rng(0)
    q, c = rng.standard_normal((70, 12)).astype(np.float32), rng.standard_normal((45, 12))
    c = c.astype(np.float32)
    want = np.asarray(jax_pairwise_dist(jnp.asarray(q), jnp.asarray(c), metric=metric,
                                        block_q=32))
    got = pairwise_dist(torch.from_numpy(q), torch.from_numpy(c), metric=metric, block_q=32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_plain_update_matches_pallas_interpret():
    """70 × 90 × 16 with blocks of 32: padded rows and masked columns on
    the Pallas side, none on the plain side."""
    rng = np.random.default_rng(1)
    l, r = _unit_rows(rng, 70, 16), _unit_rows(rng, 90, 16)
    g = (0.05 * rng.standard_normal(90)).astype(np.float32)
    log_mu = np.full(70, -np.log(70), np.float32)
    want = np.asarray(jax_pallas_update(jnp.asarray(l), jnp.asarray(r), jnp.asarray(g),
                                        jnp.asarray(log_mu), 0.1, block_q=32, block_c=32,
                                        interpret=True))
    args = [torch.from_numpy(a) for a in (l, r, g, log_mu)]
    before = sinkhorn_fused.launches
    got = sinkhorn_potential_update(*args, 0.1)
    assert sinkhorn_fused.launches == before  # a CPU tensor takes the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sinkhorn_update_plain(*args, 0.1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_fused_solver_and_plan_match_jax_solver():
    rng = np.random.default_rng(2)
    l, r = _unit_rows(rng, 50, 16), _unit_rows(rng, 64, 16)
    cost = jax_pairwise_dist(jnp.asarray(l), jnp.asarray(r), metric="sqeuclidean")
    f_want, g_want = jax_sinkhorn_potentials(cost, tau=0.1, n_iters=15)
    f_got, g_got = sinkhorn_potentials_fused(torch.from_numpy(l), torch.from_numpy(r),
                                             tau=0.1, n_iters=15)
    np.testing.assert_allclose(f_got.numpy(), np.asarray(f_want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g_got.numpy(), np.asarray(g_want), rtol=1e-4, atol=1e-5)
    # the materialised-cost solver (the plain version's) on the same cost
    c_t = torch.from_numpy(np.array(cost))
    f_p, g_p = sinkhorn_potentials(c_t, tau=0.1, n_iters=15)
    np.testing.assert_allclose(f_p.numpy(), np.asarray(f_want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sinkhorn_plan(c_t, tau=0.1, n_iters=15).numpy(),
                               np.asarray(jax_sinkhorn_plan(cost, tau=0.1, n_iters=15)),
                               rtol=1e-4, atol=1e-7)


def _emb_and_pairs(rng, n=160, d=24, s=48):
    emb = rng.standard_normal((n, d)).astype(np.float32)
    pairs = np.stack([rng.permutation(n // 2)[:s], n // 2 + rng.permutation(n // 2)[:s]], 1)
    return emb, pairs.astype(np.int32)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("tau", [0.1, 0.3])
def test_sinkhorn_loss_value_and_grad_match_jax(tau):
    """Value rel 1e-3, gradient relative L2 < 1e-3 (the tolerances of
    tests/test_parity.py's OT-loss test): the port's loss is the f′
    identity with an analytic reverse sweep, the JAX loss the unrolled
    scan under jax.grad."""
    emb, pairs = _emb_and_pairs(np.random.default_rng(3))
    jfn = lambda e: jax_sinkhorn_loss(e, jnp.asarray(pairs), tau=tau, n_iters=12, block_q=16)
    want, g_want = jax.value_and_grad(jfn)(jnp.asarray(emb))
    e = torch.from_numpy(emb).requires_grad_(True)
    got = sinkhorn_align_loss(e, torch.from_numpy(pairs).long(), tau=tau, n_iters=12)
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-3)
    assert _rel_l2(e.grad.numpy(), np.asarray(g_want)) < 1e-3


def test_reverse_sweep_matches_autograd_of_plain_solver():
    """The Function's backward against torch autograd through the plain
    unrolled solver on a materialised cost (rel L2 1e-5: same arithmetic,
    other order)."""
    emb, pairs = _emb_and_pairs(np.random.default_rng(4), s=40)
    pairs_t = torch.from_numpy(pairs).long()
    e1 = torch.from_numpy(emb).requires_grad_(True)
    e2 = torch.from_numpy(emb).requires_grad_(True)
    a = sinkhorn_align_loss(e1, pairs_t, tau=0.3, n_iters=20)
    b = sinkhorn_align_loss_plain(e2, pairs_t, tau=0.3, n_iters=20)
    (2.5 * a).backward()
    (2.5 * b).backward()
    assert a.item() == pytest.approx(b.item(), rel=1e-5)
    assert _rel_l2(e1.grad.numpy(), e2.grad.numpy()) < 1e-5
    with pytest.raises(NotImplementedError, match="sqeuclidean"):
        sinkhorn_align_loss(e1, pairs_t, metric="cityblock")


def test_update_refuses_other_devices():
    x = torch.empty(8, 16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        sinkhorn_potential_update(x, x, torch.empty(8, device="meta"),
                                  torch.empty(8, device="meta"), 0.3)
