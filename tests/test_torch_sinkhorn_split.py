"""The Sinkhorn update kernel's arithmetic (tpugraph_torch.kernels.
sinkhorn_fused), emulated in torch on the CPU: the (strip, tile) units
shared by the persistent grid, each block's piece of a strip one split of
its candidate axis leaving a base-2 partial (max, sumexp), the partials
merged in split order, with the TPU kernel's -inf guards — against the
plain version and the JAX package's Pallas update in interpret mode.  Also
the host's stream plan and the error budget of the 3× TF32 product at the
config's τ.

Torch runs on one thread here, as in tests/test_torch_sinkhorn.py."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugraph.kernels.sinkhorn_pallas import sinkhorn_potential_update as jax_pallas_update
from tpugraph_torch.kernels.sinkhorn_fused import (TILE_C, TILE_Q, sinkhorn_update_plain,
                                                   sq_norms, stream_plan)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _merge(m, s, m2, s2):
    mn = torch.maximum(m, m2)
    safe = torch.where(mn == -math.inf, 0.0, mn)
    return mn, s * torch.exp2(m - safe) + s2 * torch.exp2(m2 - safe)


def _splits(q, c, grid):
    """{strip: [(block, first tile, end tile)]}: block b takes units
    [b·total/grid, (b+1)·total/grid) of the strip-by-strip sequence."""
    n_tiles = -(-c // TILE_C)
    total = -(-q // TILE_Q) * n_tiles
    out = {}
    for b in range(grid):
        u, u1 = b * total // grid, (b + 1) * total // grid
        while u < u1:
            strip, end = u // n_tiles, min(u1, (u // n_tiles + 1) * n_tiles)
            out.setdefault(strip, []).append((b, u % n_tiles, end - strip * n_tiles))
            u = end
    return out


def _fold(l, r, g, l_sq, r_sq, k2, t0, t1):
    """One split's partial: tiles [t0, t1) folded tile by tile into a
    base-2 running (max, sumexp), one rescale per row per tile."""
    m, s = torch.full((l.shape[0],), -math.inf), torch.zeros(l.shape[0])
    for t in range(t0, t1):
        c0, c1 = t * TILE_C, min(r.shape[0], (t + 1) * TILE_C)
        cost = (l_sq[:, None] + r_sq[None, c0:c1] - 2.0 * (l @ r[c0:c1].t())).clamp_min(0.0)
        z = g[None, c0:c1] * k2 - cost * k2
        mx = torch.maximum(m, z.max(1).values)
        safe = torch.where(mx == -math.inf, 0.0, mx)
        s = s * torch.exp2(m - safe) + torch.exp2(z - safe[:, None]).sum(1)
        m = mx
    return m, s


def _emulate(l, r, g, log_mu, tau, grid, extra=None):
    """The kernel's update on ``grid`` blocks: each strip's splits merged in
    block order.  ``extra`` (m, s) partials are merged after them."""
    q = l.shape[0]
    l_sq, r_sq = sq_norms(l), sq_norms(r)
    k2 = math.log2(math.e) / tau
    out = torch.empty(q)
    for strip, pieces in _splits(q, r.shape[0], grid).items():
        rows = slice(strip * TILE_Q, min(q, (strip + 1) * TILE_Q))
        m, s = torch.full((rows.stop - rows.start,), -math.inf), torch.zeros(rows.stop - rows.start)
        for _, t0, t1 in pieces:
            m, s = _merge(m, s, *_fold(l[rows], r, g, l_sq[rows], r_sq, k2, t0, t1))
        for m2, s2 in extra or ():
            m, s = _merge(m, s, m2[rows], s2[rows])
        safe = torch.where(m == -math.inf, 0.0, m)
        out[rows] = tau * (log_mu[rows] - (safe * math.log(2.0) + torch.log(s.clamp_min(1e-38))))
    return out


def _inputs(rng, q, c, d):
    def unit(n):
        x = rng.standard_normal((n, d)).astype(np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    g = (0.2 * rng.standard_normal(c)).astype(np.float32)
    return unit(q), unit(c), g, np.full(q, -np.log(q), np.float32)


def _pallas(l, r, g, log_mu, tau):
    return np.asarray(jax_pallas_update(jnp.asarray(l), jnp.asarray(r), jnp.asarray(g),
                                        jnp.asarray(log_mu), tau, block_q=32, block_c=TILE_C,
                                        interpret=True))


@pytest.mark.parametrize("tau", [0.05, 0.3])
@pytest.mark.parametrize("q,c,grid", [(70, 300, 4), (130, 1000, 7)])
def test_split_merge_matches_plain_and_pallas(q, c, grid, tau):
    """C no multiple of the tile or of a block's share: 2 strips × 3 tiles
    (the last of 44 columns) on 4 blocks; 3 strips × 8 tiles on 7 blocks,
    so splits of 3 and 4 tiles cut strips mid-way."""
    rng = np.random.default_rng(q + c + grid)
    arrs = _inputs(rng, q, c, 16)
    assert max(len(p) for p in _splits(q, c, grid).values()) >= 2
    got = _emulate(*map(torch.from_numpy, arrs), tau, grid)
    plain = sinkhorn_update_plain(*map(torch.from_numpy, arrs), tau)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), _pallas(*arrs, tau), rtol=1e-5, atol=1e-5)


def test_split_with_no_valid_column_contributes_nothing():
    """A split whose every column has g = -inf, and an empty split, each
    leave (-inf, 0), which the merge skips."""
    rng = np.random.default_rng(3)
    l, r, g, log_mu = map(torch.from_numpy, _inputs(rng, 40, 600, 16))
    g[:2 * TILE_C] = -math.inf  # the splits of blocks 0 and 1, one tile each
    want = sinkhorn_update_plain(l, r, g, log_mu, 0.3)
    assert torch.isfinite(want).all()
    torch.testing.assert_close(_emulate(l, r, g, log_mu, 0.3, grid=5), want, rtol=1e-5, atol=1e-5)
    empty = (torch.full((40,), -math.inf), torch.zeros(40))
    torch.testing.assert_close(_emulate(l, r, g, log_mu, 0.3, grid=5, extra=[empty]), want,
                               rtol=1e-5, atol=1e-5)


def test_all_masked_row_ends_at_log_1e38():
    """Every column -inf: the plain logsumexp gives +inf potentials; the
    TPU kernel's guard clamps the sum at 1e-38, so lse = log(1e-38).  (The
    JAX package on the CPU flushes that fp32 subnormal to zero and returns
    +inf as well; the card keeps subnormals.)"""
    rng = np.random.default_rng(4)
    l, r, g, log_mu = map(torch.from_numpy, _inputs(rng, 33, 260, 16))
    g[:] = -math.inf
    got = _emulate(l, r, g, log_mu, 0.3, grid=3)
    want = 0.3 * (log_mu.double() - math.log(1e-38))
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=0.0)
    assert torch.isinf(sinkhorn_update_plain(l, r, g, log_mu, 0.3)).all()


@pytest.mark.parametrize("q,c,n_sm", [(4500, 4500, 132), (70, 4000, 132), (9000, 130, 8)])
def test_stream_plan_shares_units_evenly(q, c, n_sm):
    """Every unit in exactly one block's share, the shares within one unit
    of each other, and the scratch sized for the most splits of a strip."""
    grid, max_splits = stream_plan(q, c, n_sm)
    n_strips, n_tiles = -(-q // TILE_Q), -(-c // TILE_C)
    assert grid == min(n_sm, n_strips * n_tiles)
    splits = _splits(q, c, grid)
    covered = np.zeros((n_strips, n_tiles), int)
    share = np.zeros(grid, int)
    for strip, pieces in splits.items():
        for b, t0, t1 in pieces:
            covered[strip, t0:t1] += 1
            share[b] += t1 - t0
        assert [b for b, _, _ in pieces] == sorted({b for b, _, _ in pieces})  # split order
    np.testing.assert_array_equal(covered, 1)
    assert share.max() - share.min() <= 1
    assert max_splits == max(len(p) for p in splits.values())


def _tf32(x):
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("tau", [0.05, 0.3])
def test_3xtf32_error_budget(tau):
    """The kernel's product big·big + big·small + small·big (each TF32
    product exact in fp32, sums in fp32) keeps the update within 1 % of the
    tolerance 1e-4 + 1e-4·|f| against a float64 reference; one TF32 product
    alone does much worse."""
    rng = np.random.default_rng(5)
    l, r, g, log_mu = _inputs(rng, 1024, 1024, 128)

    def update(dot):
        cost = np.maximum(sq_norms(torch.from_numpy(l)).numpy()[:, None]
                          + sq_norms(torch.from_numpy(r)).numpy()[None, :] - 2.0 * dot, 0.0)
        z = torch.from_numpy(((g[None, :] - cost) / tau).astype(np.float32))
        return tau * (log_mu - torch.logsumexp(z, dim=1).numpy())

    l64, r64 = l.astype(np.float64), r.astype(np.float64)
    c64 = np.maximum((l64 * l64).sum(1)[:, None] + (r64 * r64).sum(1)[None, :]
                     - 2.0 * l64 @ r64.T, 0.0)
    z64 = (g.astype(np.float64)[None, :] - c64) / tau
    zmax = z64.max(1)
    want = tau * (log_mu - (zmax + np.log(np.exp(z64 - zmax[:, None]).sum(1))))
    lb, rb = _tf32(l), _tf32(r)
    ls, rs = _tf32(l - lb), _tf32(r - rb)
    dot3 = (lb @ rs.T + ls @ rb.T) + lb @ rb.T
    dot1 = lb @ rb.T

    def share(f):
        return float(np.max(np.abs(f - want) / (1e-4 + 1e-4 * np.abs(want))))

    assert share(update(dot3)) <= 0.01
    assert share(update(dot1)) > 5 * share(update(dot3))
