"""The fused GCN layer at every width (tpugraph_torch.kernels.gcn_fused:
``fused_gcn_layer`` outside the instances' {128, 256}², ``fused_bucket_apply``,
``kernel_plan``, ``FUSED_WIDTHS``) on the host, against the JAX package's
Pallas kernel in interpret mode (``tpugraph/kernels/gcn_fused_pallas.py``).

On the CPU the wrappers run their plain versions; the card's kernel
(``csrc/gcn_fused.cu``, ``gcn_fused_kernel_any``) is held to them by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.  What is checked here:
the plain versions against the Pallas layer and its bucket entry (fp32 at
(64, 64), (50, 300), (300, 50), bf16 at (50, 300)), the bucket entry's
padded shape, the one-bucket matrix the card's launch walks, the launch
plan's shared memory and scratch at every width on a grid up to 1,030 and
beyond, the route table against ``gcn_layer_plain``, and the encoder with a
layer at a fused width without an instance against the JAX encoder.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugraph.kernels.gcn_fused_pallas import _tile_sizes
from tpugraph.kernels.gcn_fused_pallas import fused_bucket_apply as jax_bucket_apply
from tpugraph.kernels.gcn_fused_pallas import fused_gcn_layer as jax_fused_layer
from tpugraph.models.encoder import AlignGCN as JaxAlignGCN
from tpugraph.sparse.build import build_adjacency as jax_build_adjacency
from tpugraph.sparse.ell import build_ell_operator as jax_ell_operator
from tpugraph_torch.convert import params_from_jax
from tpugraph_torch.kernels import gcn_fused
from tpugraph_torch.kernels.gcn_fused import (FUSED_WIDTHS, WIDTHS, bucket_matrix,
                                              bucket_tile_rows, fused_bucket_apply,
                                              fused_bucket_apply_plain, fused_gcn_layer,
                                              gcn_layer, gcn_layer_plain, kernel_plan,
                                              layer_plan, reference_layer)
from tpugraph_torch.kernels.spmm_ell import SEG_SLOTS, apply_with_diag
from tpugraph_torch.models.encoder import AlignGCN
from tpugraph_torch.sparse.build import build_adjacency
from tpugraph_torch.sparse.ell import build_ell_operator

# tests/test_fused_gcn.py's bounds: fp32 and bf16
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4), torch.bfloat16: dict(rtol=0.05, atol=0.5)}
SMEM_BLOCK = 232_448  # shared memory a block may use on the H100
# the launch plan's grid: tails of every kind up to 1,030 columns
GRID = (1, 3, 4, 5, 31, 32, 33, 50, 63, 64, 65, 100, 127, 128, 129, 191, 192, 200, 255, 256,
        257, 300, 384, 500, 511, 512, 513, 514, 640, 768, 1000, 1024, 1030)


def _one_bucket_graph(rng, n=100, k=3):
    """Every row of K = 3 off-diagonal edges (one ELL bucket, so one Pallas
    call a layer) and a self-loop on each row (the split diagonal)."""
    dst = np.repeat(np.arange(n), k)
    src = (dst + np.tile(np.arange(1, k + 1), n)) % n
    loops = np.arange(n)
    src, dst = np.concatenate([src, loops]), np.concatenate([dst, loops])
    w = rng.standard_normal(len(src)).astype(np.float32)
    return src.astype(np.int32), dst.astype(np.int32), w, n


def _inputs(rng, n, d_in, d_out):
    x = rng.standard_normal((n, d_in)).astype(np.float32)
    wm = (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(np.float32)
    b = rng.standard_normal(d_out).astype(np.float32)
    return x, wm, b


def _to(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _jax(a, dtype):
    return jnp.asarray(a).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


CASES = [(64, 64, torch.float32), (50, 300, torch.float32), (300, 50, torch.float32),
         (50, 300, torch.bfloat16)]


@pytest.mark.parametrize("d_in,d_out,dtype", CASES)
def test_layer_matches_jax_interpret(d_in, d_out, dtype):
    """The layer outside the instances (the card's any-width kernel; its
    plain version here) against the Pallas layer in interpret mode, with the
    split diagonal and a bias, at tests/test_fused_gcn.py's tolerances."""
    rng = np.random.default_rng(d_in + d_out)
    src, dst, w, n = _one_bucket_graph(rng)
    top = build_ell_operator(src, dst, w, n, split_diag=True)
    jop = jax_ell_operator(src, dst, w, n, split_diag=True)
    assert len(jop.fwd.buckets) == 1
    x, wm, b = _inputs(rng, n, d_in, d_out)
    assert kernel_plan(d_in, d_out, dtype).kernel == "gcn_fused_kernel_any"
    got = fused_gcn_layer(top.fwd, top.diag, _to(x, dtype), _to(wm, dtype), torch.from_numpy(b))
    want = jax_fused_layer(jop.fwd, jop.diag, _jax(x, dtype), _jax(wm, dtype), jnp.asarray(b),
                           interpret=True)
    assert got.dtype == dtype and got.shape == (n, d_out)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("d_in,d_out,dtype", CASES)
def test_bucket_apply_matches_jax_interpret(d_in, d_out, dtype):
    """``fused_bucket_apply`` (no diagonal, no bias) against the Pallas
    entry: the same padded shape, the same zero rows past R, the values at
    the tolerances above."""
    rng = np.random.default_rng(7 + d_in + d_out)
    n, r, k = 100, 37, 5
    idx = rng.integers(0, n, (r, k)).astype(np.int32)
    w = rng.standard_normal((r, k)).astype(np.float32)
    x, wm, _ = _inputs(rng, n, d_in, d_out)
    got = fused_bucket_apply(torch.from_numpy(idx), torch.from_numpy(w), _to(x, dtype),
                             _to(wm, dtype))
    want = np.asarray(jax_bucket_apply(jnp.asarray(idx), jnp.asarray(w), _jax(x, dtype),
                                       _jax(wm, dtype), interpret=True), np.float32)
    assert got.shape == want.shape and got.dtype == dtype
    assert not got[r:].any() and not want[r:].any()
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


def test_tile_rows_copy_the_jax_rule():
    """The port's copy of the Pallas wrapper's row tile (``_tile_sizes``)."""
    for k in range(1, 600):
        assert bucket_tile_rows(k) == _tile_sizes(k)[0], k


@pytest.mark.parametrize("k", [1, 4, 40, SEG_SLOTS + 1, 300])
def test_bucket_apply_pads_with_zero_rows(k):
    """R rows padded to the multiple of the tile at or above R, rows past R
    zero; the rows below R the weighted sums of x[idx] times W (float64).
    The one-bucket matrix the card's launch walks holds the same function:
    ``reference_layer`` over it (no diagonal, no bias) gives those rows, its
    rows past R are in no bucket, and a bucket of K > SEG_SLOTS is cut into
    segments (every row a cut row)."""
    rng = np.random.default_rng(k)
    n, r, d_in, d_out = 60, 45, 12, 7
    idx = torch.from_numpy(rng.integers(0, n, (r, k)).astype(np.int32))
    w = torch.from_numpy(rng.standard_normal((r, k)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((n, d_in)).astype(np.float32))
    wm = torch.from_numpy(rng.standard_normal((d_in, d_out)).astype(np.float32))
    got = fused_bucket_apply(idx, w, x, wm)
    r_pad = -(-r // _tile_sizes(k)[0]) * _tile_sizes(k)[0]
    assert got.shape == (r_pad, d_out) and not got[r:].any()
    agg = np.einsum("rk,rkd->rd", w.double().numpy(), x.double().numpy()[idx.numpy()])
    np.testing.assert_allclose(got[:r].numpy(), agg @ wm.double().numpy(), rtol=1e-5, atol=1e-4)
    m = bucket_matrix(idx, w, n)
    assert m.n_rows == r_pad and len(m.buckets) == 1 and m.n_cols == n
    torch.testing.assert_close(reference_layer(m, None, x, wm), got, rtol=1e-5, atol=1e-5)
    plan = layer_plan(m)
    assert plan.tiles.n_zero_rows == r_pad - r
    assert plan.hub.shape[0] == (r if k > SEG_SLOTS else 0)
    torch.testing.assert_close(fused_bucket_apply_plain(idx, w, x, wm), got, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_plan_fits_at_every_width(dtype):
    """At every (d_in, d_out) of the grid (and far above it) the launch plan
    fits a block's shared memory, covers d_in in its chunks and d_out in its
    panels with less than one chunk or panel to spare, holds W whole only
    where two blocks still fit an SM, and agrees with the kernel's own sum
    (csrc/gcn_fused.cu, any::smem_bytes); the instances keep theirs."""
    up = gcn_fused._up
    for d_in, d_out in itertools.chain(itertools.product(GRID, GRID),
                                       [(2048, 2048), (5000, 700), (1, 4096)]):
        p = kernel_plan(d_in, d_out, dtype)
        assert p.smem_bytes <= SMEM_BLOCK, (d_in, d_out, p)
        if (d_in, d_out) in WIDTHS:
            assert p.kernel != "gcn_fused_kernel_any" and p.k_chunk == d_in
            assert p.panel * p.n_panels == d_out
            assert p.cluster == gcn_fused.PANELS[d_in, d_out, dtype]
            continue
        assert p.kernel == "gcn_fused_kernel_any" and p.cluster == 1
        assert p.k_chunk % 128 == 0 and p.partial_pitch == up(d_in, 128)
        assert (p.n_k_chunks - 1) * p.k_chunk < p.partial_pitch <= p.n_k_chunks * p.k_chunk
        assert p.panel in (64, 128) and (p.n_panels - 1) * p.panel < d_out <= p.n_panels * p.panel
        assert up(d_out, p.panel) <= up(d_out, 192 - p.panel)  # the panel that pads less
        w_bytes = 4 * p.n_panels * p.panel * up(d_in, 32)
        assert p.w_resident == (4 * 32 * p.k_chunk + w_bytes <= gcn_fused.SMEM_TWO_BLOCKS)
        assert p.w_chunk == (up(d_in, 32) if p.w_resident else gcn_fused.W_CHUNK)
        assert p.smem_bytes == 4 * 32 * p.k_chunk + (
            w_bytes if p.w_resident else 4 * p.panel * gcn_fused.W_CHUNK)
        assert (p.n_k_chunks == 1) == (d_in <= 1536)
    assert kernel_plan(5000, 700, dtype).n_k_chunks == 4
    with pytest.raises(ValueError):
        kernel_plan(0, 5, dtype)


@pytest.mark.parametrize("d_in,d_out", [(3, 5), (50, 300), (300, 50), (1030, 1030)])
def test_scratch_holds_the_plans_partials(d_in, d_out):
    """The wrapper's scratch at an any-width (d_in, d_out): one fp32 partial
    of the plan's pitch per segment, then the unit, done and cut-row
    counters, all zero; cached per (d_in, d_out, stream)."""
    rng = np.random.default_rng(3)
    n = 400
    src = rng.integers(0, n, 3000)
    dst = rng.integers(0, n, 3000)
    dst[:600] = 5  # a cut row (K > SEG_SLOTS)
    m = build_ell_operator(src, dst, np.ones(3000, np.float32), n).fwd
    plan = layer_plan(m)
    n_split = plan.split_p0.shape[0] - 1
    assert n_split == 1 and plan.n_partials > 1
    kp = kernel_plan(d_in, d_out, torch.float32)
    scratch = gcn_fused._scratch(plan, d_in, d_out, torch.device("cpu"), 0)
    assert scratch.shape == (plan.n_partials * kp.partial_pitch + 2 + n_split,)
    assert not scratch.any()
    assert gcn_fused.counters(plan, d_in, d_out, 0).shape == (2 + n_split,)
    assert gcn_fused._scratch(plan, d_in, d_out, torch.device("cpu"), 0) is scratch


@pytest.mark.parametrize("d_in,d_out", sorted(FUSED_WIDTHS | {(300, 50), (64, 128), (384, 384),
                                                                (768, 768), (3, 5)}))
def test_route_table_agrees_with_plain(d_in, d_out):
    """``fused_width`` is ``FUSED_WIDTHS`` (the instances' widths among
    them); ``gcn_layer_plain`` takes the route it names (the aggregate,
    then W; else x·W, then the aggregate) and ``gcn_layer`` gives its
    output bit for bit on the host."""
    assert set(WIDTHS) <= FUSED_WIDTHS
    fused = gcn_fused.fused_width(d_in, d_out)
    assert fused == ((d_in, d_out) in FUSED_WIDTHS)
    rng = np.random.default_rng(d_in * d_out)
    src, dst, w, n = _one_bucket_graph(rng, n=50)
    op = build_ell_operator(src, dst, w, n, split_diag=True)
    x, wm, b = (torch.from_numpy(a) for a in _inputs(rng, n, d_in, d_out))
    plain = gcn_layer_plain(op, x, wm, b)
    if fused:
        route = reference_layer(op.fwd, op.diag, x, wm, b)
    else:
        route = apply_with_diag(op.fwd, op.diag, torch.matmul(x, wm)) + b
    assert torch.equal(plain, route)
    assert torch.equal(gcn_layer(op, x, wm, b), plain)


@pytest.mark.parametrize("d_in,d_out", [(3, 5), (1030, 1030)])
def test_check_takes_every_width(d_in, d_out):
    """The wrapper's checks refuse a type, layout or shape the kernel does
    not take, and no width."""
    src, dst, w, n = _one_bucket_graph(np.random.default_rng(0), n=20)
    op = build_ell_operator(src, dst, w, n, split_diag=True)
    x, wm = torch.zeros(n, d_in), torch.zeros(d_in, d_out)
    gcn_fused._check(op.fwd, op.diag, x, wm, torch.zeros(d_out))
    with pytest.raises(ValueError):
        gcn_fused._check(op.fwd, op.diag, x, wm.to(torch.bfloat16), None)
    with pytest.raises(ValueError):
        gcn_fused._check(op.fwd, op.diag, x, wm[1:], None)
    with pytest.raises(TypeError):
        gcn_fused._check(op.fwd, op.diag, x.double(), wm.double(), None)
    with pytest.raises(ValueError):
        gcn_fused._check(op.fwd, op.diag, x, torch.zeros(d_in, 0), None)


def test_encoder_at_a_fused_width_matches_jax():
    """``AlignGCN`` at dim 50, hidden 300: its first layer on the fused route
    without an instance ((50, 300) in ``FUSED_WIDTHS``), its second x·W then
    the SpMM; the JAX encoder's parameters carried across by
    ``params_from_jax``, the layers' activations and every parameter's
    gradient against ``jax.grad``."""
    assert gcn_fused.fused_width(50, 300) and (50, 300) not in WIDTHS
    assert not gcn_fused.fused_width(300, 50)
    rng = np.random.default_rng(11)
    n = 120
    tri = np.stack([rng.integers(0, n, 480), rng.integers(0, 5, 480),
                    rng.integers(0, n, 480)], 1).astype(np.int32)
    jop = jax_build_adjacency(n, tri, use_native=False, fmt="ell")
    op = build_adjacency(n, tri, use_native=False, fmt="ell")
    jm = JaxAlignGCN(n_ent=n, dim=50, hidden=300, spmm_impl="ell")
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(2), jop)["params"])
    params["gc1"]["b"] = 0.1 * rng.standard_normal(300).astype(np.float32)
    params["gc2"]["b"] = 0.1 * rng.standard_normal(50).astype(np.float32)
    cot = rng.standard_normal((n, 50)).astype(np.float32)
    want = jm.apply({"params": params}, jop, method="layer_activations")
    grads = params_from_jax(jax.tree_util.tree_map(np.asarray, jax.grad(
        lambda p: jnp.sum(jm.apply({"params": p}, jop) * cot))(params)))
    model = AlignGCN(n_ent=n, dim=50, hidden=300, spmm_impl="ell")
    model.load_state_dict(params_from_jax(params))
    got = model.layer_activations(op)
    (got[-1] * torch.from_numpy(cot)).sum().backward()
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w_), rtol=1e-4, atol=1e-5)
    for k, v in model.named_parameters():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(grads[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
