"""Port parity: plain ELL SpMM and the fused GCN layer's plain version
(tpugraph_torch.kernels) against the JAX package, plus the host-side tile
table the CUDA kernel walks (its arithmetic replayed here in torch)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugraph.kernels.gcn_fused_pallas import fused_gcn_layer as jax_fused_layer
from tpugraph.kernels.spmm_ell import spmm_ell
from tpugraph.sparse.ell import build_ell_operator as jax_ell_operator
from tpugraph_torch.kernels import gcn_fused
from tpugraph_torch.kernels.gcn_fused import fused_gcn_layer, fused_plan, reference_layer
from tpugraph_torch.kernels.spmm_ell import TILE_ROWS, apply_with_diag, ell_apply, ell_spmm
from tpugraph_torch.nn.graphconv import GraphConvolution
from tpugraph_torch.sparse.ell import build_ell_operator


def _random_graph(rng, n, nnz):
    src = rng.integers(0, n, nnz).astype(np.int32)
    dst = rng.integers(0, n, nnz).astype(np.int32)
    w = rng.standard_normal(nnz).astype(np.float32)
    return src, dst, w


def _both_ops(src, dst, w, n, split_diag):
    return (jax_ell_operator(src, dst, w, n, split_diag=split_diag),
            build_ell_operator(src, dst, w, n, split_diag=split_diag))


@pytest.mark.parametrize("split_diag", [False, True])
def test_ell_apply_matches_spmm_ell(split_diag):
    rng = np.random.default_rng(5)
    n, d = 211, 24
    src, dst, w = _random_graph(rng, n, 1500)
    src[:40] = dst[:40]
    jop, top = _both_ops(src, dst, w, n, split_diag)
    x = rng.standard_normal((n, d)).astype(np.float32)
    want = np.asarray(spmm_ell(jop, jnp.asarray(x)))
    got = apply_with_diag(top.fwd, top.diag, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if not split_diag:
        np.testing.assert_allclose(ell_apply(top.fwd, torch.from_numpy(x)).numpy(), want,
                                   rtol=1e-5, atol=1e-5)


def _layer_inputs(rng, n, d_in, d_out, dtype):
    x = rng.standard_normal((n, d_in)).astype(np.float32)
    wm = (rng.standard_normal((d_in, d_out)) * 0.1).astype(np.float32)
    b = rng.standard_normal(d_out).astype(np.float32)
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(wm, dtype)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    return (jx, jw, jnp.asarray(b)), (torch.from_numpy(x).to(tdt),
                                      torch.from_numpy(wm).to(tdt), torch.from_numpy(b))


def _compare_layer(jop, top, rng, d_in, d_out, dtype, rtol, atol, bias=True):
    (jx, jw, jb), (tx, tw, tb) = _layer_inputs(rng, top.n_rows, d_in, d_out, dtype)
    want = jax_fused_layer(jop.fwd, jop.diag, jx, jw, jb if bias else None, interpret=True)
    got = reference_layer(top.fwd, top.diag, tx, tw, tb if bias else None)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


# the three cases of tests/test_fused_gcn.py, at its tolerances
@pytest.mark.parametrize("split_diag", [False, True])
@pytest.mark.parametrize("d_in,d_out", [(128, 128), (128, 256)])
def test_reference_layer_matches_pallas(split_diag, d_in, d_out):
    rng = np.random.default_rng(0)
    n, nnz = 257, 1800
    src, dst, w = _random_graph(rng, n, nnz)
    if split_diag:
        src[:50] = dst[:50]
    jop, top = _both_ops(src, dst, w, n, split_diag)
    _compare_layer(jop, top, rng, d_in, d_out, jnp.float32, 1e-5, 1e-4)


def test_reference_layer_bf16():
    rng = np.random.default_rng(1)
    src, dst, w = _random_graph(rng, 300, 2000)
    jop, top = _both_ops(src, dst, w, 300, True)
    _compare_layer(jop, top, rng, 128, 128, jnp.bfloat16, 0.05, 0.5, bias=False)


def test_reference_layer_padding_inert():
    rng = np.random.default_rng(2)
    n = 67
    dst = np.arange(n, dtype=np.int32)
    src = rng.integers(0, n, n).astype(np.int32)
    w = rng.standard_normal(n).astype(np.float32)
    jop, top = _both_ops(src, dst, w, n, False)
    _compare_layer(jop, top, rng, 128, 128, jnp.float32, 1e-5, 1e-4, bias=False)


def test_reference_layer_self_loop_only_rows():
    """Rows whose only edge is the self-loop lie in no bucket after the
    diagonal split; their output is diag·x·W + b."""
    rng = np.random.default_rng(3)
    n = 90
    src, dst, w = _random_graph(rng, 40, 200)  # rows 40.. have no off-diagonal edge
    loops = np.arange(n, dtype=np.int32)
    src, dst = np.concatenate([src, loops]), np.concatenate([dst, loops])
    w = np.concatenate([w, rng.uniform(0.5, 1.5, n).astype(np.float32)])
    jop, top = _both_ops(src, dst, w, n, True)
    assert fused_plan(top.fwd).n_zero_rows >= n - 40
    _compare_layer(jop, top, rng, 128, 128, jnp.float32, 1e-5, 1e-4)


def _replay_plan(m, diag, x, wmat, bias):
    """What the CUDA kernel computes, tile by tile, from the same tables."""
    plan = fused_plan(m)
    out = torch.full((m.n_rows, wmat.shape[1]), float("nan"))
    written = np.zeros(m.n_rows, int)
    for row0, nrows, k, slot0 in plan.tiles.tolist():
        assert 1 <= nrows <= TILE_ROWS
        for r in range(nrows):
            row = int(plan.rows[row0 + r])
            s = slot0 + r * k
            acc = (plan.w[s:s + k, None] * x[plan.idx[s:s + k].long()]).sum(0)
            if diag is not None:
                acc = acc + diag[row] * x[row]
            out[row] = acc @ wmat + bias
            written[row] += 1
    np.testing.assert_array_equal(written, 1)  # every row exactly once
    return out


@pytest.mark.parametrize("split_diag", [False, True])
def test_fused_plan_replay_matches_reference(split_diag):
    rng = np.random.default_rng(6)
    n = 300
    # a hub row with K in the hundreds, many short rows, and bare rows
    src, dst, w = _random_graph(rng, n, 1200)
    dst[:400] = 7
    src[400:460] = dst[400:460]
    op = build_ell_operator(src, dst, w, n, split_diag=split_diag)
    assert max(b.k for b in op.fwd.buckets) >= 256
    x = torch.from_numpy(rng.standard_normal((n, 16)).astype(np.float32))
    wm = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    got = _replay_plan(op.fwd, op.diag, x, wm, b)
    want = reference_layer(op.fwd, op.diag, x, wm, b)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-4)
    tiles = fused_plan(op.fwd).tiles.numpy()
    cost = tiles[:, 1] * (tiles[:, 2] + 1)
    assert np.all(np.diff(cost) <= 0)  # heaviest first


def test_fused_layer_cpu_uses_plain_version_and_counts_nothing():
    rng = np.random.default_rng(7)
    src, dst, w = _random_graph(rng, 50, 300)
    op = build_ell_operator(src, dst, w, 50, split_diag=True)
    x = torch.randn(50, 128, generator=torch.Generator().manual_seed(0))
    wm = torch.randn(128, 128, generator=torch.Generator().manual_seed(1))
    before = gcn_fused.launches
    torch.testing.assert_close(fused_gcn_layer(op.fwd, op.diag, x, wm),
                               reference_layer(op.fwd, op.diag, x, wm))
    assert gcn_fused.launches == before


def test_non_cpu_tensors_never_take_the_plain_version():
    rng = np.random.default_rng(8)
    src, dst, w = _random_graph(rng, 20, 60)
    op = build_ell_operator(src, dst, w, 20, split_diag=True)
    x = torch.empty(20, 128, device="meta")
    layer = GraphConvolution(128, 128, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        layer(x, op)  # grad enabled: the trainable layer's forward refuses too
    with torch.no_grad(), pytest.raises(ValueError, match="cuda or cpu"):
        layer(x, op)
    with torch.no_grad(), pytest.raises(ValueError, match="cuda or cpu"):
        ell_spmm(op.bwd, op.diag, x)
