"""The sorted and xla SpMM paths of the port (``spmm_impl`` ``sorted`` /
``xla``) against the JAX package, on the CPU, where the sorted kernel runs
its plain version: the operators array for array, the SpMM forward and
gradient in fp32 and bf16, the attribute incidence, ``coo_to_dense``, and
training runs.

Tolerances: fp32 sums in another order, 1e-5; bf16, where both packages
sum in fp32 and round once, one bf16 ulp (rel 2^-7); a bf16 gradient of
``spmm_xla`` is a bf16 scatter-add in both packages, whose sums round at
every edge: relative L2 at 2^-6 (a row of ~10 edges takes ~sqrt(10)
roundings of 2^-9 that differ in order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpugraph.train.loop as jax_loop
import tpugraph_torch.train.loop as loop
from tpugraph.configs.configs import get_config as jax_get_config
from tpugraph.data.synthetic import synthetic_align_task as jax_synthetic_task
from tpugraph.kernels.spmm import spmm as jax_spmm
from tpugraph.kernels.spmm import spmm_xla as jax_spmm_xla
from tpugraph.models.attr_channel import build_attr_operator as jax_attr_operator
from tpugraph.sparse.build import build_adjacency as jax_build_adjacency
from tpugraph.sparse.build import build_spmm_operator as jax_build_spmm_operator
from tpugraph.sparse.build import coo_to_dense as jax_coo_to_dense
from tpugraph.sparse.build import pad_sort_edges as jax_pad_sort_edges
from tpugraph.train.loop import build_model as jax_build_model
from tpugraph.train.loop import fit as jax_fit
from tpugraph_torch.configs.configs import get_config
from tpugraph_torch.convert import params_from_jax
from tpugraph_torch.kernels import spmm as spmm_mod
from tpugraph_torch.kernels.spmm import segment_spmm, spmm, spmm_xla
from tpugraph_torch.models.attr_channel import build_attr_operator
from tpugraph_torch.sparse.build import (build_adjacency, build_spmm_operator, coo_to_dense,
                                         pad_sort_edges)
from tpugraph_torch.train.loop import fit


def _assert_edges_equal(j, t):
    for name in ("src", "dst", "w"):
        np.testing.assert_array_equal(np.asarray(getattr(j, name)), getattr(t, name).numpy())
    assert (j.n_rows, j.nnz, j.n_cols) == (t.n_rows, t.nnz, t.n_cols)


def _coo(rng, n_rows=40, n_cols=40, nnz=300):
    return (rng.integers(0, n_cols, nnz), rng.integers(0, n_rows, nnz),
            rng.standard_normal(nnz))


@pytest.mark.parametrize("sort_by", ["dst", "src"])
def test_pad_sort_edges_matches_jax(sort_by):
    src, dst, w = _coo(np.random.default_rng(0))
    for bucket in (64, 512):
        _assert_edges_equal(jax_pad_sort_edges(src, dst, w, 40, bucket, sort_by, n_cols=40),
                            pad_sort_edges(src, dst, w, 40, bucket, sort_by, n_cols=40))
    with pytest.raises(ValueError):
        pad_sort_edges(src, dst, w, 40, 64, sort_by="rows")


def test_build_spmm_operator_matches_jax_and_refuses_out_of_range():
    rng = np.random.default_rng(1)
    src, dst, w = _coo(rng, n_rows=25, n_cols=60)
    jop = jax_build_spmm_operator(src, dst, w, 25, bucket=128, n_cols=60)
    op = build_spmm_operator(src, dst, w, 25, bucket=128, n_cols=60)
    _assert_edges_equal(jop.fwd, op.fwd)
    _assert_edges_equal(jop.bwd, op.bwd)
    assert op.n_rows == 25 and op.nnz == 300 and op.bwd.n_rows == 60
    with pytest.raises(ValueError, match="out of range"):  # both packages refuse it
        jax_build_spmm_operator(src, dst, w, 25, bucket=128)
    with pytest.raises(ValueError, match="out of range"):
        build_spmm_operator(src, dst, w, 25, bucket=128)
    with pytest.raises(ValueError, match="out of range"):
        build_spmm_operator(np.array([-1, 0]), np.array([0, 1]), np.ones(2), 4)


@pytest.mark.parametrize("weighting, norm", [("uniform", "sym"), ("funifun", "rw"),
                                             ("funifun", "none")])
@pytest.mark.parametrize("use_native", [False, True])
def test_build_adjacency_sorted_matches_jax(weighting, norm, use_native):
    """fmt='sorted': the self-loops stay edges; the numpy paths and the
    native builders (the same source) agree array for array."""
    task = jax_synthetic_task(seed=1, n_ent=120, n_rel=6, n_triples=480)
    kw = dict(n_rel=task.n_rel, weighting=weighting, norm=norm, bucket=256,
              use_native=use_native)
    jop = jax_build_adjacency(task.n_ent, task.merged_triples, fmt="sorted", **kw)
    op = build_adjacency(task.n_ent, task.merged_triples, fmt="sorted", **kw)
    _assert_edges_equal(jop.fwd, op.fwd)
    _assert_edges_equal(jop.bwd, op.bwd)
    assert op.nnz == jop.nnz and int((op.fwd.src == op.fwd.dst)[:op.nnz].sum()) == task.n_ent
    with pytest.raises(ValueError, match="fmt"):
        build_adjacency(task.n_ent, task.merged_triples, fmt="csr")


def test_coo_to_dense_matches_jax_and_the_spmm():
    rng = np.random.default_rng(2)
    src, dst, w = _coo(rng, n_rows=30, n_cols=50, nnz=200)
    src[:5], dst[:5] = 7, 3  # duplicates sum
    dense = coo_to_dense(src, dst, w, 30, 50)
    np.testing.assert_array_equal(dense, jax_coo_to_dense(src, dst, w, 30, 50))
    op = build_spmm_operator(src, dst, w, 30, bucket=64, n_cols=50)
    x = rng.standard_normal((50, 8)).astype(np.float32)
    np.testing.assert_allclose(spmm(op, torch.from_numpy(x)).numpy(), dense @ x,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["sorted", "xla"])
def test_spmm_forward_and_gradient_match_jax(dtype, impl):
    """A·x and its gradient for x over an adjacency with hub rows, against
    the JAX spmm (custom VJP over op.bwd) and spmm_xla (autodiff)."""
    rng = np.random.default_rng(3)
    n = 300
    tri = np.stack([rng.integers(0, n, 1500), rng.integers(0, 5, 1500),
                    np.where(rng.random(1500) < 0.2, 7, rng.integers(0, n, 1500))], 1)
    tri = tri.astype(np.int32)
    jop = jax_build_adjacency(n, tri, use_native=False, fmt="sorted", bucket=512)
    op = build_adjacency(n, tri, use_native=False, fmt="sorted", bucket=512)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    cot = rng.standard_normal((n, 16)).astype(np.float32)
    jfn, fn = (jax_spmm, spmm) if impl == "sorted" else (jax_spmm_xla, spmm_xla)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    want, vjp = jax.vjp(lambda x_: jfn(jop, x_), jx)
    gwant = vjp(jnp.asarray(cot, jnp.dtype(dtype)))[0]
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    before = spmm_mod.launches
    got = fn(op, tx)
    got.backward(torch.from_numpy(cot).to(tx.dtype))
    assert spmm_mod.launches == before  # the plain version on the CPU
    assert got.dtype == tx.grad.dtype == tx.dtype
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    g, gw = tx.grad.float().numpy(), np.asarray(gwant, np.float32)
    if dtype == "bfloat16" and impl == "xla":  # a bf16 scatter-add in both packages
        assert np.linalg.norm(g - gw) / np.linalg.norm(gw) < 2 ** -6
    else:
        np.testing.assert_allclose(g, gw, rtol=tol, atol=tol)


def test_sorted_attr_incidence_matches_jax():
    """The entity × attribute incidence as sorted padded edges: array for
    array, and the SpMM with its gradient for the attribute table."""
    rng = np.random.default_rng(4)
    n_ent, n_attr = 90, 12
    attr = np.stack([rng.integers(0, n_ent, 400), rng.integers(0, n_attr, 400)], 1)
    jop = jax_attr_operator(attr, n_ent, n_attr, fmt="sorted", bucket=256)
    op = build_attr_operator(attr, n_ent, n_attr, fmt="sorted", bucket=256)
    _assert_edges_equal(jop.fwd, op.fwd)
    _assert_edges_equal(jop.bwd, op.bwd)
    table = rng.standard_normal((n_attr, 8)).astype(np.float32)
    cot = rng.standard_normal((n_ent, 8)).astype(np.float32)
    want, vjp = jax.vjp(lambda t: jax_spmm(jop, t), jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_(True)
    got = spmm(op, tt)
    got.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="rows"):
        segment_spmm(op.fwd, torch.zeros(n_attr + 1, 8))


def test_sorted_fit_matches_ell_fit():
    """As tests/test_ell.py::test_fit_with_ell_impl_matches_sorted holds the
    JAX trainer: the same run with 'sorted' and 'ell' lands on the same
    Hits@1 (within 0.02) and last history loss (rel 1e-3)."""
    kw = dict(syn_seed=5, syn_n_ent=200, syn_n_rel=6, syn_n_triples=700, dim=32, epochs=20,
              eval_every=10, k_neg=8, neg_every=5, pad_bucket=512, neg_mode="uniform")
    r1 = fit(get_config("base", spmm_impl="sorted", **kw), device="cpu")
    r2 = fit(get_config("base", spmm_impl="ell", **kw), device="cpu")
    assert r1.metrics["hits@1"] == pytest.approx(r2.metrics["hits@1"], abs=2e-2)
    assert r1.history[-1]["loss"] == pytest.approx(r2.history[-1]["loss"], rel=1e-3)
    r3 = fit(get_config("base", spmm_impl="xla", **kw), device="cpu")
    assert r3.history[-1]["loss"] == pytest.approx(r1.history[-1]["loss"], rel=1e-3)


def test_sorted_fit_matches_jax_sorted_fit(monkeypatch):
    """A sorted run of the port against the JAX sorted run from the same
    initial parameters, with the same uniform negatives injected into both
    trainers (their generators differ): each history loss rel 1e-4 and the
    final Hits@1/@10 within 0.01."""
    kw = dict(dim=16, epochs=10, eval_every=5, k_neg=5, neg_every=10, pad_bucket=512,
              neg_mode="uniform", spmm_impl="sorted")
    task = jax_synthetic_task(seed=5, n_ent=150, n_rel=5, n_triples=600)
    jcfg = jax_get_config("base", **kw)
    jop = jax_build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel,
                              weighting=jcfg.weighting, norm=jcfg.norm, bucket=512, fmt="sorted")
    params = jax_build_model(jcfg, task).init(
        jax.random.fold_in(jax.random.PRNGKey(jcfg.seed), 2**30), jop)["params"]
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(0)
    n1, s = task.kg1.n_ent, len(task.train_pairs)
    neg_l = rng.integers(0, n1, (s, 5)).astype(np.int32)
    neg_r = rng.integers(n1, task.n_ent, (s, 5)).astype(np.int32)
    monkeypatch.setattr(jax_loop, "sample_uniform_negatives",
                        lambda *a: (jnp.asarray(neg_l), jnp.asarray(neg_r)))
    monkeypatch.setattr(loop, "sample_uniform_negatives",
                        lambda gen, pairs, *a: (torch.from_numpy(neg_l).long(),
                                                torch.from_numpy(neg_r).long()))
    monkeypatch.setattr(loop, "init_params", lambda *a, **k: params)
    jres = jax_fit(jcfg, task=task)
    res = fit(get_config("base", **kw), task=task, device="cpu")
    assert [h["epoch"] for h in res.history] == [h["epoch"] for h in jres.history]
    for h, jh in zip(res.history, jres.history):
        assert h["loss"] == pytest.approx(jh["loss"], rel=1e-4)
    for k in ("hits@1", "hits@10"):
        assert abs(res.metrics[k] - jres.metrics[k]) <= 0.01


def test_sorted_mtl_channel_run_and_eval_only(tmp_path):
    """Config mtl with the attribute channel under spmm_impl sorted: the
    adjacency and the incidence are sorted operators, the run trains, and
    driver.evaluate from its checkpoint directory scores what it scored."""
    from tpugraph_torch.train.driver import evaluate, run

    cfg = get_config("mtl", syn_n_ent=150, syn_n_rel=5, syn_n_triples=600, dim=16, k_neg=5,
                     epochs=4, neg_every=2, eval_every=0, sinkhorn_iters=3, rel_k_neg=2,
                     use_attr_channel=True, spmm_impl="sorted", pad_bucket=512,
                     checkpoint_dir=str(tmp_path), checkpoint_every=2)
    res = run(cfg, device="cpu")
    assert type(res.op).__name__ == "SpMMOperator" and np.isfinite(res.metrics["final_loss"])
    ev = evaluate(cfg, device="cpu")
    assert ev.emb.shape == (res.task.n_ent, 2 * cfg.dim)
    assert max(abs(ev.metrics[k] - res.metrics[k]) for k in ev.metrics) < 1e-6
