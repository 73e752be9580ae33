"""Port parity for the training slice (configs ``base`` and ``sinkhorn``):
the GCN layer's backward, ELL SpMM over A and Aᵀ, the margin loss, hard-negative
mining, the optimizer and its schedule, three Adam steps of the joint loss,
and the trainer end to end through ``driver.run`` and the CLI, against the
JAX package on the same weights and negatives (CPU, plain versions)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpugraph.configs.configs import get_config as jax_get_config
from tpugraph.kernels.spmm_ell import spmm_ell as jax_spmm_ell
from tpugraph.models.align import AlignMTL as JaxAlignMTL
from tpugraph.nn.graphconv import GraphConvolution as JaxGraphConvolution
from tpugraph.sparse.build import build_adjacency as jax_build_adjacency
from tpugraph.train.losses import margin_align_loss as jax_margin_loss
from tpugraph.train.metrics import epoch_edge_ops as jax_epoch_edge_ops
from tpugraph.train.negatives import blockwise_knn_l1 as jax_knn
from tpugraph.train.negatives import sample_hard_negatives as jax_hard_negatives
from tpugraph.train.optim import lr_factor as jax_lr_factor
from tpugraph.train.optim import make_tx
from tpugraph_torch.cli.main import main as cli_main
from tpugraph_torch.configs.configs import get_config
from tpugraph_torch.convert import params_from_jax
from tpugraph_torch.data.synthetic import synthetic_align_task
from tpugraph_torch.dist import trainer as dist_trainer
from tpugraph_torch.kernels import gcn_fused, sinkhorn_fused, spmm_ell
from tpugraph_torch.models.align import AlignMTL
from tpugraph_torch.nn.graphconv import GraphConvolution
from tpugraph_torch.sparse.build import build_adjacency
from tpugraph_torch.train.driver import run
from tpugraph_torch.train.loop import build_model, check_schedule
from tpugraph_torch.train.losses import margin_align_loss
from tpugraph_torch.train.metrics import epoch_edge_ops
from tpugraph_torch.train.mtl import check_ot_size
from tpugraph_torch.train.negatives import blockwise_knn_l1, sample_hard_negatives
from tpugraph_torch.train.optim import lr_factor, make_optimizer

TINY = dict(syn_n_ent=120, syn_n_rel=6, syn_n_triples=500, k_neg=5)


@pytest.fixture
def one_thread():
    """Sinkhorn's exp(−C/τ) amplifies torch's run-to-run reduction order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(rng, n=150, t=600):
    tri = np.stack([rng.integers(0, n, t), rng.integers(0, 5, t), rng.integers(0, n, t)], 1)
    tri = tri.astype(np.int32)
    return (jax_build_adjacency(n, tri, use_native=False, fmt="ell"), build_adjacency(n, tri))


def test_layer_backward_matches_jax_grad():
    """dx, dW, db of one fp32 layer against jax.grad of the JAX layer with
    impl='ell' (atol 1e-5: the same sums in another order)."""
    rng = np.random.default_rng(0)
    jop, op = _graph(rng)
    x = rng.standard_normal((op.n_rows, 24)).astype(np.float32)
    w = (0.2 * rng.standard_normal((24, 16))).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    cot = rng.standard_normal((op.n_rows, 16)).astype(np.float32)
    jlayer = JaxGraphConvolution(16, impl="ell")
    f = lambda x_, p: jnp.sum(jlayer.apply({"params": p}, x_, jop) * cot)
    gx, gp = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), {"w": jnp.asarray(w),
                                                          "b": jnp.asarray(b)})
    layer = GraphConvolution(24, 16)
    layer.load_state_dict({"w": torch.from_numpy(w), "b": torch.from_numpy(b)})
    xt = torch.from_numpy(x).requires_grad_(True)
    before = (gcn_fused.launches, spmm_ell.launches)
    (layer(xt, op) * torch.from_numpy(cot)).sum().backward()
    assert (gcn_fused.launches, spmm_ell.launches) == before  # plain versions on the CPU
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(layer.w.grad.numpy(), np.asarray(gp["w"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(layer.b.grad.numpy(), np.asarray(gp["b"]), rtol=1e-5, atol=1e-5)


def test_ell_spmm_matches_jax_forward_and_vjp():
    """ell_spmm over op.fwd is the JAX spmm_ell, and over the transpose
    op.bwd it is that op's VJP (the GCN layer's backward)."""
    rng = np.random.default_rng(1)
    jop, op = _graph(rng)
    x = rng.standard_normal((op.n_rows, 8)).astype(np.float32)
    cot = rng.standard_normal((op.n_rows, 8)).astype(np.float32)
    y, vjp = jax.vjp(lambda x_: jax_spmm_ell(jop, x_), jnp.asarray(x))
    got = spmm_ell.ell_spmm(op.fwd, op.diag, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
    got = spmm_ell.ell_spmm(op.bwd, op.diag, torch.from_numpy(cot))
    np.testing.assert_allclose(got.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_margin_loss_value_and_grad_match_jax(weighted):
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((90, 12)).astype(np.float32)
    pairs = np.stack([rng.integers(0, 45, 20), rng.integers(45, 90, 20)], 1).astype(np.int32)
    neg_l = rng.integers(0, 45, (20, 4)).astype(np.int32)
    neg_r = rng.integers(45, 90, (20, 4)).astype(np.int32)
    w = rng.uniform(0, 2, 20).astype(np.float32) if weighted else None
    jw = None if w is None else jnp.asarray(w)
    want, gwant = jax.value_and_grad(lambda e: jax_margin_loss(
        e, jnp.asarray(pairs), jnp.asarray(neg_l), jnp.asarray(neg_r), 3.0, jw))(
        jnp.asarray(emb))
    e = torch.from_numpy(emb).requires_grad_(True)
    got = margin_align_loss(e, *(torch.from_numpy(a).long() for a in (pairs, neg_l, neg_r)),
                            3.0, None if w is None else torch.from_numpy(w))
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(gwant), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_cands,k", [(70, 6), (3, 5)])
def test_knn_matches_jax_including_the_tiny_pool(n_cands, k):
    """Tie-free random data: the same indices in the same order; with a
    pool of 3 and k = 5 the unfilled and partner columns take the row's
    best valid candidate in both packages."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((40, 8)).astype(np.float32)
    c = rng.standard_normal((n_cands, 8)).astype(np.float32)
    exclude = rng.integers(-1, n_cands, 40).astype(np.int32)
    want = np.asarray(jax_knn(jnp.asarray(q), jnp.asarray(c), jnp.asarray(exclude), k,
                              block_c=16))
    got = blockwise_knn_l1(torch.from_numpy(q), torch.from_numpy(c),
                           torch.from_numpy(exclude).long(), k, block_c=16)
    np.testing.assert_array_equal(got.numpy(), want)
    # the approximate path: the same index sets (CPU approx_min_k is exact)
    want = np.asarray(jax_knn(jnp.asarray(q), jnp.asarray(c), jnp.asarray(exclude), k,
                              approx=True))
    got = blockwise_knn_l1(torch.from_numpy(q), torch.from_numpy(c),
                           torch.from_numpy(exclude).long(), k, approx=True)
    np.testing.assert_array_equal(np.sort(got.numpy(), 1), np.sort(want, 1))


def test_hard_negatives_match_jax():
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((100, 8)).astype(np.float32)
    pairs = np.stack([rng.permutation(40)[:25], 40 + rng.permutation(60)[:25]], 1)
    pairs = pairs.astype(np.int32)
    want = jax_hard_negatives(jnp.asarray(emb), jnp.asarray(pairs), 40, 100, 7)
    got = sample_hard_negatives(torch.from_numpy(emb), torch.from_numpy(pairs).long(),
                                40, 100, 7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("sched", [
    dict(lr_schedule="const"),
    dict(lr_schedule="cosine", lr_final_frac=0.1),
    dict(lr_schedule="const", lr_warmup=3),
    dict(lr_schedule="cosine", lr_warmup=2, lr_final_frac=0.2),
])
def test_optimizer_and_schedule_match_optax(sched):
    """lr_factor, then five Adam updates on the same gradients."""
    for t in range(8):
        assert lr_factor(t, 5, sched["lr_schedule"], sched.get("lr_warmup", 0),
                         sched.get("lr_final_frac", 0.0)) == pytest.approx(
            jax_lr_factor(t, 5, sched["lr_schedule"], sched.get("lr_warmup", 0),
                          sched.get("lr_final_frac", 0.0)), rel=1e-12)
    rng = np.random.default_rng(5)
    p0 = rng.standard_normal(6).astype(np.float32)
    grads = [rng.standard_normal(6).astype(np.float32) for _ in range(5)]
    tx = make_tx(jax_get_config("base", epochs=5, lr=0.05, **sched))
    p, state = jnp.asarray(p0), None
    state = tx.init(p)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, lr_sched = make_optimizer(get_config("base", epochs=5, lr=0.05, **sched), [param])
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, p)
        p = optax.apply_updates(p, upd)
        param.grad = torch.from_numpy(g)
        opt.step()
        lr_sched.step()
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(p), rtol=1e-5, atol=1e-7)


def test_three_adam_steps_of_the_sinkhorn_joint_loss_match_jax(one_thread):
    """AlignMTL (margin + 3·Sinkhorn, τ 0.3, 20 iterations) with the same
    weights and negatives, three Adam steps: params allclose at rtol 1e-4,
    atol 1e-5."""
    task = synthetic_align_task(seed=3, n_ent=120, n_rel=6, n_triples=500)
    over = dict(dim=32, k_neg=5)
    jcfg, cfg = jax_get_config("sinkhorn", **over), get_config("sinkhorn", **over)
    jop = jax_build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel,
                              use_native=False, fmt="ell")
    op = build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel)
    rng = np.random.default_rng(6)
    s, n1 = len(task.train_pairs), task.kg1.n_ent
    negs = (rng.integers(0, n1, (s, 5)), rng.integers(n1, task.n_ent, (s, 5)))
    jbatch = {"pairs": jnp.asarray(task.train_pairs), "neg_l": jnp.asarray(negs[0], jnp.int32),
              "neg_r": jnp.asarray(negs[1], jnp.int32)}
    batch = {"pairs": torch.from_numpy(task.train_pairs).long(),
             "neg_l": torch.from_numpy(negs[0]), "neg_r": torch.from_numpy(negs[1])}
    jmodel = JaxAlignMTL(n_ent=task.n_ent, n_rel=task.n_rel, n_attr=1, cfg=jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jop, jbatch)["params"]
    model = AlignMTL(task.n_ent, cfg)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))

    tx = optax.adam(jcfg.lr)
    state = tx.init(params)

    @jax.jit
    def step(params, state):
        grads = jax.grad(lambda p: jmodel.apply({"params": p}, jop, jbatch)[0])(params)
        upd, state = tx.update(grads, state, params)
        return optax.apply_updates(params, upd), state

    opt, sched = make_optimizer(cfg, model.parameters())
    for _ in range(3):
        params, state = step(params, state)
        opt.zero_grad()
        loss, aux = model(op, batch)
        loss.backward()
        opt.step()
        sched.step()
    assert set(aux) == {"margin", "sinkhorn", "total"}
    got = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), got[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


def test_run_sinkhorn_and_base_on_the_host(tmp_path, one_thread):
    """driver.run routes config sinkhorn to fit_mtl and base to fit; uniform
    negatives at epoch 0, one hard-mining interval from epoch 3; the loss
    falls; the kernels are never launched for CPU tensors."""
    before = (gcn_fused.launches, spmm_ell.launches, sinkhorn_fused.launches)
    cfg = get_config("sinkhorn", **TINY, epochs=6, neg_every=3, eval_every=3,
                     metrics_path=str(tmp_path / "m.jsonl"),
                     save_emb_path=str(tmp_path / "emb.pt"))
    res = run(cfg, device="cpu")
    assert res.timings["minings"] == 1 and res.timings["steps"] == 6
    assert all(np.isfinite(v) for v in res.metrics.values())
    assert res.losses[-1] < res.losses[0] and res.metrics["final_loss"] == res.losses[-1]
    assert [h["epoch"] for h in res.history] == [0, 3, 5]
    assert {"loss_margin", "loss_sinkhorn", "hits@1", "edges_per_s"} <= set(res.history[-1])
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    assert "_config" in json.loads(lines[0]) and len(lines) == 4
    assert (tmp_path / "emb.pt").exists()
    base = run(get_config("base", **TINY, epochs=4, neg_every=2, eval_every=0), device="cpu")
    assert base.timings["minings"] == 1 and base.history == []
    assert np.isfinite(base.metrics["final_loss"]) and "encoder.emb" not in base.params
    assert (gcn_fused.launches, spmm_ell.launches, sinkhorn_fused.launches) == before


def test_cli_trains_and_prints_one_json_line(capsys):
    argv = ["--config", "sinkhorn", "--epochs", "2", "--device", "cpu", "--quiet",
            "--set", *(f"{k}={v}" for k, v in TINY.items()), "neg_every=1"]
    assert cli_main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["config"] == "sinkhorn" and np.isfinite(out["final_loss"])


@pytest.mark.parametrize("fused", [False, True])
def test_cli_debug_nans_raises_at_the_poisoned_step(fused, capsys):
    """--debug-nans: a learning rate of 1e30 overflows the second step's
    forward.  Unfused, anomaly detection or the step check names epoch 1;
    fused, the interval's finite flag names the interval; without the flag
    the run ends with a NaN loss."""
    argv = ["--config", "base", "--epochs", "6", "--device", "cpu", "--quiet",
            "--set", *(f"{k}={v}" for k, v in TINY.items()), "lr=1e30", "neg_every=3",
            f"steps_per_call={3 if fused else 1}"]
    with pytest.raises(FloatingPointError,
                       match="interval of epochs 0-2" if fused else "epoch 1"):
        cli_main([*argv, "--debug-nans"])
    assert cli_main(argv) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["final_loss"] != 0.0


def test_unported_options_and_the_card_default(monkeypatch):
    # a sharded config: fit and fit_mtl take it (one device, as the JAX
    # trainers do; tests/test_torch_sharded_single.py), and driver.run still
    # sends it to the distributed trainer
    routed = []
    monkeypatch.setattr(dist_trainer, "fit_distributed",
                        lambda cfg, **kw: routed.append(cfg.name) or "distributed")
    for over in (dict(slice_shards=2), dict(n_shards=2), dict(feature_shards=2)):
        check_schedule(get_config("sinkhorn", **over))
        assert run(get_config("sinkhorn", **over), device="cpu") == "distributed"
    assert routed == ["sinkhorn"] * 3
    # the fused interval, profiling and the TensorBoard sink are ported
    # (tests/test_torch_fused.py, tests/test_torch_observability.py); bf16
    # training too (tests/test_torch_bf16.py)
    for over in (dict(steps_per_call=5), dict(profile_dir="prof"),
                 dict(param_dtype="bfloat16")):
        check_schedule(get_config("sinkhorn", **over))
    # every single-device SpMM impl builds (tests/test_torch_sorted.py); the
    # operator's layout follows it
    task = synthetic_align_task(seed=0, n_ent=40, n_rel=3, n_triples=120)
    for impl in ("ell", "pallas", "sorted", "xla"):
        model = build_model(get_config("base", spmm_impl=impl, dim=8), task)
        assert model.gc1.impl == ("ell" if impl == "pallas" else impl)  # get_config resolves the alias
    with pytest.raises(ValueError, match="spmm_impl"):
        build_model(get_config("base", spmm_impl="dense"), task)
    # the approximate, CSLS-mining and sqeuclidean search paths are ported
    for over in (dict(boot_cap=10, boot_approx=True), dict(neg_metric="sqeuclidean"),
                 dict(eval_approx_k=50), dict(neg_approx=True), dict(neg_csls_k=5),
                 dict(boot_cap=10, neg_metric="sqeuclidean")):
        check_schedule(get_config("sinkhorn", **over))
    with pytest.raises(ValueError, match="neg_metric"):
        check_schedule(get_config("sinkhorn", neg_metric="cosine"))
    with pytest.raises(ValueError, match="sinkhorn_pairs"):
        check_ot_size(get_config("sinkhorn"), 9000)
    check_ot_size(get_config("sinkhorn"), 4500)
    with pytest.raises(ValueError, match="n_rel"):
        AlignMTL(10, get_config("mtl"))  # the heads need their sizes
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(get_config("sinkhorn", **TINY, epochs=1))
    assert epoch_edge_ops(1234) == jax_epoch_edge_ops(1234)
    assert epoch_edge_ops(1234, True) == jax_epoch_edge_ops(1234, True)
