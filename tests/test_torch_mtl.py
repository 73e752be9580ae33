"""Port parity for config ``mtl`` and recipes v7/v7r: the relation and
attribute heads, AlignMTL's loss, aux and gradients (with and without the
attribute channel, with bootstrapped pairs and with the OT subsample), the
attribute incidence operator and its trainable SpMM, ``combine_channels``,
the per-interval draws, eval-only from an MTL run, and v7/v7r through the
CLI, against the JAX package on the same inputs (CPU, plain versions)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugraph.configs.configs import get_config as jax_get_config
from tpugraph.kernels.spmm_ell import spmm_ell as jax_spmm_ell
from tpugraph.models.align import AlignMTL as JaxAlignMTL
from tpugraph.models.attr_channel import build_attr_operator as jax_build_attr_operator
from tpugraph.models.attr_channel import combine_channels as jax_combine_channels
from tpugraph.models.heads import AttributeHead as JaxAttributeHead
from tpugraph.models.heads import RelationHead as JaxRelationHead
from tpugraph.sparse.build import build_adjacency as jax_build_adjacency
from tpugraph_torch.cli.main import main as cli_main
from tpugraph_torch.configs.configs import get_config
from tpugraph_torch.configs.recipes import RECIPES
from tpugraph_torch.convert import params_from_jax
from tpugraph_torch.data.synthetic import synthetic_align_task
from tpugraph_torch.kernels import gcn_fused, sinkhorn_fused, spmm_ell
from tpugraph_torch.models.align import AlignMTL, init_mtl_params
from tpugraph_torch.models.attr_channel import build_attr_operator, combine_channels
from tpugraph_torch.models.heads import AttributeHead, RelationHead, lecun_normal
from tpugraph_torch.sparse.build import build_adjacency
from tpugraph_torch.sparse.graph import KG, AlignTask
from tpugraph_torch.train.driver import evaluate, run
from tpugraph_torch.train.checkpoint import Checkpointer
from tpugraph_torch.train.loop import _check_resume, check_schedule
from tpugraph_torch.train.mtl import check_ot_size, draw_interval, fit_mtl, interval_keys


@pytest.fixture
def one_thread():
    """Sinkhorn's exp(−C/τ) amplifies torch's run-to-run reduction order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def test_relation_and_attribute_heads_match_jax():
    """The same parameters and triples: each head's loss rtol 1e-5, and its
    gradients for the embeddings and its own parameters rel 1e-5."""
    rng = np.random.default_rng(0)
    n, n_rel, n_attr, d, t, k, b = 60, 7, 11, 16, 90, 4, 40
    emb = rng.standard_normal((n, d)).astype(np.float32)
    tri = np.stack([rng.integers(0, n, t), rng.integers(0, n_rel, t),
                    rng.integers(0, n, t)], 1).astype(np.int32)
    neg_t, neg_h = rng.integers(0, n, (t, k)), rng.integers(0, n, (t, k))
    attr = np.stack([rng.integers(0, n, b), rng.integers(0, n_attr, b)], 1).astype(np.int32)

    jrel = JaxRelationHead(n_rel=n_rel, dim=d)
    jattr = JaxAttributeHead(n_attr=n_attr)
    rel_args = (jnp.asarray(tri), jnp.asarray(neg_t, jnp.int32), jnp.asarray(neg_h, jnp.int32))
    p_rel = jrel.init(jax.random.PRNGKey(1), jnp.asarray(emb), *rel_args)["params"]
    p_attr = jattr.init(jax.random.PRNGKey(2), jnp.asarray(emb), jnp.asarray(attr))["params"]
    heads = [(jrel, p_rel, rel_args, RelationHead(n_rel, d),
              (torch.from_numpy(tri).long(), torch.from_numpy(neg_t), torch.from_numpy(neg_h)),
              {"rel": "rel"}),
             (jattr, p_attr, (jnp.asarray(attr),), AttributeHead(d, n_attr),
              (torch.from_numpy(attr).long(),), {"w": "kernel", "b": "bias"})]
    for jhead, p, jargs, head, args, names in heads:
        (want, (g_emb, g_p)) = jax.value_and_grad(
            lambda e, p_: jhead.apply({"params": p_}, e, *jargs), argnums=(0, 1))(
                jnp.asarray(emb), p)
        leaves = _tree(p if "rel" in p else p["Dense_0"])
        g_leaves = _tree(g_p if "rel" in g_p else g_p["Dense_0"])
        head.load_state_dict({k_: torch.tensor(leaves[v]) for k_, v in names.items()})
        e = torch.from_numpy(emb).requires_grad_(True)
        loss = head(e, *args)
        loss.backward()
        assert loss.item() == pytest.approx(float(want), rel=1e-5)
        np.testing.assert_allclose(e.grad.numpy(), np.asarray(g_emb), rtol=1e-5, atol=1e-6)
        for k_, v in names.items():
            got, wg = getattr(head, k_).grad.numpy(), g_leaves[v]
            assert np.linalg.norm(got - wg) / np.linalg.norm(wg) < 1e-5, k_


def test_head_initialisers_follow_flax():
    """lecun-normal: truncated at two standard deviations, variance 1/fan_in."""
    w = lecun_normal(np.random.default_rng(0), 256, 2000)
    assert np.abs(w).max() <= 2.0 / np.sqrt(256) / 0.87962566103423978 + 1e-6
    assert w.var() == pytest.approx(1.0 / 256, rel=0.02)
    p = init_mtl_params(get_config("mtl", use_attr_channel=True, dim=16), 50, 9, 12, seed=3)
    assert p["rel_head.rel"].std().item() == pytest.approx(0.25, rel=0.1)
    assert set(p) >= {"attr_head.w", "attr_head.b", "ae_encoder.attr_emb", "ae_encoder.gc2.w"}


def test_params_from_jax_refuses_unknown_leaves():
    """Every flax tree of the ported models maps; anything else raises."""
    leaf = np.zeros((2, 2), np.float32)
    layer = {"w": leaf, "b": leaf[0]}
    enc = {"emb": leaf, "gc1": layer, "gc2": layer, "hw1": layer, "hw2": layer}
    got = params_from_jax({"encoder": enc, "rel_head": {"rel": leaf},
                           "attr_head": {"Dense_0": {"kernel": leaf, "bias": leaf[0]}},
                           "ae_encoder": {"attr_emb": leaf, "GraphConvolution_0": layer,
                                          "GraphConvolution_1": layer}})
    assert {"encoder.hw2.b", "rel_head.rel", "attr_head.w", "ae_encoder.gc2.w"} <= set(got)
    for bad in ({"encoder": enc, "extra_head": {}}, {**enc, "hw3": layer},
                {"encoder": enc, "attr_head": {"Dense_1": {}}},
                {"encoder": enc, "ae_encoder": {"attr_emb": leaf, "GraphConvolution_2": layer}},
                {**enc, "gc1": {"w": leaf}}):
        with pytest.raises(ValueError):
            params_from_jax(bad)


def _mtl_models(task, over):
    """A JAX AlignMTL of config mtl and the port's, on the same weights."""
    jcfg, cfg = jax_get_config("mtl", **over), get_config("mtl", **over)
    jop = jax_build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel,
                              use_native=False, fmt="ell")
    op = build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel)
    attr = task.merged_attr_triples
    jattr_op = attr_op = None
    if cfg.use_attr_channel:
        jattr_op = jax_build_attr_operator(attr, task.n_ent, task.n_attr, fmt="ell")
        attr_op = build_attr_operator(attr, task.n_ent, task.n_attr)
    jmodel = JaxAlignMTL(n_ent=task.n_ent, n_rel=task.n_rel, n_attr=task.n_attr, cfg=jcfg)
    model = AlignMTL(task.n_ent, cfg, n_rel=task.n_rel, n_attr=task.n_attr)
    return jmodel, jop, jattr_op, model, op, attr_op, cfg


def _mtl_batch(task, cfg, rng, boot: int = 0, ot_pairs: int = 0):
    """The same batch for both packages: negatives, corruptions and an
    attribute batch, with ``boot`` weighted proposals and an OT subsample
    of ``ot_pairs`` seed pairs."""
    pairs, n1, n = task.train_pairs, task.kg1.n_ent, task.n_ent
    tri, attr = task.merged_triples, task.merged_attr_triples
    s = len(pairs) + boot
    b = {"pairs": pairs,
         "neg_l": rng.integers(0, n1, (s, cfg.k_neg)), "neg_r": rng.integers(n1, n, (s, cfg.k_neg)),
         "rel_triples": tri, "rel_neg_t": rng.integers(0, n, (len(tri), cfg.rel_k_neg)),
         "rel_neg_h": rng.integers(0, n, (len(tri), cfg.rel_k_neg)),
         "attr_triples": attr[rng.integers(0, len(attr), 50)]}
    if boot:
        prop = np.stack([rng.integers(0, n1, boot), rng.integers(n1, n, boot)], 1)
        b["pairs_aug"] = np.concatenate([pairs, prop])
        b["w"] = np.concatenate([np.ones(len(pairs)), np.where(np.arange(boot) % 2, 0.5, 0.0)])
    if ot_pairs:
        b["ot_pairs"] = pairs[rng.permutation(len(pairs))[:ot_pairs]]
    jb = {k: jnp.asarray(v, jnp.float32 if k == "w" else jnp.int32) for k, v in b.items()}
    tb = {k: torch.from_numpy(np.asarray(v, np.float32 if k == "w" else np.int64))
          for k, v in b.items()}
    return jb, tb


MTL_CASES = {
    "heads": dict(),
    "heads_channel": dict(use_attr_channel=True, attr_beta=0.7),
    "heads_channel_boot": dict(use_attr_channel=True, boot_cap=12),
    "heads_ot_pairs": dict(sinkhorn_pairs=20),
}


@pytest.mark.parametrize("case", list(MTL_CASES))
def test_alignmtl_mtl_loss_aux_and_grads_match_jax(case, one_thread):
    """Config mtl (margin, Sinkhorn, relation and attribute heads; the AE
    channel's margin and the combined embedding where it is on): the loss,
    every aux term and every gradient rel 1e-5."""
    task = synthetic_align_task(seed=4, n_ent=110, n_rel=5, n_triples=420, n_attr=24)
    over = dict(dim=16, k_neg=4, rel_k_neg=3, sinkhorn_iters=6, **MTL_CASES[case])
    jmodel, jop, jattr_op, model, op, attr_op, cfg = _mtl_models(task, over)
    rng = np.random.default_rng(9)
    jb, tb = _mtl_batch(task, cfg, rng, boot=over.get("boot_cap", 0),
                        ot_pairs=over.get("sinkhorn_pairs", 0))
    params = jax.jit(lambda k: jmodel.init(k, jop, jb, attr_op=jattr_op))(
        jax.random.PRNGKey(0))["params"]
    model.load_state_dict(params_from_jax(_tree(params)))
    (want, jaux), grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, jop, jb, attr_op=jattr_op), has_aux=True))(params)
    loss, aux = model(op, tb, train=True, attr_op=attr_op)
    loss.backward()
    assert set(aux) == set(jaux)
    for k in aux:
        assert aux[k].item() == pytest.approx(float(jaux[k]), rel=1e-5), k
    want_g = params_from_jax(_tree(grads))
    assert set(want_g) == {k for k, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        g, wg = p.grad, want_g[name]
        if name == "ae_encoder.gc2.b":
            # its gradient is 0: the AE margin reads differences of rows,
            # blind to a shift of them all; both sides hold rounding only
            assert max(float(g.abs().max()), float(wg.abs().max())) < 1e-6
            continue
        assert float((g - wg).norm() / wg.norm()) < 1e-5, name
    jemb = jmodel.apply({"params": params}, jop, attr_op=jattr_op, method=jmodel.embed)
    with torch.no_grad():
        emb = model.embed(op, attr_op)
    assert emb.shape == jemb.shape == (task.n_ent, 32 if cfg.use_attr_channel else 16)
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), rtol=1e-5, atol=1e-6)


def test_attr_operator_matches_jax_including_mean_aggregation():
    """Duplicated pairs and entities without attributes: the incidence
    applied to the identity (its dense form) equals the JAX operator's, and
    each row is the mean of its distinct attributes."""
    rng = np.random.default_rng(5)
    n, n_attr = 40, 9
    attr = np.stack([rng.integers(0, n - 5, 120), rng.integers(0, n_attr, 120)], 1)
    attr = np.concatenate([attr, attr[:30]]).astype(np.int32)  # duplicates
    eye = np.eye(n_attr, dtype=np.float32)
    got = spmm_ell.spmm_ell(build_attr_operator(attr, n, n_attr), torch.from_numpy(eye))
    want = jax_spmm_ell(jax_build_attr_operator(attr, n, n_attr, fmt="ell"), jnp.asarray(eye))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    dense = np.zeros((n, n_attr))
    dense[attr[:, 0], attr[:, 1]] = 1.0
    rows = dense.sum(1, keepdims=True)
    np.testing.assert_allclose(got.numpy(), dense / np.maximum(rows, 1), rtol=1e-6)
    # the JAX package's own case (tests/test_mtl.py): {0, 1}, {2}, none
    small = build_attr_operator(np.array([[0, 0], [0, 1], [1, 2]], np.int32), 3, 4)
    feats = spmm_ell.spmm_ell(small, torch.eye(4)).numpy()
    np.testing.assert_allclose(feats, [[0.5, 0.5, 0, 0], [0, 0, 1, 0], [0, 0, 0, 0]])


def test_incidence_spmm_forward_and_grad_match_jax():
    """The trainable SpMM on the rectangular incidence: forward, and the
    gradient for the attribute table over the transpose, against the JAX
    spmm_ell and its VJP; no kernel launches for CPU tensors."""
    task = synthetic_align_task(seed=1, n_ent=80, n_rel=4, n_triples=300, n_attr=13)
    attr = task.merged_attr_triples
    jop = jax_build_attr_operator(attr, task.n_ent, task.n_attr, fmt="ell")
    op = build_attr_operator(attr, task.n_ent, task.n_attr)
    assert (op.fwd.n_rows, op.fwd.n_cols, op.bwd.n_rows) == (160, 13, 13) and op.diag is None
    rng = np.random.default_rng(2)
    table = rng.standard_normal((13, 8)).astype(np.float32)
    cot = rng.standard_normal((160, 8)).astype(np.float32)
    y, vjp = jax.vjp(lambda t: jax_spmm_ell(jop, t), jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_(True)
    before = spmm_ell.launches
    got = spmm_ell.spmm_ell(op, t)
    (got * torch.from_numpy(cot)).sum().backward()
    assert spmm_ell.launches == before
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(y), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]),
                               rtol=1e-5, atol=1e-5)


def test_combine_channels_matches_jax():
    rng = np.random.default_rng(3)
    se = rng.standard_normal((30, 8)).astype(np.float32)
    ae = rng.standard_normal((30, 8)).astype(np.float32)
    ae[4] = 0.0  # a zero row: the 1e-8 guard
    got = combine_channels(torch.from_numpy(se), torch.from_numpy(ae), 0.8)
    want = jax_combine_channels(jnp.asarray(se), jnp.asarray(ae), 0.8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_interval_draws_and_the_ot_size_guard():
    """The draws follow the JAX package's shapes and ranges, repeat for the
    same (seed, interval) and change with the interval; the OT subsample
    draws distinct seed pairs; the guard reads the effective OT size."""
    cfg = get_config("mtl", sinkhorn_pairs=30, rel_k_neg=4)
    pairs = torch.stack([torch.arange(50), torch.arange(50) + 100], 1)
    attr = torch.stack([torch.arange(20_000) % 200, torch.arange(20_000) % 7], 1)
    assert interval_keys(cfg, 50) == ("ot_pairs", "rel_neg_t", "rel_neg_h", "attr_triples")
    assert interval_keys(cfg, 30) == ("rel_neg_t", "rel_neg_h", "attr_triples")
    a, b = (draw_interval(cfg, 4, pairs, 200, 70, attr) for _ in range(2))
    c = draw_interval(cfg, 6, pairs, 200, 70, attr)
    assert a["rel_neg_t"].shape == (70, 4) and a["attr_triples"].shape == (8192, 2)
    assert int(a["rel_neg_h"].max()) < 200 and int(a["rel_neg_t"].min()) >= 0
    assert a["ot_pairs"].shape == (30, 2) and len(set(a["ot_pairs"][:, 0].tolist())) == 30
    assert set(a["ot_pairs"][:, 0].tolist()) <= set(range(50))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not any(torch.equal(a[k], c[k]) for k in a)
    with pytest.raises(ValueError, match="sinkhorn_pairs"):
        check_ot_size(get_config("mtl", sinkhorn_pairs=9000), 10_000)
    check_ot_size(get_config("mtl", sinkhorn_pairs=4096), 10_000)
    check_ot_size(get_config("mtl", epochs=0), 10_000)


def test_fit_mtl_refuses_a_task_without_attributes():
    task = synthetic_align_task(seed=1, n_ent=60, n_rel=4, n_triples=200)
    bare = AlignTask(kg1=KG(60, 4, task.kg1.triples), kg2=KG(60, 4, task.kg2.triples),
                     train_pairs=task.train_pairs, test_pairs=task.test_pairs)
    for over in (dict(), dict(use_attr_head=False, use_attr_channel=True)):
        with pytest.raises(ValueError, match="no attribute triples"):
            fit_mtl(get_config("mtl", **over), task=bare, device="cpu")


def test_mtl_channel_run_and_eval_only_on_the_host(tmp_path, one_thread):
    """Config mtl with the channel through driver.run: every aux term in
    the history, the loss falling, no kernel launch on the CPU; then
    driver.evaluate from its directory scores the combined table as the
    run's final eval did."""
    before = (gcn_fused.launches, spmm_ell.launches, sinkhorn_fused.launches)
    cfg = get_config("mtl", syn_n_ent=120, syn_n_rel=5, syn_n_triples=480, dim=16, k_neg=4,
                     rel_k_neg=3, sinkhorn_iters=5, epochs=6, neg_every=3, eval_every=5,
                     use_attr_channel=True, checkpoint_dir=str(tmp_path / "ck"),
                     checkpoint_every=2)
    res = run(cfg, device="cpu")
    assert {"loss_margin", "loss_sinkhorn", "loss_rel", "loss_attr", "loss_ae",
            "edges_per_s"} <= set(res.history[-1])
    assert res.losses[-1] < res.losses[0] and res.timings["draws"] == 2
    assert (gcn_fused.launches, spmm_ell.launches, sinkhorn_fused.launches) == before
    ev = evaluate(cfg, device="cpu")
    assert ev.emb.shape == (240, 32)
    assert ev.metrics == {k: v for k, v in res.metrics.items() if k != "final_loss"}
    # a checkpoint without the interval's draws is refused
    state = Checkpointer(cfg.checkpoint_dir, 2).restore_latest()[1]
    del state["extra"]["attr_triples"]
    with pytest.raises(ValueError, match="extra.attr_triples"):
        _check_resume(cfg, state, len(res.task.train_pairs), interval_keys(cfg, 10**6))


@pytest.mark.parametrize("recipe", ["v7", "v7r"])
def test_cli_recipe_v7_on_the_host(recipe, capsys, one_thread):
    """v7 and v7r (v6 + the attribute head at weight 4.0 or 0.25) at small
    sizes, through the CLI on the host."""
    check_schedule(get_config("base", **RECIPES[recipe]))
    argv = ["--recipe", recipe, "--device", "cpu", "--quiet", "--set", "syn_n_ent=150",
            "syn_n_triples=600", "epochs=4", "boot_start=2", "boot_cap=30", "k_neg=5",
            "eval_every=0", "dim=32", "sinkhorn_iters=5"]
    assert cli_main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["final_loss"]) and 0.0 <= out["hits@1"] <= 1.0
