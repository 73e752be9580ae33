"""The distributed trainer's run options (``tpugraph_torch/dist/trainer.py``)
against the JAX package's and against itself, on the CPU (gloo, one rank;
the kernels run their plain versions):

* one distributed step with each encoder option — the attribute channel,
  dropout (an injected keep mask), ``l2_normalize``, bf16 — equals JAX's
  ``make_encoder`` with that option + the margin loss (+ the channel's)
  under ``jax.grad`` on the conftest's 8 virtual devices, from the JAX
  trainer's parameters (``params_from_jax``) and injected negatives: rtol
  1e-4 / atol 1e-5 in fp32, PERF.md §2's bf16 step limits in bf16;
* ``fit_distributed`` at 8 shards equals 1 shard with each option (losses
  rel 1e-4, Hits@k abs 1e-6; bf16 the JAX test's rel 0.02), and with the
  channel (and with dropout, whose keep mask is the single-device
  encoder's) equals ``fit_mtl`` / ``fit``;
* checkpoints: a ``dwy100k_dist``-shaped run (v7r, approximate mining and
  history evals, dropout) stopped by SIGTERM in the middle of an interval
  and resumed equals the uninterrupted run bit for bit; ``driver.evaluate``
  from its directory (and at another shard count) gives the run's final
  metrics; a checkpoint with another row-layout stamp, or none, is refused
  with the JAX messages, and so is an eval-only run without a checkpoint;
* ``debug_nans``: a poisoned run raises ``FloatingPointError`` naming the
  epoch.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tpugraph.dist.mesh import make_mesh as jax_make_mesh
from tpugraph.dist.trainer import init_params as jax_init_params
from tpugraph.dist.trainer import make_encoder as jax_make_encoder
from tpugraph.sparse.build import coo_from_triples as jax_coo
from tpugraph.sparse.build import coo_normalize as jax_normalize
from tpugraph.sparse.halo_ell import build_attr_incidence_ell as jax_attr_incidence
from tpugraph.sparse.halo_ell import build_halo_ell as jax_build_halo_ell
from tpugraph.sparse.partition import partition_edges as jax_partition_edges
from tpugraph.train.losses import margin_align_loss as jax_margin_loss
from tpugraph_torch.cli.main import main as cli_main
from tpugraph_torch.configs.configs import get_config
from tpugraph_torch.configs.recipes import RECIPES
from tpugraph_torch.convert import params_from_jax
from tpugraph_torch.data.synthetic import synthetic_align_task
from tpugraph_torch.dist.mesh import make_mesh
from tpugraph_torch.dist.mp_worker import sigterm_at_call
from tpugraph_torch.dist.trainer import dist_parts, fit_distributed
from tpugraph_torch.serve import load_embeddings
from tpugraph_torch.train.driver import evaluate, run
from tpugraph_torch.train.loop import fit, load_task
from tpugraph_torch.train.mtl import fit_mtl
from tpugraph_torch.train.negatives import sample_uniform_negatives

CPU = torch.device("cpu")
TASK = dict(seed=13, n_ent=120, n_rel=5, n_triples=500, n_attr=16)
KW = dict(dim=16, epochs=8, eval_every=4, k_neg=6, neg_every=4, syn_n_ent=120)
OPTIONS = {"channel": dict(use_attr_channel=True, attr_beta=0.8),
           "dropout": dict(dropout=0.3),
           "l2_normalize": dict(l2_normalize=True),
           # at dim 64: §2's bf16 limit rests on many units near 0; dim 16's
           # 3,840 units put gc2.w 0.139 from JAX (whose CPU compile keeps
           # excess precision between bf16 ops), dim 64's 0.064
           "bf16": dict(param_dtype="bfloat16", dim=64)}
BF16_STEP = dict(loss_rel=2.0 ** -7, grad_rel_l2=1e-1)  # PERF.md §2


def _jax_step(cfg, task, params, batch, keep):
    """JAX's distributed encoder with ``cfg``'s option, its margin loss
    (and the channel's) and gradients; ``keep`` the (n_pad, hidden) keep
    mask, injected as the JAX trainer's {0, 1/keep} mask."""
    mesh = jax_make_mesh(cfg.n_shards, 1)
    src, dst, w = jax_coo(task.n_ent, task.merged_triples, n_rel=task.n_rel,
                          weighting=cfg.weighting)
    w = jax_normalize(src, dst, w, task.n_ent, norm=cfg.norm)
    hg = jax_partition_edges(src, dst, w, task.n_ent, cfg.n_shards)
    put = NamedSharding(mesh, P("graph"))
    halo = jax.device_put(jax_build_halo_ell(hg), put)
    extra = ()
    if cfg.dropout > 0:
        extra += (jax.device_put(jnp.asarray(keep.numpy(), jnp.float32) / (1.0 - cfg.dropout),
                                 NamedSharding(mesh, P("graph", None))),)
    if cfg.use_attr_channel:
        extra += (jax.device_put(jax_attr_incidence(task.merged_attr_triples,
                                                    hg.n_loc * cfg.n_shards, task.n_attr,
                                                    cfg.n_shards, hg.n_loc), put),)
    encode = jax_make_encoder(mesh, halo, cfg.highway, impl="ell",
                              attr_channel=cfg.use_attr_channel, compute_dtype=cfg.param_dtype,
                              dropout=cfg.dropout > 0, l2_normalize=cfg.l2_normalize)
    pairs, neg_l, neg_r = (jnp.asarray(batch[k].numpy(), dtype=jnp.int32)
                           for k in ("pairs", "neg_l", "neg_r"))

    def loss_fn(p):
        out = encode(p, halo, *extra)
        se, ae = out if cfg.use_attr_channel else (out, None)
        loss = jax_margin_loss(se, pairs, neg_l, neg_r, cfg.gamma)
        if ae is not None:
            loss = loss + cfg.attr_channel_weight * jax_margin_loss(ae, pairs, neg_l, neg_r,
                                                                     cfg.gamma)
        return loss

    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), params_from_jax(jax.tree_util.tree_map(np.asarray, grads))


@pytest.mark.parametrize("option", list(OPTIONS))
def test_one_step_with_each_option_matches_jax(option):
    task = synthetic_align_task(**TASK)
    cfg = get_config("base", n_shards=8, **{**KW, **OPTIONS[option]})
    n_pad = -(-task.n_ent // 8) * 8
    params = jax_init_params(jax.random.PRNGKey(3), n_pad, cfg.dim, cfg.dim, False,
                             n_attr_channel=task.n_attr if cfg.use_attr_channel else 0)
    pairs = torch.as_tensor(task.train_pairs, dtype=torch.int64)
    neg_l, neg_r = sample_uniform_negatives(torch.Generator().manual_seed(5), pairs,
                                            task.kg1.n_ent, task.n_ent, cfg.k_neg)
    batch = {"pairs": pairs, "neg_l": neg_l, "neg_r": neg_r}
    keep = torch.rand((n_pad, cfg.dim), generator=torch.Generator().manual_seed(2)) >= 0.3
    j_loss, want = _jax_step(cfg, task, jax.tree_util.tree_map(np.asarray, params), batch, keep)
    with make_mesh(8, CPU) as mesh:
        parts = dist_parts(cfg, task, mesh)
        parts.model.load_full(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
        loss = parts.grads(batch, keep if cfg.dropout > 0 else None)
    got = {k: v.grad for k, v in parts.model.named_parameters()}
    assert set(got) == set(want)
    assert set(parts.aux) == ({"margin", "ae"} if cfg.use_attr_channel else {"margin"})
    if option == "bf16":
        assert float(loss) == pytest.approx(j_loss, rel=BF16_STEP["loss_rel"])
        # gc2.b's gradient is 0 by construction (the margin reads differences
        # of rows): rounding noise in both, under sqrt(n)·2^-8 of the largest
        # gradient entry (PERF.md §2)
        scale = max(float(v.abs().max()) for v in want.values())
        noise = max(float(got["gc2.b"].abs().max()), float(want["gc2.b"].abs().max()))
        assert noise <= np.sqrt(n_pad) * 2 ** -8 * scale
        for k, g in got.items():
            if k != "gc2.b":
                assert float((g - want[k]).norm() / want[k].norm()) < BF16_STEP["grad_rel_l2"], k
        return
    assert float(loss) == pytest.approx(j_loss, rel=1e-4)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_eight_shards_equal_one_with_each_option(option):
    """And the single-device trainer: ``fit_mtl`` with the channel,
    ``fit`` otherwise (dropout draws the single-device mask)."""
    task = synthetic_align_task(**TASK)
    kw = {**KW, **OPTIONS[option]}
    r1 = fit_distributed(get_config("base", n_shards=1, **kw), task=task, device="cpu")
    r8 = fit_distributed(get_config("base", n_shards=8, **kw), task=task, device="cpu")
    assert r8.timings["steps"] == KW["epochs"] and len(r8.history) == 3  # epochs 0, 4, 7
    if option == "bf16":  # the JAX test's bound; the parameters stay fp32
        assert r8.history[-1]["loss"] == pytest.approx(r1.history[-1]["loss"], rel=0.02)
        assert r8.params["emb"].dtype == torch.float32
        assert np.isfinite(r8.metrics["hits@1"])
        return
    single = (fit_mtl if option == "channel" else fit)(
        get_config("base", **kw), task=task, device="cpu")
    for other in (r1, single):
        np.testing.assert_allclose(r8.losses, other.losses, rtol=1e-4)
        for k in ("hits@1", "hits@10", "mrr"):
            assert r8.metrics[k] == pytest.approx(other.metrics[k], abs=1e-6), k
    if option == "channel":
        assert r8.history[-1]["loss_ae"] > 0
        assert r8.params["ae_encoder.attr_emb"].shape == (task.n_attr, 16)
        torch.testing.assert_close(r8.params["ae_encoder.attr_emb"],
                                   single.params["ae_encoder.attr_emb"], rtol=1e-4, atol=1e-6)


# a dwy100k_dist-shaped run at test size: recipe v7r's surface with the
# approximate mining and history evals, dropout, checkpoints every 4 epochs
CKPT = get_config("dwy100k_dist", **{
    **RECIPES["v7r"], "dim": 16, "k_neg": 6, "epochs": 10, "eval_every": 4, "neg_every": 3,
    "boot_start": 3, "boot_cap": 20, "sinkhorn_pairs": 13, "syn_n_ent": 120, "neg_approx": True,
    "eval_approx_k": 8, "dropout": 0.2, "checkpoint_every": 4})


def test_sigterm_mid_interval_resume_is_bitwise_and_eval_only_matches(tmp_path):
    task = synthetic_align_task(**TASK)
    full = run(CKPT, task=task, device="cpu")
    cfg = CKPT.replace(checkpoint_dir=str(tmp_path / "ck"))
    undo = sigterm_at_call(5)  # during epoch 4, the second interval's middle
    try:
        first = run(cfg, task=task, device="cpu")
    finally:
        undo()
    assert first.timings["steps"] == 5 and first.timings["saves"] == 1  # epoch 4 once
    assert sorted(os.listdir(cfg.checkpoint_dir)) == ["ckpt-4.pt", "params.pt"]
    resumed = run(cfg, task=task, device="cpu")
    assert resumed.timings["start_epoch"] == 5 and resumed.timings["load_s"] > 0
    assert first.losses + resumed.losses == full.losses  # bit for bit
    assert resumed.metrics == full.metrics
    for k, v in full.params.items():
        assert torch.equal(resumed.params[k], v), k
    assert resumed.timings["saves"] == 2  # epochs 8 and 9 (the last)
    ev = evaluate(cfg, task=task, device="cpu")
    for k in ("hits@1", "hits@10", "mrr", "final_loss"):
        assert ev.metrics[k] == pytest.approx(full.metrics[k], abs=1e-4), k
    assert ev.timings["steps"] == 0 and ev.timings["start_epoch"] == 10
    # another shard count re-slices (and re-pads) the checkpoint's table
    ev4 = evaluate(cfg.replace(n_shards=4), task=task, device="cpu")
    for k in ("hits@1", "hits@10", "mrr"):
        assert ev4.metrics[k] == pytest.approx(full.metrics[k], abs=1e-4), k


def test_layout_stamp_and_missing_checkpoints_are_refused(tmp_path, capsys):
    cfg = get_config("dwy100k_dist", **{**KW, "epochs": 4, "eval_every": 0},
                     syn_n_rel=5, syn_n_triples=500, checkpoint_dir=str(tmp_path / "ck"),
                     checkpoint_every=2, save_emb_path=str(tmp_path / "emb.pt"))
    task = load_task(cfg)  # the task the CLI loads for these settings
    trained = run(cfg, task=task, device="cpu")
    path = os.path.join(cfg.checkpoint_dir, "ckpt-3.pt")
    state = torch.load(path, weights_only=True)
    assert state["layout"] == [0, task.kg1.n_ent]
    assert state["model"]["emb"].shape[0] == 240  # the whole padded table
    emb = load_embeddings(cfg.save_emb_path)
    assert emb.shape == (task.n_ent, 16)
    os.remove(cfg.save_emb_path)
    ev = evaluate(cfg, task=task, device="cpu")  # writes the table again, rows [:n]
    torch.testing.assert_close(load_embeddings(cfg.save_emb_path), emb, rtol=0, atol=0)
    assert ev.metrics["hits@1"] == trained.metrics["hits@1"]
    assert cli_main(["--config", "dwy100k_dist", "--eval-only", "--device", "cpu", "--quiet",
                     "--set", "syn_n_ent=120", "syn_n_rel=5", "syn_n_triples=500", "dim=16",
                     "k_neg=6", "neg_every=4",
                     f"checkpoint_dir={cfg.checkpoint_dir}"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["hits@1"] == round(trained.metrics["hits@1"], 4)
    torch.save({**state, "layout": [0, task.kg1.n_ent + 1]}, path)
    with pytest.raises(ValueError, match=r"row layout \(halo_grouped, kg2_base\)=\(0, 121\) but "
                                         r"this run uses \(0, 120\)"):
        evaluate(cfg, task=task, device="cpu")
    torch.save({k: v for k, v in state.items() if k != "layout"}, path)
    with pytest.raises(ValueError, match="predates the row-layout stamp"):
        run(cfg.replace(epochs=6), task=task, device="cpu")
    with pytest.raises(ValueError, match="needs cfg.checkpoint_dir"):
        evaluate(cfg.replace(checkpoint_dir=None), task=task, device="cpu")
    with pytest.raises(ValueError, match="no checkpoint found"):
        evaluate(cfg.replace(checkpoint_dir=str(tmp_path / "empty")), task=task, device="cpu")


def test_debug_nans_raises_naming_the_epoch():
    task = synthetic_align_task(**TASK)
    cfg = get_config("dwy100k_dist", **{**KW, "eval_every": 0, "lr": 1e30})
    with pytest.raises(FloatingPointError, match="epoch 1: a non-finite"):
        run(cfg, task=task, device="cpu", debug_nans=True)
    assert run(cfg.replace(lr=2e-3, epochs=2), task=task, device="cpu",
               debug_nans=True).timings["steps"] == 2
