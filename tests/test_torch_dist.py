"""The distributed trainer (``tpugraph_torch/dist/``) against the JAX
package's and against itself across shard and rank counts, on the CPU
(gloo; the kernels run their plain versions):

* with the JAX trainer's parameters (``params_from_jax``) and injected
  negatives, the encoder output and one margin step's loss and gradients
  equal JAX's ``make_encoder`` + ``margin_align_loss`` under ``jax.grad``
  on the conftest's 8 virtual devices (rtol 1e-4, atol 1e-5); so does one
  step of recipe v7r's surface (the margin with bootstrapped pairs at their
  weights, the ring OT on a subsample, the relation and attribute heads)
  against JAX's encoder, ``ring_sinkhorn_align_loss`` and the JAX
  trainer's head formulas, on an injected batch
  (``mp_worker.surface_batch``);
* ``fit_distributed`` at 8 shards equals 1 shard: uniform negatives loss
  rel 1e-4 and Hits@k abs 1e-6, hard negatives loss rel 1e-3, highway
  loss rel 1e-4 (``tests/test_dist.py``'s bounds); on the v7r surface
  (proposals, CSLS mining and eval, the draws of ``fit_mtl``) 8 shards
  equal 1 and ``fit_mtl``, losses rel 1e-4 and Hits@k abs 1e-6;
* two spawned gloo ranks of 4 shards equal one rank (``dist/mp_worker.py``):
  the halo SpMM forward and gradient, the ring stages (CSLS and the ring
  OT's potentials, loss and gradient among them), three trainer steps
  within rel 1e-5, and ``edges_per_s_chip == edges_per_s / R`` exactly,
  unrounded; one v7r-surface step's loss and every gradient, and a run's
  losses, within rel 1e-5; a fused run's losses and parameters within rel
  1e-5; the profiler's trace written by rank 0 alone;
* every refusal, the OT-size guard's message on each branch, the routing
  of ``driver.run`` and the CLI, and the saved table.

The grouped exchange (``halo_grouped``) is ``tests/test_torch_dist_grouped.py``'s,
the JAX worker's rehearsal modes ``tests/test_torch_dist_rehearsal.py``'s.
"""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tpugraph.dist.mesh import make_mesh as jax_make_mesh
from tpugraph.dist.ring import ring_sinkhorn_align_loss as jax_ring_ot_loss
from tpugraph.dist.trainer import init_params as jax_init_params
from tpugraph.dist.trainer import make_encoder as jax_make_encoder
from tpugraph.sparse.build import coo_from_triples as jax_coo
from tpugraph.sparse.build import coo_normalize as jax_normalize
from tpugraph.sparse.halo_ell import build_halo_ell as jax_build_halo_ell
from tpugraph.sparse.partition import partition_edges as jax_partition_edges
from tpugraph.train.losses import margin_align_loss as jax_margin_loss
from tpugraph_torch.cli.main import main as cli_main
from tpugraph_torch.configs.configs import get_config
from tpugraph_torch.configs.recipes import RECIPES
from tpugraph_torch.convert import params_from_jax
from tpugraph_torch.data.synthetic import synthetic_align_task
from tpugraph_torch.dist import mp_worker
from tpugraph_torch.dist.mesh import make_mesh, shards_of
from tpugraph_torch.dist.trainer import check_distributed, dist_parts, fit_distributed
from tpugraph_torch.models.encoder import AlignGCN
from tpugraph_torch.serve import load_embeddings
from tpugraph_torch.sparse.build import build_adjacency
from tpugraph_torch.train.driver import run
from tpugraph_torch.train.mtl import fit_mtl
from tpugraph_torch.train.negatives import sample_uniform_negatives

CPU = torch.device("cpu")
TASK = dict(seed=4, n_ent=120, n_rel=5, n_triples=500)
KW = dict(dim=16, epochs=12, eval_every=6, k_neg=6, neg_every=4, syn_n_ent=120)


# recipe v7r's surface at test size: proposals from epoch 2, the OT head on
# a 13-pair subsample of the 18 seeds, the attribute head, CSLS eval; plus the relation
# head and CSLS mining, which v7r leaves off
SURFACE = get_config("dwy100k_dist", **{
    **RECIPES["v7r"], **KW, "boot_start": 2, "boot_cap": 20, "sinkhorn_pairs": 13,
    "use_rel_head": True, "neg_csls_k": 3, "eval_csls_k": 5, "epochs": 8, "eval_every": 4,
    "neg_every": 2})


def _jax_encoder(cfg, task, impl):
    """JAX's mesh, halo operator and distributed encoder for ``cfg``."""
    mesh = jax_make_mesh(cfg.n_shards, 1)
    src, dst, w = jax_coo(task.n_ent, task.merged_triples, n_rel=task.n_rel,
                          weighting=cfg.weighting)
    w = jax_normalize(src, dst, w, task.n_ent, norm=cfg.norm)
    hg = jax_partition_edges(src, dst, w, task.n_ent, cfg.n_shards)
    halo = jax.device_put(jax_build_halo_ell(hg) if impl == "ell" else hg,
                          NamedSharding(mesh, P("graph")))
    return mesh, halo, jax_make_encoder(mesh, halo, cfg.highway, impl=impl)


def _jax_step(cfg, task, params, batch, impl):
    """JAX's distributed encoder output, margin loss and gradients."""
    mesh, halo, encode = _jax_encoder(cfg, task, impl)
    pairs, neg_l, neg_r = (jnp.asarray(batch[k].numpy(), dtype=jnp.int32)
                           for k in ("pairs", "neg_l", "neg_r"))

    def loss_fn(p):
        return jax_margin_loss(encode(p, halo), pairs, neg_l, neg_r, cfg.gamma)

    with mesh:
        emb = np.asarray(jax.jit(encode)(params, halo))
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return emb, float(loss), jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize("impl,highway", [("ell", False), ("sorted", True)])
def test_encoder_and_one_step_match_jax(impl, highway):
    task = synthetic_align_task(**TASK)
    cfg = get_config("highway" if highway else "base", n_shards=8, spmm_impl=impl, **KW)
    n_pad = -(-task.n_ent // 8) * 8
    params = jax_init_params(jax.random.PRNGKey(3), n_pad, cfg.dim, cfg.dim, highway)
    pairs = torch.as_tensor(task.train_pairs, dtype=torch.int64)
    neg_l, neg_r = sample_uniform_negatives(torch.Generator().manual_seed(5), pairs,
                                            task.kg1.n_ent, task.n_ent, cfg.k_neg)
    batch = {"pairs": pairs, "neg_l": neg_l, "neg_r": neg_r}
    j_emb, j_loss, j_grads = _jax_step(cfg, task, params, batch, impl)
    with make_mesh(8, CPU) as mesh:
        parts = dist_parts(cfg, task, mesh)
        parts.model.load_full(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
        emb = parts.embed()
        loss = parts.grads(batch)
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(emb.numpy(), j_emb, **tol)
    assert float(loss) == pytest.approx(j_loss, rel=1e-4)
    want = params_from_jax(j_grads)
    got = {k: v.grad for k, v in parts.model.named_parameters()}
    assert set(got) == set(want)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), **tol, err_msg=k)


def _jax_surface_loss(cfg, encode, halo, mesh, batch, rel_triples):
    """The JAX trainer's ``joint_loss`` of ``batch`` (``head_losses``'
    formulas, ``tpugraph/dist/trainer.py:459-506``), on the whole tree."""
    b = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    rel_tri = jnp.asarray(rel_triples)

    def loss_fn(p):
        se = encode({k: p[k] for k in ("emb", "gc1", "gc2")}, halo)
        loss = jax_margin_loss(se, b["pairs_aug"], b["neg_l"], b["neg_r"], cfg.gamma, b["w"])
        loss = loss + cfg.sinkhorn_weight * jax_ring_ot_loss(
            se, b["ot_pairs"], mesh, tau=cfg.sinkhorn_tau, n_iters=cfg.sinkhorn_iters)
        h, r, t = se[rel_tri[:, 0]], p["rel"][rel_tri[:, 1]], se[rel_tri[:, 2]]
        neg_t = jnp.einsum("td,tkd->tk", h * r, se[b["rel_neg_t"]])
        neg_h = jnp.einsum("td,tkd->tk", r * t, se[b["rel_neg_h"]])
        l_rel = (-jax.nn.log_sigmoid(jnp.sum(h * r * t, axis=-1)).mean()
                 - 0.5 * (jax.nn.log_sigmoid(-neg_t).mean() + jax.nn.log_sigmoid(-neg_h).mean()))
        at = b["attr_triples"]
        log_p = jax.nn.log_softmax(se[at[:, 0]] @ p["attr_out"]["w"] + p["attr_out"]["b"], -1)
        l_attr = -jnp.take_along_axis(log_p, at[:, 1:2], axis=1).mean()
        return loss + cfg.rel_weight * l_rel + cfg.attr_weight * l_attr

    return loss_fn


def test_v7r_surface_step_matches_jax():
    task = synthetic_align_task(**TASK)
    cfg = SURFACE.replace(n_shards=8)
    n_pad = -(-task.n_ent // 8) * 8
    params = jax_init_params(jax.random.PRNGKey(3), n_pad, cfg.dim, cfg.dim, False,
                             n_rel=task.n_rel, n_attr=task.n_attr)
    batch = mp_worker.surface_batch(cfg, task)
    assert int((batch["w"][len(task.train_pairs):] > 0).sum()) == 13  # live proposals
    mesh, halo, encode = _jax_encoder(cfg, task, "ell")
    with mesh:
        j_loss, j_grads = jax.jit(jax.value_and_grad(
            _jax_surface_loss(cfg, encode, halo, mesh, batch, task.merged_triples)))(params)
    with make_mesh(8, CPU) as mesh:
        parts = dist_parts(cfg, task, mesh)
        parts.model.load_full(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
        loss = parts.grads(batch)
    assert set(parts.aux) == {"margin", "sinkhorn", "rel", "attr"}
    assert float(loss) == pytest.approx(float(j_loss), rel=1e-4)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, j_grads))
    got = {k: v.grad for k, v in parts.model.named_parameters()}
    assert set(got) == set(want)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


def test_v7r_surface_eight_shards_equal_one_and_fit_mtl():
    task = synthetic_align_task(**TASK)
    r1 = fit_distributed(SURFACE.replace(n_shards=1), task=task, device="cpu")
    r8 = fit_distributed(SURFACE, task=task, device="cpu")
    single = fit_mtl(SURFACE.replace(n_shards=1), task=task, device="cpu")
    assert r8.timings["proposals"] == 3 and r8.timings["minings"] == 3
    assert r8.timings["draws"] == 4
    np.testing.assert_allclose(r8.losses, r1.losses, rtol=1e-4)
    np.testing.assert_allclose(r8.losses, single.losses, rtol=1e-4)
    for k in ("hits@1", "hits@10", "mrr"):
        assert r8.metrics[k] == pytest.approx(r1.metrics[k], abs=1e-6), k
        assert r8.metrics[k] == pytest.approx(single.metrics[k], abs=1e-6), k
    assert {"loss_margin", "loss_sinkhorn", "loss_rel", "loss_attr"} <= set(r8.history[-1])
    assert r8.params["rel_head.rel"].shape == (task.n_rel, 16)
    assert r8.params["attr_head.w"].shape == (16, task.n_attr)


@pytest.mark.parametrize("case", ["uniform", "hard", "highway"])
def test_eight_shards_equal_one(case):
    task = synthetic_align_task(**TASK)
    kw = dict(KW, neg_mode="hard" if case == "hard" else "uniform")
    if case == "hard":
        kw["k_neg"] = 4
    if case == "highway":
        kw.update(epochs=10, eval_every=5, neg_every=5)
    name = "highway" if case == "highway" else "base"
    r1 = fit_distributed(get_config(name, n_shards=1, **kw), task=task, device="cpu")
    r8 = fit_distributed(get_config(name, n_shards=8, **kw), task=task, device="cpu")
    rel = 1e-3 if case == "hard" else 1e-4
    assert r8.history[-1]["loss"] == pytest.approx(r1.history[-1]["loss"], rel=rel)
    assert r8.losses[-1] < r8.losses[-kw["neg_every"]]  # falling within the last interval
    if case != "hard":
        for k in ("hits@1", "hits@10", "mrr"):
            assert r8.metrics[k] == pytest.approx(r1.metrics[k], abs=1e-6), k
    assert r8.params["emb"].shape == (task.n_ent, 16)  # 120 rows per KG: 8 divides 240
    assert r8.timings["steps"] == kw["epochs"]
    assert r8.timings["minings"] == (2 if case == "hard" else 0)


TWO_RANK_CFG = get_config("base", n_shards=4, dim=16, epochs=3, eval_every=1, k_neg=4,
                          neg_every=2, syn_n_ent=120)
TWO_RANK_TASK = dict(seed=9, n_ent=120, n_rel=5, n_triples=500)


# one step with the encoder's options on the v7r surface: the attribute
# channel, dropout, bf16
OPTIONS_CFG = SURFACE.replace(use_attr_channel=True, dropout=0.3, param_dtype="bfloat16")
# a checkpointed run that SIGTERM stops: mined negatives from epoch 3, the
# signal reaching rank 1 alone at its 5th step (epoch 4, mid-interval)
PREEMPT_CFG = get_config("base", n_shards=4, dim=16, epochs=8, eval_every=0, k_neg=4,
                         neg_every=3, neg_mode="hard", neg_approx=True, checkpoint_every=2,
                         syn_n_ent=120)
# the fused interval: two steps a call, mined negatives in the second interval
FUSED_CFG = TWO_RANK_CFG.replace(epochs=4, steps_per_call=2, eval_every=2)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of two gloo ranks holding 4 shards, and the same work on
    one in-process rank; the spawn's checkpoint directory."""
    tmp = tmp_path_factory.mktemp("ranks")
    args = (4, TWO_RANK_CFG, TWO_RANK_TASK, SURFACE.replace(epochs=4), OPTIONS_CFG)
    ck = str(tmp / "ck")
    ranks = mp_worker.run_ranks("check", 2, tmp, *args, (PREEMPT_CFG, ck, 5, 1), FUSED_CFG,
                                str(tmp / "prof"), timeout=300.0)
    return ranks, mp_worker.check_mode(*args, fused_cfg=FUSED_CFG), ck


@pytest.mark.parametrize("impl", ["ell", "sorted"])
def test_two_ranks_halo_equals_one(two_ranks, impl):
    ranks, one, _ = two_ranks
    for i in range(2):  # output, gradient
        got = torch.cat([r["halo"][impl][i] for r in ranks])
        torch.testing.assert_close(got, one["halo"][impl][i], rtol=1e-5, atol=1e-6)


def test_two_ranks_ring_equals_one(two_ranks):
    ranks, one, _ = two_ranks
    for r in ranks:
        for k in ("cityblock", "sqeuclidean", "tiny_pool", "csls", "approx_cityblock",
                  "approx_sqeuclidean", "approx_csls_cityblock", "approx_csls_sqeuclidean"):
            assert torch.equal(r["ring"][k], one["ring"][k]), k
        for k in ("hits", "hits_csls", "hits_approx", "hits_approx_csls"):
            assert r["ring"][k] == one["ring"][k], k
        for s in mp_worker.OT_SIZES:  # loss, the table's gradient, f, g: whole on each rank
            for got, want in zip(r["ring"][f"ot_{s}"], one["ring"][f"ot_{s}"]):
                assert torch.isfinite(got).all()
                assert float((got - want).norm() / want.norm()) < 1e-5, s


def test_two_ranks_v7r_surface_equals_one(two_ranks):
    """The ring OT computed in part on each rank keeps the replicated-loss
    convention: the loss and every gradient (the table's rows, the shared
    weights summed once, the heads' not summed) equal one rank's."""
    ranks, one, _ = two_ranks
    want = one["surface"]["step"]
    for r in ranks:
        assert float(r["surface"]["step"]["loss"]) == pytest.approx(float(want["loss"]),
                                                                    rel=1e-5)
        assert set(r["surface"]["step"]["aux"]) == {"margin", "sinkhorn", "rel", "attr"}
        np.testing.assert_allclose(r["surface"]["fit"]["losses"], one["surface"]["fit"]["losses"],
                                   rtol=1e-5)
    got = {k: v for k, v in ranks[0]["surface"]["step"]["grads"].items() if k != "emb"}
    got["emb"] = torch.cat([r["surface"]["step"]["grads"]["emb"] for r in ranks])
    assert set(got) == set(want["grads"])
    for k, v in want["grads"].items():
        assert float((got[k] - v).norm() / v.norm()) < 1e-5, k
        for r in ranks[1:]:
            if k != "emb":
                assert torch.equal(r["surface"]["step"]["grads"][k], got[k]), k


def test_two_ranks_train_as_one_with_the_per_device_rate(two_ranks):
    ranks, one, _ = two_ranks
    for r in ranks:
        np.testing.assert_allclose(r["fit"]["losses"], one["fit"]["losses"], rtol=1e-5)
        for k, v in one["fit"]["params"].items():
            if k == "gc2.b":  # its gradient is 0 by construction: Adam steps on rounding noise
                continue
            assert float((r["fit"]["params"][k] - v).norm() / v.norm()) < 1e-5, k
        assert len(r["fit"]["history"]) == 3
        for rec in r["fit"]["history"]:  # unrounded, exact (ROADMAP.md Queue C 2)
            assert rec["edges_per_s_chip"] == rec["edges_per_s"] / 2
    for rec in one["fit"]["history"]:
        assert rec["edges_per_s_chip"] == rec["edges_per_s"]


def test_two_ranks_step_with_the_encoder_options_equals_one(two_ranks):
    """The attribute channel (its replicated weights summed over the
    ranks), dropout (each rank's rows of one global mask) and bf16 (the
    halo exchange's rows in bf16): the loss and every gradient equal one
    rank's within rel 1e-5."""
    ranks, one, _ = two_ranks
    want = one["options"]
    assert {"margin", "ae", "sinkhorn", "rel", "attr"} == set(want["aux"])
    got = {k: v for k, v in ranks[0]["options"]["grads"].items() if k != "emb"}
    got["emb"] = torch.cat([r["options"]["grads"]["emb"] for r in ranks])
    assert set(got) == set(want["grads"])
    for r in ranks:
        assert float(r["options"]["loss"]) == pytest.approx(float(want["loss"]), rel=1e-5)
    for k, v in want["grads"].items():
        assert float((got[k] - v).norm() / v.norm()) < 1e-5, k


def test_two_ranks_fused_equal_one_and_rank_zero_alone_traces(two_ranks):
    """A fused run (two steps an interval, eager on the host) on two ranks
    equals one rank's: each step's loss and the parameters within rel 1e-5,
    the metrics within 1e-6; the traced run wrote its trace of epochs 2-2
    (the run's end) on rank 0 only."""
    ranks, one, ck = two_ranks
    want = one["fused"]
    for r in ranks:
        np.testing.assert_allclose(r["fused"]["losses"], want["losses"], rtol=1e-5)
        assert len(r["fused"]["losses"]) == FUSED_CFG.epochs
        assert [h["epoch"] for h in r["fused"]["history"]] == [1, 3]
        for k in ("hits@1", "hits@10", "mrr"):
            assert r["fused"]["metrics"][k] == pytest.approx(want["metrics"][k], abs=1e-6), k
        for k, v in want["params"].items():
            if k != "gc2.b":  # 0 gradient by construction: Adam steps on rounding noise
                assert float((r["fused"]["params"][k] - v).norm() / v.norm()) < 1e-5, k
    prof = os.path.join(os.path.dirname(ck), "prof")
    assert os.listdir(os.path.join(prof, "rank0")) == ["trace-epochs-2-2.json"]
    assert not os.path.exists(os.path.join(prof, "rank1"))


def test_two_ranks_agree_on_a_sigterm_and_one_rank_resumes(two_ranks):
    """SIGTERM reaching rank 1 alone stops both ranks at the same epoch
    (the agreed latch), both save there (rank 0 writes), and one rank
    resumes the two ranks' checkpoint to the uninterrupted run's losses."""
    ranks, _, ck = two_ranks
    assert [r["preempt"]["steps"] for r in ranks] == [5, 5]  # epochs 0-4
    assert [r["preempt"]["saves"] for r in ranks] == [2, 2]  # epochs 2 and 4
    assert ranks[0]["preempt"]["losses"] == ranks[1]["preempt"]["losses"]
    assert sorted(os.listdir(ck)) == ["ckpt-2.pt", "ckpt-4.pt", "params.pt"]
    task = synthetic_align_task(**TWO_RANK_TASK)
    full = fit_distributed(PREEMPT_CFG, task=task, device="cpu")
    resumed = fit_distributed(PREEMPT_CFG.replace(checkpoint_dir=ck), task=task, device="cpu")
    assert resumed.timings["start_epoch"] == 5  # mid-interval: the saved negatives
    np.testing.assert_allclose(ranks[0]["preempt"]["losses"] + resumed.losses, full.losses,
                               rtol=1e-4)
    assert resumed.metrics["final_loss"] == pytest.approx(full.metrics["final_loss"], rel=1e-4)


def test_unported_options_refuse_and_the_jax_refusals_come_first():
    """Every option of the JAX trainer passes ``check_distributed`` and
    every rehearsal mode of the JAX worker is a mode of ``run_ranks``; what
    the JAX trainer refuses is refused with its message."""
    task = synthetic_align_task(**TASK)
    ported = [dict(checkpoint_dir="ck", checkpoint_every=2), dict(use_attr_channel=True),
              dict(neg_approx=True), dict(eval_approx_k=16), dict(param_dtype="bfloat16"),
              dict(dropout=0.3), dict(l2_normalize=True),
              dict(steps_per_call=4, neg_every=4, epochs=8), dict(profile_dir="prof"),
              dict(feature_shards=2), dict(slice_shards=2), dict(halo_grouped=True)]
    for over in ported:  # no longer refused
        check_distributed(get_config("base", **{**KW, "n_shards": 2, **over}), task)
    for over, what in ((dict(param_dtype="float16"), "param_dtype"),
                       (dict(halo_grouped=True, n_shards=3), "even n_shards"),
                       (dict(highway=True, hidden=8), "hidden == dim"),
                       (dict(neg_every=0), "neg_every")):
        with pytest.raises(ValueError, match=what):
            fit_distributed(get_config("base", **{**KW, "n_shards": 2, **over}), task=task,
                            device="cpu")
    bare = SimpleNamespace(train_pairs=task.train_pairs, merged_attr_triples=None, n_attr=0,
                           n_rel=0)  # a task without attribute triples or relation types
    for over, what in ((dict(use_attr_head=True), "attribute head"),
                       (dict(use_rel_head=True), "relation head")):
        with pytest.raises(ValueError, match=what):
            check_distributed(get_config("base", **{**KW, "n_shards": 2, **over}), bare)
    for mode in ("fit_checkpoint", "fitprod", "fitprod2"):  # the JAX worker's fit, fitprod*
        assert mode in mp_worker.MODES
    with pytest.raises(ValueError, match="unknown mode"):
        mp_worker.run_ranks("fit", 2, "unused")
    with pytest.raises(ValueError, match="multiple of the world size"):
        shards_of(4, 3, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(get_config("dwy100k_dist", **KW), task=task)  # the card by default


@pytest.mark.parametrize("n_shards", [1, 8])
def test_ot_size_guard_gives_the_jax_message_of_each_branch(n_shards):
    """An OT problem above 8,192 pairs: on one shard the JAX single-device
    message, on more the ring branch's, with its flop count
    (``tpugraph/dist/trainer.py:224-255``); sinkhorn_pairs caps it."""
    task = SimpleNamespace(train_pairs=np.zeros((9000, 2), np.int64), merged_attr_triples=None,
                           n_attr=0, n_rel=5)
    cfg = get_config("dwy100k_dist", n_shards=n_shards, use_sinkhorn=True, dim=256)
    what = ("does not compile" if n_shards == 1 else
            r"ring loss's ~3·S² per-iteration recompute \(1\.2e\+12 flops per loss step at "
            r"dim=256\)")
    with pytest.raises(ValueError, match=f"9000 pairs .*{what}.*sinkhorn_pairs <= 8192"):
        check_distributed(cfg, task)
    check_distributed(cfg.replace(sinkhorn_pairs=4096), task)
    check_distributed(cfg.replace(epochs=0), task)


def test_driver_and_cli_route_the_config_and_save_the_table(tmp_path, capsys):
    task = synthetic_align_task(**TASK)
    cfg = get_config("dwy100k_dist", **{**KW, "epochs": 4, "eval_every": 0},
                     save_emb_path=str(tmp_path / "emb.pt"))
    res = run(cfg, task=task, device="cpu")
    assert res.timings["minings"] == 0 and len(res.history) == 0
    # the saved table is the encoder's output of the final parameters, in
    # entity-id row order: the single-device encoder on the same parameters
    model = AlignGCN(task.n_ent, 16)
    model.load_state_dict({**res.params, "emb": res.params["emb"][:task.n_ent]})
    op = build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel, use_native=False)
    with torch.no_grad():
        torch.testing.assert_close(load_embeddings(cfg.save_emb_path), model(op),
                                   rtol=1e-5, atol=1e-5)
    assert cli_main(["--config", "dwy100k_dist", "--device", "cpu", "--quiet", "--set",
                     "syn_n_ent=60", "syn_n_rel=4", "syn_n_triples=200", "dim=8", "k_neg=3",
                     "epochs=6", "neg_every=3", "eval_every=0"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["config"] == "dwy100k_dist" and np.isfinite(line["hits@1"])


def test_cli_trains_recipe_v7r_on_the_config(capsys):
    """``--config dwy100k_dist --recipe v7r`` at a tiny size: the OT head on
    a subsample, the attribute head, proposals and the CSLS eval."""
    assert cli_main(["--config", "dwy100k_dist", "--recipe", "v7r", "--device", "cpu",
                     "--quiet", "--set", "syn_n_ent=120", "syn_n_rel=5", "syn_n_triples=500",
                     "dim=8", "k_neg=3", "epochs=4", "boot_start=2", "boot_cap=10",
                     "eval_every=0", "sinkhorn_pairs=12"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["config"] == "dwy100k_dist"
    assert all(np.isfinite(line[k]) for k in ("hits@1", "hits@10", "mrr", "final_loss"))
