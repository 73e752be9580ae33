"""Tensor parallelism and slices in the distributed trainer
(``tpugraph_torch/dist/``: ``feature_shards`` F, ``slice_shards`` L) against
the JAX trainer and against one rank, on the CPU (gloo; the kernels run
their plain versions):

* the rank grid (``dist/mesh.py::grid_of``): ranks to (s, g, f) in the JAX
  mesh's order, the three groups' members, and the ``ValueError`` for a
  world off the grid;
* one margin step from the JAX trainer's parameters (``params_from_jax``)
  and injected negatives equals JAX's ``make_encoder`` on
  ``make_mesh(2, 2, n_slice=2)`` (the conftest's 8 virtual devices) under
  ``jax.grad``: the encoder output, the loss and every gradient within
  rtol 1e-4 / atol 1e-5, at W = 1 and on W = 4 spawned gloo ranks in two
  layouts, (L, Gr, F) = (1, 2, 2) (the halo exchange and the ring in the
  graph group at F = 2) and (2, 1, 2); one case with highway gates on the
  sorted SpMM, one with the attribute channel and ``l2_normalize``;
* one step of recipe v7r's surface (proposals at their weights, the ring
  OT on a subsample, the relation and attribute heads) on both layouts
  equals W = 1 within rel 1e-5, once with a margin batch of 38 pairs and
  once of 37, which L = 2 does not divide (the leaf stays whole: a term
  counted twice over the slices would show);
* one step with the attribute channel and dropout equals W = 1 within
  PERF.md §2's bf16 step limits in bf16 on (1, 2, 2) and within rel 1e-5
  in fp32 on (2, 1, 2);
* the surface's 4-epoch run on (1, 2, 2), with hard CSLS mining, proposals
  and evals in the graph groups [0, 2] and [1, 3], equals W = 1: each loss,
  the metrics and every parameter within rel 1e-5;
* a run with hard negatives at (L, F) = (2, 2), stopped by SIGTERM after
  4 epochs and resumed at W = 1 (F = L = 1), equals the uninterrupted
  W = 1 run: each loss and the final loss within rel 1e-5.

Two spawns of 4 ranks, one per layout, each with several checks; each
rank runs one thread (``dist/mp_worker.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tpugraph.dist.mesh import make_mesh as jax_make_mesh
from tpugraph.dist.trainer import init_params as jax_init_params
from tpugraph.dist.trainer import make_encoder as jax_make_encoder
from tpugraph.models.attr_channel import combine_channels as jax_combine_channels
from tpugraph.sparse.build import coo_from_triples as jax_coo
from tpugraph.sparse.build import coo_normalize as jax_normalize
from tpugraph.sparse.halo_ell import build_attr_incidence_ell as jax_attr_incidence
from tpugraph.sparse.halo_ell import build_halo_ell as jax_build_halo_ell
from tpugraph.sparse.partition import partition_edges as jax_partition_edges
from tpugraph.train.losses import margin_align_loss as jax_margin_loss
from tpugraph_torch.configs.configs import get_config
from tpugraph_torch.configs.recipes import RECIPES
from tpugraph_torch.convert import params_from_jax
from tpugraph_torch.data.synthetic import synthetic_align_task
from tpugraph_torch.dist import mp_worker
from tpugraph_torch.dist.mesh import coords_of, grid_of, group_members, rank_of
from tpugraph_torch.dist.trainer import fit_distributed
from tpugraph_torch.train.negatives import sample_uniform_negatives

TASK = dict(seed=4, n_ent=120, n_rel=5, n_triples=500)
KW = dict(dim=16, k_neg=4, neg_every=2, syn_n_ent=120, n_shards=2)
TOL = dict(rtol=1e-4, atol=1e-5)
# the JAX step's cases: highway gates on the sorted SpMM; the attribute
# channel with l2_normalize on the ELL SpMM
JAX_CASES = {"highway": get_config("highway", spmm_impl="sorted", **KW),
             "channel_l2": get_config("base", use_attr_channel=True, l2_normalize=True, **KW)}
# recipe v7r's surface (tests/test_torch_dist.py's SURFACE on 2 shards):
# the margin over 18 seeds and 20 proposals, or 19
SURFACE = get_config("dwy100k_dist", **{
    **RECIPES["v7r"], **KW, "boot_start": 2, "boot_cap": 20, "sinkhorn_pairs": 13,
    "use_rel_head": True, "neg_csls_k": 3, "eval_csls_k": 5, "epochs": 4})
SURFACES = {"surface_38": SURFACE, "surface_37": SURFACE.replace(boot_cap=19)}
# the encoder's options on the surface, with epoch 1's keep mask: the
# attribute channel and dropout in bf16 on the layout with the halo exchange
# (its rows in bf16), in fp32 on the one with slices (the channel's margin
# striped)
OPTIONS = {"options_bf16": SURFACE.replace(use_attr_channel=True, dropout=0.3,
                                           param_dtype="bfloat16"),
           "options_fp32": SURFACE.replace(use_attr_channel=True, dropout=0.3)}
BF16_STEP = dict(loss_rel=2.0 ** -7, grad_rel_l2=1e-1)  # PERF.md §2
ZERO_BY_CONSTRUCTION = ("ae_encoder.gc2.b",)  # the channel's margin reads row differences
# hard negatives from epoch 2; SIGTERM on rank 1 during its 4th step (epoch
# 3, the middle of the interval 2-3): saves at epochs 2 and 3
PREEMPT = get_config("base", **{**KW, "epochs": 6, "eval_every": 0, "neg_mode": "hard",
                                "checkpoint_every": 2, "feature_shards": 2, "slice_shards": 2})
# the surface's run with evals at 2 and 3 (and the final one): hard CSLS
# mining and proposals at epoch 2
FIT = SURFACE.replace(eval_every=2)
LAYOUTS = {"graph": (1, 2), "slice": (2, 2)}  # (L, F) of W = 4: Gr = 2 and Gr = 1
LAYOUT_OPTIONS = dict(zip(LAYOUTS, OPTIONS))


def test_grid_maps_ranks_and_groups_as_the_jax_mesh():
    assert grid_of(1, 2, 8, 2) == (1, 1, 1)  # one rank holds every block
    assert grid_of(4, 1, 8, 1) == (1, 4, 1)  # F = L = 1: R divides S
    grid = grid_of(8, 2, 8, 2)
    assert grid == (2, 2, 2)
    # slice outermost, feature innermost: jax make_mesh's reshape(L, G, F)
    want = np.arange(8).reshape(2, 2, 2)
    for r in range(8):
        s, g, f = coords_of(r, grid)
        assert want[s, g, f] == r and rank_of(s, g, f, grid) == r
    assert group_members(grid) == {"graph": [[0, 2], [1, 3], [4, 6], [5, 7]],
                                   "feature": [[0, 1], [2, 3], [4, 5], [6, 7]],
                                   "slice": [[0, 4], [1, 5], [2, 6], [3, 7]]}
    assert group_members(grid_of(4, 2, 2, 2)) == {"graph": [[0], [1], [2], [3]],
                                                  "feature": [[0, 1], [2, 3]],
                                                  "slice": [[0, 2], [1, 3]]}
    for world, n_slice, n_shards, n_feature in ((6, 2, 8, 2), (12, 2, 8, 2), (3, 1, 8, 1),
                                                (2, 2, 8, 2)):
        with pytest.raises(ValueError, match="slice_shards·G·feature_shards"):
            grid_of(world, n_slice, n_shards, n_feature)
    with pytest.raises(ValueError, match="must be >= 1"):
        grid_of(4, 0, 8, 2)


def _batch(task, cfg) -> dict:
    pairs = torch.as_tensor(task.train_pairs, dtype=torch.int64)
    neg_l, neg_r = sample_uniform_negatives(torch.Generator().manual_seed(5), pairs,
                                            task.kg1.n_ent, task.n_ent, cfg.k_neg)
    return {"pairs": pairs, "neg_l": neg_l, "neg_r": neg_r}


def _jax_step(cfg, task, params, batch):
    """JAX's encoder on the 3-D mesh (2 slices, 2 graph shards, 2 feature
    blocks) with ``cfg``'s options: its evaluation table (with the channel,
    ``combine_channels`` of both), its margin loss (and the channel's) and
    gradients."""
    mesh = jax_make_mesh(cfg.n_shards, 2, n_slice=2)
    src, dst, w = jax_coo(task.n_ent, task.merged_triples, n_rel=task.n_rel,
                          weighting=cfg.weighting)
    w = jax_normalize(src, dst, w, task.n_ent, norm=cfg.norm)
    hg = jax_partition_edges(src, dst, w, task.n_ent, cfg.n_shards)
    impl = cfg.spmm_impl
    put = NamedSharding(mesh, P("graph"))
    halo = jax.device_put(jax_build_halo_ell(hg) if impl == "ell" else hg, put)
    extra = ()
    if cfg.use_attr_channel:
        extra = (jax.device_put(jax_attr_incidence(task.merged_attr_triples,
                                                   hg.n_loc * cfg.n_shards, task.n_attr,
                                                   cfg.n_shards, hg.n_loc), put),)
    encode = jax_make_encoder(mesh, halo, cfg.highway, impl=impl,
                              attr_channel=cfg.use_attr_channel, l2_normalize=cfg.l2_normalize)
    pairs, neg_l, neg_r = (jnp.asarray(batch[k].numpy(), dtype=jnp.int32)
                           for k in ("pairs", "neg_l", "neg_r"))

    def loss_fn(p):
        out = encode(p, halo, *extra)
        se, ae = out if cfg.use_attr_channel else (out, None)
        loss = jax_margin_loss(se, pairs, neg_l, neg_r, cfg.gamma)
        if ae is not None:
            loss = loss + cfg.attr_channel_weight * jax_margin_loss(ae, pairs, neg_l, neg_r,
                                                                     cfg.gamma)
        return loss, se if ae is None else jax_combine_channels(se, ae, cfg.attr_beta)

    with mesh:
        (loss, emb), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return {"emb": np.asarray(emb), "loss": float(loss),
            "grads": params_from_jax(jax.tree_util.tree_map(np.asarray, grads))}


@pytest.fixture(scope="module")
def cases():
    """The JAX steps and their parameters and batches, and each v7r
    surface step at W = 1."""
    task = synthetic_align_task(**TASK)
    out = {}
    for name, cfg in JAX_CASES.items():
        n_pad = -(-task.n_ent // cfg.n_shards) * cfg.n_shards
        params = jax.tree_util.tree_map(np.asarray, jax_init_params(
            jax.random.PRNGKey(3), n_pad, cfg.dim, cfg.dim, cfg.highway,
            n_attr_channel=task.n_attr if cfg.use_attr_channel else 0))
        batch = _batch(task, cfg)
        out[name] = (cfg, params_from_jax(params), batch, _jax_step(cfg, task, params, batch))
    one = {name: mp_worker.whole_step(cfg, TASK) for name, cfg in SURFACES.items()}
    one.update({name: mp_worker.whole_step(cfg, TASK, mask_epoch=1)
                for name, cfg in OPTIONS.items()})
    return out, one


@pytest.fixture(scope="module")
def spawns(cases, tmp_path_factory):
    """One spawn of 4 gloo ranks per layout: the JAX cases' steps, the v7r
    surface steps, on (L, F) = (1, 2) the surface's run, and on (2, 2) the
    run SIGTERM stops."""
    jax_cases, _ = cases
    out = {}
    for layout, (n_slice, n_feature) in LAYOUTS.items():
        tmp = tmp_path_factory.mktemp(layout)
        grid = dict(feature_shards=n_feature, slice_shards=n_slice)
        steps = {name: (cfg.replace(**grid), TASK, params, batch)
                 for name, (cfg, params, batch, _) in jax_cases.items()}
        steps.update({name: (cfg.replace(**grid), TASK) for name, cfg in SURFACES.items()})
        name = LAYOUT_OPTIONS[layout]
        steps[name] = (OPTIONS[name].replace(**grid), TASK, None, None, 1)
        preempt = (PREEMPT, TASK, str(tmp / "ck"), 4, 1) if layout == "slice" else None
        fit = (FIT.replace(**grid), TASK) if layout == "graph" else None
        out[layout] = (mp_worker.run_ranks("mesh", 4, tmp, steps, preempt, fit, timeout=240.0),
                       str(tmp / "ck"))
    return out


def _check_jax(got: dict, want: dict) -> None:
    np.testing.assert_allclose(got["emb"].numpy(), want["emb"], **TOL)
    assert float(got["loss"]) == pytest.approx(want["loss"], rel=1e-4)
    assert set(got["grads"]) == set(want["grads"])
    for k, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), want["grads"][k].numpy(), **TOL, err_msg=k)


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_one_rank_holding_every_block_matches_jax(cases, case):
    """W = 1 at F = L = 2: one rank holds every block and runs the F = L = 1
    step, which equals JAX's tensor-parallel, sliced step."""
    cfg, params, batch, want = cases[0][case]
    got = mp_worker.whole_step(cfg.replace(feature_shards=2, slice_shards=2), TASK, params,
                               batch)
    assert got["grid"] == (1, 1, 1)
    _check_jax(got, want)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_four_ranks_match_jax(cases, spawns, layout):
    """Each rank of W = 4 returns the whole encoder output, the loss and
    every gradient gathered from the grid, equal to JAX's: a gradient
    summed F times (a gather's backward mistaken for the layer input's) or
    1/F times would show."""
    ranks, _ = spawns[layout]
    n_slice, n_feature = LAYOUTS[layout]
    for r, res in enumerate(ranks):
        for case in JAX_CASES:
            assert res[case]["grid"] == (n_slice, 4 // (n_slice * n_feature), n_feature)
            _check_jax(res[case], cases[0][case][3])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_four_ranks_v7r_surface_equal_one(cases, spawns, layout):
    """The v7r surface step on W = 4 equals W = 1 (the loss, its terms and
    every gradient within rel 1e-5), with a margin batch L divides and one
    it does not; every rank holds the same whole loss and gradients."""
    ranks, _ = spawns[layout]
    one = cases[1]
    for name in SURFACES:
        want = one[name]
        assert set(want["aux"]) == {"margin", "sinkhorn", "rel", "attr"}
        for res in ranks:
            got = res[name]
            assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-5), name
            assert set(got["aux"]) == set(want["aux"])
            for k, v in want["aux"].items():
                assert float(got["aux"][k]) == pytest.approx(float(v), rel=1e-5), (name, k)
            assert set(got["grads"]) == set(want["grads"])
            for k, v in want["grads"].items():
                assert float((got["grads"][k] - v).norm() / v.norm()) < 1e-5, (name, k)
        for res in ranks[1:]:
            for k, v in ranks[0][name]["grads"].items():
                assert torch.equal(res[name]["grads"][k], v), (name, k)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_four_ranks_step_with_the_encoder_options_equals_one(cases, spawns, layout):
    """The attribute channel and dropout (the full-width keep mask on the
    gathered h) on W = 4: in bf16 on (L, Gr, F) = (1, 2, 2) within PERF.md
    §2's bf16 step limits of W = 1 (a layer input's cotangent is rounded to
    bf16 per feature block before its sum), in fp32 on (2, 1, 2) the loss
    and every gradient within rel 1e-5; a gradient 0 by construction as
    noise (under sqrt(n)·2^-8 in bf16, 1e-5 in fp32, of the largest
    entry)."""
    ranks, _ = spawns[layout]
    for name in (LAYOUT_OPTIONS[layout],):
        want = cases[1][name]
        assert set(want["aux"]) == {"margin", "ae", "sinkhorn", "rel", "attr"}
        bf16 = name.endswith("bf16")
        scale = max(float(v.abs().max()) for v in want["grads"].values())
        for res in ranks:
            got = res[name]
            rel = BF16_STEP["loss_rel"] if bf16 else 1e-5
            assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=rel), name
            for k, v in want["grads"].items():
                if k in ZERO_BY_CONSTRUCTION:
                    noise = np.sqrt(v.numel()) * 2 ** -8 if bf16 else 1e-5
                    assert float(got["grads"][k].abs().max()) <= noise * scale, (name, k)
                    continue
                err = float((got["grads"][k] - v).norm() / v.norm())
                assert err < (BF16_STEP["grad_rel_l2"] if bf16 else 1e-5), (name, k, err)


def test_four_ranks_mine_propose_and_evaluate_in_the_graph_groups(spawns):
    """The surface's 4-epoch run on (L, Gr, F) = (1, 2, 2), whose graph
    groups [0, 2] and [1, 3] are not contiguous in the world: the hard CSLS
    mining (``ring_knn`` and the hubness), the proposals and the evals
    (``ring_hits_at_k``) run over the graph group's global ranks and equal
    W = 1: each loss, the metrics and every parameter within rel 1e-5."""
    ranks, _ = spawns["graph"]
    one = fit_distributed(FIT, task=synthetic_align_task(**TASK), device="cpu")
    counts = ("minings", "proposals", "evals")
    assert [one.timings[k] for k in counts] == [1, 1, 4]
    for r in ranks:
        got = r["fit"]
        assert [got["timings"][k] for k in counts] == [1, 1, 4]
        np.testing.assert_allclose(got["losses"], one.losses, rtol=1e-5)
        for k, v in one.metrics.items():
            assert got["metrics"][k] == pytest.approx(v, rel=1e-5), k
        for rec, want in zip(got["history"], one.history, strict=True):
            for k in ("hits@1", "hits@10", "mrr"):
                assert rec[k] == pytest.approx(want[k], rel=1e-5), (rec["epoch"], k)
        for k, v in one.params.items():
            assert float((got["params"][k] - v).norm() / v.norm()) < 1e-5, k


def test_a_run_stopped_on_four_ranks_resumes_on_one(spawns):
    """SIGTERM reaching rank 1 alone stops the (L, F) = (2, 2) run on every
    rank after epoch 3 (saves at 2 and 3, rank 0 writing the whole table,
    weights and moments); W = 1 at F = L = 1 resumes it from epoch 4 to the
    uninterrupted W = 1 run's losses."""
    ranks, ck = spawns["slice"]
    assert [r["preempt"]["steps"] for r in ranks] == [4] * 4
    assert [r["preempt"]["saves"] for r in ranks] == [2] * 4
    assert all(r["preempt"]["losses"] == ranks[0]["preempt"]["losses"] for r in ranks)
    task = synthetic_align_task(**TASK)
    flat = PREEMPT.replace(feature_shards=1, slice_shards=1)
    full = fit_distributed(flat, task=task, device="cpu")
    resumed = fit_distributed(flat.replace(checkpoint_dir=ck), task=task, device="cpu")
    assert resumed.timings["start_epoch"] == 4 and resumed.timings["minings"] == 1
    np.testing.assert_allclose(ranks[0]["preempt"]["losses"] + resumed.losses, full.losses,
                               rtol=1e-5)
    assert resumed.metrics["final_loss"] == pytest.approx(full.metrics["final_loss"], rel=1e-5)
