"""The distributed trainer (``tpugraph_torch/dist/``) against the JAX
package's and against itself across shard and rank counts, on the CPU
(gloo; the kernels run their plain versions):

* with the JAX trainer's parameters (``params_from_jax``) and injected
  negatives, the encoder output and one margin step's loss and gradients
  equal JAX's ``make_encoder`` + ``margin_align_loss`` under ``jax.grad``
  on the conftest's 8 virtual devices (rtol 1e-4, atol 1e-5);
* ``fit_distributed`` at 8 shards equals 1 shard: uniform negatives loss
  rel 1e-4 and Hits@k abs 1e-6, hard negatives loss rel 1e-3, highway
  loss rel 1e-4 (``tests/test_dist.py``'s bounds);
* two spawned gloo ranks of 4 shards equal one rank (``dist/mp_worker.py``):
  the halo SpMM forward and gradient, the ring stages, three trainer steps
  within rel 1e-5, and ``edges_per_s_chip == edges_per_s / R`` exactly,
  unrounded;
* every refusal, the routing of ``driver.run`` and the CLI, and the saved
  table.
"""

import json

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
from tpugraph.sparse.halo_ell import build_halo_ell as jax_build_halo_ell
from tpugraph.sparse.partition import partition_edges as jax_partition_edges
from tpugraph.train.losses import margin_align_loss as jax_margin_loss
from tpugraph_torch.cli.main import main as cli_main
from tpugraph_torch.configs.configs import get_config
from tpugraph_torch.convert import params_from_jax
from tpugraph_torch.data.synthetic import synthetic_align_task
from tpugraph_torch.dist import mp_worker
from tpugraph_torch.dist.mesh import make_mesh, shards_of
from tpugraph_torch.dist.trainer import UNPORTED, dist_parts, fit_distributed
from tpugraph_torch.models.encoder import AlignGCN
from tpugraph_torch.serve import load_embeddings
from tpugraph_torch.sparse.build import build_adjacency
from tpugraph_torch.train.driver import run
from tpugraph_torch.train.negatives import sample_uniform_negatives

CPU = torch.device("cpu")
TASK = dict(seed=4, n_ent=120, n_rel=5, n_triples=500)
KW = dict(dim=16, epochs=12, eval_every=6, k_neg=6, neg_every=4, syn_n_ent=120)


def _jax_step(cfg, task, params, batch, impl):
    """JAX's distributed encoder output, margin loss and gradients."""
    mesh = jax_make_mesh(cfg.n_shards, 1)
    src, dst, w = jax_coo(task.n_ent, task.merged_triples, n_rel=task.n_rel,
                          weighting=cfg.weighting)
    w = jax_normalize(src, dst, w, task.n_ent, norm=cfg.norm)
    hg = jax_partition_edges(src, dst, w, task.n_ent, cfg.n_shards)
    halo = jax.device_put(jax_build_halo_ell(hg) if impl == "ell" else hg,
                          NamedSharding(mesh, P("graph")))
    encode = jax_make_encoder(mesh, halo, cfg.highway, impl=impl)
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


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of two gloo ranks holding 4 shards, and the same work on
    one in-process rank."""
    args = (4, TWO_RANK_CFG, TWO_RANK_TASK)
    ranks = mp_worker.run_ranks("check", 2, tmp_path_factory.mktemp("ranks"), *args,
                                timeout=240.0)
    return ranks, mp_worker.check_mode(*args)


@pytest.mark.parametrize("impl", ["ell", "sorted"])
def test_two_ranks_halo_equals_one(two_ranks, impl):
    ranks, one = two_ranks
    for i in range(2):  # output, gradient
        got = torch.cat([r["halo"][impl][i] for r in ranks])
        torch.testing.assert_close(got, one["halo"][impl][i], rtol=1e-5, atol=1e-6)


def test_two_ranks_ring_equals_one(two_ranks):
    ranks, one = two_ranks
    for r in ranks:
        for k in ("cityblock", "sqeuclidean", "tiny_pool"):
            assert torch.equal(r["ring"][k], one["ring"][k]), k
        assert r["ring"]["hits"] == one["ring"]["hits"]


def test_two_ranks_train_as_one_with_the_per_device_rate(two_ranks):
    ranks, one = two_ranks
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


REFUSED = {
    "feature_shards > 1": dict(feature_shards=2),
    "slice_shards > 1": dict(slice_shards=2),
    "halo_grouped": dict(halo_grouped=True),
    "checkpoint": dict(checkpoint_dir="ck", checkpoint_every=2),
    "use_sinkhorn": dict(use_sinkhorn=True),
    "heads": dict(use_rel_head=True),
    "attribute channel": dict(use_attr_channel=True),
    "boot_cap": dict(boot_cap=10),
    "CSLS": dict(eval_csls_k=10),
    "bf16": dict(param_dtype="bfloat16"),
    "steps_per_call": dict(steps_per_call=4, neg_every=4, epochs=8),
    "profile_dir": dict(profile_dir="prof"),
}


def test_unported_options_refuse_and_the_jax_refusals_come_first():
    task = synthetic_align_task(**TASK)
    assert len(REFUSED) == len(UNPORTED)
    more = [dict(use_attr_head=True), dict(neg_csls_k=5), dict(neg_approx=True),
            dict(eval_approx_k=16), dict(dropout=0.3), dict(l2_normalize=True)]
    for over in [*REFUSED.values(), *more]:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            fit_distributed(get_config("base", **{**KW, "n_shards": 2, **over}), task=task,
                            device="cpu")
    for over, what in ((dict(param_dtype="float16"), "param_dtype"),
                       (dict(halo_grouped=True, n_shards=3), "even n_shards"),
                       (dict(highway=True, hidden=8), "hidden == dim"),
                       (dict(neg_every=0), "neg_every")):
        with pytest.raises(ValueError, match=what):
            fit_distributed(get_config("base", **{**KW, "n_shards": 2, **over}), task=task,
                            device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        run(get_config("base", n_shards=2, **KW), task=task, device="cpu", debug_nans=True)
    for mode in mp_worker.REHEARSALS:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            mp_worker.run_ranks(mode, 2, "unused")
    with pytest.raises(ValueError, match="multiple of the world size"):
        shards_of(4, 3, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(get_config("dwy100k_dist", **KW), task=task)  # the card by default


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
