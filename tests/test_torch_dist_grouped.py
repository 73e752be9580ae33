"""The grouped halo exchange of the distributed trainer (``halo_grouped``:
``dist/trainer.py::RowLayout``, ``sparse/halo_ell.py::rank_operators``,
``dist/mesh.py``'s halo groups) against the JAX package's and against the
ungrouped layout, on the CPU (gloo; the kernels run their plain versions):

* one margin step at a remap that moves KG2 (111 entities a side, 4 shards:
  r0 = 112) from the JAX trainer's parameters and an injected batch equals
  JAX's grouped ``make_encoder`` (``axis_index_groups``) +
  ``margin_align_loss`` under ``jax.grad``, for impls ell and sorted: the
  encoder output, the loss and every gradient within rtol 1e-4 / atol 1e-5
  (``tests/test_torch_dist.py``'s bounds);
* the halo SpMM on a graph of two components, at 4 and 8 shards on one
  rank, by both routes (x's rows, and the exchange), equals the dense A·x
  and its gradient (the JAX test's rtol 1e-5 / 1e-4), the padding rows'
  gradient 0;
* ``fit_distributed`` with ``halo_grouped`` equals the ungrouped run, each
  loss, the metrics and the entities' parameters: bit for bit at the
  identity remap, within rel 1e-6 at remaps that move KG2 (the port draws
  each entity's initial row, dropout mask and relation corruptions in
  entity order, so the layout moves no value; the shard boundaries move,
  and a row's sum splits otherwise between its local and boundary groups):
  hard mining and proposals in both impls, the ``mtl`` heads and channel
  with the OT head, dropout, the attribute channel with CSLS eval (the JAX
  tests' cases), on one host thread;
* the relation head's corruptions never reach the padding rows, odd shard
  counts are refused, a resume across the flag or to a shard count with
  another r0 raises the JAX layout message, and a grouped run stopped at 4
  shards resumes at 8 (the same r0) to the uncut run;
* spawned gloo ranks at W = 2 (Gr = 2: each rank holds one KG's half, no
  ``all_to_all_single`` is called) and W = 4 (Gr = 4: each call in a halo
  group of 2 ranks) equal W = 1: the halo SpMM's forward bit for bit and
  its gradient within 1e-6, a run's losses and metrics bit for bit, its
  parameters within rel 1e-6 (the weights' gradients are summed over the
  ranks in another order).
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
from tpugraph.sparse.build import coo_from_triples as jax_coo
from tpugraph.sparse.build import coo_normalize as jax_normalize
from tpugraph.sparse.halo_ell import build_halo_ell as jax_build_halo_ell
from tpugraph.sparse.partition import partition_edges as jax_partition_edges
from tpugraph.train.losses import margin_align_loss as jax_margin_loss
from tpugraph_torch.configs.configs import get_config
from tpugraph_torch.convert import params_from_jax
from tpugraph_torch.data.synthetic import synthetic_align_task
from tpugraph_torch.dist import mp_worker
from tpugraph_torch.dist.mesh import group_members, make_mesh
from tpugraph_torch.dist.trainer import RowLayout, dist_parts, fit_distributed
from tpugraph_torch.sparse.build import coo_to_dense
from tpugraph_torch.train.negatives import sample_uniform_negatives

CPU = torch.device("cpu")
KW = dict(dim=16, k_neg=4, n_shards=4)
UNEVEN = dict(seed=27, n_ent=111, n_rel=5, n_triples=450)  # 111 a side: r0 = 112 at 4 shards


def _jax_grouped_step(cfg, task, params, batch, impl):
    """JAX's grouped encoder (the trainer's row remap, ``n_groups=2``) on
    ``cfg.n_shards`` devices: its output, margin loss and gradients."""
    n1 = task.kg1.n_ent
    half = cfg.n_shards // 2
    r0 = half * -(-max(n1, task.n_ent - n1) // half)
    src, dst, w = jax_coo(task.n_ent, task.merged_triples, n_rel=task.n_rel,
                          weighting=cfg.weighting)
    w = jax_normalize(src, dst, w, task.n_ent, norm=cfg.norm)
    src, dst = (np.where(a < n1, a, a - n1 + r0) for a in (src, dst))
    hg = jax_partition_edges(src, dst, w, 2 * r0, cfg.n_shards, n_groups=2)
    mesh = jax_make_mesh(cfg.n_shards, 1)
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
    return emb, float(loss), params_from_jax(jax.tree_util.tree_map(np.asarray, grads))


@pytest.mark.parametrize("impl,highway", [("ell", False), ("sorted", True)])
def test_grouped_step_at_a_moving_remap_matches_jax(impl, highway):
    task = synthetic_align_task(**UNEVEN)
    cfg = get_config("highway" if highway else "base", spmm_impl=impl, halo_grouped=True, **KW)
    rows = RowLayout.of(cfg, task)
    assert (rows.n1, rows.r0, rows.n_rows) == (111, 112, 224)
    params = jax_init_params(jax.random.PRNGKey(3), rows.n_rows, cfg.dim, cfg.dim, highway)
    pairs = rows.rows(torch.as_tensor(task.train_pairs, dtype=torch.int64))
    neg_l, neg_r = sample_uniform_negatives(torch.Generator().manual_seed(5), pairs,
                                            task.kg1.n_ent, task.n_ent, cfg.k_neg)
    batch = {"pairs": pairs, "neg_l": neg_l, "neg_r": rows.rows(neg_r)}
    j_emb, j_loss, j_grads = _jax_grouped_step(cfg, task, params, batch, impl)
    with make_mesh(4, CPU, halo_grouped=True) as mesh:
        parts = dist_parts(cfg, task, mesh)
        assert parts.hg.n_groups == 2 and parts.hg.send_idx.shape[1] == 2
        parts.model.load_full(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
        emb = parts.embed()
        loss = parts.grads(batch)
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(emb.numpy(), j_emb, **tol)
    assert float(loss) == pytest.approx(j_loss, rel=1e-4)
    got = {k: v.grad for k, v in parts.model.named_parameters()}
    assert set(got) == set(j_grads)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), j_grads[k].numpy(), **tol, err_msg=k)


@pytest.mark.parametrize("impl", ["ell", "sorted"])
@pytest.mark.parametrize("n_shards", [4, 8])
def test_grouped_halo_spmm_matches_dense_by_both_routes(n_shards, impl):
    """At W = 1 by x's rows and through the exchange (the self-copy of the
    grouped send lists)."""
    n1, n2 = 60, 84
    src, dst, w = mp_worker.two_components(n1, n2)
    a = coo_to_dense(src, dst, w, n1 + n2, n1 + n2)
    x = np.random.default_rng(1).standard_normal((n1 + n2, 8)).astype(np.float32)
    for exchange in (False, True):
        out = mp_worker.grouped_halo_mode(n_shards, exchange)
        r0, (got, grad) = out["r0"], (t.numpy() for t in out[impl])
        assert out["direct"] != exchange
        np.testing.assert_allclose(np.concatenate([got[:n1], got[r0:r0 + n2]]), a @ x,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.concatenate([grad[:n1], grad[r0:r0 + n2]]),
                                   2 * a.T @ (a @ x), rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(grad[n1:r0], 0.0)
        np.testing.assert_array_equal(grad[r0 + n2:], 0.0)


MTL = dict(use_rel_head=True, use_attr_head=True, use_attr_channel=True, use_sinkhorn=True,
           sinkhorn_weight=0.5, attr_beta=0.8)
# the JAX tests' grouped runs (tests/test_halo_grouped.py), each with a task
# whose remap is the identity and one that moves KG2
RUNS = {
    "hard_boot_ell": (dict(seed=25, n_ent=120, n_rel=5, n_triples=500),
                      dict(epochs=8, eval_every=4, neg_every=4, neg_mode="hard", boot_cap=16,
                           boot_start=4, boot_weight=0.5)),
    "hard_boot_sorted_moved": (UNEVEN, dict(epochs=8, eval_every=4, neg_every=4, neg_mode="hard",
                                            boot_cap=16, boot_start=4, boot_weight=0.5,
                                            spmm_impl="sorted", neg_csls_k=3, eval_csls_k=5)),
    "uniform_moved": (UNEVEN, dict(epochs=8, eval_every=4, neg_every=4, neg_mode="uniform")),
    "mtl": (dict(seed=29, n_ent=120, n_rel=5, n_triples=500, n_attr=16),
            dict(epochs=6, eval_every=6, neg_every=3, neg_mode="uniform", **MTL)),
    "mtl_moved": (dict(seed=29, n_ent=111, n_rel=5, n_triples=450, n_attr=16),
                  dict(epochs=6, eval_every=6, neg_every=3, neg_mode="uniform", **MTL)),
    "dropout_moved": (UNEVEN, dict(epochs=6, eval_every=3, neg_every=3, dropout=0.3)),
    "attr_csls": (dict(seed=47, n_ent=128, n_rel=5, n_triples=500, n_attr=16),
                  dict(epochs=6, eval_every=3, neg_every=3, neg_mode="uniform",
                       use_attr_channel=True, attr_beta=0.8, eval_csls_k=5)),
}


# gradients 0 by construction (the margins read row differences): Adam
# steps them on rounding noise
ZERO_BY_CONSTRUCTION = ("gc2.b", "ae_encoder.gc2.b")


@pytest.fixture
def one_thread():
    """One host thread: an index backward sums in a fixed order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", list(RUNS))
def test_grouped_run_equals_ungrouped(case, one_thread):
    """At the identity remap the rows, the shards and every sum are the
    ungrouped run's: equal bit for bit.  A remap that moves KG2 moves the
    shard boundaries, so a row's sum splits differently between its local
    and boundary groups: each loss within rel 1e-6, the metrics within
    1e-6, the parameters within rel 1e-6 (a zero-gradient bias apart)."""
    task_kw, kw = RUNS[case]
    task = synthetic_align_task(**task_kw)
    cfg = get_config("base", syn_n_ent=task_kw["n_ent"], **KW, **kw)
    rg = fit_distributed(cfg.replace(halo_grouped=True), task=task, device="cpu")
    ru = fit_distributed(cfg, task=task, device="cpu")
    rows = RowLayout.of(cfg.replace(halo_grouped=True), task)
    moved = rows.r0 > rows.n1
    assert moved == case.endswith("moved")
    assert len(rg.losses) == cfg.epochs and len(rg.history) == len(ru.history)
    assert set(rg.params) == set(ru.params)
    params = {k: (rows.entities(v) if k == "emb" else v, ru.params[k][:task.n_ent]
                  if k == "emb" else ru.params[k]) for k, v in rg.params.items()}
    if not moved:
        assert rg.losses == ru.losses and rg.metrics == ru.metrics
        for k, (got, want) in params.items():
            assert torch.equal(got, want), k
        return
    np.testing.assert_allclose(rg.losses, ru.losses, rtol=1e-6)
    for k, v in ru.metrics.items():
        assert rg.metrics[k] == pytest.approx(v, rel=1e-6, abs=1e-6), k
    for k, (got, want) in params.items():
        if k not in ZERO_BY_CONSTRUCTION:
            assert float((got - want).norm() / want.norm()) < 1e-6, k


def test_relation_corruptions_never_reach_the_padding_rows():
    """At a remap that moves KG2 the padding rows [n1, r0) and [r1, n_pad)
    get no gradient from any loss: they stay 0 however long a run with the
    relation head trains, while the real rows move."""
    task = synthetic_align_task(**UNEVEN)
    cfg = get_config("base", syn_n_ent=111, epochs=2, eval_every=0, neg_every=2,
                     neg_mode="uniform", halo_grouped=True, use_rel_head=True, rel_k_neg=4, **KW)
    rows = RowLayout.of(cfg, task)
    short = fit_distributed(cfg, task=task, device="cpu")
    long = fit_distributed(cfg.replace(epochs=6), task=task, device="cpu")
    for res in (short, long):
        emb = res.params["emb"]
        assert emb.shape[0] == rows.n_rows == 224
        assert torch.equal(emb[rows.n1:rows.r0], torch.zeros_like(emb[rows.n1:rows.r0]))
        assert torch.equal(emb[rows.r1:], torch.zeros_like(emb[rows.r1:]))
    assert not torch.allclose(short.params["emb"][:rows.n1], long.params["emb"][:rows.n1])


def test_odd_shards_and_an_odd_count_of_graph_ranks_are_refused():
    cfg = get_config("base", n_shards=3, halo_grouped=True, syn_n_ent=64, syn_n_triples=200)
    with pytest.raises(ValueError, match="even n_shards"):
        fit_distributed(cfg, device="cpu")
    # the halo groups split each graph group into its two halves, in order
    assert group_members((1, 4, 2), halo_grouped=True)["halo"] == [[0, 2], [4, 6], [1, 3],
                                                                     [5, 7]]
    assert "halo" not in group_members((1, 2, 1), halo_grouped=True)  # a rank per KG half
    with pytest.raises(ValueError, match="do not split"):
        group_members((1, 3, 1), halo_grouped=True)


def test_the_layout_is_enforced_on_resume(tmp_path):
    """Equal-sized KGs give the grouped and ungrouped tables the same shape
    (256 rows): the stamp refuses a resume across the flag; the same layout
    resumes."""
    task = synthetic_align_task(seed=37, n_ent=128, n_rel=5, n_triples=500)
    cfg = get_config("base", syn_n_ent=128, epochs=4, eval_every=0, neg_every=2,
                     neg_mode="uniform", checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2,
                     halo_grouped=True, **KW)
    fit_distributed(cfg, task=task, device="cpu")
    with pytest.raises(ValueError, match=r"row layout \(halo_grouped, kg2_base\)=\(1, 128\) but "
                                         r"this run uses \(0, 128\)"):
        fit_distributed(cfg.replace(halo_grouped=False, epochs=6), task=task, device="cpu")
    res = fit_distributed(cfg.replace(epochs=6), task=task, device="cpu")
    assert res.timings["start_epoch"] == 4 and np.isfinite(res.metrics["final_loss"])


def test_a_grouped_run_stopped_at_four_shards_resumes_at_eight(tmp_path):
    """120 entities a side: r0 = 120 at 4 and at 8 shards.  A run with hard
    negatives stopped by SIGTERM in its 5th step (epoch 4, mid-interval)
    resumes at 8 shards, from its saved batch, to the uncut run; a resume
    at 14 shards (r0 = 126) raises the layout message."""
    task_kw = dict(seed=9, n_ent=120, n_rel=5, n_triples=500)
    task = synthetic_align_task(**task_kw)
    cfg = get_config("base", syn_n_ent=120, epochs=8, eval_every=0, neg_every=3,
                     neg_mode="hard", checkpoint_every=2, halo_grouped=True, **KW)
    ck = str(tmp_path / "ck")
    cut = mp_worker.preempt_mode(cfg, task_kw, ck, 5, None)
    assert cut["steps"] == 5 and cut["saves"] == 2  # epochs 2 and 4
    full = fit_distributed(cfg, task=task, device="cpu")
    resumed = fit_distributed(cfg.replace(n_shards=8, checkpoint_dir=ck), task=task,
                              device="cpu")
    assert resumed.timings["start_epoch"] == 5
    np.testing.assert_allclose(cut["losses"] + resumed.losses, full.losses, rtol=1e-6)
    assert resumed.metrics["final_loss"] == pytest.approx(full.metrics["final_loss"], rel=1e-6)
    with pytest.raises(ValueError, match=r"\(halo_grouped, kg2_base\)=\(1, 120\) but this run "
                                         r"uses \(1, 126\)"):
        fit_distributed(cfg.replace(n_shards=14, checkpoint_dir=ck), task=task, device="cpu")


# the spawned ranks' run: hard CSLS mining, proposals and CSLS evals at a
# remap that moves KG2
SPAWN_CFG = get_config("base", syn_n_ent=111, dim=16, epochs=6, eval_every=3, k_neg=4,
                       neg_every=3, neg_mode="hard", neg_csls_k=3, eval_csls_k=5, boot_cap=12,
                       boot_start=3, halo_grouped=True)
WORLDS = {2: 4, 4: 8}  # W: n_shards (Gr = W, each KG half on W/2 ranks)


@pytest.fixture(scope="module")
def spawns(tmp_path_factory):
    """A spawn of W gloo ranks for each of ``WORLDS`` (W = 2 refusing every
    ``all_to_all_single``), and the same work on one in-process rank."""
    out, threads = {}, torch.get_num_threads()
    for world, n_shards in WORLDS.items():
        cfgs = {"fit": SPAWN_CFG.replace(n_shards=n_shards)}
        ranks = mp_worker.run_ranks("grouped", world, tmp_path_factory.mktemp(f"w{world}"),
                                    n_shards, cfgs, UNEVEN, world == 2, timeout=240.0)
        torch.set_num_threads(1)  # as each rank runs
        try:
            out[world] = ranks, mp_worker.grouped_mode(n_shards, cfgs, UNEVEN, True)
        finally:
            torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("world", list(WORLDS))
def test_ranks_equal_one(spawns, world):
    ranks, one = spawns[world]
    assert not one["calls"] and one["halo"]["direct"]
    for impl in ("ell", "sorted"):
        out, grad = (torch.cat([r["halo"][impl][i] for r in ranks]) for i in range(2))
        assert torch.equal(out, one["halo"][impl][0]), impl
        torch.testing.assert_close(grad, one["halo"][impl][1], rtol=1e-6, atol=1e-6)
    for r in ranks:
        assert r["fit"]["losses"] == one["fit"]["losses"]
        assert r["fit"]["metrics"] == one["fit"]["metrics"]
        assert r["fit"]["timings"]["minings"] == 1 and r["fit"]["timings"]["proposals"] == 1
        for k, v in one["fit"]["params"].items():  # the weights' gradients summed over ranks
            if k not in ZERO_BY_CONSTRUCTION:
                assert float((r["fit"]["params"][k] - v).norm() / v.norm()) < 1e-6, k


def test_two_ranks_each_hold_a_kg_half_and_exchange_nothing(spawns):
    """Gr = 2: each rank's boundary reads its own rows; the spawn ran with
    ``all_to_all_single`` raising."""
    ranks, _ = spawns[2]
    assert all(r["halo"]["direct"] and not r["calls"] for r in ranks)


def test_four_ranks_exchange_in_their_halo_groups(spawns):
    """Gr = 4: every ``all_to_all_single`` runs in a group of 2 ranks (the
    rank's KG half); each layer pass of each step calls one."""
    ranks, _ = spawns[4]
    for r in ranks:
        assert not r["halo"]["direct"]
        assert r["calls"] and set(r["calls"]) == {2}
    assert len({len(r["calls"]) for r in ranks}) == 1
