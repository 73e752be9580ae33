"""Port parity for recipe v6's modules: the recipe table, bootstrapped
mutual-NN proposals, the CSLS hubness terms, CSLS Hits@k and top-k serving,
AlignMTL's margin loss over the proposals, one interval boundary, and
``--recipe`` through the CLI, against the JAX package on the same inputs
(CPU, plain versions)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugraph.configs.configs import get_config as jax_get_config
from tpugraph.configs.recipes import RECIPES as JAX_RECIPES
from tpugraph.models.align import AlignMTL as JaxAlignMTL
from tpugraph.models.encoder import AlignGCN as JaxAlignGCN
from tpugraph.serve import _topk_query as jax_topk_query
from tpugraph.sparse.build import build_adjacency as jax_build_adjacency
from tpugraph.train.bootstrap import propose_mutual_nn_pairs as jax_propose
from tpugraph.train.eval import _both_direction_ranks as jax_ranks
from tpugraph.train.eval import _knn_mean_l1 as jax_knn_mean_l1
from tpugraph.train.eval import hits_at_k as jax_hits
from tpugraph.train.negatives import _cand_hubness as jax_cand_hubness
from tpugraph.train.negatives import sample_hard_negatives as jax_hard_negatives
from tpugraph_torch.cli.main import main as cli_main
from tpugraph_torch.configs.configs import get_config
from tpugraph_torch.configs.recipes import RECIPES
from tpugraph_torch.convert import params_from_jax
from tpugraph_torch.data.synthetic import synthetic_align_task
from tpugraph_torch.models.align import AlignMTL
from tpugraph_torch.models.encoder import AlignGCN
from tpugraph_torch.serve import topk_alignments
from tpugraph_torch.sparse.build import build_adjacency
from tpugraph_torch.train.bootstrap import propose_mutual_nn_pairs
from tpugraph_torch.train.eval import _both_direction_ranks, _knn_mean_l1, hits_at_k
from tpugraph_torch.train.loop import check_schedule, embed
from tpugraph_torch.train.negatives import _cand_hubness, sample_hard_negatives


@pytest.fixture
def one_thread():
    """Sinkhorn's exp(−C/τ) amplifies torch's run-to-run reduction order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _emb(seed, n=160, d=24):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _boot_setup(seed, n1=80, n2=100, d=12, s=30):
    """Embeddings and seed masks; with few non-seed entities for the
    padding case."""
    rng = np.random.default_rng(seed)
    n = n1 + n2
    emb = rng.standard_normal((n, d)).astype(np.float32)
    pairs = np.stack([rng.choice(n1, s, replace=False),
                      n1 + rng.choice(n2, s, replace=False)], 1).astype(np.int32)
    mask1 = np.ones(n1, bool)
    mask1[pairs[:, 0]] = False
    mask2 = np.ones(n2, bool)
    mask2[pairs[:, 1] - n1] = False
    return emb, mask1, mask2, n1, n


def test_recipes_equal_the_jax_table():
    assert RECIPES == JAX_RECIPES
    for name in ("v1", "v2", "v3", "v4", "v5", "v6", "v7", "v7r"):
        check_schedule(get_config("base", **RECIPES[name]))
    v7, v7r = get_config("base", **RECIPES["v7"]), get_config("base", **RECIPES["v7r"])
    assert {k for k, v in v7.to_dict().items() if v7r.to_dict()[k] != v} == {"attr_weight"}


@pytest.mark.parametrize("case,csls_k", [("many", 0), ("many", 10), ("few_mutual", 0)])
def test_proposals_match_jax(case, csls_k):
    """The same pairs in the same order and the same weights; with a cap
    above the mutual pairs (and above n1), weight-0 rows [0, n1] pad it."""
    if case == "many":
        emb, mask1, mask2, n1, n = _boot_setup(7)
        cap = 16
    else:
        emb, mask1, mask2, n1, n = _boot_setup(3, n1=20, n2=25, s=15)
        cap = 64
    want_p, want_w = jax_propose(jnp.asarray(emb), jnp.asarray(mask1), jnp.asarray(mask2),
                                 n1, n, cap, block_c=32, csls_k=csls_k)
    got_p, got_w = propose_mutual_nn_pairs(torch.from_numpy(emb), torch.from_numpy(mask1),
                                           torch.from_numpy(mask2), n1, n, cap, block_c=32,
                                           csls_k=csls_k)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    assert 0 < got_w.sum() < cap if case == "few_mutual" else got_w.sum() > 0


@pytest.mark.parametrize("n_q,k", [(70, 10), (6, 10)])
def test_hubness_terms_match_jax(n_q, k):
    """_cand_hubness (r(j) over a query pool) and _knn_mean_l1, whose k is
    clamped to a pool smaller than k: rtol 1e-5."""
    emb = _emb(0)
    q, c = emb[:n_q], emb[80:150]
    if n_q >= k:  # the JAX hubness takes no k above its query pool
        want = jax_cand_hubness(jnp.asarray(q), jnp.asarray(c), k, "cityblock", block_c=32)
        got = _cand_hubness(torch.from_numpy(q), torch.from_numpy(c), k, block_c=32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    want = jax_knn_mean_l1(jnp.asarray(c), jnp.asarray(q), k, block_c=32)
    got = _knn_mean_l1(torch.from_numpy(c), torch.from_numpy(q), k, block_c=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def _near_threshold(emb, pairs, csls_k):
    """Per query and direction, the candidates whose float64 CSLS score lies
    within 1e-5·d of the threshold: the ranks may differ by that many."""
    e = emb.astype(np.float64)
    left, right = e[pairs[:, 0]], e[pairs[:, 1]]
    out = []
    for q, c in ((left, right), (right, left)):
        d = np.abs(q[:, None, :] - c[None, :, :]).sum(-1)
        k = min(csls_k, len(q))
        r = np.sort(d, axis=0)[:k].mean(0)  # each candidate's hubness over the queries
        score = 2 * d - r[None, :]
        thresh = np.diag(score)[:, None]
        near = np.abs(score - thresh) <= 1e-5 * np.abs(d).max()
        np.fill_diagonal(near, False)
        out.append(near.sum(1))
    return out


@pytest.mark.parametrize("pool", ["normal", "small"])
def test_csls_hits_match_jax(pool):
    """Both directions' CSLS ranks and the metrics; the small pool (6 pairs,
    csls_k 10) clamps k and matches csls_k = 6 exactly."""
    if pool == "normal":
        emb = _emb(1)
        emb[100:130] = emb[0:30] + 0.3 * emb[30:60]
        pairs = np.stack([np.arange(0, 60), np.arange(100, 160)], 1).astype(np.int32)
    else:
        emb = np.random.default_rng(9).standard_normal((40, 8)).astype(np.float32)
        pairs = np.stack([np.arange(6), 20 + np.arange(6)], 1).astype(np.int32)
    jl, jr = jax_ranks(jnp.asarray(emb), jnp.asarray(pairs), block_c=16, csls_k=10)
    tl, tr = _both_direction_ranks(torch.from_numpy(emb), torch.from_numpy(pairs).long(),
                                   block_c=16, csls_k=10)
    for got, want, slack in zip((tl, tr), (jl, jr), _near_threshold(emb, pairs, 10)):
        assert np.all(np.abs(got.numpy() - np.asarray(want)) <= slack)
    want = jax_hits(jnp.asarray(emb), pairs, csls_k=10)
    got = hits_at_k(torch.from_numpy(emb), pairs, csls_k=10)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    if pool == "small":
        assert got == hits_at_k(torch.from_numpy(emb), pairs, csls_k=6)
        assert got["hits@1"] < 1.0


@pytest.mark.parametrize("n_cands,k", [(90, 10), (40, 40)])
def test_csls_topk_matches_jax(n_cands, k):
    emb = _emb(2)
    q_ids = np.arange(0, 30)
    c_ids = np.arange(60, 60 + n_cands)
    jv, ji = jax_topk_query(jnp.asarray(emb), jnp.asarray(q_ids), jnp.asarray(c_ids), k, 16,
                            10)
    tv, ti = topk_alignments(torch.from_numpy(emb), q_ids, c_ids, k=k, block_c=16, csls_k=10)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(tv, np.asarray(jv), rtol=1e-5)


def _v6_small(task, **over):
    return {**RECIPES["v6"], "dim": 32, "k_neg": 5, "boot_cap": 24, "boot_start": 2,
            "syn_n_ent": task.kg1.n_ent, **over}


def _models(task, cfg_over):
    """A JAX AlignMTL and the port's, on the same weights."""
    jcfg = jax_get_config("base", **cfg_over)
    cfg = get_config("base", **cfg_over)
    jop = jax_build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel,
                              use_native=False, fmt="ell")
    op = build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel)
    jmodel = JaxAlignMTL(n_ent=task.n_ent, n_rel=task.n_rel, n_attr=1, cfg=jcfg)
    s, n1 = len(task.train_pairs), task.kg1.n_ent
    probe = {"pairs": jnp.asarray(task.train_pairs),
             "neg_l": jnp.zeros((s, cfg.k_neg), jnp.int32),
             "neg_r": jnp.full((s, cfg.k_neg), n1, jnp.int32)}
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jop, probe)["params"]
    model = AlignMTL(task.n_ent, cfg)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    return jmodel, jop, params, model, op, cfg


def test_alignmtl_loss_and_grads_with_boot_pairs_match_jax(one_thread):
    """Margin over seed + proposals with weights (0.5, and 0 for padding),
    Sinkhorn over the seed pairs: loss and every gradient rel 1e-5."""
    task = synthetic_align_task(seed=3, n_ent=120, n_rel=6, n_triples=500)
    jmodel, jop, params, model, op, cfg = _models(task, _v6_small(task))
    rng = np.random.default_rng(6)
    s, n1, n = len(task.train_pairs), task.kg1.n_ent, task.n_ent
    cap = cfg.boot_cap
    boot = np.stack([rng.integers(0, n1, cap), rng.integers(n1, n, cap)], 1)
    boot_w = np.where(np.arange(cap) < cap // 2, 0.5, 0.0).astype(np.float32)
    boot[cap // 2:] = [0, n1]
    pairs_aug = np.concatenate([task.train_pairs, boot]).astype(np.int32)
    w = np.concatenate([np.ones(s, np.float32), boot_w])
    negs = (rng.integers(0, n1, (s + cap, 5)), rng.integers(n1, n, (s + cap, 5)))
    jbatch = {"pairs": jnp.asarray(task.train_pairs), "pairs_aug": jnp.asarray(pairs_aug),
              "w": jnp.asarray(w), "neg_l": jnp.asarray(negs[0], jnp.int32),
              "neg_r": jnp.asarray(negs[1], jnp.int32)}
    batch = {"pairs": torch.from_numpy(task.train_pairs).long(),
             "pairs_aug": torch.from_numpy(pairs_aug).long(), "w": torch.from_numpy(w),
             "neg_l": torch.from_numpy(negs[0]), "neg_r": torch.from_numpy(negs[1])}
    (want, jaux), grads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, jop, jbatch), has_aux=True))(params)
    loss, aux = model(op, batch)
    loss.backward()
    assert loss.item() == pytest.approx(float(want), rel=1e-5)
    assert aux["margin"].item() == pytest.approx(float(jaux["margin"]), rel=1e-5)
    want_g = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    for name, p in model.named_parameters():
        g, wg = p.grad, want_g[name]
        assert float((g - wg).norm() / wg.norm()) < 1e-5, name


def test_interval_boundary_matches_jax():
    """One boundary from the same parameters: the proposals, then hard
    negatives mined over seed + proposals."""
    task = synthetic_align_task(seed=5, n_ent=150, n_rel=6, n_triples=600)
    cfg_over = _v6_small(task, boot_cap=40)
    jcfg, cfg = jax_get_config("base", **cfg_over), get_config("base", **cfg_over)
    jop = jax_build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel,
                              use_native=False, fmt="ell")
    jenc = JaxAlignGCN(n_ent=task.n_ent, dim=jcfg.dim, spmm_impl="ell")
    params = jenc.init(jax.random.PRNGKey(1), jop)["params"]
    jemb = jenc.apply({"params": params}, jop)
    enc = AlignGCN(n_ent=task.n_ent, dim=cfg.dim)
    enc.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    emb = embed(enc, build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel))
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), rtol=1e-5, atol=1e-5)

    n1, n, pairs = task.kg1.n_ent, task.n_ent, task.train_pairs
    mask1 = np.ones(n1, bool)
    mask1[pairs[:, 0]] = False
    mask2 = np.ones(n - n1, bool)
    mask2[pairs[:, 1] - n1] = False
    jp, jw = jax_propose(jemb, jnp.asarray(mask1), jnp.asarray(mask2), n1, n, cfg.boot_cap)
    tp, tw = propose_mutual_nn_pairs(emb, torch.from_numpy(mask1), torch.from_numpy(mask2),
                                     n1, n, cfg.boot_cap)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert tw.sum() > 0
    pairs_t = np.concatenate([pairs, np.asarray(jp)]).astype(np.int32)
    want = jax_hard_negatives(jemb, jnp.asarray(pairs_t), n1, n, cfg.k_neg)
    got = sample_hard_negatives(emb, torch.from_numpy(pairs_t).long(), n1, n, cfg.k_neg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cli_recipe_v6_on_the_host(capsys, one_thread):
    """v6 with small sizes: bootstrapping from epoch 2, CSLS eval; v7 runs
    with the same sizes."""
    argv = ["--recipe", "v6", "--device", "cpu", "--quiet", "--set", "syn_n_ent=150",
            "syn_n_triples=600", "epochs=4", "boot_start=2", "boot_cap=30", "k_neg=5",
            "eval_every=0", "dim=32"]
    assert cli_main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["final_loss"]) and 0.0 <= out["hits@1"] <= 1.0
    assert cli_main(["--recipe", "v7", *argv[2:]]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["final_loss"]) and 0.0 <= out["hits@1"] <= 1.0
