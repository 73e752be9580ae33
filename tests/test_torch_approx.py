"""Port parity for the approximate, CSLS-mining and sqeuclidean search
paths: the shortlist kernel's plain version, the hubness terms, exact and
approximate mining, prefiltered proposals, prefiltered Hits@k and top-k,
and a training run whose history evals are approximate, against the JAX
package on the same inputs (CPU, plain versions).

On the CPU the JAX package's ``approx_min_k`` is exact and ordered like
``lax.top_k``, so its approximate paths select exactly what the port's
``torch.topk`` selects: the index sets agree, not just their recall."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugraph.serve import topk_alignments as jax_topk_alignments
from tpugraph.train.bootstrap import _nn1_prefiltered as jax_nn1_prefiltered
from tpugraph.train.bootstrap import propose_mutual_nn_pairs as jax_propose
from tpugraph.train.eval import hits_at_k as jax_hits
from tpugraph.train.negatives import _cand_hubness as jax_cand_hubness
from tpugraph.train.negatives import _hubness_both_approx as jax_hubness_both
from tpugraph.train.negatives import blockwise_knn_l1 as jax_knn
from tpugraph.train.negatives import sample_hard_negatives as jax_hard_negatives
from tpugraph_torch.configs.configs import get_config
from tpugraph_torch.kernels import shortlist_dist as sd
from tpugraph_torch.serve import main as serve_main
from tpugraph_torch.serve import save_embeddings, topk_alignments
from tpugraph_torch.train.bootstrap import _nn1_prefiltered, propose_mutual_nn_pairs
from tpugraph_torch.train.driver import run
from tpugraph_torch.train.eval import hits_at_k
from tpugraph_torch.train.loop import embed
from tpugraph_torch.train.mtl import attr_operator
from tpugraph_torch.train.negatives import (_cand_hubness, _hubness_both_approx,
                                            blockwise_knn_l1, sample_hard_negatives)


def _rows(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _correlated(seed, n1, n2, d, noise):
    """Two KGs whose first n1 entities are noisy copies of each other, so
    that mutual nearest neighbours exist; KG2 rows 0..n/20 shrunk towards
    the origin as hubs."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n1, d)).astype(np.float32)
    right = (np.pad(base, ((0, n2 - n1), (0, 0)))
             + noise * rng.standard_normal((n2, d)).astype(np.float32))
    right[: n2 // 20] *= 0.05
    return np.concatenate([base, right])


def _sets(a):
    return np.sort(np.asarray(a), axis=1)


@pytest.mark.parametrize("metric", ["cityblock", "sqeuclidean"])
@pytest.mark.parametrize("d", [16, 37])
def test_shortlist_dist_plain_matches_a_direct_computation(metric, d, monkeypatch):
    """The plain version (and the wrapper on CPU tensors) against a float64
    (S, K, d) computation, rtol 1e-5; also with a gather block smaller than
    the query count, so that several blocks run."""
    q, table = _rows(d, (50, d), (80, d))
    idx = np.random.default_rng(1).integers(0, 80, (50, 13))
    diff = q[:, None, :].astype(np.float64) - table[idx].astype(np.float64)
    want = np.abs(diff).sum(-1) if metric == "cityblock" else (diff * diff).sum(-1)
    args = (torch.from_numpy(q), torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_allclose(sd.shortlist_dist_plain(*args, metric).numpy(), want, rtol=1e-5)
    before = sd.launches
    got = sd.shortlist_dist(*args, metric)
    assert sd.launches == before  # the plain version launches nothing
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    monkeypatch.setattr(sd, "PLAIN_BLOCK_ELEMS", 7 * 13 * d)
    np.testing.assert_allclose(sd.shortlist_dist_plain(*args, metric).numpy(), want, rtol=1e-5)
    with pytest.raises(ValueError, match="unknown metric"):
        sd.shortlist_dist(*args, "cosine")
    meta = torch.empty(4, d, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        sd.shortlist_dist(meta, meta, torch.empty(4, 2, dtype=torch.int64, device="meta"))


@pytest.mark.parametrize("k", [7, 200])
def test_hubness_terms_match_jax(k):
    """``_cand_hubness`` (sqeuclidean) and ``_hubness_both_approx``, rtol
    1e-5; k = 200 exceeds the 120 queries, which the fused sweep clamps
    (the exact JAX term takes k ≤ S only)."""
    q, c = _rows(5, (120, 24), (150, 24))
    tq, tc = torch.from_numpy(q), torch.from_numpy(c)
    want_sq, want_l1 = jax_hubness_both(jnp.asarray(q), jnp.asarray(c), k, block_c=64)
    got_sq, got_l1 = _hubness_both_approx(tq, tc, k)
    np.testing.assert_allclose(got_sq.numpy(), np.asarray(want_sq), rtol=1e-5)
    np.testing.assert_allclose(got_l1.numpy(), np.asarray(want_l1), rtol=1e-5)
    if k <= q.shape[0]:
        want = jax_cand_hubness(jnp.asarray(q), jnp.asarray(c), k, "sqeuclidean", block_c=64)
        got = _cand_hubness(tq, tc, k, "sqeuclidean")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("metric,csls_k", [("sqeuclidean", 0), ("sqeuclidean", 5),
                                           ("cityblock", 5)])
@pytest.mark.parametrize("n_cands,k", [(70, 6), (3, 5)])
def test_exact_knn_matches_jax(metric, csls_k, n_cands, k):
    """Exact mining by sqeuclidean and by the CSLS score: the same index
    sets as the JAX package.  For sqeuclidean with a pool smaller than k the
    JAX package pads with a finite sentinel whose ids (≥ C) come back as
    negatives (ROADMAP Queue C 4), so that corner is held to what it should
    return instead: every id a real candidate, none the partner unless the
    pool holds nothing else, the row's best one in every padded column."""
    q, c = _rows(3, (40, 8), (n_cands, 8))
    exclude = np.random.default_rng(4).integers(-1, n_cands, 40)
    got = blockwise_knn_l1(torch.from_numpy(q), torch.from_numpy(c),
                           torch.from_numpy(exclude), k, block_c=16, metric=metric,
                           csls_k=csls_k).numpy()
    if metric == "sqeuclidean" and n_cands < k:
        d = ((q[:, None, :] - c[None, :, :]) ** 2).sum(-1)
        if csls_k:
            kk = min(csls_k, q.shape[0])
            d = 2 * d - np.sort(d, axis=0)[:kk].mean(0)[None, :]
        d[np.arange(40), np.where(exclude >= 0, exclude, 0)] = np.where(
            exclude >= 0, np.inf, d[np.arange(40), np.where(exclude >= 0, exclude, 0)])
        order = np.argsort(d, axis=1)
        assert (got < n_cands).all() and (got != exclude[:, None]).all()
        for row, ex in enumerate(exclude):
            n_valid = n_cands - (ex >= 0)
            np.testing.assert_array_equal(np.sort(got[row, :n_valid]),
                                          np.sort(order[row, :n_valid]))
            assert got[row, 0] == order[row, 0] and (got[row, n_valid:] == got[row, 0]).all()
        return
    want = jax_knn(jnp.asarray(q), jnp.asarray(c), jnp.asarray(exclude, jnp.int32), k,
                   block_c=16, metric=metric, csls_k=csls_k)
    np.testing.assert_array_equal(_sets(got), _sets(want))


@pytest.mark.parametrize("metric", ["cityblock", "sqeuclidean"])
@pytest.mark.parametrize("csls_k", [0, 5])
@pytest.mark.parametrize("n_cands,k", [(300, 10), (8, 10)])
def test_approx_knn_matches_jax(metric, csls_k, n_cands, k):
    """Approximate mining (the prefilter with its L1 rerank, the direct
    sqeuclidean selection, the exact L1 tile with CSLS; k ≥ C fills and
    re-excludes): the same index sets as the JAX package."""
    q, c = _rows(11, (130, 20), (n_cands, 20))
    exclude = np.random.default_rng(12).integers(-1, n_cands, 130)
    want = jax_knn(jnp.asarray(q), jnp.asarray(c), jnp.asarray(exclude, jnp.int32), k,
                   metric=metric, approx=True, csls_k=csls_k)
    got = blockwise_knn_l1(torch.from_numpy(q), torch.from_numpy(c),
                           torch.from_numpy(exclude), k, metric=metric, approx=True,
                           csls_k=csls_k).numpy()
    np.testing.assert_array_equal(_sets(got), _sets(want))
    if n_cands >= k:
        assert (got != exclude[:, None]).all()


@pytest.mark.parametrize("metric,approx,csls_k", [("cityblock", True, 0),
                                                  ("sqeuclidean", True, 10),
                                                  ("sqeuclidean", False, 10)])
def test_hard_negatives_match_jax(metric, approx, csls_k):
    emb = _correlated(6, 120, 140, 16, 0.4)
    rng = np.random.default_rng(7)
    pairs = np.stack([rng.permutation(120)[:60], 120 + rng.permutation(140)[:60]], 1)
    want = jax_hard_negatives(jnp.asarray(emb), jnp.asarray(pairs, jnp.int32), 120, 260, 12,
                              block_c=64, metric=metric, approx=approx, csls_k=csls_k)
    got = sample_hard_negatives(torch.from_numpy(emb), torch.from_numpy(pairs), 120, 260, 12,
                                block_c=64, metric=metric, approx=approx, csls_k=csls_k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_sets(g.numpy()), _sets(w))


def _masks(n1, n2, seed, s=40):
    rng = np.random.default_rng(seed)
    mask1, mask2 = np.ones(n1, bool), np.ones(n2, bool)
    mask1[rng.choice(n1, s, replace=False)] = False
    mask2[rng.choice(n2, s, replace=False)] = False
    return mask1, mask2


@pytest.mark.parametrize("metric", ["cityblock", "sqeuclidean"])
@pytest.mark.parametrize("csls_k", [0, 10])
def test_prefiltered_proposals_match_jax(metric, csls_k):
    """``_nn1_prefiltered`` (a bf16 selection tile, 16 shortlisted, the
    exact rerank): the same indices and, rtol 1e-5, scores; then
    ``propose_mutual_nn_pairs(approx=True)``: the same pairs in the same
    order and the same weights."""
    n1, n2 = 300, 320
    emb = _correlated(9, n1, n2, 32, 0.15)
    mask1, mask2 = _masks(n1, n2, 10)
    q, c = emb[:n1], emb[n1:]
    wv, wi = jax_nn1_prefiltered(jnp.asarray(q), jnp.asarray(c), jnp.asarray(mask2),
                                 metric=metric, csls_k=csls_k)
    gv, gi = _nn1_prefiltered(torch.from_numpy(q), torch.from_numpy(c),
                              torch.from_numpy(mask2), metric=metric, csls_k=csls_k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5)
    cap = 64
    want_p, want_w = jax_propose(jnp.asarray(emb), jnp.asarray(mask1), jnp.asarray(mask2),
                                 n1, n1 + n2, cap, metric=metric, csls_k=csls_k, approx=True)
    got_p, got_w = propose_mutual_nn_pairs(torch.from_numpy(emb), torch.from_numpy(mask1),
                                           torch.from_numpy(mask2), n1, n1 + n2, cap,
                                           metric=metric, csls_k=csls_k, approx=True)
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    assert got_w.sum() > cap // 2


def _trained_like(seed, n_test=300, d=32, noise=0.5):
    """Position-aligned test pairs (left i ↔ right i) of noisy copies, with
    hub rows on the right (as ``tests/test_eval_approx.py`` builds them)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n_test, d)).astype(np.float32)
    left = base + noise * rng.normal(size=(n_test, d)).astype(np.float32)
    right = base + noise * rng.normal(size=(n_test, d)).astype(np.float32)
    right[: n_test // 20] *= 0.05
    pairs = np.stack([np.arange(n_test), n_test + np.arange(n_test)], 1)
    return np.concatenate([left, right]), pairs


@pytest.mark.parametrize("csls_k", [0, 10])
@pytest.mark.parametrize("approx_k", [8, 64])
def test_prefiltered_hits_match_jax(csls_k, approx_k):
    emb, pairs = _trained_like(1)
    want = jax_hits(jnp.asarray(emb), jnp.asarray(pairs, jnp.int32), csls_k=csls_k,
                    approx_k=approx_k)
    got = hits_at_k(torch.from_numpy(emb), pairs, csls_k=csls_k, approx_k=approx_k)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-12), key


@pytest.mark.parametrize("csls_k", [0, 10])
@pytest.mark.parametrize("n2,k,approx_k", [(180, 5, 32), (6, 10, 4)])
def test_prefiltered_topk_matches_jax(csls_k, n2, k, approx_k):
    """The same ids in the same best-first order and, rtol 1e-5, the same
    scores; with 6 candidates and k = 10 the pool pads with inf at the
    first candidate."""
    emb = _correlated(2, 150, max(n2, 150), 16, 0.2)[: 150 + n2]
    q_ids, c_ids = np.arange(150), 150 + np.arange(n2)
    wv, wi = jax_topk_alignments(jnp.asarray(emb), q_ids, c_ids, k=k, csls_k=csls_k,
                                 approx_k=approx_k)
    gv, gi = topk_alignments(torch.from_numpy(emb), q_ids, c_ids, k=k, csls_k=csls_k,
                             approx_k=approx_k)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gv, wv, rtol=1e-5)
    assert (gv[:, 1:] >= gv[:, :-1]).all()  # best first
    if n2 < k:
        assert np.isinf(gv[:, n2:]).all() and (gi[:, n2:] == c_ids[0]).all()


def test_serve_cli_approx(tmp_path):
    emb = torch.from_numpy(_correlated(4, 60, 70, 16, 0.2))
    save_embeddings(str(tmp_path / "emb.pt"), emb)
    out = tmp_path / "al.tsv"
    assert serve_main(["--emb", str(tmp_path / "emb.pt"), "--out", str(out), "--n-left", "60",
                       "--k", "3", "--approx-k", "8", "--csls-k", "5", "--device", "cpu"]) == 0
    lines = out.read_text().strip().splitlines()
    _, ids = topk_alignments(emb, np.arange(60), 60 + np.arange(70), k=3, csls_k=5, approx_k=8)
    assert len(lines) == 60
    assert [int(cell.split(":")[0]) for cell in lines[7].split("\t")[1:]] == list(ids[7])


TINY = dict(syn_n_ent=150, syn_n_triples=600, dim=16, k_neg=4, neg_every=2, epochs=6,
            eval_every=2)


@pytest.mark.parametrize("name,over", [
    ("base", dict(eval_approx_k=4)),
    ("base", dict(eval_approx_k=4, eval_csls_k=5, neg_metric="sqeuclidean", neg_approx=True,
                  neg_csls_k=5, boot_cap=20, boot_start=2, boot_approx=True, boot_csls_k=5)),
    ("mtl", dict(eval_approx_k=4, use_attr_channel=True, neg_metric="sqeuclidean",
                 neg_approx=True, boot_cap=20, boot_start=2, boot_approx=True)),
])
def test_fit_history_is_approximate_and_final_exact(name, over):
    """A run's history evals count within 4-entry shortlists (so Hits@10
    reads 1.0) and its final metrics are exact: the last history record and
    the final eval score the same table, held to the JAX package's
    approximate and exact Hits@k on it.  The other cases also mine and
    propose by the approximate sqeuclidean paths, with CSLS, and through
    ``fit_mtl`` over the combined SE‖AE table of the attribute channel."""
    cfg = get_config(name, **TINY, **over)
    res = run(cfg, device="cpu")
    with torch.no_grad():
        emb = (embed(res.model, res.op) if name == "base"
               else res.model.embed(res.op, attr_operator(cfg, res.task, torch.device("cpu"))))
    assert emb.shape[1] == (2 if cfg.use_attr_channel else 1) * cfg.dim
    pairs = jnp.asarray(res.task.test_pairs, jnp.int32)
    approx = jax_hits(jnp.asarray(emb.numpy()), pairs, csls_k=cfg.eval_csls_k, approx_k=4)
    exact = jax_hits(jnp.asarray(emb.numpy()), pairs, csls_k=cfg.eval_csls_k)
    last = res.history[-1]
    assert [r["epoch"] for r in res.history] == [0, 2, 4, 5]
    assert last["hits@10"] == 1.0 and exact["hits@10"] < 1.0
    for key in ("hits@1", "hits@10", "mrr"):
        assert last[key] == pytest.approx(round(approx[key], 4), abs=1e-9), key
        assert res.metrics[key] == pytest.approx(exact[key], abs=1e-12), key
    t = res.timings
    assert t["minings"] == 2 and 0 < t["final_eval_s"] <= t["eval_s"]
    assert t["proposals"] == (2 if cfg.boot_cap else 0)
    assert np.isfinite(res.losses).all()
