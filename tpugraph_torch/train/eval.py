"""Blockwise Hits@k / MRR (counterpart of ``tpugraph/train/eval.py``).

    rank(i) = #{ j != i : s(l_i, r_j) < s(l_i, r_i) }

with s = d, the L1 distance, or with ``csls_k > 0`` the CSLS score
s(q, j) = 2·d(q, j) − r(j), r(j) the mean distance of candidate j to its
csls_k nearest queries (the query's own term cancels within a row).
The exact path is the L1 search (``kernels/l1_search.py``): the counts
one ``l1_count`` per direction, the hubness terms one ``l1_topk`` each (on
the card one kernel launch apiece, with no distance tile in device
memory).  The true match is excluded by index, not by its score tying
the threshold.

``approx_k > 0`` (the training-history evals, ``eval_approx_k``) counts
within a shortlist instead: each query's ``approx_k`` nearest candidates
by the sqeuclidean score, selected exactly (the JAX package's
``approx_min_k`` is approximate on the TPU and exact on the CPU) and scored
in exact L1 in the same select-and-rerank call
(``kernels/shortlist_dist.py::select_rerank``).  With CSLS both hubness
terms come from one sqeuclidean-selected sweep
(``negatives._hubness_both_approx``).
``dist_tile`` is the (Q, C) distance tile of the sqeuclidean search paths
(an fp32 product, as the JAX package computes it outside any kernel) and
of cityblock callers that need the whole tile (``l1_search.l1_tile``).
"""

from __future__ import annotations

import numpy as np
import torch

from tpugraph_torch.kernels.l1_search import l1_count, l1_tile, l1_topk
from tpugraph_torch.kernels.shortlist_dist import check_metric, select_rerank, sq_norms
from tpugraph_torch.train.losses import pairwise_l1


BLOCK_Q = 256  # queries per sqeuclidean block of the exact search paths


def dist_tile(q: torch.Tensor, cands: torch.Tensor, metric: str = "cityblock",
              block_c: int = 1024, c2: torch.Tensor | None = None) -> torch.Tensor:
    """(Q, C) fp32 distances.  cityblock: ``l1_search.l1_tile`` (``block_c``
    is kept for the JAX signature: the search blocks its own work).
    sqeuclidean: the expanded form ‖q‖² + ‖c‖² − 2·q·c in one fp32
    product, not clamped at 0, as in the JAX package (``c2``: the
    candidates' ``sq_norms``, when the caller holds them)."""
    check_metric(metric)
    if metric == "sqeuclidean":
        c2 = sq_norms(cands) if c2 is None else c2
        return sq_norms(q)[:, None] + c2[None, :] - 2.0 * (q.float() @ cands.float().t())
    return l1_tile(q.contiguous(), cands.contiguous())


def _ranks_l1(q: torch.Tensor, cands: torch.Tensor, d_true: torch.Tensor,
              block_c: int = 1024, cand_corr: torch.Tensor | None = None,
              true_corr: torch.Tensor | None = None) -> torch.Tensor:
    """For each query, count candidates strictly closer than its true match
    (candidate i is query i's true match: position-aligned pools).  With
    (cand_corr, true_corr) candidate j scores 2·d(q, j) − cand_corr[j]
    against the threshold 2·d_true − true_corr.  One ``l1_count``
    (``block_c`` is kept for the JAX signature)."""
    s, c = q.shape[0], cands.shape[0]
    if s != c:
        raise ValueError(f"_ranks_l1 requires position-aligned pools, got S={s} C={c}")
    csls = {} if cand_corr is None else dict(a=2.0, bias=cand_corr.contiguous())
    thresh = d_true if cand_corr is None else 2.0 * d_true - true_corr
    return l1_count(q.contiguous(), cands.contiguous(), thresh.float().contiguous(),
                    self_col=torch.arange(s, device=q.device), **csls)


def _knn_mean_l1(q: torch.Tensor, cands: torch.Tensor, k: int,
                 block_c: int = 1024) -> torch.Tensor:
    """Mean L1 distance of each query to its k nearest candidates (the CSLS
    hubness term), k clamped to the pool size: one ``l1_topk``'s values
    (``block_c`` is kept for the JAX signature)."""
    k = min(k, cands.shape[0])
    return l1_topk(q.contiguous(), cands.contiguous(), k)[0].mean(dim=1)


def _ranks_l1_prefiltered(q: torch.Tensor, cands: torch.Tensor, d_true: torch.Tensor,
                          approx_k: int, cand_corr: torch.Tensor | None = None,
                          csls_k: int = 0, r_sel: torch.Tensor | None = None) -> torch.Tensor:
    """Ranks counted within a shortlist: each query's ``approx_k`` nearest
    candidates by the sqeuclidean score (2·d₂ − r_sel(j) with CSLS, so that
    candidates CSLS promotes past the true match are kept), then the exact
    L1 (or L1 CSLS, with ``cand_corr``) score of each entry against the
    true match's.  Position-aligned pools; the true match is excluded by
    index.  ``r_sel``: the sqeuclidean hubness, when the caller holds it."""
    s = q.shape[0]
    if s != cands.shape[0]:
        raise ValueError(f"_ranks_l1_prefiltered requires position-aligned pools, "
                         f"got S={s} C={cands.shape[0]}")
    csls = {}
    if csls_k > 0:
        if r_sel is None:
            from tpugraph_torch.train.negatives import _hubness_both_approx

            r_sel = _hubness_both_approx(q, cands, csls_k)[0]
        csls = dict(a=2.0, bias=r_sel)
    short, _, score = select_rerank(q, cands, min(approx_k, s), rerank="cityblock", **csls)
    thresh = d_true
    if csls_k > 0:
        score = 2.0 * score - cand_corr[short]
        thresh = 2.0 * d_true - cand_corr  # candidate i is query i's true match
    is_self = short == torch.arange(s, device=q.device)[:, None]
    return ((score < thresh[:, None]) & ~is_self).sum(dim=1)


def _both_direction_ranks(emb: torch.Tensor, test_pairs: torch.Tensor, block_c: int = 1024,
                          csls_k: int = 0,
                          approx_k: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(ranks_l2r, ranks_r2l) over the test pairs; ``approx_k > 0`` counts
    within shortlists (``_ranks_l1_prefiltered``)."""
    left = emb.index_select(0, test_pairs[:, 0])
    right = emb.index_select(0, test_pairs[:, 1])
    d_true = pairwise_l1(left, right).float()
    if approx_k > 0:
        from tpugraph_torch.train.negatives import _hubness_both_approx

        ka = min(approx_k, right.shape[0])
        if csls_k <= 0:
            return (_ranks_l1_prefiltered(left, right, d_true, ka),
                    _ranks_l1_prefiltered(right, left, d_true, ka))
        # one sweep per direction gives both hubness terms, oriented per
        # candidate pool: (sel_l, corr_l) are the left entities' hubness
        # over the right pool
        sel_l, corr_l = _hubness_both_approx(right, left, csls_k)
        sel_r, corr_r = _hubness_both_approx(left, right, csls_k)
        return (_ranks_l1_prefiltered(left, right, d_true, ka, corr_r, csls_k, sel_r),
                _ranks_l1_prefiltered(right, left, d_true, ka, corr_l, csls_k, sel_l))
    if csls_k <= 0:
        return (_ranks_l1(left, right, d_true, block_c=block_c),
                _ranks_l1(right, left, d_true, block_c=block_c))
    # the hubness of each right entity over the left pool, and the reverse
    corr_l = _knn_mean_l1(left, right, csls_k, block_c)
    corr_r = _knn_mean_l1(right, left, csls_k, block_c)
    return (_ranks_l1(left, right, d_true, block_c, cand_corr=corr_r, true_corr=corr_r),
            _ranks_l1(right, left, d_true, block_c, cand_corr=corr_l, true_corr=corr_l))


def hits_at_k(emb: torch.Tensor, test_pairs, ks: tuple[int, ...] = (1, 10),
              block_c: int = 1024, csls_k: int = 0, approx_k: int = 0) -> dict[str, float]:
    """Both-direction Hits@k and MRR over the test alignment pairs; the
    candidate pool is the test entities of the opposite KG.  ``csls_k > 0``
    ranks by the CSLS score; ``approx_k > 0`` counts within a shortlist of
    that many candidates per query (approximate: the training loop's
    history evals use it; its final metrics stay exact)."""
    pairs = torch.as_tensor(np.asarray(test_pairs), dtype=torch.int64, device=emb.device)
    rl, rr = _both_direction_ranks(emb, pairs, block_c=block_c, csls_k=csls_k,
                                   approx_k=approx_k)
    return rank_metrics(rl, rr, ks)


def rank_metrics(rl: torch.Tensor, rr: torch.Tensor,
                 ks: tuple[int, ...] = (1, 10)) -> dict[str, float]:
    """Hits@k and MRR of each direction's ranks and their means (the ring
    eval's, ``dist/ring.py``, too)."""
    both = torch.stack([rl, rr]).cpu().numpy()  # single readback
    out = {}
    for tag, ranks in (("l2r", both[0]), ("r2l", both[1])):
        for k in ks:
            out[f"hits@{k}_{tag}"] = float((ranks < k).mean())
        out[f"mrr_{tag}"] = float((1.0 / (ranks.astype(np.float64) + 1.0)).mean())
    for k in ks:
        out[f"hits@{k}"] = 0.5 * (out[f"hits@{k}_l2r"] + out[f"hits@{k}_r2l"])
    out["mrr"] = 0.5 * (out["mrr_l2r"] + out["mrr_r2l"])
    return out
