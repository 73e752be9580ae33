"""Negative sampling for the margin loss (counterpart of
``tpugraph/train/negatives.py``).

* uniform: ``torch.randint`` from an explicit ``torch.Generator`` on the
  host, moved to the run's device, so one seed gives the same negatives on
  the CPU and on the card.  The numbers differ from ``jax.random``'s for the
  same seed; the parity tests inject one set of ids into both packages.
* hard, exact (``approx=False``): the k nearest non-partner entities of the
  opposite KG in L1 or sqeuclidean (``metric``): cityblock in one
  ``kernels/l1_search.py::l1_topk`` (on the card one kernel launch with a
  running queue per query, no distance tile in device memory);
  sqeuclidean blocked over queries, each block keeping its (BLOCK_Q, C)
  distance row (``eval.dist_tile``) and taking one ``topk``: the same k
  smallest as the JAX package's running merge.  ``csls_k > 0`` ranks by the
  CSLS score 2·d(q, j) − r(j), r the candidate's hubness over the whole
  query pool (the query's own term cannot change a row's top k).  Where the
  pool is smaller than k, the JAX package's sqeuclidean path pads with a
  finite sentinel whose ids escape its mask (ROADMAP Queue C 4); the port
  has no pad columns, so every column without a real candidate takes the
  row's best valid one, as in the cityblock path.
* hard, approximate (``approx=True``): one select-and-rerank call per
  direction (``kernels/shortlist_dist.py::select_rerank``: on the card one
  launch that scores the sqeuclidean product on the tensor cores, keeps each
  query's running shortlist and reranks it, with no (queries, C) tile in
  device memory).  Cityblock without CSLS shortlists
  ``k_short = min(C, max(2k, k + 8))`` candidates by the sqeuclidean score
  and keeps the k nearest in exact L1; sqeuclidean selects the k directly;
  cityblock with CSLS selects exactly through ``l1_topk``.  The JAX
  package selects with ``lax.approx_min_k`` (approximate on the TPU, exact
  on the CPU); the port selects exactly.  Mining returns index sets: their
  order within a row is not part of the contract.

``_cand_hubness`` (exact) and ``_hubness_both_approx`` (selected by the
sqeuclidean score, its L1 term scored in the same call) are the CSLS
hubness terms that mining, proposals, eval and serving share.
"""

from __future__ import annotations

import torch

from tpugraph_torch.kernels.l1_search import l1_topk
from tpugraph_torch.kernels.shortlist_dist import check_metric, select_rerank
from tpugraph_torch.train.eval import BLOCK_Q, _knn_mean_l1, dist_tile, sq_norms

HUB_BLOCK = 4096  # candidates per exact sqeuclidean hubness tile, as in the JAX package


def sample_uniform_negatives(gen: torch.Generator, pairs: torch.Tensor, n_ent_1: int,
                             n_ent: int, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Corrupt the left slot within KG1 ids, the right within KG2's global
    ids.  ``gen`` is a CPU generator; the result lies on ``pairs``' device."""
    s = pairs.shape[0]
    neg_l = torch.randint(0, n_ent_1, (s, k), generator=gen, dtype=torch.int64)
    neg_r = torch.randint(n_ent_1, n_ent, (s, k), generator=gen, dtype=torch.int64)
    return neg_l.to(pairs.device), neg_r.to(pairs.device)


def blockwise_knn_l1(q: torch.Tensor, cands: torch.Tensor, exclude: torch.Tensor, k: int,
                     block_c: int = 1024, metric: str = "cityblock", approx: bool = False,
                     csls_k: int = 0) -> torch.Tensor:
    """Indices (into cands) of the k nearest candidates per query by
    ``metric`` (the CSLS score with ``csls_k > 0``), the query's own partner
    ``exclude[i]`` (-1 = none) masked out.

    A pool smaller than k leaves columns with no real candidate, and an
    exhausted pool puts the masked partner among the k: both are filled
    with the row's best valid column, as the JAX package does."""
    check_metric(metric)
    q, cands = q.contiguous(), cands.contiguous()
    if approx:
        return _knn_query_blocked_approx(q, cands, exclude, k, metric, csls_k=csls_k)
    s, c = q.shape[0], cands.shape[0]
    k_eff = min(k, c)
    r = _cand_hubness(q, cands, csls_k, metric, block_c) if csls_k > 0 else None
    exclude = exclude.contiguous()
    if metric == "cityblock":
        csls = {} if r is None else dict(a=2.0, bias=r)
        vals, idx = l1_topk(q, cands, k_eff, exclude=exclude, **csls)
    else:
        c2 = sq_norms(cands)
        col_ids = torch.arange(c, device=q.device)
        vals = torch.empty((s, k_eff), dtype=torch.float32, device=q.device)
        idx = torch.empty((s, k_eff), dtype=torch.int64, device=q.device)
        for q0 in range(0, s, BLOCK_Q):
            dist = dist_tile(q[q0:q0 + BLOCK_Q], cands, metric, block_c, c2)
            if r is not None:
                dist = 2.0 * dist - r[None, :]
            dist.masked_fill_(col_ids[None, :] == exclude[q0:q0 + BLOCK_Q, None], float("inf"))
            vals[q0:q0 + BLOCK_Q], idx[q0:q0 + BLOCK_Q] = torch.topk(dist, k_eff, dim=1,
                                                                     largest=False, sorted=True)
    if k_eff < k:  # tiny pool: the JAX merge's (inf, 0) init columns
        pad = k - k_eff
        vals = torch.cat([vals, vals.new_full((s, pad), float("inf"))], 1)
        idx = torch.cat([idx, idx.new_zeros((s, pad))], 1)
    bad = torch.isinf(vals) | (idx == exclude[:, None])
    return torch.where(bad, idx[:, :1], idx)


def _cand_hubness(q: torch.Tensor, cands: torch.Tensor, csls_k: int, metric: str = "cityblock",
                  block_c: int = 1024) -> torch.Tensor:
    """r(j): the mean distance of candidate j to its csls_k nearest queries
    (csls_k clamped to the query pool), over (HUB_BLOCK, S) sqeuclidean
    tiles, or through ``eval._knn_mean_l1`` for cityblock."""
    check_metric(metric)
    if metric == "cityblock":
        return _knn_mean_l1(cands, q, csls_k, block_c)
    k = min(csls_k, q.shape[0])
    q2 = sq_norms(q)
    return torch.cat([
        torch.topk(dist_tile(cands[c0:c0 + HUB_BLOCK], q, metric, c2=q2), k, dim=1,
                   largest=False).values.mean(dim=1)
        for c0 in range(0, cands.shape[0], HUB_BLOCK)])


def _hubness_both_approx(q_pool: torch.Tensor, cands: torch.Tensor,
                         k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(r_sq, r_l1): candidate j's mean sqeuclidean and mean exact-L1
    distance to its k nearest queries (k clamped to the pool), "nearest"
    selected by sqeuclidean: one select-and-rerank call with the candidates
    as its queries."""
    q_pool, cands = q_pool.contiguous(), cands.contiguous()
    k = min(k, q_pool.shape[0])
    _, v2, l1 = select_rerank(cands, q_pool, k, c2=sq_norms(q_pool), rerank="cityblock")
    return v2.mean(dim=1), l1.mean(dim=1)


def _knn_query_blocked_approx(q: torch.Tensor, cands: torch.Tensor, exclude: torch.Tensor,
                              k: int, metric: str, csls_k: int = 0,
                              r_cand: torch.Tensor | None = None) -> torch.Tensor:
    """Approximate k-NN, selected by the sqeuclidean score through
    ``select_rerank`` (cityblock with CSLS: exactly, through ``l1_topk``).

    ``r_cand``: the candidates' hubness for the CSLS score (the approximate
    eval passes the one it holds); computed here when None and
    ``csls_k > 0``: the sqeuclidean one selected by sqeuclidean
    (``_hubness_both_approx``), the exact L1 one for cityblock.  The
    exclusion mask applies before selection and again in the rerank: the
    partner can enter the shortlist only through ties."""
    q, cands = q.contiguous(), cands.contiguous()
    s, c = q.shape[0], cands.shape[0]
    exclude = exclude.contiguous()
    if r_cand is None and csls_k > 0:
        r_cand = (_hubness_both_approx(q, cands, csls_k)[0] if metric == "sqeuclidean"
                  else _cand_hubness(q, cands, csls_k, metric))
    csls = dict(a=2.0, bias=r_cand) if csls_k > 0 else {}
    k_eff = min(k, c)
    if metric == "cityblock" and csls_k == 0:
        # shortlist by the sqeuclidean score, then exact L1 within it only
        k_short = min(c, max(2 * k_eff, k_eff + 8))
        sidx, _, d_l1 = select_rerank(q, cands, k_short, exclude=exclude, rerank="cityblock")
        d_l1.masked_fill_(sidx == exclude[:, None], float("inf"))
        pos = torch.topk(d_l1, k_eff, dim=1, largest=False).indices
        idx = sidx.gather(1, pos)
    elif metric == "sqeuclidean":
        idx = select_rerank(q, cands, k_eff, exclude=exclude, **csls)[0]
    else:
        idx = l1_topk(q, cands, k_eff, exclude=exclude, a=2.0, bias=r_cand.contiguous())[1]
    if k_eff < k:
        # tiny pool: repeat the row's best column, a valid negative (the
        # mask ran before selection)
        idx = torch.cat([idx, idx[:, :1].expand(-1, k - k_eff)], dim=1)
    if k >= c:
        # exhausted pool: the selection took every candidate, the masked
        # partner (which sorts last) included
        idx = torch.where(idx == exclude[:, None], idx[:, :1], idx)
    return idx


def sample_hard_negatives(emb: torch.Tensor, pairs: torch.Tensor, n_ent_1: int, n_ent: int,
                          k: int, block_c: int = 1024, metric: str = "cityblock",
                          approx: bool = False,
                          csls_k: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Truncated k-NN negatives: the k closest non-partner entities of the
    opposite KG, in the current embedding space (by the CSLS score with
    ``csls_k > 0``)."""
    e_l, e_r = emb[pairs[:, 0]], emb[pairs[:, 1]]
    cand_l, cand_r = emb[:n_ent_1], emb[n_ent_1:n_ent]
    neg_r = blockwise_knn_l1(e_l, cand_r, pairs[:, 1] - n_ent_1, k, block_c, metric,
                             approx, csls_k) + n_ent_1
    neg_l = blockwise_knn_l1(e_r, cand_l, pairs[:, 0], k, block_c, metric, approx, csls_k)
    return neg_l, neg_r
