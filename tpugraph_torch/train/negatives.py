"""Negative sampling for the margin loss (counterpart of
``tpugraph/train/negatives.py``, uniform and exact-L1 hard paths).

* uniform: ``torch.randint`` from an explicit ``torch.Generator`` on the
  host, moved to the run's device, so one seed gives the same negatives on
  the CPU and on the card.  The numbers differ from ``jax.random``'s for the
  same seed; the parity tests inject one set of ids into both packages.
* hard: the k nearest non-partner entities of the opposite KG in exact L1,
  blocked over queries and candidates so that no more than one
  (BLOCK_Q, block_c, d) difference tensor exists at a time, as in
  ``train/eval.py``.  A block of queries keeps its (BLOCK_Q, C) distance
  row and takes one ``topk``: the same k smallest as the JAX package's
  running merge, without a sort per candidate block.

``_cand_hubness`` is the CSLS hubness term that serving and bootstrapping
share.  The approximate (``approx``), CSLS (``csls_k``) and sqeuclidean
mining paths are not ported yet (``ROADMAP.md``).
"""

from __future__ import annotations

import torch

from tpugraph_torch.train.eval import BLOCK_Q, _knn_mean_l1
from tpugraph_torch.train.losses import pairwise_l1


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
    """Indices (into cands) of the k nearest candidates per query in L1,
    the query's own partner ``exclude[i]`` (-1 = none) masked out.

    A pool smaller than k leaves columns with no real candidate, and an
    exhausted pool puts the masked partner among the k: both are filled
    with the row's best valid column, as the JAX package does."""
    if metric != "cityblock" or approx or csls_k:
        raise NotImplementedError(
            "only exact cityblock mining is ported (metric='cityblock', approx=False, "
            "csls_k=0); see ROADMAP.md")
    s, c = q.shape[0], cands.shape[0]
    k_eff = min(k, c)
    out = torch.empty((s, k), dtype=torch.int64, device=q.device)
    col_ids = torch.arange(c, device=q.device)
    for q0 in range(0, s, BLOCK_Q):
        qb = q[q0:q0 + BLOCK_Q]
        dist = torch.cat([pairwise_l1(qb[:, None, :], cands[None, c0:c0 + block_c, :]).float()
                          for c0 in range(0, c, block_c)], dim=1)
        ex = exclude[q0:q0 + BLOCK_Q, None]
        dist.masked_fill_(col_ids[None, :] == ex, float("inf"))
        vals, idx = torch.topk(dist, k_eff, dim=1, largest=False, sorted=True)
        if k_eff < k:  # tiny pool: the JAX merge's (inf, 0) init columns
            pad = k - k_eff
            vals = torch.cat([vals, vals.new_full((vals.shape[0], pad), float("inf"))], 1)
            idx = torch.cat([idx, idx.new_zeros((idx.shape[0], pad))], 1)
        bad = torch.isinf(vals) | (idx == ex)
        out[q0:q0 + BLOCK_Q] = torch.where(bad, idx[:, :1], idx)
    return out


def sample_hard_negatives(emb: torch.Tensor, pairs: torch.Tensor, n_ent_1: int, n_ent: int,
                          k: int, block_c: int = 1024, metric: str = "cityblock",
                          approx: bool = False,
                          csls_k: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Truncated k-NN negatives: the k closest non-partner entities of the
    opposite KG, in the current embedding space."""
    e_l, e_r = emb[pairs[:, 0]], emb[pairs[:, 1]]
    cand_l, cand_r = emb[:n_ent_1], emb[n_ent_1:n_ent]
    neg_r = blockwise_knn_l1(e_l, cand_r, pairs[:, 1] - n_ent_1, k, block_c, metric,
                             approx, csls_k) + n_ent_1
    neg_l = blockwise_knn_l1(e_r, cand_l, pairs[:, 0], k, block_c, metric, approx, csls_k)
    return neg_l, neg_r


def _cand_hubness(q: torch.Tensor, cands: torch.Tensor, csls_k: int,
                  block_c: int = 1024) -> torch.Tensor:
    """r(j): the mean L1 distance of candidate j to its csls_k nearest
    queries, blocked over candidates and queries (cityblock only: the
    sqeuclidean hubness is not ported yet)."""
    return _knn_mean_l1(cands, q, csls_k, block_c)
