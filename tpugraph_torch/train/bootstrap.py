"""Bootstrapped pair augmentation (counterpart of
``tpugraph/train/bootstrap.py``).

At each resample interval after ``boot_start``, the trainer proposes new
alignment pairs: the mutual nearest neighbours between the two KGs'
non-seed entities, the ``cap`` most confident by the direction-1 score, each
added to the margin loss with weight ``boot_weight``.  The proposal is
stateless: recomputed from the current embeddings each interval.

The exact nearest neighbour is one ``kernels/l1_search.py::l1_topk`` at
k = 1 for L1 (on the card one kernel launch per direction, no distance
tile in device memory) and blocked over queries (``eval.dist_tile``) for
sqeuclidean.  ``approx=True`` (``boot_approx``)
shortlists 16 candidates per query by a selection score whose product
takes both operands rounded to bf16 (products of bf16 values are exact in
fp32; the norms come from the unrounded rows), as the JAX package's bf16
product with fp32 output does, and takes the nearest within the shortlist
in the exact metric, both in one select-and-rerank call
(``kernels/shortlist_dist.py::select_rerank``).  The JAX package selects
with ``lax.approx_min_k`` (approximate on the TPU, exact on the CPU); the
port selects exactly.
"""

from __future__ import annotations

import torch

from tpugraph_torch.kernels.l1_search import l1_topk
from tpugraph_torch.kernels.shortlist_dist import check_metric, select_rerank
from tpugraph_torch.train.eval import BLOCK_Q, dist_tile, sq_norms
from tpugraph_torch.train.negatives import _cand_hubness, _hubness_both_approx


def _nn1(q: torch.Tensor, cands: torch.Tensor, c_mask: torch.Tensor, block_c: int = 1024,
         metric: str = "cityblock", csls_k: int = 0,
         approx: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Per query, (score, index) of the nearest eligible candidate.

    csls_k > 0 scores by 2·d − r(j), r the candidate's hubness over the
    full, unmasked query pool.  Ties go to the lower index; a query with no
    eligible candidate gets (inf, 0), as in the JAX package."""
    check_metric(metric)
    q, cands = q.contiguous(), cands.contiguous()
    if approx:
        return _nn1_prefiltered(q, cands, c_mask, metric=metric, csls_k=csls_k)
    s = q.shape[0]
    r = _cand_hubness(q, cands, csls_k, metric, block_c) if csls_k > 0 else None
    if metric == "cityblock":
        csls = {} if r is None else dict(a=2.0, bias=r)
        vals, idx = l1_topk(q, cands, 1, col_mask=c_mask.contiguous(), **csls)
        return vals[:, 0], idx[:, 0]
    c2 = sq_norms(cands)
    vals = torch.empty(s, dtype=torch.float32, device=q.device)
    idx = torch.empty(s, dtype=torch.int64, device=q.device)
    for q0 in range(0, s, BLOCK_Q):
        dist = dist_tile(q[q0:q0 + BLOCK_Q], cands, metric, block_c, c2)
        if r is not None:
            dist = 2.0 * dist - r[None, :]
        dist.masked_fill_(~c_mask[None, :], float("inf"))
        vals[q0:q0 + BLOCK_Q], idx[q0:q0 + BLOCK_Q] = dist.min(dim=1)
    return vals, idx


def _nn1_prefiltered(q: torch.Tensor, cands: torch.Tensor, c_mask: torch.Tensor,
                     metric: str = "cityblock", k_short: int = 16,
                     csls_k: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The nearest eligible candidate within a shortlist of ``k_short``.
    Ineligible candidates are masked before selection, so the shortlist is
    all eligible where the pool allows; the rerank scores the exact metric
    (cityblock, or sqeuclidean in fp32).  csls_k > 0: the selection scores
    2·d₂ − r₂(j) and the rerank 2·d − r(j), r the L1 hubness for cityblock
    (both from ``_hubness_both_approx``)."""
    k_short = min(cands.shape[0], k_short)
    csls = {}
    if csls_k > 0:
        r_sel, r_l1 = _hubness_both_approx(q, cands, csls_k)
        r_score = r_l1 if metric == "cityblock" else r_sel
        csls = dict(a=2.0, bias=r_sel)
    sidx, _, ds = select_rerank(q, cands, k_short, col_mask=c_mask.contiguous(), bf16=True,
                                rerank=metric, **csls)
    if csls_k > 0:
        ds = 2.0 * ds - r_score[sidx]
    ds.masked_fill_(~c_mask[sidx], float("inf"))
    vals, pos = ds.min(dim=1)
    return vals, sidx.gather(1, pos[:, None])[:, 0]


def propose_mutual_nn_pairs(emb: torch.Tensor, mask1: torch.Tensor, mask2: torch.Tensor,
                            n1: int, n: int, cap: int, block_c: int = 1024,
                            metric: str = "cityblock", csls_k: int = 0,
                            approx: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``cap`` most confident mutual-NN pairs among eligible entities.

    emb (n, d): KG1 = [:n1], KG2 = [n1:n]; mask1 (n1,) and mask2 (n − n1,)
    bool: the entities eligible (not in the seed set).  Returns (pairs
    (cap, 2) int64 of global ids, weight (cap,) float32 in {0, 1}); a
    padding row is [0, n1] with weight 0.  Confidence is the direction-1
    score (the distance, or the CSLS score when csls_k > 0), smaller kept
    first, ties to the lower KG1 id."""
    cand1, cand2 = emb[:n1], emb[n1:n]
    v12, i12 = _nn1(cand1, cand2, mask2, block_c, metric, csls_k, approx)
    _, i21 = _nn1(cand2, cand1, mask1, block_c, metric, csls_k, approx)
    mutual = mask1 & (i21[i12] == torch.arange(n1, device=emb.device))
    score = torch.where(mutual, v12, torch.full_like(v12, float("inf")))
    k_eff = min(cap, n1)
    top, left = torch.sort(score, stable=True)  # lax.top_k's order, ties included
    top, left = top[:k_eff], left[:k_eff]
    weight = torch.isfinite(top).float()
    pairs = torch.stack([left, i12[left] + n1], dim=1)
    pad = torch.tensor([0, n1], dtype=pairs.dtype, device=pairs.device)
    pairs = torch.where(weight[:, None] > 0, pairs, pad)
    if k_eff < cap:  # tiny graphs: pad up to the fixed capacity
        pairs = torch.cat([pairs, pad.expand(cap - k_eff, 2)])
        weight = torch.cat([weight, weight.new_zeros(cap - k_eff)])
    return pairs, weight
