"""Bootstrapped pair augmentation (counterpart of
``tpugraph/train/bootstrap.py``, exact cityblock path).

At each resample interval after ``boot_start``, the trainer proposes new
alignment pairs: the mutual nearest neighbours between the two KGs'
non-seed entities, the ``cap`` most confident by the direction-1 score, each
added to the margin loss with weight ``boot_weight``.  The proposal is
stateless: recomputed from the current embeddings each interval.

The nearest neighbour is exact L1, blocked over queries and candidates so
that no more than one (BLOCK_Q, block_c, d) difference tensor exists at a
time, as in ``train/eval.py``.  The approximate (``boot_approx``) and
sqeuclidean paths are not ported yet; ``train/loop.py::check_trainable``
refuses them (``ROADMAP.md``).
"""

from __future__ import annotations

import torch

from tpugraph_torch.train.eval import BLOCK_Q
from tpugraph_torch.train.losses import pairwise_l1
from tpugraph_torch.train.negatives import _cand_hubness


def _nn1(q: torch.Tensor, cands: torch.Tensor, c_mask: torch.Tensor, block_c: int = 1024,
         csls_k: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Per query, (score, index) of the nearest eligible candidate.

    csls_k > 0 scores by 2·d − r(j), r the candidate's hubness over the
    full, unmasked query pool.  Ties go to the lower index; a query with no
    eligible candidate gets (inf, 0), as in the JAX package."""
    s, c = q.shape[0], cands.shape[0]
    r = _cand_hubness(q, cands, csls_k, block_c) if csls_k > 0 else None
    vals = torch.empty(s, dtype=torch.float32, device=q.device)
    idx = torch.empty(s, dtype=torch.int64, device=q.device)
    for q0 in range(0, s, BLOCK_Q):
        qb = q[q0:q0 + BLOCK_Q]
        dist = torch.cat([pairwise_l1(qb[:, None, :], cands[None, c0:c0 + block_c, :]).float()
                          for c0 in range(0, c, block_c)], dim=1)
        if r is not None:
            dist = 2.0 * dist - r[None, :]
        dist.masked_fill_(~c_mask[None, :], float("inf"))
        vals[q0:q0 + BLOCK_Q], idx[q0:q0 + BLOCK_Q] = dist.min(dim=1)
    return vals, idx


def propose_mutual_nn_pairs(emb: torch.Tensor, mask1: torch.Tensor, mask2: torch.Tensor,
                            n1: int, n: int, cap: int, block_c: int = 1024,
                            csls_k: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``cap`` most confident mutual-NN pairs among eligible entities.

    emb (n, d): KG1 = [:n1], KG2 = [n1:n]; mask1 (n1,) and mask2 (n − n1,)
    bool: the entities eligible (not in the seed set).  Returns (pairs
    (cap, 2) int64 of global ids, weight (cap,) float32 in {0, 1}); a
    padding row is [0, n1] with weight 0.  Confidence is the direction-1
    score (the distance, or the CSLS score when csls_k > 0), smaller kept
    first, ties to the lower KG1 id."""
    cand1, cand2 = emb[:n1], emb[n1:n]
    v12, i12 = _nn1(cand1, cand2, mask2, block_c, csls_k)
    _, i21 = _nn1(cand2, cand1, mask1, block_c, csls_k)
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
