"""Exact blockwise Hits@k / MRR (counterpart of ``tpugraph/train/eval.py``,
raw-L1 and CSLS paths).

    rank(i) = #{ j != i : s(l_i, r_j) < s(l_i, r_i) }

with s = d, the L1 distance, or with ``csls_k > 0`` the CSLS score
s(q, j) = 2·d(q, j) − r(j), r(j) the mean distance of candidate j to its
csls_k nearest queries (the query's own term cancels within a row).
Counted over query blocks × candidate blocks, so no more than a
(block_q, block_c, d) difference tensor exists at a time (a single query
block against 1,024 candidates at 10,500 × 128 would be 5.5 GB).  The true
match is excluded by index, not by its score tying the threshold.  The
prefiltered approximate path is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from tpugraph_torch.train.losses import pairwise_l1


BLOCK_Q = 256  # queries per block: (256, 1024, 128) fp32 is 134 MB


def _ranks_l1(q: torch.Tensor, cands: torch.Tensor, d_true: torch.Tensor,
              block_c: int = 1024, cand_corr: torch.Tensor | None = None,
              true_corr: torch.Tensor | None = None) -> torch.Tensor:
    """For each query, count candidates strictly closer than its true match
    (candidate i is query i's true match: position-aligned pools).  With
    (cand_corr, true_corr) candidate j scores 2·d(q, j) − cand_corr[j]
    against the threshold 2·d_true − true_corr."""
    s, c = q.shape[0], cands.shape[0]
    if s != c:
        raise ValueError(f"_ranks_l1 requires position-aligned pools, got S={s} C={c}")
    thresh_all = d_true if cand_corr is None else 2.0 * d_true - true_corr
    ranks = torch.empty(s, dtype=torch.int64, device=q.device)
    for q0 in range(0, s, BLOCK_Q):
        qb = q[q0:q0 + BLOCK_Q]
        thresh = thresh_all[q0:q0 + BLOCK_Q, None]
        row_ids = torch.arange(q0, q0 + qb.shape[0], device=q.device)[:, None]
        count = torch.zeros(qb.shape[0], dtype=torch.int64, device=q.device)
        for c0 in range(0, c, block_c):
            cb = cands[c0:c0 + block_c]
            score = pairwise_l1(qb[:, None, :], cb[None, :, :])
            if cand_corr is not None:
                score = 2.0 * score - cand_corr[None, c0:c0 + block_c]
            col_ids = torch.arange(c0, c0 + cb.shape[0], device=q.device)[None, :]
            count += ((score < thresh) & (col_ids != row_ids)).sum(dim=1)
        ranks[q0:q0 + qb.shape[0]] = count
    return ranks


def _knn_mean_l1(q: torch.Tensor, cands: torch.Tensor, k: int,
                 block_c: int = 1024) -> torch.Tensor:
    """Mean L1 distance of each query to its k nearest candidates (the CSLS
    hubness term), k clamped to the pool size."""
    s, c = q.shape[0], cands.shape[0]
    k = min(k, c)
    out = torch.empty(s, dtype=torch.float32, device=q.device)
    for q0 in range(0, s, BLOCK_Q):
        qb = q[q0:q0 + BLOCK_Q]
        dist = torch.cat([pairwise_l1(qb[:, None, :], cands[None, c0:c0 + block_c, :]).float()
                          for c0 in range(0, c, block_c)], dim=1)
        out[q0:q0 + BLOCK_Q] = torch.topk(dist, k, dim=1, largest=False).values.mean(dim=1)
    return out


def _both_direction_ranks(emb: torch.Tensor, test_pairs: torch.Tensor, block_c: int = 1024,
                          csls_k: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(ranks_l2r, ranks_r2l) over the test pairs."""
    left = emb.index_select(0, test_pairs[:, 0])
    right = emb.index_select(0, test_pairs[:, 1])
    d_true = pairwise_l1(left, right).float()
    if csls_k <= 0:
        return (_ranks_l1(left, right, d_true, block_c=block_c),
                _ranks_l1(right, left, d_true, block_c=block_c))
    # the hubness of each right entity over the left pool, and the reverse
    corr_l = _knn_mean_l1(left, right, csls_k, block_c)
    corr_r = _knn_mean_l1(right, left, csls_k, block_c)
    return (_ranks_l1(left, right, d_true, block_c, cand_corr=corr_r, true_corr=corr_r),
            _ranks_l1(right, left, d_true, block_c, cand_corr=corr_l, true_corr=corr_l))


def hits_at_k(emb: torch.Tensor, test_pairs, ks: tuple[int, ...] = (1, 10),
              block_c: int = 1024, csls_k: int = 0) -> dict[str, float]:
    """Both-direction Hits@k and MRR over the test alignment pairs; the
    candidate pool is the test entities of the opposite KG.  ``csls_k > 0``
    ranks by the CSLS score."""
    pairs = torch.as_tensor(np.asarray(test_pairs), dtype=torch.int64, device=emb.device)
    rl, rr = _both_direction_ranks(emb, pairs, block_c=block_c, csls_k=csls_k)
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
