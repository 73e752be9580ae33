"""Alignment losses (counterpart of ``tpugraph/train/losses.py``).

The Sinkhorn optimal-transport loss lives in ``train/ot.py``.
"""

from __future__ import annotations

import torch


def pairwise_l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(…, d), (…, d) -> broadcasted L1 distance over the last axis."""
    return (a - b).abs().sum(-1)


def margin_align_loss(emb: torch.Tensor, pairs: torch.Tensor, neg_l: torch.Tensor,
                      neg_r: torch.Tensor, gamma: float = 10.0,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """Margin ranking loss, k negatives per side, L1 distance.

    0.5 * (mean ReLU(d⁺ + γ − d(e_l, neg_r)) + mean ReLU(d⁺ + γ − d(neg_l, e_r)))

    ``weights`` (S,) down-weights rows: each side's mean becomes
    Σ w·ReLU / (Σ w · k)."""
    if emb.dim() != 2 or pairs.shape != (neg_l.shape[0], 2) or neg_l.shape != neg_r.shape:
        raise ValueError(f"shapes: emb {tuple(emb.shape)}, pairs {tuple(pairs.shape)}, "
                         f"neg_l {tuple(neg_l.shape)}, neg_r {tuple(neg_r.shape)}")
    e_l, e_r = emb[pairs[:, 0]], emb[pairs[:, 1]]
    d_pos = pairwise_l1(e_l, e_r)[:, None]  # (S, 1)
    d_neg_r = pairwise_l1(e_l[:, None, :], emb[neg_r])  # (S, k)
    d_neg_l = pairwise_l1(emb[neg_l], e_r[:, None, :])  # (S, k)
    h_r = (d_pos + gamma - d_neg_r).clamp_min(0.0)
    h_l = (d_pos + gamma - d_neg_l).clamp_min(0.0)
    if weights is None:
        return 0.5 * (h_r.mean() + h_l.mean())
    w = weights[:, None]
    denom = weights.sum().clamp_min(1e-9) * neg_r.shape[1]
    return 0.5 * ((w * h_r).sum() + (w * h_l).sum()) / denom
