"""Alignment losses (counterpart of ``tpugraph/train/losses.py``).

The Sinkhorn optimal-transport loss lives in ``train/ot.py``.
"""

from __future__ import annotations

import torch

from tpugraph_torch.kernels.margin_l1 import margin_l1_loss, margin_loss_plain


def pairwise_l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(…, d), (…, d) -> broadcasted L1 distance over the last axis."""
    return (a - b).abs().sum(-1)


def margin_align_loss(emb: torch.Tensor, pairs: torch.Tensor, neg_l: torch.Tensor,
                      neg_r: torch.Tensor, gamma: float = 10.0,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """Margin ranking loss, k negatives per side, L1 distance.

    0.5 * (mean ReLU(d⁺ + γ − d(e_l, neg_r)) + mean ReLU(d⁺ + γ − d(neg_l, e_r)))

    ``weights`` (S,) down-weights rows: each side's mean becomes
    Σ w·ReLU / (Σ w · k).  On a CPU table the plain composite; on a CUDA
    one the hand kernel ``kernels/margin_l1.py`` (forward and a fixed-order
    backward)."""
    if emb.dim() != 2 or pairs.shape != (neg_l.shape[0], 2) or neg_l.shape != neg_r.shape:
        raise ValueError(f"shapes: emb {tuple(emb.shape)}, pairs {tuple(pairs.shape)}, "
                         f"neg_l {tuple(neg_l.shape)}, neg_r {tuple(neg_r.shape)}")
    if emb.device.type == "cpu":
        return margin_loss_plain(emb, pairs, neg_l, neg_r, gamma, weights)
    return margin_l1_loss(emb, pairs, neg_l, neg_r, gamma, weights)
