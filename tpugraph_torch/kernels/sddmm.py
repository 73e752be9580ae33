"""Pairwise alignment distances (counterpart of ``tpugraph/kernels/sddmm.py``).

Plain torch, as the JAX package left it to XLA: ``pairwise_dist``, the
full (Q, C) distance matrix, one block of query rows at a time.
'sqeuclidean' uses the expanded form ‖a‖² + ‖b‖² − 2a·b clamped at 0;
'cityblock' is the family's L1.
"""

from __future__ import annotations

import torch


def _dist_block(a: torch.Tensor, b: torch.Tensor, metric: str) -> torch.Tensor:
    """(Qb, d) x (Cb, d) -> (Qb, Cb) distances."""
    if metric == "cityblock":
        return (a[:, None, :] - b[None, :, :]).abs().sum(-1)
    if metric == "sqeuclidean":
        d = ((a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :]
             - 2.0 * torch.matmul(a.float(), b.float().t()))
        return d.clamp_min(0.0)
    raise ValueError(f"unknown metric {metric!r}")


def pairwise_dist(q: torch.Tensor, c: torch.Tensor, metric: str = "cityblock",
                  block_q: int = 512) -> torch.Tensor:
    """Full (Q, C) distance matrix, computed one row block at a time."""
    return torch.cat([_dist_block(q[i:i + block_q], c, metric)
                      for i in range(0, q.shape[0], block_q)], dim=0)
