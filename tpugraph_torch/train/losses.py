"""Distances (counterpart of ``tpugraph/train/losses.py``).  The margin
loss comes with the training slice."""

from __future__ import annotations

import torch


def pairwise_l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(…, d), (…, d) -> broadcasted L1 distance over the last axis."""
    return (a - b).abs().sum(-1)
