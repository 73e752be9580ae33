"""Highway gate layer (counterpart of ``tpugraph/nn/highway.py``).

h' = T ⊙ h + (1 − T) ⊙ x,  T = σ(x · W_T + b_T)

Each entity interpolates between its pre- and post-aggregation states.
The gate's product is a dense GEMM, which the JAX package also leaves
outside Pallas; it runs in x's (the compute) dtype, as the JAX gate does.
"""

from __future__ import annotations

import torch
from torch import nn


class Highway(nn.Module):
    """Parameters ``w`` (dim, dim) and ``b`` (dim,), the flax tree's
    ``hw1``/``hw2`` leaves."""

    def __init__(self, dim: int, device: torch.device | str | None = None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(dim, dim, device=device))
        self.b = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        t = torch.sigmoid(x @ self.w.to(x.dtype) + self.b.to(x.dtype))
        return t * h + (1.0 - t) * x
