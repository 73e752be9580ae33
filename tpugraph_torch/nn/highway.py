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
    ``hw1``/``hw2`` leaves; with ``cols`` a column block of them, (dim,
    cols) and (cols,), as a tensor-parallel rank holds them."""

    def __init__(self, dim: int, device: torch.device | str | None = None,
                 cols: int | None = None):
        super().__init__()
        cols = cols or dim
        self.w = nn.Parameter(torch.empty(dim, cols, device=device))
        self.b = nn.Parameter(torch.zeros(cols, device=device))

    def forward(self, x: torch.Tensor, h: torch.Tensor,
                mix: torch.Tensor | None = None) -> torch.Tensor:
        """The gate reads the full-width x; it mixes h with ``mix`` (by
        default x; a tensor-parallel rank's own columns of x)."""
        t = torch.sigmoid(x @ self.w.to(x.dtype) + self.b.to(x.dtype))
        return t * h + (1.0 - t) * (x if mix is None else mix)
