"""GraphConvolution (counterpart of ``tpugraph/nn/graphconv.py``).

out = A · x · W + b, computed as (A·x)·W by the fused GCN-layer kernel
(``kernels/gcn_fused.py``); the JAX layer computes A·(x·W), which is equal
by associativity.  The weight keeps the JAX layout (d_in, d_out).
"""

from __future__ import annotations

import torch
from torch import nn

from tpugraph_torch.kernels.gcn_fused import fused_gcn_layer
from tpugraph_torch.sparse.ell import EllOperator


class GraphConvolution(nn.Module):
    """One GCN layer; the activation is left to the caller."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True,
                 device: torch.device | str | None = None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(in_dim, out_dim, device=device))
        self.b = nn.Parameter(torch.zeros(out_dim, device=device)) if use_bias else None

    def forward(self, x: torch.Tensor, op: EllOperator) -> torch.Tensor:
        if x.device.type != "cpu" and torch.is_grad_enabled() and (
                x.requires_grad or self.w.requires_grad):
            raise NotImplementedError(
                "training is not ported yet: the fused GCN kernel is forward "
                "only, so run the layer under torch.no_grad()")
        return fused_gcn_layer(op.fwd, op.diag, x, self.w.to(x.dtype), self.b)
