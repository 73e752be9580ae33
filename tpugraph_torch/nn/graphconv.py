"""GraphConvolution (counterpart of ``tpugraph/nn/graphconv.py``).

out = A · x · W + b.  The weight keeps the JAX layout (d_in, d_out).  The
layer dispatches on ``impl``, and the operator's type must match it
(``operator_format``):

* ``ell`` (``pallas`` is its alias): ``kernels/gcn_fused.py::gcn_layer``
  over an ``EllOperator``.  Where (d_in, d_out) is in
  ``gcn_fused.FUSED_WIDTHS`` (the fused kernel's instances, and the widths
  where its any-width kernel timed faster on the card), (A·x)·W in one
  launch of the fused GCN-layer kernel; the JAX layer computes A·(x·W),
  equal by associativity in fp32; in bf16 the two round at other points.
  At every other width the JAX layer's own order: x·W, then the ELL SpMM
  kernel.  The backward runs the
  ELL SpMM kernel over the transpose.  Pad slots gather x[0] with
  weight 0, so a non-finite x[0] poisons the padded rows (0·NaN), as in the
  JAX package (``tpugraph/kernels/spmm_ell.py:53-65``).
* ``sorted``: support = x·W (``torch.matmul`` in x's type), then the
  sorted-segment SpMM kernel over an ``SpMMOperator``
  (``kernels/spmm.py::spmm``) — the JAX layer's own order.  Pad edges
  drain to a dump row: the path for probing NaNs.
* ``xla``: the same with the plain composite, differentiated by autograd.

Training runs in fp32 or bf16 (bf16 activations, fp32 parameters: W and b
are cast to x's type on the way in, and their gradients flow back through
the casts).
"""

from __future__ import annotations

import torch
from torch import nn

from tpugraph_torch.kernels.gcn_fused import gcn_layer
from tpugraph_torch.kernels.spmm import spmm, spmm_xla
from tpugraph_torch.sparse.ell import EllOperator
from tpugraph_torch.sparse.graph import SpMMOperator

IMPLS = ("ell", "pallas", "sorted", "xla")


def operator_format(impl: str) -> str:
    """The operator layout an impl takes: ``build_adjacency``'s ``fmt``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown spmm_impl {impl!r}; expected one of {IMPLS}")
    return "ell" if impl in ("ell", "pallas") else "sorted"


class GraphConvolution(nn.Module):
    """One GCN layer; the activation is left to the caller."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True, impl: str = "ell",
                 device: torch.device | str | None = None):
        super().__init__()
        operator_format(impl)
        self.impl = impl
        self.w = nn.Parameter(torch.empty(in_dim, out_dim, device=device))
        self.b = nn.Parameter(torch.zeros(out_dim, device=device)) if use_bias else None

    def forward(self, x: torch.Tensor, op: EllOperator | SpMMOperator) -> torch.Tensor:
        if self.impl in ("ell", "pallas"):
            return gcn_layer(op, x, self.w.to(x.dtype), self.b)
        support = torch.matmul(x, self.w.to(x.dtype))
        out = (spmm if self.impl == "sorted" else spmm_xla)(op, support)
        return out if self.b is None else out + self.b.to(out.dtype)
