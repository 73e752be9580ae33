"""Plain-torch ELL SpMM forward (counterpart of the forward of
``tpugraph/kernels/spmm_ell.py``).

out[row] = Σ_k w[row, k] · x[idx[row, k]] per degree bucket: an
``index_select`` gather, an fp32 ``einsum`` over K, then one ``row_order``
gather back to natural row order, plus ``diag ⊙ x``.  It is the building
block of the fused GCN layer's plain version (``gcn_fused.reference_layer``).
The autograd.Function and the transpose pass come with the training slice.
"""

from __future__ import annotations

import torch

from tpugraph_torch.sparse.ell import EllMatrix


def check_n_cols(m: EllMatrix, x: torch.Tensor) -> None:
    """A feature matrix of the wrong height would gather out of bounds on
    the card; refuse it on every device."""
    if x.shape[0] != m.n_cols:
        raise ValueError(f"x has {x.shape[0]} rows but the operator expects {m.n_cols}")


def ell_apply(m: EllMatrix, x: torch.Tensor) -> torch.Tensor:
    """A @ x via bucketed gather + dense reduce; output in natural row order.
    bf16 inputs gather in bf16 but accumulate in fp32, then cast back.  A
    trailing zero row catches the degree-0 rows through ``row_order``."""
    check_n_cols(m, x)
    d = x.shape[-1]
    outs = []
    for b in m.buckets:
        g = x.index_select(0, b.idx.reshape(-1)).reshape(b.idx.shape[0], b.k, d)
        acc = torch.einsum("rk,rkd->rd", b.w, g.float())
        outs.append(acc.to(x.dtype))
    outs.append(x.new_zeros((1, d)))
    return torch.cat(outs, dim=0).index_select(0, m.row_order)


def apply_with_diag(m: EllMatrix, diag: torch.Tensor | None, x: torch.Tensor) -> torch.Tensor:
    """ELL part + gather-free diagonal part; the diagonal multiply runs in
    fp32 like the einsum does."""
    y = ell_apply(m, x)
    if diag is not None:
        y = y + (diag[:, None] * x.float()).to(x.dtype)
    return y
