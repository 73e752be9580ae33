"""Sinkhorn optimal-transport alignment loss (counterpart of
``tpugraph/train/ot.py``).

    L_ot = −mean_i [ log P_ii − log Σ_j P_ij ],   log P = (f_i + g_j − C_ij)/τ

with C the sqeuclidean cost between the L2-normalised left and right seed
embeddings and (f, g) the Sinkhorn potentials after ``n_iters`` iterations.

The row LSE is f_i/τ + LSE_j((g_j − C_ij)/τ), and one more f-update from
the final g gives f′ with LSE_j((g_j − C_ij)/τ) = log μ_i − f′_i/τ.  So

    L_ot = −mean_i[(f′_i + g_i − C_ii)/τ] − log S

and the forward is 2·n_iters + 1 launches of the fused potential-update
kernel plus the diagonal C_ii: no S×S tensor.  The gradient is the exact
one of the unrolled solver (what ``jax.grad`` computes through the scan),
by an analytic reverse sweep over a materialised cost: each update's
reverse is one launch of the reverse kernel (``sinkhorn_reverse``), and the
final contraction to l̄ and r̄ two matrix products.  The L2 normalisation
and the gathers stay ordinary autograd outside.
"""

from __future__ import annotations

import math

import torch

from tpugraph_torch.kernels.sddmm import pairwise_dist
from tpugraph_torch.kernels.sinkhorn import sinkhorn_log_plan
from tpugraph_torch.kernels.sinkhorn_fused import (sinkhorn_potential_update, sinkhorn_reverse,
                                                   solve, sq_norms)


def _normalized_sides(emb: torch.Tensor, pairs: torch.Tensor):
    pairs = torch.as_tensor(pairs, dtype=torch.int64, device=emb.device)
    l, r = emb[pairs[:, 0]], emb[pairs[:, 1]]
    # normalize so τ has a stable scale across dims/datasets
    l = l / (torch.linalg.vector_norm(l, dim=-1, keepdim=True) + 1e-8)
    r = r / (torch.linalg.vector_norm(r, dim=-1, keepdim=True) + 1e-8)
    return l, r


def _reverse_update(cbar: torch.Tensor, cost: torch.Tensor, b: torch.Tensor,
                    out: torch.Tensor, out_bar: torch.Tensor, log_m: float, tau: float,
                    rows: bool) -> torch.Tensor:
    """Backward of one potential update out = τ(log m − LSE((b − C)/τ)),
    over the rows of C (an f-update) or its columns (a g-update).  Adds
    ō⊙P to C̄ in place and returns b̄ = −Σ ō⊙P, with
    P = exp((b − C)/τ − lse) and lse = log m − out/τ: one
    ``sinkhorn_reverse`` (the kernel on the card)."""
    return sinkhorn_reverse(cbar, cost, b, log_m - out / tau, out_bar, tau, rows)


class _SinkhornNLL(torch.autograd.Function):
    """L_ot of unit rows l, r (S, d), by the fused update kernel."""

    @staticmethod
    def forward(ctx, l, r, tau, n_iters):
        s = l.shape[0]
        fs, gs = solve(l, r, tau, n_iters)
        log_mu = torch.full((s,), -math.log(s), dtype=torch.float32, device=l.device)
        f_last = sinkhorn_potential_update(l, r, gs[-1], log_mu, tau)
        c_diag = (sq_norms(l) + sq_norms(r) - 2.0 * (l * r).sum(1)).clamp_min(0.0)
        ctx.tau = tau
        ctx.save_for_backward(l, r, *fs, *gs, f_last)
        return -((f_last + gs[-1] - c_diag) / tau).mean() - math.log(s)

    @staticmethod
    def backward(ctx, grad):
        l, r, *pots = ctx.saved_tensors
        tau = ctx.tau
        n = (len(pots) - 1) // 2
        fs, gs, f_last = pots[:n], pots[n:2 * n], pots[-1]
        s = l.shape[0]
        log_m = -math.log(s)
        c_raw = sq_norms(l)[:, None] + sq_norms(r)[None, :] - 2.0 * (l @ r.t())
        cost = c_raw.clamp_min(0.0)
        c = grad / (s * tau)
        cbar = torch.zeros_like(cost)
        cbar.diagonal().add_(c)
        # L = −mean((f′ + g_n − C_ii)/τ) − log S
        g_bar = -c + _reverse_update(cbar, cost, gs[-1], f_last, -c.expand(s), log_m, tau,
                                     rows=True)
        for k in range(n - 1, -1, -1):
            f_bar = _reverse_update(cbar, cost, fs[k], gs[k], g_bar, log_m, tau, rows=False)
            b = gs[k - 1] if k > 0 else torch.zeros_like(gs[0])
            g_bar = _reverse_update(cbar, cost, b, fs[k], f_bar, log_m, tau, rows=True)
        m = cbar.mul_(c_raw > 0)  # the clamp at 0
        l_bar = 2.0 * (l * m.sum(1)[:, None] - m @ r)
        r_bar = 2.0 * (r * m.sum(0)[:, None] - m.t() @ l)
        return l_bar, r_bar, None, None


def sinkhorn_align_loss(emb: torch.Tensor, pairs, tau: float = 0.05, n_iters: int = 20,
                        metric: str = "sqeuclidean") -> torch.Tensor:
    """The OT head's loss over the seed pairs (S, 2), value and gradient as
    the JAX package's."""
    if metric != "sqeuclidean":
        raise NotImplementedError(f"metric={metric!r}: the fused update builds the "
                                  "sqeuclidean cost only")
    if n_iters < 1:
        raise ValueError("n_iters must be >= 1")
    l, r = _normalized_sides(emb, pairs)
    return _SinkhornNLL.apply(l.contiguous(), r.contiguous(), tau, n_iters)


def sinkhorn_align_loss_plain(emb: torch.Tensor, pairs, tau: float = 0.05,
                              n_iters: int = 20) -> torch.Tensor:
    """The plain version: the JAX formula on a materialised cost, with the
    unrolled solver differentiated by autograd.  A reference for tests and
    the card's checks, not the training path."""
    l, r = _normalized_sides(emb, pairs)
    log_p = sinkhorn_log_plan(pairwise_dist(l, r, metric="sqeuclidean"), tau=tau,
                              n_iters=n_iters)
    return -(torch.diagonal(log_p) - torch.logsumexp(log_p, dim=1)).mean()
