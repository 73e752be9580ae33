"""Log-domain Sinkhorn on a materialised cost (counterpart of
``tpugraph/kernels/sinkhorn.py``).

Entropic OT between uniform marginals with cost matrix C and temperature τ:

    P = diag(e^{f/τ}) · e^{−C/τ} · diag(e^{g/τ})

with the potentials f, g fixed-point iterated by log-sum-exp updates.
Plain torch (the JAX package's XLA solver); it is also the plain version of
the fused potential-update kernel's solver (``kernels/sinkhorn_fused.py``).
"""

from __future__ import annotations

import math

import torch


def sinkhorn_potentials(cost: torch.Tensor, tau: float = 0.05, n_iters: int = 20,
                        log_mu: torch.Tensor | None = None,
                        log_nu: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Run n_iters of log-domain Sinkhorn; returns potentials (f, g)."""
    n, m = cost.shape
    c32 = cost.float()
    if log_mu is None:
        log_mu = torch.full((n,), -math.log(n), dtype=torch.float32, device=cost.device)
    if log_nu is None:
        log_nu = torch.full((m,), -math.log(m), dtype=torch.float32, device=cost.device)
    g = torch.zeros(m, dtype=torch.float32, device=cost.device)
    f = torch.zeros(n, dtype=torch.float32, device=cost.device)
    for _ in range(n_iters):
        f = tau * (log_mu - torch.logsumexp((g[None, :] - c32) / tau, dim=1))
        g = tau * (log_nu - torch.logsumexp((f[:, None] - c32) / tau, dim=0))
    return f, g


def sinkhorn_log_plan(cost: torch.Tensor, tau: float = 0.05, n_iters: int = 20,
                      **kw) -> torch.Tensor:
    """log P — the log transport plan."""
    f, g = sinkhorn_potentials(cost, tau=tau, n_iters=n_iters, **kw)
    return (f[:, None] + g[None, :] - cost.float()) / tau


def sinkhorn_plan(cost: torch.Tensor, tau: float = 0.05, n_iters: int = 20,
                  **kw) -> torch.Tensor:
    return torch.exp(sinkhorn_log_plan(cost, tau=tau, n_iters=n_iters, **kw))
