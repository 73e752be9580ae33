"""Fused sqeuclidean-cost + Sinkhorn potential update (counterpart of
``tpugraph/kernels/sinkhorn_pallas.py``).

    f_i = τ·(log μ_i − LSE_j[(g_j − C_ij)/τ]),
    C_ij = max(‖l_i‖² + ‖r_j‖² − 2·l_i·r_j, 0)

* ``sinkhorn_potential_update`` — one update: on a CUDA tensor one launch
  of the hand-written Hopper kernel ``csrc/sinkhorn_fused.cu``, which builds
  the cost tile by tile and never stores it; on a CPU tensor the plain
  version ``sinkhorn_update_plain`` (a materialised cost, then
  ``torch.logsumexp``).  It never falls back from the card.
* ``sinkhorn_potentials_fused`` — the solver: alternate f- and g-updates by
  swapping the two sides, the squared norms computed once per solve.
"""

from __future__ import annotations

import ctypes
import math

import torch

from tpugraph_torch.kernels import _build

# kernel launches since the process started (or the caller last reset it)
launches = 0


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Row squared norms, the ‖·‖² terms of the expanded cost."""
    return (x * x).sum(1)


def sinkhorn_update_plain(l: torch.Tensor, r: torch.Tensor, g: torch.Tensor,
                          log_mu: torch.Tensor, tau: float, l_sq: torch.Tensor | None = None,
                          r_sq: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version: the (Q, C) cost, then one logsumexp over C."""
    l_sq = sq_norms(l) if l_sq is None else l_sq
    r_sq = sq_norms(r) if r_sq is None else r_sq
    cost = (l_sq[:, None] + r_sq[None, :] - 2.0 * (l @ r.t())).clamp_min(0.0)
    return tau * (log_mu - torch.logsumexp((g[None, :] - cost) / tau, dim=1))


def _lib():
    fn = _build.load("sinkhorn_fused").sinkhorn_update_forward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, ctypes.c_float, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return fn


def _check(l, r, g, log_mu, l_sq, r_sq) -> None:
    dev = l.device
    if l.dim() != 2 or r.dim() != 2 or l.shape[1] != r.shape[1]:
        raise ValueError(f"l (Q, d) and r (C, d) must share d, got {tuple(l.shape)}, "
                         f"{tuple(r.shape)}")
    if l.shape[1] % 4 or r.shape[0] == 0:
        raise ValueError(f"the kernel needs d % 4 == 0 and C > 0, got d={l.shape[1]}")
    q, c = l.shape[0], r.shape[0]
    for name, t, shape in (("l", l, tuple(l.shape)), ("r", r, tuple(r.shape)),
                           ("g", g, (c,)), ("log_mu", log_mu, (q,)),
                           ("l_sq", l_sq, (q,)), ("r_sq", r_sq, (c,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous and on {dev}")
    if l.data_ptr() % 16 or r.data_ptr() % 16:
        raise ValueError("l and r must be 16-byte aligned (the kernel reads float4)")


def sinkhorn_potential_update(l: torch.Tensor, r: torch.Tensor, g: torch.Tensor,
                              log_mu: torch.Tensor, tau: float,
                              l_sq: torch.Tensor | None = None,
                              r_sq: torch.Tensor | None = None) -> torch.Tensor:
    """One f-update: (Q,) new query potentials from l (Q, d), r (C, d),
    g (C,) and log μ (Q,), all float32.  ``l_sq``/``r_sq`` are the squared
    row norms, computed here when not given."""
    if l.device.type == "cpu":
        return sinkhorn_update_plain(l, r, g, log_mu, tau, l_sq, r_sq)
    if l.device.type != "cuda":
        raise ValueError(f"sinkhorn_potential_update runs on cuda or cpu, not {l.device}")
    l_sq = sq_norms(l) if l_sq is None else l_sq
    r_sq = sq_norms(r) if r_sq is None else r_sq
    _check(l, r, g, log_mu, l_sq, r_sq)
    out = torch.empty(l.shape[0], dtype=torch.float32, device=l.device)
    err = _lib()(l.data_ptr(), r.data_ptr(), l_sq.data_ptr(), r_sq.data_ptr(), g.data_ptr(),
                 log_mu.data_ptr(), float(tau), l.shape[0], r.shape[0], l.shape[1],
                 out.data_ptr(), torch.cuda.current_stream(l.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sinkhorn_fused launch failed with CUDA error {err}")
    global launches
    launches += 1
    return out


def solve(l: torch.Tensor, r: torch.Tensor, tau: float,
          n_iters: int) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Every iterate of the solver: ([f_1..f_n], [g_1..g_n]), 2·n_iters
    updates, f first, from f = g = 0 and uniform marginals."""
    q, c = l.shape[0], r.shape[0]
    l_sq, r_sq = sq_norms(l), sq_norms(r)
    log_mu = torch.full((q,), -math.log(q), dtype=torch.float32, device=l.device)
    log_nu = torch.full((c,), -math.log(c), dtype=torch.float32, device=l.device)
    g = torch.zeros(c, dtype=torch.float32, device=l.device)
    fs, gs = [], []
    for _ in range(n_iters):
        f = sinkhorn_potential_update(l, r, g, log_mu, tau, l_sq, r_sq)
        g = sinkhorn_potential_update(r, l, f, log_nu, tau, r_sq, l_sq)
        fs.append(f)
        gs.append(g)
    return fs, gs


def sinkhorn_potentials_fused(l: torch.Tensor, r: torch.Tensor, tau: float = 0.05,
                              n_iters: int = 20) -> tuple[torch.Tensor, torch.Tensor]:
    """Full solver; matches ``kernels/sinkhorn.py::sinkhorn_potentials`` on
    cost = sqeuclidean(l, r)."""
    if n_iters < 1:
        raise ValueError("n_iters must be >= 1")
    fs, gs = solve(l.float().contiguous(), r.float().contiguous(), tau, n_iters)
    return fs[-1], gs[-1]
