"""Optimizer construction (counterpart of ``tpugraph/train/optim.py``).

Adam with an optional learning-rate schedule, counted in optimizer updates
(== epochs for these full-graph trainers):

    factor(t) = min((t+1)/warmup, 1)                              (warmup)
              * { 1                                               'const'
                { f + (1-f) * 1/2 * (1 + cos(pi * p))             'cosine'
    with p = clip((t - warmup) / max(1, total - warmup), 0, 1).

optax applies ``schedule(count)`` to the count-th update (count from 0);
``torch.optim.lr_scheduler.LambdaLR`` gives ``lr · factor(t)`` to the t-th
``opt.step()`` when ``scheduler.step()`` follows each one, so the two
frameworks see the same lr sequence.  ``torch.optim.Adam`` and
``optax.adam`` share their defaults (β = (0.9, 0.999), ε = 1e-8 added to
the bias-corrected √v̂) and put ε in the same place.
"""

from __future__ import annotations

import math
from collections.abc import Iterable

import torch


def lr_factor(t: float, total: int, schedule: str = "const", warmup: int = 0,
              final_frac: float = 0.0) -> float:
    """Schedule multiplier at update ``t``."""
    wu = min((t + 1) / warmup, 1.0) if warmup > 0 else 1.0
    if schedule == "cosine":
        p = min(max((t - warmup) / max(1, total - warmup), 0.0), 1.0)
        dec = final_frac + (1.0 - final_frac) * 0.5 * (1.0 + math.cos(math.pi * p))
    elif schedule == "const":
        dec = 1.0
    else:
        raise ValueError(f"unknown lr_schedule {schedule!r}")
    return wu * dec


def make_optimizer(cfg, params: Iterable[torch.nn.Parameter]
                   ) -> tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """(Adam, LambdaLR) for ``cfg``; call ``sched.step()`` after each
    ``opt.step()``."""
    lr_factor(0, cfg.epochs, cfg.lr_schedule)  # rejects an unknown schedule now
    opt = torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: lr_factor(t, cfg.epochs, cfg.lr_schedule, cfg.lr_warmup,
                                 cfg.lr_final_frac))
    return opt, sched
