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

The fused interval on the card (``train/fused.py``) replays a captured
step, so its Adam is ``capturable``: the step count lives on the device
and the learning rate in a device tensor, which ``LambdaLR`` fills in place
between replays (``torch.optim.lr_scheduler._update_param_group_val``).  The
schedule is the same.  ``optimizer_state`` / ``load_optimizer_state`` keep
a checkpoint in one form, so that a run of either mode resumes the
other's.
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


def make_optimizer(cfg, params: Iterable[torch.nn.Parameter], capturable: bool = False
                   ) -> tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """(Adam, LambdaLR) for ``cfg``; call ``sched.step()`` after each
    ``opt.step()``.  ``capturable``: Adam for a captured step (CUDA
    parameters), its learning rate a tensor on their device."""
    lr_factor(0, cfg.epochs, cfg.lr_schedule)  # rejects an unknown schedule now
    params = list(params)
    lr = torch.tensor(cfg.lr, device=params[0].device) if capturable else cfg.lr
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, capturable=capturable)
    for group in opt.param_groups:
        group["initial_lr"] = cfg.lr  # the schedule's base stays a float
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: lr_factor(t, cfg.epochs, cfg.lr_schedule, cfg.lr_warmup,
                                 cfg.lr_final_frac))
    return opt, sched


def optimizer_state(opt: torch.optim.Adam) -> dict:
    """Adam's state dict in the form of a plain (not capturable) Adam: the
    learning rates as floats (a capturable Adam's, its float32 tensor's
    value), each step count a CPU float32 scalar."""
    sd = opt.state_dict()
    groups = [{**g, "lr": float(g["lr"]), "capturable": False} for g in sd["param_groups"]]
    state = {i: {**st, "step": st["step"].detach().to("cpu", torch.float32)}
             for i, st in sd["state"].items()}
    return {"state": state, "param_groups": groups}


def load_optimizer_state(opt: torch.optim.Adam, sd: dict) -> None:
    """Load ``optimizer_state``'s form into ``opt``, which keeps its own
    mode: its ``capturable`` flag (so the step counts move to the
    parameters' device) and, when capturable, its learning-rate tensor,
    filled with the saved value."""
    live = [g["lr"] for g in opt.param_groups]
    opt.load_state_dict({"state": sd["state"], "param_groups": [
        {**saved, "capturable": g["capturable"]}
        for g, saved in zip(opt.param_groups, sd["param_groups"], strict=True)]})
    for group, lr in zip(opt.param_groups, live):
        if isinstance(lr, torch.Tensor):  # the tensor a captured step reads
            lr.fill_(float(group["lr"]))
            group["lr"] = lr
