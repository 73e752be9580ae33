"""Multi-task training loop (counterpart of ``tpugraph/train/mtl.py``):
config ``sinkhorn``, the margin loss plus the Sinkhorn OT head, over
AlignMTL.

The epoch schedule is ``train/loop.py::train_loop``'s, which is the JAX
package's plain path (``steps_per_call = 1``): uniform negatives at epoch
0, bootstrap proposals and hard mining at each later ``neg_every``
boundary, eval at ``eval_every`` and at the end, checkpoints and resume.
The proposals join the margin loss only; the Sinkhorn head stays on the
seed pairs (``models/align.py``).  Each step runs, on the card, the fused
GCN-layer kernel twice (forward), the ELL SpMM kernel twice (the layers'
backward) and the Sinkhorn potential-update kernel 2·sinkhorn_iters + 1
times (the OT head's forward).
"""

from __future__ import annotations

import torch

from tpugraph_torch import resolve_device
from tpugraph_torch.configs.configs import TrainConfig
from tpugraph_torch.models.align import AlignMTL
from tpugraph_torch.models.encoder import init_params
from tpugraph_torch.sparse.graph import AlignTask
from tpugraph_torch.train.loop import (TrainResult, build_operator, check_trainable, embed,
                                       load_task, train_loop)

OT_PAIRS_MAX = 8192  # the JAX package's guard on the S×S OT problem


def check_ot_size(cfg: TrainConfig, n_seed: int) -> None:
    """The JAX package refuses an OT problem above 8,192 pairs (its S×S cost
    failed to compile); the port keeps the guard so that a config behaves
    the same in both packages."""
    if cfg.use_sinkhorn and cfg.epochs > 0 and n_seed > OT_PAIRS_MAX:
        raise ValueError(
            f"use_sinkhorn with an effective OT problem of {n_seed} pairs does not "
            f"compile in the JAX package at this scale — set sinkhorn_pairs <= "
            f"{OT_PAIRS_MAX} (not ported yet; see ROADMAP.md)")


def fit_mtl(cfg: TrainConfig, task: AlignTask | None = None, verbose: bool = False,
            device: str | torch.device = "cuda") -> TrainResult:
    """Train AlignMTL per ``cfg``; parameters start from
    ``init_params(seed=cfg.seed)``."""
    dev = resolve_device(device)
    check_trainable(cfg)
    task = task or load_task(cfg)
    check_ot_size(cfg, len(task.train_pairs))
    op = build_operator(cfg, task, dev)
    model = AlignMTL(task.n_ent, cfg, device=dev)
    model.encoder.load_state_dict(init_params(task.n_ent, cfg.dim, cfg.hidden, seed=cfg.seed))
    return train_loop(cfg, task, op, model, lambda batch: model(op, batch),
                      lambda: embed(model.encoder, op), dev, verbose)
