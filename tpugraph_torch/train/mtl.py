"""Multi-task training loop (counterpart of ``tpugraph/train/mtl.py``):
configs ``sinkhorn`` and ``mtl`` and recipes v5–v7r, over AlignMTL.

The epoch schedule is ``train/loop.py::train_loop``'s, the JAX package's:
uniform negatives at epoch 0, bootstrap proposals and hard mining at each
later ``neg_every`` boundary, eval at ``eval_every`` and at the end,
checkpoints and resume; with ``steps_per_call = neg_every`` the fused
interval (on the card a captured step, replayed; ``train/fused.py``), with
the JAX ``fit_mtl``'s refusals (``loop.check_trainable``).  A fused save
keeps the interval's draws, as the JAX one keeps its batch.
At each boundary ``fit_mtl`` adds its own draws to the batch, each from
a host generator derived from (seed, the interval's first epoch)
(``loop.interval_generator``): the relation head's corrupted tails and
heads, the attribute head's batch of attribute triples, and with
``0 < sinkhorn_pairs < S`` the OT head's subsample of the seed pairs.
The proposals join the margin losses only; the Sinkhorn head stays on the
seed pairs (``models/align.py``).  Proposals, mining and evals read
``AlignMTL.embed``: with the attribute channel, the combined SE‖AE space,
where a sqeuclidean score weights the channels β² : (1−β)².  The
approximate and sqeuclidean search options (``boot_approx``,
``neg_approx``, ``neg_metric``, ``neg_csls_k``, ``eval_approx_k``) reach
them through ``train_loop`` as in ``fit``.

Each step runs, on the card, the fused GCN-layer kernel twice (forward)
and the ELL SpMM kernel twice (the layers' backward), the Sinkhorn
potential-update kernel 2·sinkhorn_iters + 1 times (the OT head's
forward), and with the attribute channel the fused layer twice more and
the SpMM four times more (the incidence forward and backward, and the AE
layers' backward).
"""

from __future__ import annotations

import numpy as np
import torch

from tpugraph_torch import resolve_device
from tpugraph_torch.configs.configs import TrainConfig
from tpugraph_torch.models.align import AlignMTL, init_mtl_params
from tpugraph_torch.models.attr_channel import build_attr_operator
from tpugraph_torch.sparse.ell import EllOperator
from tpugraph_torch.sparse.graph import AlignTask
from tpugraph_torch.train.loop import (StepParts, TrainResult, build_operator,
                                       check_trainable, interval_generator, load_task,
                                       train_loop)

OT_PAIRS_MAX = 8192  # the JAX package's guard on the S×S OT problem
ATTR_BATCH_MAX = 8192  # attribute triples per interval


def check_ot_size(cfg: TrainConfig, n_seed: int) -> None:
    """The JAX package refuses an effective OT problem above 8,192 pairs
    (its S×S cost failed to compile); the port keeps the guard so that a
    config behaves the same in both packages."""
    if not cfg.use_sinkhorn or cfg.epochs == 0:
        return
    ot_eff = min(cfg.sinkhorn_pairs, n_seed) if cfg.sinkhorn_pairs > 0 else n_seed
    if ot_eff > OT_PAIRS_MAX:
        raise ValueError(
            f"use_sinkhorn with an effective OT problem of {ot_eff} pairs (seeds={n_seed}, "
            f"sinkhorn_pairs={cfg.sinkhorn_pairs}) does not compile in the JAX package at "
            f"this scale — set sinkhorn_pairs <= {OT_PAIRS_MAX} (e.g. 4096)")


def attr_triples_of(cfg: TrainConfig, task: AlignTask) -> np.ndarray | None:
    """The merged attribute triples; a ValueError when the attribute head or
    channel is on and the task has none."""
    attr = task.merged_attr_triples
    if (cfg.use_attr_head or cfg.use_attr_channel) and (attr is None or task.n_attr == 0):
        raise ValueError("attribute head/channel enabled but the task has no attribute triples")
    return attr


def attr_operator(cfg: TrainConfig, task: AlignTask, dev: torch.device) -> EllOperator | None:
    """The AE channel's incidence operator on ``dev``, or None when the
    channel is off."""
    if not cfg.use_attr_channel:
        return None
    return build_attr_operator(attr_triples_of(cfg, task), task.n_ent, task.n_attr).to(dev)


def interval_keys(cfg: TrainConfig, n_seed: int) -> tuple[str, ...]:
    """The batch entries ``fit_mtl`` draws at each interval boundary."""
    keys = ()
    if cfg.use_sinkhorn and 0 < cfg.sinkhorn_pairs < n_seed:
        keys += ("ot_pairs",)
    if cfg.use_rel_head:
        keys += ("rel_neg_t", "rel_neg_h")
    if cfg.use_attr_head:
        keys += ("attr_triples",)
    return keys


def draw_interval(cfg: TrainConfig, epoch0: int, pairs: torch.Tensor, n_ent: int,
                  n_triples: int, attr_triples: torch.Tensor | None) -> dict[str, torch.Tensor]:
    """One interval's draws (``interval_keys``), on ``pairs``' device:
    ``ot_pairs`` (sinkhorn_pairs of the seed pairs, without replacement),
    ``rel_neg_t`` and ``rel_neg_h`` ((n_triples, rel_k_neg) entity ids,
    uniform over all ``n_ent``), ``attr_triples`` (min(8192, Ta) rows drawn
    with replacement)."""
    dev, out = pairs.device, {}
    if "ot_pairs" in interval_keys(cfg, pairs.shape[0]):
        sub = torch.randperm(pairs.shape[0], generator=interval_generator(cfg, epoch0, 3))
        out["ot_pairs"] = pairs[sub[:cfg.sinkhorn_pairs].to(dev)]
    if cfg.use_rel_head:
        gen = interval_generator(cfg, epoch0, 1)
        shape = (n_triples, cfg.rel_k_neg)
        out["rel_neg_t"] = torch.randint(0, n_ent, shape, generator=gen).to(dev)
        out["rel_neg_h"] = torch.randint(0, n_ent, shape, generator=gen).to(dev)
    if cfg.use_attr_head:
        n_attr_tri = attr_triples.shape[0]
        idx = torch.randint(0, n_attr_tri, (min(ATTR_BATCH_MAX, n_attr_tri),),
                            generator=interval_generator(cfg, epoch0, 2))
        out["attr_triples"] = attr_triples[idx.to(dev)]
    return out


def mtl_parts(cfg: TrainConfig, task: AlignTask, dev: torch.device) -> StepParts:
    """``fit_mtl``'s model (AlignMTL, from ``init_mtl_params(seed=cfg.seed)``),
    its loss over the batch and the constant relation triples, its
    evaluation table (``AlignMTL.embed``) and its per-interval draws."""
    attr_np = attr_triples_of(cfg, task)
    op = build_operator(cfg, task, dev)
    attr_op = attr_operator(cfg, task, dev)
    n_attr = max(task.n_attr, 1)
    model = AlignMTL(task.n_ent, cfg, device=dev, n_rel=task.n_rel, n_attr=n_attr)
    model.load_state_dict(init_mtl_params(cfg, task.n_ent, task.n_rel, n_attr, seed=cfg.seed))

    pairs = torch.as_tensor(task.train_pairs, dtype=torch.int64, device=dev)
    const = {}
    if cfg.use_rel_head:
        const["rel_triples"] = torch.as_tensor(task.merged_triples, dtype=torch.int64,
                                               device=dev)
    attr_triples = (torch.as_tensor(attr_np, dtype=torch.int64, device=dev)
                    if cfg.use_attr_head else None)
    n_triples = len(task.merged_triples)

    def draw(epoch0):
        return draw_interval(cfg, epoch0, pairs, task.n_ent, n_triples, attr_triples)

    def loss_fn(batch, generator):
        return model(op, {**batch, **const}, train=True, attr_op=attr_op, generator=generator)

    def embed_fn():
        with torch.no_grad():
            return model.embed(op, attr_op)

    keys = interval_keys(cfg, len(pairs))
    return StepParts(model, op, loss_fn, embed_fn, draw if keys else None, keys)


def fit_mtl(cfg: TrainConfig, task: AlignTask | None = None, verbose: bool = False,
            device: str | torch.device = "cuda") -> TrainResult:
    """Train AlignMTL per ``cfg`` (``mtl_parts``)."""
    dev = resolve_device(device)
    check_trainable(cfg)
    task = task or load_task(cfg)
    attr_triples_of(cfg, task)
    check_ot_size(cfg, len(task.train_pairs))
    return train_loop(cfg, task, mtl_parts(cfg, task, dev), dev, verbose)
