"""Config -> trainer dispatch, and the eval-only entry (counterpart of
``tpugraph/train/driver.py``).

``run`` trains: a config of more than one shard (config
``dwy100k_dist``) goes to ``dist/trainer.py::fit_distributed``, one with
an OT head or an MTL head or channel (configs ``sinkhorn`` and ``mtl``,
recipes v5–v7r) to ``train/mtl.py::fit_mtl``, the others (configs
``base`` and ``highway``) to ``train/loop.py::fit``.  Called directly,
``fit`` and ``fit_mtl`` train a sharded config on one device over the
whole graph, as the JAX trainers do.  ``evaluate`` restores trained parameters (a
training run's ``checkpoint_dir`` holds them; a sharded config's are scored
by the distributed trainer at ``epochs=0``), runs the encoder forward
over the merged graph once (with the attribute channel, the AE channel
too, scoring the combined SE‖AE table as the run did), and scores the
exact both-direction Hits@k, CSLS with ``eval_csls_k``; optionally it
hands the table to the serving path.  Both run on the card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import torch

from tpugraph_torch import resolve_device
from tpugraph_torch.configs.configs import TrainConfig
from tpugraph_torch.convert import AE_PREFIX, PARAMS_FILE, embed_params, load_params
from tpugraph_torch.models.attr_channel import AttrChannelGCN, combine_channels
from tpugraph_torch.models.encoder import AlignGCN
from tpugraph_torch.sparse.ell import EllOperator
from tpugraph_torch.sparse.graph import AlignTask, SpMMOperator
from tpugraph_torch.train.eval import hits_at_k
from tpugraph_torch.train.loop import (StepParts, TrainResult, build_model, build_operator,
                                       embed, fit, load_task, margin_parts)


def run(cfg: TrainConfig, task: AlignTask | None = None, device: str | torch.device = "cuda",
        verbose: bool = False, debug_nans: bool = False) -> TrainResult:
    """Train per ``cfg``.  ``task``: a pre-built AlignTask; None loads it
    from ``cfg``.  ``debug_nans``: raise ``FloatingPointError`` at the first
    non-finite step (``train/loop.py``).  A distributed run starts a
    world-size-1 group in this process, or joins torchrun's
    (``dist/mesh.py``)."""
    if sharded(cfg):
        from tpugraph_torch.dist.trainer import fit_distributed

        return fit_distributed(cfg, task=task, verbose=verbose, device=device,
                               debug_nans=debug_nans)
    if uses_mtl(cfg):
        from tpugraph_torch.train.mtl import fit_mtl

        return fit_mtl(cfg, task=task, verbose=verbose, device=device, debug_nans=debug_nans)
    return fit(cfg, task=task, verbose=verbose, device=device, debug_nans=debug_nans)


def sharded(cfg: TrainConfig) -> bool:
    """Whether ``run`` sends ``cfg`` to the distributed trainer (more than
    one shard on any axis)."""
    return max(cfg.n_shards, cfg.feature_shards, cfg.slice_shards) > 1


def uses_mtl(cfg: TrainConfig) -> bool:
    """Whether ``run`` trains ``cfg`` with ``fit_mtl`` (an OT or MTL head, or
    the attribute channel) rather than ``fit``."""
    return cfg.use_sinkhorn or cfg.use_rel_head or cfg.use_attr_head or cfg.use_attr_channel


def step_parts(cfg: TrainConfig, task: AlignTask, dev: torch.device) -> StepParts:
    """The model, loss and draws that ``run`` trains ``cfg`` with
    (``loop.margin_parts`` or ``mtl.mtl_parts``), on ``dev``."""
    from tpugraph_torch.train.mtl import mtl_parts

    return mtl_parts(cfg, task, dev) if uses_mtl(cfg) else margin_parts(cfg, task, dev)


@dataclass
class EvalResult:
    metrics: dict
    emb: torch.Tensor  # (n_ent, dim) fp32 on the run's device, 2·dim with the AE channel
    op: EllOperator | SpMMOperator
    model: AlignGCN
    task: AlignTask
    # host wall seconds of each stage, each ended by a device synchronise:
    # build (adjacency + move to device), forward, eval
    timings: dict = field(default_factory=dict)


def _params(cfg: TrainConfig, params):
    if params is not None:
        return params
    if not cfg.checkpoint_dir or not os.path.exists(
            os.path.join(cfg.checkpoint_dir, PARAMS_FILE)):
        raise ValueError(
            f"evaluate() needs trained parameters: pass params= or point "
            f"cfg.checkpoint_dir at a directory holding {PARAMS_FILE} "
            f"(got {cfg.checkpoint_dir!r}); it refuses to score a random init")
    return load_params(cfg.checkpoint_dir)


def _evaluate_distributed(cfg: TrainConfig, task: AlignTask | None,
                          device: str | torch.device) -> TrainResult:
    """A sharded config's eval-only run, the JAX ``evaluate``'s: the
    distributed trainer at ``epochs=0`` from the newest checkpoint under
    ``checkpoint_dir`` (the exact final eval, and the table saved when
    ``save_emb_path`` is set); a missing directory or checkpoint is refused
    with the JAX messages."""
    from tpugraph_torch.train.checkpoint import Checkpointer

    if not cfg.checkpoint_dir:
        raise ValueError(
            "evaluate() needs cfg.checkpoint_dir pointing at a trained checkpoint (set "
            "checkpoint_dir/checkpoint_every on the training run); without one there is "
            "nothing to evaluate")
    every = max(cfg.checkpoint_every, 1)  # the restore needs the checkpointer enabled
    has_batch = Checkpointer(cfg.checkpoint_dir, every).latest_has_key("neg_l")
    if has_batch is None:
        raise ValueError(
            f"no checkpoint found under {cfg.checkpoint_dir!r} — evaluate() refuses to report "
            f"metrics from a fresh random init; train first or fix the path")
    # the checkpoint's mode, as the JAX evaluate adopts it: a fused save
    # carries no interval batch (no interval runs at epochs=0)
    steps = 1 if has_batch else max(cfg.neg_every, 1)
    return run(cfg.replace(epochs=0, checkpoint_every=every, steps_per_call=steps,
                           profile_dir=None), task=task, device=device)


def evaluate(cfg: TrainConfig, params: dict | None = None, task: AlignTask | None = None,
             device: str | torch.device = "cuda") -> EvalResult | TrainResult:
    """Score trained parameters under ``cfg``: one forward, exact Hits@k
    over the test pairs (CSLS with ``cfg.eval_csls_k``), and
    ``save_embeddings(cfg.save_emb_path, ...)`` when that is set.
    ``params``: an encoder's or an AlignMTL's state dict
    (``convert.params_from_jax``), of which ``convert.embed_params`` keeps
    the encoder's and the AE channel's; None reads
    ``<checkpoint_dir>/params.pt``.  A sharded config
    (``dwy100k_dist``) is scored by the distributed trainer from its
    checkpoint instead, as the JAX ``evaluate`` does
    (``_evaluate_distributed``; it takes no ``params`` and returns the
    trainer's ``TrainResult``)."""
    from tpugraph_torch.train.mtl import attr_operator

    if sharded(cfg):
        if params is not None:
            raise ValueError("a sharded config is evaluated from its checkpoint_dir, "
                             "not from params")
        return _evaluate_distributed(cfg, task, device)
    dev = resolve_device(device)
    params = embed_params(_params(cfg, params))
    ae_params = {k.removeprefix(AE_PREFIX): params.pop(k) for k in list(params)
                 if k.startswith(AE_PREFIX)}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    timings = {}
    t0 = time.perf_counter()
    task = task or load_task(cfg)
    op = build_operator(cfg, task, dev)
    model = build_model(cfg, task, device=dev)
    model.load_state_dict(params)
    attr_op = attr_operator(cfg, task, dev)
    if attr_op is not None:
        ae = AttrChannelGCN(max(task.n_attr, 1), cfg.dim, cfg.spmm_impl, device=dev)
        ae.load_state_dict(ae_params)
    sync()
    timings["build_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    emb = embed(model, op)
    if attr_op is not None:
        with torch.no_grad():
            emb = combine_channels(emb, ae(op, attr_op), cfg.attr_beta)
    sync()
    timings["forward_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    metrics = hits_at_k(emb, task.test_pairs, csls_k=cfg.eval_csls_k)
    timings["eval_s"] = time.perf_counter() - t0

    if cfg.save_emb_path:
        from tpugraph_torch.serve import save_embeddings

        save_embeddings(cfg.save_emb_path, emb)
    return EvalResult(metrics=metrics, emb=emb, op=op, model=model, task=task,
                      timings=timings)
