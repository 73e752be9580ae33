"""Eval-only entry (counterpart of ``tpugraph/train/driver.py::evaluate``).

Restore trained parameters, run the encoder forward over the merged graph
once, and score the exact both-direction Hits@k; optionally hand the table
to the serving path.  Training (``run``) comes with the training slice.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import torch

from tpugraph_torch import resolve_device
from tpugraph_torch.configs.configs import TrainConfig
from tpugraph_torch.convert import PARAMS_FILE, load_params
from tpugraph_torch.models.encoder import AlignGCN
from tpugraph_torch.sparse.build import build_adjacency
from tpugraph_torch.sparse.ell import EllOperator
from tpugraph_torch.sparse.graph import AlignTask
from tpugraph_torch.train.eval import hits_at_k
from tpugraph_torch.train.loop import build_model, embed, load_task


@dataclass
class EvalResult:
    metrics: dict
    emb: torch.Tensor  # (n_ent, dim) fp32 on the run's device
    op: EllOperator
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


def evaluate(cfg: TrainConfig, params: dict | None = None, task: AlignTask | None = None,
             device: str | torch.device = "cuda") -> EvalResult:
    """Score trained parameters under ``cfg``: one forward, exact Hits@k
    over the test pairs, and ``save_embeddings(cfg.save_emb_path, ...)``
    when that is set.  ``params`` is a state dict
    (``convert.params_from_jax``); None reads ``<checkpoint_dir>/params.pt``."""
    dev = resolve_device(device)
    params = _params(cfg, params)
    if cfg.eval_csls_k:
        raise NotImplementedError("CSLS eval is not ported yet")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    timings = {}
    t0 = time.perf_counter()
    task = task or load_task(cfg)
    op = build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel,
                         weighting=cfg.weighting, norm=cfg.norm, fmt="ell").to(dev)
    model = build_model(cfg, task, device=dev)
    model.load_state_dict(params)
    sync()
    timings["build_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    emb = embed(model, op)
    sync()
    timings["forward_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    metrics = hits_at_k(emb, task.test_pairs)
    timings["eval_s"] = time.perf_counter() - t0

    if cfg.save_emb_path:
        from tpugraph_torch.serve import save_embeddings

        save_embeddings(cfg.save_emb_path, emb)
    return EvalResult(metrics=metrics, emb=emb, op=op, model=model, task=task,
                      timings=timings)
