"""Config -> trainer dispatch, and the eval-only entry (counterpart of
``tpugraph/train/driver.py``).

``run`` trains: a config with an OT head (config ``sinkhorn``, recipes
v5 and v6) goes to ``train/mtl.py::fit_mtl``, the others to
``train/loop.py::fit``.  ``evaluate`` restores trained parameters (a
training run's ``checkpoint_dir`` holds them), runs the encoder forward
over the merged graph once, and scores the exact both-direction Hits@k,
CSLS with ``eval_csls_k``; optionally it hands the table to the serving
path.  Both run on the card unless the caller passes ``device="cpu"``.
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
from tpugraph_torch.sparse.ell import EllOperator
from tpugraph_torch.sparse.graph import AlignTask
from tpugraph_torch.train.eval import hits_at_k
from tpugraph_torch.train.loop import (TrainResult, build_model, build_operator, embed, fit,
                                       load_task)


def run(cfg: TrainConfig, task: AlignTask | None = None, device: str | torch.device = "cuda",
        verbose: bool = False) -> TrainResult:
    """Train per ``cfg``.  ``task``: a pre-built AlignTask; None loads it
    from ``cfg``."""
    if max(cfg.n_shards, cfg.feature_shards, cfg.slice_shards) > 1:
        raise NotImplementedError("the distributed trainer is not ported yet; see ROADMAP.md")
    if cfg.use_sinkhorn or cfg.use_rel_head or cfg.use_attr_head or cfg.use_attr_channel:
        from tpugraph_torch.train.mtl import fit_mtl

        return fit_mtl(cfg, task=task, verbose=verbose, device=device)
    return fit(cfg, task=task, verbose=verbose, device=device)


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
    over the test pairs (CSLS with ``cfg.eval_csls_k``), and
    ``save_embeddings(cfg.save_emb_path, ...)`` when that is set.
    ``params`` is the encoder's state dict (``convert.params_from_jax``);
    None reads ``<checkpoint_dir>/params.pt``."""
    dev = resolve_device(device)
    params = _params(cfg, params)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    timings = {}
    t0 = time.perf_counter()
    task = task or load_task(cfg)
    op = build_operator(cfg, task, dev)
    model = build_model(cfg, task, device=dev)
    model.load_state_dict(params)
    sync()
    timings["build_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    emb = embed(model, op)
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
