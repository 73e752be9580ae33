"""Full-graph training loop (counterpart of ``tpugraph/train/loop.py``).

One optimizer step per epoch over the whole merged graph; negatives are
drawn at each ``neg_every`` boundary (uniform at epoch 0, then exact-L1
hard mining from the current parameters when ``neg_mode='hard'``); exact
Hits@k at ``eval_every`` and at the end.  ``fit`` trains config ``base``
(AlignGCN + margin loss); ``train/mtl.py::fit_mtl`` runs the same loop over
AlignMTL.  Both run on the card unless the caller passes ``device="cpu"``.

Not ported yet, and refused up front (``check_trainable``): the fused
``steps_per_call`` interval, bootstrapping, ``sinkhorn_pairs``,
checkpoint/resume, profiling, bf16 training, CSLS/approximate eval and
mining, and the distributed trainer (``ROADMAP.md``).
"""

from __future__ import annotations

import time
from collections.abc import Callable
from dataclasses import dataclass, field

import numpy as np
import torch

from tpugraph_torch import resolve_device
from tpugraph_torch.configs.configs import TrainConfig
from tpugraph_torch.data.synthetic import synthetic_align_task
from tpugraph_torch.models.encoder import AlignGCN, init_params
from tpugraph_torch.sparse.build import build_adjacency
from tpugraph_torch.sparse.ell import EllOperator
from tpugraph_torch.sparse.graph import AlignTask
from tpugraph_torch.train.eval import hits_at_k
from tpugraph_torch.train.losses import margin_align_loss
from tpugraph_torch.train.metrics import MetricsLogger, epoch_edge_ops
from tpugraph_torch.train.negatives import sample_hard_negatives, sample_uniform_negatives
from tpugraph_torch.train.optim import make_optimizer


@dataclass
class TrainResult:
    params: dict  # the model's state dict, on the run's device
    metrics: dict
    history: list = field(default_factory=list)
    op: EllOperator | None = None
    model: torch.nn.Module | None = None
    task: AlignTask | None = None
    losses: list = field(default_factory=list)  # total loss of every step
    # host wall seconds, each stage ended by a device synchronise: setup_s
    # (optimizer and loop set-up), train_s (the steps), mine_s (hard
    # mining), eval_s (evals incl. the final one), step_s (each step's);
    # and the counts steps, minings, evals
    timings: dict = field(default_factory=dict)


def load_task(cfg: TrainConfig) -> AlignTask:
    if cfg.dataset == "synthetic":
        return synthetic_align_task(
            seed=cfg.syn_seed,
            n_ent=cfg.syn_n_ent,
            n_rel=cfg.syn_n_rel,
            n_triples=cfg.syn_n_triples,
            drop_frac=cfg.syn_drop_frac,
            noise_frac=cfg.syn_noise_frac,
            train_ratio=cfg.train_ratio,
            name=f"synthetic-{cfg.pair}",
        )
    raise NotImplementedError(f"dataset {cfg.dataset!r} is not ported yet (synthetic only)")


def build_model(cfg: TrainConfig, task: AlignTask,
                device: torch.device | str | None = None) -> AlignGCN:
    if cfg.spmm_impl not in ("ell", "pallas"):
        raise NotImplementedError(f"spmm_impl={cfg.spmm_impl!r} is not ported yet (ell only)")
    return AlignGCN(
        n_ent=task.n_ent,
        dim=cfg.dim,
        hidden=cfg.hidden,
        highway=cfg.highway,
        dropout=cfg.dropout,
        compute_dtype=cfg.param_dtype,
        l2_normalize=cfg.l2_normalize,
        device=device,
    )


def embed(model: AlignGCN, op: EllOperator) -> torch.Tensor:
    """The encoder's output table (fp32), forward only."""
    with torch.no_grad():
        return model(op)


def check_trainable(cfg: TrainConfig) -> None:
    """Refuse, before any work, a config that needs an unported part."""
    if cfg.neg_every < 1:
        raise ValueError("neg_every must be >= 1 (to effectively never resample, set "
                         "neg_every >= epochs)")
    unported = {
        "steps_per_call > 1 (the fused interval)": cfg.steps_per_call > 1,
        "boot_cap > 0 (bootstrapping)": cfg.boot_cap > 0,
        "sinkhorn_pairs > 0": cfg.sinkhorn_pairs > 0,
        "checkpoint_dir / checkpoint_every (checkpoint and resume)":
            bool(cfg.checkpoint_dir) or cfg.checkpoint_every > 0,
        "profile_dir": bool(cfg.profile_dir),
        f"param_dtype={cfg.param_dtype!r} training (float32 only)":
            cfg.param_dtype != "float32",
        "eval_csls_k / eval_approx_k": cfg.eval_csls_k > 0 or cfg.eval_approx_k > 0,
        "approximate, CSLS or sqeuclidean hard mining": cfg.neg_mode == "hard" and (
            cfg.neg_approx or cfg.neg_csls_k > 0 or cfg.neg_metric != "cityblock"),
        "the distributed trainer": max(cfg.n_shards, cfg.feature_shards,
                                       cfg.slice_shards) > 1,
    }
    for what, hit in unported.items():
        if hit:
            raise NotImplementedError(f"{what} is not ported yet; see ROADMAP.md")
    if cfg.neg_mode not in ("uniform", "hard"):
        raise ValueError(f"unknown neg_mode {cfg.neg_mode!r}")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_loop(cfg: TrainConfig, task: AlignTask, op: EllOperator, model: torch.nn.Module,
               loss_fn: Callable[[dict], tuple[torch.Tensor, dict]],
               embed_fn: Callable[[], torch.Tensor], dev: torch.device,
               verbose: bool = False) -> TrainResult:
    """The epoch loop shared by ``fit`` and ``fit_mtl``: ``loss_fn(batch)``
    returns (loss, aux) with grad; ``embed_fn()`` the eval table."""
    t_setup = time.perf_counter()
    opt, sched = make_optimizer(cfg, model.parameters())
    pairs = torch.as_tensor(np.asarray(task.train_pairs), dtype=torch.int64, device=dev)
    n1, n = task.kg1.n_ent, task.n_ent
    logger = MetricsLogger(cfg.metrics_path, config=cfg.to_dict(), tb_dir=cfg.tb_dir)
    history, losses = [], []
    timings = {"train_s": 0.0, "mine_s": 0.0, "eval_s": 0.0, "step_s": [],
               "steps": 0, "minings": 0, "evals": 0}

    def evaluate_now():
        t0 = time.perf_counter()
        emb = embed_fn()
        m = hits_at_k(emb, task.test_pairs)
        timings["eval_s"] += time.perf_counter() - t0
        timings["evals"] += 1
        return emb, m

    batch, loss, aux = None, torch.tensor(float("nan")), {}
    t_start = time.perf_counter()
    timings["setup_s"] = t_start - t_setup
    try:
        for epoch in range(cfg.epochs):
            if epoch % cfg.neg_every == 0:
                epoch0 = epoch - epoch % cfg.neg_every
                if cfg.neg_mode == "hard" and epoch > 0:
                    t0 = time.perf_counter()
                    neg_l, neg_r = sample_hard_negatives(embed_fn(), pairs, n1, n, cfg.k_neg)
                    _sync(dev)
                    timings["mine_s"] += time.perf_counter() - t0
                    timings["minings"] += 1
                else:
                    gen = torch.Generator().manual_seed(cfg.seed * 1_000_003 + epoch0)
                    neg_l, neg_r = sample_uniform_negatives(gen, pairs, n1, n, cfg.k_neg)
                batch = {"pairs": pairs, "neg_l": neg_l, "neg_r": neg_r}
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss, aux = loss_fn(batch)
            loss.backward()
            opt.step()
            sched.step()
            losses.append(loss.detach())
            _sync(dev)
            timings["step_s"].append(time.perf_counter() - t0)
            timings["train_s"] += timings["step_s"][-1]
            timings["steps"] += 1
            if cfg.eval_every and (epoch % cfg.eval_every == 0 or epoch >= cfg.epochs - 1):
                _, m = evaluate_now()
                wall = time.perf_counter() - t_start
                rec = {
                    "epoch": epoch,
                    "loss": loss.item(),
                    "wall_s": round(wall, 3),
                    "edges_per_s": round(epoch_edge_ops(op.nnz) * (epoch + 1) / max(wall, 1e-9), 1),
                    **{f"loss_{k}": v.item() for k, v in aux.items()},
                    **{k: round(v, 4) for k, v in m.items()},
                }
                history.append(rec)
                logger.log(rec)
                if verbose:
                    print(f"[{cfg.name}] epoch {epoch} loss {rec['loss']:.4f} "
                          f"hits@1 {m['hits@1']:.3f} hits@10 {m['hits@10']:.3f}")
        final_emb, final = evaluate_now()
        final["final_loss"] = loss.item()
        if cfg.save_emb_path:  # hand the table to the serving path (tpugraph_torch.serve)
            from tpugraph_torch.serve import save_embeddings

            save_embeddings(cfg.save_emb_path, final_emb)
    finally:
        logger.close()
    return TrainResult(params={k: v.detach() for k, v in model.state_dict().items()},
                       metrics=final, history=history, op=op, model=model, task=task,
                       losses=torch.stack(losses).tolist() if losses else [],
                       timings=timings)


def build_operator(cfg: TrainConfig, task: AlignTask, dev: torch.device) -> EllOperator:
    return build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel,
                           weighting=cfg.weighting, norm=cfg.norm, fmt="ell").to(dev)


def fit(cfg: TrainConfig, task: AlignTask | None = None, verbose: bool = False,
        device: str | torch.device = "cuda") -> TrainResult:
    """Train an AlignGCN with the margin loss per ``cfg`` (config ``base``);
    parameters start from ``init_params(seed=cfg.seed)``."""
    dev = resolve_device(device)
    check_trainable(cfg)
    task = task or load_task(cfg)
    op = build_operator(cfg, task, dev)
    model = build_model(cfg, task, device=dev)
    model.load_state_dict(init_params(task.n_ent, cfg.dim, cfg.hidden, seed=cfg.seed))

    def loss_fn(batch):
        loss = margin_align_loss(model(op), batch["pairs"], batch["neg_l"], batch["neg_r"],
                                 cfg.gamma)
        return loss, {"margin": loss}

    return train_loop(cfg, task, op, model, loss_fn, lambda: embed(model, op), dev, verbose)
