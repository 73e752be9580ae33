"""Full-graph training loop (counterpart of ``tpugraph/train/loop.py``).

One optimizer step per epoch over the whole merged graph.  At each
``neg_every`` boundary, in the JAX package's order: with ``boot_cap > 0``
the mutual-NN proposals (from ``boot_start`` on, else a weight-0
placeholder) join the seed pairs in the margin loss; then negatives are
drawn over those pairs (uniform at epoch 0, then exact-L1 hard mining from
the current parameters when ``neg_mode='hard'``).  Proposal and mining
share one encoder forward, since both read the same parameters.  Exact
Hits@k (CSLS with ``eval_csls_k``) at ``eval_every`` and at the end.  With
``checkpoint_dir`` and ``checkpoint_every`` the loop saves and resumes
(``train/checkpoint.py``), and SIGTERM makes it save and stop at the next
epoch boundary.  ``fit`` trains configs ``base`` and ``highway`` (AlignGCN
+ margin loss); ``train/mtl.py::fit_mtl`` runs the same loop over AlignMTL
and adds its own per-interval draws to the batch.  Each step with dropout
draws its mask from a generator of its own (``step_generator``).  Both run
on the card unless the caller passes ``device="cpu"``.

Not ported yet, and refused up front (``check_trainable``): the fused
``steps_per_call`` interval, approximate and sqeuclidean proposals,
profiling, bf16 training, approximate eval, approximate, CSLS and
sqeuclidean mining, and the distributed trainer (``ROADMAP.md``).
"""

from __future__ import annotations

import time
from collections.abc import Callable
from dataclasses import dataclass, field

import numpy as np
import torch

from tpugraph_torch import resolve_device
from tpugraph_torch.configs.configs import TrainConfig
from tpugraph_torch.convert import embed_params
from tpugraph_torch.data.synthetic import synthetic_align_task
from tpugraph_torch.models.encoder import AlignGCN, init_params
from tpugraph_torch.sparse.build import build_adjacency
from tpugraph_torch.sparse.ell import EllOperator
from tpugraph_torch.sparse.graph import AlignTask
from tpugraph_torch.train.bootstrap import propose_mutual_nn_pairs
from tpugraph_torch.train.checkpoint import Checkpointer
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
    losses: list = field(default_factory=list)  # total loss of every step run here
    # host wall seconds, each stage ended by a device synchronise: setup_s
    # (optimizer and loop set-up), load_s (restoring a checkpoint), train_s
    # (the steps), step_s (each step's), forward_s (the interval
    # boundaries' encoder forwards), propose_s (bootstrap proposals), mine_s
    # (hard mining), draw_s (fit_mtl's per-interval draws), eval_s (evals
    # incl. the final one), save_s (checkpoints); the counts steps,
    # forwards, proposals, minings, draws, evals, saves; and start_epoch,
    # the first epoch this process ran
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


def interval_generator(cfg: TrainConfig, epoch0: int, stream: int = 0) -> torch.Generator:
    """The host generator of one interval's draws, from (seed, the
    interval's first epoch): the uniform negatives (stream 0) and
    ``fit_mtl``'s relation corruptions (1), attribute batch (2) and OT
    subsample (3)."""
    return torch.Generator().manual_seed(cfg.seed * 1_000_003 + epoch0 + (stream << 40))


def step_generator(cfg: TrainConfig, epoch: int, dev: torch.device) -> torch.Generator:
    """The generator of one training step's dropout mask, on the run's
    device, from (seed, epoch): the counterpart of the JAX step key."""
    return torch.Generator(device=dev).manual_seed(cfg.seed * 1_000_003 + epoch + (4 << 40))


def check_trainable(cfg: TrainConfig) -> None:
    """Refuse, before any work, a config that needs an unported part."""
    if cfg.neg_every < 1:
        raise ValueError("neg_every must be >= 1 (to effectively never resample, set "
                         "neg_every >= epochs)")
    unported = {
        "steps_per_call > 1 (the fused interval)": cfg.steps_per_call > 1,
        "boot_approx (approximate proposals)": cfg.boot_cap > 0 and cfg.boot_approx,
        "profile_dir": bool(cfg.profile_dir),
        f"param_dtype={cfg.param_dtype!r} training (float32 only)":
            cfg.param_dtype != "float32",
        "eval_approx_k (approximate eval)": cfg.eval_approx_k > 0,
        "approximate, CSLS or sqeuclidean hard mining": cfg.neg_mode == "hard" and (
            cfg.neg_approx or cfg.neg_csls_k > 0 or cfg.neg_metric != "cityblock"),
        "sqeuclidean proposals": cfg.boot_cap > 0 and cfg.neg_metric != "cityblock",
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


def _check_resume(cfg: TrainConfig, state: dict, n_rows: int,
                  extra_keys: tuple[str, ...] = ()) -> None:
    """Refuse a checkpoint that lacks what a resume cannot rebuild (with
    ``extra_keys``, the interval's draws of ``fit_mtl``), or whose interval
    batch belongs to another pair count (another ``boot_cap``)."""
    need = ["model", "opt", "sched", "neg_l", "neg_r", "loss"]
    if cfg.boot_cap > 0:
        need += ["boot_pairs", "boot_w"]
    missing = [k for k in need if k not in state]
    missing += [f"extra.{k}" for k in extra_keys if k not in state.get("extra", {})]
    if missing:
        raise ValueError(
            f"checkpoint at {cfg.checkpoint_dir!r} lacks {missing}: it predates the resume "
            f"state (loss, interval negatives, proposals and draws) or was written by "
            f"another configuration — resuming it would redraw the interval batch from "
            f"the restored parameters and silently diverge; retrain or point "
            f"checkpoint_dir elsewhere")
    if state["neg_l"].shape != (n_rows, cfg.k_neg):
        raise ValueError(
            f"checkpoint at {cfg.checkpoint_dir!r} holds negatives of shape "
            f"{tuple(state['neg_l'].shape)}, this run needs ({n_rows}, {cfg.k_neg}) "
            f"(k_neg or boot_cap changed); retrain or point checkpoint_dir elsewhere")


def train_loop(cfg: TrainConfig, task: AlignTask, op: EllOperator, model: torch.nn.Module,
               loss_fn: Callable[[dict, torch.Generator | None], tuple[torch.Tensor, dict]],
               embed_fn: Callable[[], torch.Tensor], dev: torch.device,
               verbose: bool = False,
               draw_extra: Callable[[int], dict[str, torch.Tensor]] | None = None,
               extra_keys: tuple[str, ...] = ()) -> TrainResult:
    """The epoch loop shared by ``fit`` and ``fit_mtl``: ``loss_fn(batch,
    generator)`` returns (loss, aux) with grad for a training forward, whose
    dropout mask (if any) comes from ``generator``; ``embed_fn()`` the
    evaluation table, which the evals, proposals and mining read.
    ``draw_extra(epoch0)`` returns the entries ``extra_keys`` that each
    interval adds to the batch; a checkpoint saves them.  A checkpoint's
    ``params.pt`` holds what the evaluation table reads
    (``convert.embed_params``)."""
    t_setup = time.perf_counter()
    opt, sched = make_optimizer(cfg, model.parameters())
    pairs = torch.as_tensor(np.asarray(task.train_pairs), dtype=torch.int64, device=dev)
    n1, n = task.kg1.n_ent, task.n_ent
    logger = MetricsLogger(cfg.metrics_path, config=cfg.to_dict(), tb_dir=cfg.tb_dir)
    history, losses = [], []
    timings = {"load_s": 0.0, "train_s": 0.0, "step_s": [], "forward_s": 0.0,
               "propose_s": 0.0, "mine_s": 0.0, "draw_s": 0.0, "eval_s": 0.0, "save_s": 0.0,
               "steps": 0, "forwards": 0, "proposals": 0, "minings": 0, "draws": 0, "evals": 0,
               "saves": 0}

    use_boot = cfg.boot_cap > 0
    if use_boot:
        mask1 = torch.ones(n1, dtype=torch.bool, device=dev)
        mask1[pairs[:, 0]] = False
        mask2 = torch.ones(n - n1, dtype=torch.bool, device=dev)
        mask2[pairs[:, 1] - n1] = False
        ones_seed = torch.ones(pairs.shape[0], dtype=torch.float32, device=dev)
        placeholder = (torch.tensor([0, n1], device=dev).repeat(cfg.boot_cap, 1),
                       torch.zeros(cfg.boot_cap, dtype=torch.float32, device=dev))

    def interval_batch(boot, neg_l=None, neg_r=None):
        """The seed pairs, with the proposals ``boot`` and their weights for
        the margin loss when bootstrapping."""
        batch = {"pairs": pairs, "neg_l": neg_l, "neg_r": neg_r}
        if use_boot:
            batch["pairs_aug"] = torch.cat([pairs, boot[0]])
            batch["w"] = torch.cat([ones_seed, boot[1] * cfg.boot_weight])
        return batch

    def timed(key, count, fn):
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        timings[key] += time.perf_counter() - t0
        timings[count] += 1
        return out

    def evaluate_now():
        emb = timed("eval_s", "evals", embed_fn)
        t0 = time.perf_counter()
        m = hits_at_k(emb, task.test_pairs, csls_k=cfg.eval_csls_k)
        timings["eval_s"] += time.perf_counter() - t0
        return emb, m

    ckpt = Checkpointer(cfg.checkpoint_dir, cfg.checkpoint_every)
    start_epoch, batch, boot = 0, None, None
    loss, aux = torch.tensor(float("nan")), {}
    t0 = time.perf_counter()
    restored = ckpt.restore_latest(dev)
    if restored is not None:
        epoch, state = restored
        _check_resume(cfg, state, pairs.shape[0] + (cfg.boot_cap if use_boot else 0),
                      extra_keys)
        model.load_state_dict(state["model"])
        opt.load_state_dict(state["opt"])
        sched.load_state_dict(state["sched"])
        boot = (state["boot_pairs"], state["boot_w"]) if use_boot else None
        batch = interval_batch(boot, state["neg_l"], state["neg_r"])
        batch.update({k: state["extra"][k] for k in extra_keys})
        loss, start_epoch = state["loss"], epoch + 1
    timings["load_s"] = time.perf_counter() - t0
    timings["start_epoch"] = start_epoch

    def save_now(epoch):
        state = {"model": model.state_dict(), "opt": opt.state_dict(),
                 "sched": sched.state_dict(), "neg_l": batch["neg_l"], "neg_r": batch["neg_r"],
                 "loss": loss.detach()}
        if use_boot:
            state["boot_pairs"], state["boot_w"] = boot
        if extra_keys:
            state["extra"] = {k: batch[k] for k in extra_keys}
        timed("save_s", "saves",
              lambda: ckpt.save(epoch, state, embed_params(model.state_dict())))

    t_start = time.perf_counter()
    timings["setup_s"] = t_start - t_setup - timings["load_s"]
    ckpt.install_preemption_handler()
    try:
        for epoch in range(start_epoch, cfg.epochs):
            if epoch % cfg.neg_every == 0 or batch is None:
                epoch0 = epoch - epoch % cfg.neg_every
                propose = use_boot and epoch >= cfg.boot_start and epoch > 0
                mine = cfg.neg_mode == "hard" and epoch > 0
                emb = timed("forward_s", "forwards", embed_fn) if propose or mine else None
                if use_boot:
                    boot = timed("propose_s", "proposals", lambda: propose_mutual_nn_pairs(
                        emb, mask1, mask2, n1, n, cfg.boot_cap,
                        csls_k=cfg.boot_csls_k)) if propose else placeholder
                batch = interval_batch(boot)
                pairs_t = batch.get("pairs_aug", pairs)
                if mine:
                    batch["neg_l"], batch["neg_r"] = timed(
                        "mine_s", "minings",
                        lambda: sample_hard_negatives(emb, pairs_t, n1, n, cfg.k_neg))
                else:
                    batch["neg_l"], batch["neg_r"] = sample_uniform_negatives(
                        interval_generator(cfg, epoch0), pairs_t, n1, n, cfg.k_neg)
                if draw_extra is not None:
                    batch.update(timed("draw_s", "draws", lambda: draw_extra(epoch0)))
                del emb
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            gen = step_generator(cfg, epoch, dev) if cfg.dropout > 0.0 else None
            loss, aux = loss_fn(batch, gen)
            loss.backward()
            opt.step()
            sched.step()
            losses.append(loss.detach())
            _sync(dev)
            timings["step_s"].append(time.perf_counter() - t0)
            timings["train_s"] += timings["step_s"][-1]
            timings["steps"] += 1
            if ckpt.enabled and ((epoch > 0 and epoch % cfg.checkpoint_every == 0)
                                 or epoch >= cfg.epochs - 1 or ckpt.preempted):
                save_now(epoch)
            if cfg.eval_every and (epoch % cfg.eval_every == 0 or epoch >= cfg.epochs - 1):
                _, m = evaluate_now()
                wall = time.perf_counter() - t_start
                rec = {
                    "epoch": epoch,
                    "loss": loss.item(),
                    "wall_s": round(wall, 3),
                    # epochs run in this process: the wall covers only those
                    "edges_per_s": round(epoch_edge_ops(op.nnz, cfg.use_attr_channel)
                                         * (epoch + 1 - start_epoch) / max(wall, 1e-9), 1),
                    **{f"loss_{k}": v.item() for k, v in aux.items()},
                    **{k: round(v, 4) for k, v in m.items()},
                }
                history.append(rec)
                logger.log(rec)
                if verbose:
                    print(f"[{cfg.name}] epoch {epoch} loss {rec['loss']:.4f} "
                          f"hits@1 {m['hits@1']:.3f} hits@10 {m['hits@10']:.3f}")
            if ckpt.preempted:
                save_now(epoch)  # the latch may have fired after the save above
                break  # exit cleanly for a relaunch
        final_emb, final = evaluate_now()
        final["final_loss"] = loss.item()
        if cfg.save_emb_path:  # hand the table to the serving path (tpugraph_torch.serve)
            from tpugraph_torch.serve import save_embeddings

            save_embeddings(cfg.save_emb_path, final_emb)
    finally:
        ckpt.restore_handler()
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
    """Train an AlignGCN with the margin loss per ``cfg`` (configs ``base``
    and ``highway``); parameters start from ``init_params(seed=cfg.seed)``."""
    dev = resolve_device(device)
    check_trainable(cfg)
    task = task or load_task(cfg)
    op = build_operator(cfg, task, dev)
    model = build_model(cfg, task, device=dev)
    model.load_state_dict(init_params(task.n_ent, cfg.dim, cfg.hidden, seed=cfg.seed,
                                      highway=cfg.highway))

    def loss_fn(batch, generator):
        loss = margin_align_loss(model(op, train=True, generator=generator),
                                 batch.get("pairs_aug", batch["pairs"]),
                                 batch["neg_l"], batch["neg_r"], cfg.gamma, batch.get("w"))
        return loss, {"margin": loss}

    return train_loop(cfg, task, op, model, loss_fn, lambda: embed(model, op), dev, verbose)
