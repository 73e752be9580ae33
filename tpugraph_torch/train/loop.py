"""Full-graph training loop (counterpart of ``tpugraph/train/loop.py``).

One optimizer step per epoch over the whole merged graph.  At each
``neg_every`` boundary, in the JAX package's order: with ``boot_cap > 0``
the mutual-NN proposals (from ``boot_start`` on, else a weight-0
placeholder; by ``neg_metric``, approximate with ``boot_approx``) join the
seed pairs in the margin loss; then negatives are drawn over those pairs
(uniform at epoch 0, then hard mining from the current parameters when
``neg_mode='hard'``, by ``neg_metric``, approximate with ``neg_approx``,
CSLS-scored with ``neg_csls_k``).  Proposal and mining share one encoder
forward, since both read the same parameters.  Hits@k (CSLS with
``eval_csls_k``) at ``eval_every``, within shortlists with
``eval_approx_k``, and exact at the end.  With
``checkpoint_dir`` and ``checkpoint_every`` the loop saves and resumes
(``train/checkpoint.py``), and SIGTERM makes it save and stop at the next
epoch boundary.  ``fit`` trains configs ``base`` and ``highway`` (AlignGCN
+ margin loss); ``train/mtl.py::fit_mtl`` runs the same loop over AlignMTL
and adds its own per-interval draws to the batch.  Each step with dropout
draws its mask from a generator of its own (``step_generator``).  Both run
on the card unless the caller passes ``device="cpu"``.

``steps_per_call = neg_every`` fuses each resample interval, as the JAX
``train_interval`` does: the loop walks the epochs an interval at a time,
saves and evaluates in the JAX fused windows (``last % every <
steps_per_call``, at the interval's last epoch), and a save holds
placeholder negatives and proposals, so a resume (only at an interval
boundary) re-mines.  On the card the interval's steps are replays of one
captured step (``train/fused.py``) with no host synchronise between them;
on the host the same steps run eagerly.  ``profile_dir`` traces epochs
``start + 2`` to ``start + 5`` with ``torch.profiler`` (or to the end of a
shorter run) and writes a Chrome trace there; a fused run (``fit_mtl``
only: the JAX ``fit`` refuses it) traces the intervals that hold those
epochs, after the capture.

``param_dtype="bfloat16"`` trains with bf16 activations over fp32
parameters, and ``spmm_impl`` picks the layers' aggregation and the
operator's layout (``nn/graphconv.py``).  ``debug_nans`` (the CLI's
``--debug-nans``, the counterpart of ``jax_debug_nans``) raises
``FloatingPointError`` at the first non-finite value: unfused, under
autograd's anomaly detection and a finite check of each step's loss,
gradients and updated parameters, naming the epoch; fused, from a flag
each step of the interval folds on the device (inside the captured graph
on the card) and the interval's one synchronise reads, naming the
interval's epochs.

These trainers are single-device: ``check_trainable`` refuses more than
one shard (``train/driver.py::run`` sends such a config to
``dist/trainer.py::fit_distributed``).
"""

from __future__ import annotations

import os
import time
from collections.abc import Callable
from dataclasses import dataclass, field

import numpy as np
import torch

from tpugraph_torch import resolve_device
from tpugraph_torch.configs.configs import TrainConfig
from tpugraph_torch.convert import embed_params
from tpugraph_torch.data import load_dbp15k, load_openea, synthetic_align_task
from tpugraph_torch.kernels.shortlist_dist import METRICS
from tpugraph_torch.models.encoder import AlignGCN, init_params
from tpugraph_torch.nn.graphconv import operator_format
from tpugraph_torch.sparse.build import build_adjacency
from tpugraph_torch.sparse.ell import EllOperator
from tpugraph_torch.sparse.graph import AlignTask, SpMMOperator
from tpugraph_torch.train.bootstrap import propose_mutual_nn_pairs
from tpugraph_torch.train.checkpoint import Checkpointer
from tpugraph_torch.train.eval import hits_at_k
from tpugraph_torch.train.fused import CapturedStep, finite_flag, train_step
from tpugraph_torch.train.losses import margin_align_loss
from tpugraph_torch.train.metrics import MetricsLogger, epoch_edge_ops
from tpugraph_torch.train.negatives import sample_hard_negatives, sample_uniform_negatives
from tpugraph_torch.train.optim import load_optimizer_state, make_optimizer, optimizer_state


@dataclass
class TrainResult:
    params: dict  # the model's state dict, on the run's device
    metrics: dict
    history: list = field(default_factory=list)
    op: EllOperator | SpMMOperator | None = None
    model: torch.nn.Module | None = None
    task: AlignTask | None = None
    losses: list = field(default_factory=list)  # total loss of every step run here
    # host wall seconds, each stage ended by a device synchronise: setup_s
    # (optimizer and loop set-up), load_s (restoring a checkpoint), train_s
    # (the steps), step_s (each step's; with steps_per_call > 1 one entry
    # per interval, its wall over its steps: the interval ends in one
    # synchronise), capture_s (the fused interval's warm-up step and
    # capture on the card, once per run), forward_s (the interval
    # boundaries' encoder forwards), propose_s (bootstrap proposals), mine_s
    # (hard mining), draw_s (fit_mtl's per-interval draws), eval_s (evals
    # incl. the final one; final_eval_s, the final one alone), save_s
    # (checkpoints); the counts steps,
    # forwards, proposals, minings, draws, evals, saves; and start_epoch,
    # the first epoch this process ran
    timings: dict = field(default_factory=dict)


@dataclass
class StepParts:
    """What a trainer hands ``train_loop`` (``fit``: ``margin_parts``;
    ``fit_mtl``: ``mtl.mtl_parts``): the model over ``op``, its training
    loss ``loss_fn(batch, generator)`` -> (loss, aux) with grad (the
    dropout mask, if any, from ``generator``), ``embed_fn()`` the
    evaluation table that the evals, proposals and mining read, and with
    ``draw_extra(epoch0)`` the entries ``extra_keys`` that each interval
    adds to the batch."""
    model: torch.nn.Module
    op: EllOperator | SpMMOperator
    loss_fn: Callable[[dict, torch.Generator | None], tuple[torch.Tensor, dict]]
    embed_fn: Callable[[], torch.Tensor]
    draw_extra: Callable[[int], dict[str, torch.Tensor]] | None = None
    extra_keys: tuple[str, ...] = ()


class IntervalBatch:
    """The interval batch as ``train_loop`` and the distributed trainer
    assemble it at each boundary (``at_boundary``):
    the seed pairs, with ``boot_cap > 0`` the proposals and their weights
    (the seed pairs weigh 1, the proposals ``boot_weight``·w; before
    ``boot_start`` the weight-0 ``placeholder``), then the negatives.

    ``kg2_row`` (default n1): the table row of KG2's first entity, r0 of
    the distributed trainer's grouped layout (``dist/trainer.py::
    RowLayout``), whose KG1 rows [n1, r0) are padding: the pairs, the
    proposals and the negatives are then rows of that table, KG2 entity
    n1 + j at row r0 + j."""

    def __init__(self, cfg: TrainConfig, task: AlignTask, dev: torch.device,
                 kg2_row: int | None = None):
        self.cfg, self.n1, self.n = cfg, task.kg1.n_ent, task.n_ent
        self.r0 = self.n1 if kg2_row is None else kg2_row
        self.r1 = self.r0 + self.n - self.n1
        pairs = np.asarray(task.train_pairs)
        pairs = np.where(pairs < self.n1, pairs, pairs - self.n1 + self.r0)
        self.pairs = torch.as_tensor(pairs, dtype=torch.int64, device=dev)
        self.use_boot = cfg.boot_cap > 0
        self.placeholder = None
        if self.use_boot:
            pairs, r0 = self.pairs, self.r0
            self.mask1 = torch.zeros(r0, dtype=torch.bool, device=dev)
            self.mask1[:self.n1] = True  # rows [n1, r0): the grouped layout's padding
            self.mask1[pairs[:, 0]] = False
            self.mask2 = torch.ones(self.n - self.n1, dtype=torch.bool, device=dev)
            self.mask2[pairs[:, 1] - r0] = False
            self.ones_seed = torch.ones(pairs.shape[0], dtype=torch.float32, device=dev)
            self.placeholder = (torch.tensor([0, r0], device=dev).repeat(cfg.boot_cap, 1),
                                torch.zeros(cfg.boot_cap, dtype=torch.float32, device=dev))

    def __call__(self, boot, neg_l=None, neg_r=None) -> dict[str, torch.Tensor]:
        """The batch of the proposals ``boot`` (pairs, weights), and the
        negatives if given."""
        batch = {"pairs": self.pairs, "neg_l": neg_l, "neg_r": neg_r}
        if self.use_boot:
            batch["pairs_aug"] = torch.cat([self.pairs, boot[0]])
            batch["w"] = torch.cat([self.ones_seed, boot[1] * self.cfg.boot_weight])
        return batch

    def uniform(self, batch: dict, epoch0: int) -> None:
        """The interval's uniform negatives over the batch's margin pairs,
        from ``interval_generator(cfg, epoch0)`` (KG2's drawn as entity ids,
        then moved to its rows)."""
        neg_l, neg_r = sample_uniform_negatives(
            interval_generator(self.cfg, epoch0), batch.get("pairs_aug", self.pairs), self.n1,
            self.n, self.cfg.k_neg)
        batch["neg_l"], batch["neg_r"] = neg_l, neg_r + (self.r0 - self.n1)

    def at_boundary(self, epoch: int, embed_fn: Callable[[], torch.Tensor],
                    mine_fn: Callable[[torch.Tensor, torch.Tensor], tuple],
                    draw_extra: Callable[[int], dict] | None, timed: Callable) -> tuple:
        """(batch, proposals) of the interval starting at ``epoch``, in the
        JAX package's order: one forward ``embed_fn()`` where the interval
        proposes or mines; from ``boot_start`` the mutual-NN proposals on
        it; the negatives over the seed pairs and proposals,
        ``mine_fn(table, pairs)`` in hard mode after epoch 0, else
        uniform; then ``draw_extra(epoch0)``.  ``timed(key, count, fn)``
        runs each stage under its ``TrainResult.timings`` names."""
        cfg = self.cfg
        epoch0 = epoch - epoch % cfg.neg_every
        propose = self.use_boot and epoch >= cfg.boot_start and epoch > 0
        mine = cfg.neg_mode == "hard" and epoch > 0
        emb = timed("forward_s", "forwards", embed_fn) if propose or mine else None
        boot = self.placeholder
        if propose:
            boot = timed("propose_s", "proposals", lambda: propose_mutual_nn_pairs(
                emb, self.mask1, self.mask2, self.r0, self.r1, cfg.boot_cap,
                metric=cfg.neg_metric, csls_k=cfg.boot_csls_k, approx=cfg.boot_approx))
        batch = self(boot)
        if mine:
            pairs_t = batch.get("pairs_aug", self.pairs)
            batch["neg_l"], batch["neg_r"] = timed("mine_s", "minings",
                                                   lambda: mine_fn(emb, pairs_t))
        else:
            self.uniform(batch, epoch0)
        if draw_extra is not None:
            batch.update(timed("draw_s", "draws", lambda: draw_extra(epoch0)))
        return batch, boot


def first_batch(cfg: TrainConfig, task: AlignTask, parts: StepParts, dev: torch.device,
                boot: tuple[torch.Tensor, torch.Tensor] | None = None) -> dict:
    """Epoch 0's batch as ``train_loop`` builds it: the seed pairs, the
    placeholder proposals (or ``boot``), uniform negatives and the
    trainer's draws."""
    make = IntervalBatch(cfg, task, dev)
    batch = make(boot if boot is not None else make.placeholder)
    make.uniform(batch, 0)
    if parts.draw_extra is not None:
        batch.update(parts.draw_extra(0))
    return batch


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
    if cfg.dataset == "dbp15k":
        return load_dbp15k(cfg.data_root, cfg.pair, train_ratio=cfg.train_ratio, seed=cfg.seed)
    if cfg.dataset == "openea":
        # openea_fold selects the official 721_5fold split (0: the seeded
        # train_ratio split)
        return load_openea(cfg.data_root, train_ratio=cfg.train_ratio, seed=cfg.seed,
                           fold=cfg.openea_fold if cfg.openea_fold > 0 else None)
    raise ValueError(f"unknown dataset {cfg.dataset!r}")


def build_model(cfg: TrainConfig, task: AlignTask,
                device: torch.device | str | None = None) -> AlignGCN:
    operator_format(cfg.spmm_impl)  # an unknown impl raises here
    return AlignGCN(
        n_ent=task.n_ent,
        dim=cfg.dim,
        hidden=cfg.hidden,
        highway=cfg.highway,
        dropout=cfg.dropout,
        compute_dtype=cfg.param_dtype,
        l2_normalize=cfg.l2_normalize,
        spmm_impl=cfg.spmm_impl,
        device=device,
    )


def embed(model: AlignGCN, op: EllOperator | SpMMOperator) -> torch.Tensor:
    """The encoder's output table (fp32), forward only."""
    with torch.no_grad():
        return model(op)


def interval_generator(cfg: TrainConfig, epoch0: int, stream: int = 0) -> torch.Generator:
    """The host generator of one interval's draws, from (seed, the
    interval's first epoch): the uniform negatives (stream 0) and
    ``fit_mtl``'s relation corruptions (1), attribute batch (2) and OT
    subsample (3)."""
    return torch.Generator().manual_seed(cfg.seed * 1_000_003 + epoch0 + (stream << 40))


def step_seed(cfg: TrainConfig, epoch: int) -> int:
    """The seed of one training step's dropout mask, from (seed, epoch): the
    counterpart of the JAX step key."""
    return cfg.seed * 1_000_003 + epoch + (4 << 40)


def step_generator(cfg: TrainConfig, epoch: int, dev: torch.device) -> torch.Generator:
    """The generator of one training step's dropout mask, on the run's
    device (``step_seed``)."""
    return torch.Generator(device=dev).manual_seed(step_seed(cfg, epoch))


def check_trainable(cfg: TrainConfig, refuse_fused_profile: bool = False) -> None:
    """Refuse, before any work, a sharded config (``fit`` and ``fit_mtl``
    train on one device) and what ``check_schedule`` refuses."""
    check_schedule(cfg, refuse_fused_profile)
    if max(cfg.n_shards, cfg.feature_shards, cfg.slice_shards) > 1:
        raise NotImplementedError(
            "fit and fit_mtl train on one device; a sharded config goes through "
            "train.driver.run to dist.trainer.fit_distributed (ROADMAP.md)")


def check_schedule(cfg: TrainConfig, refuse_fused_profile: bool = False) -> None:
    """What the JAX trainers refuse of the resample interval, the fused
    interval and the negatives; with ``refuse_fused_profile`` (the JAX
    ``fit`` and distributed trainer) also ``profile_dir`` with
    ``steps_per_call > 1``."""
    if cfg.neg_every < 1:
        raise ValueError("neg_every must be >= 1 (to effectively never resample, set "
                         "neg_every >= epochs)")
    steps = max(1, cfg.steps_per_call)
    if steps > 1 and steps != cfg.neg_every:
        raise ValueError("steps_per_call > 1 requires steps_per_call == neg_every "
                         "(one fused dispatch per resample interval)")
    if steps > 1 and cfg.epochs % steps:
        raise ValueError(
            f"epochs={cfg.epochs} is not a multiple of steps_per_call={steps}: the fused "
            f"interval always runs a full {steps}-epoch scan, so the run would silently "
            f"train past cfg.epochs — adjust one of them")
    if refuse_fused_profile and steps > 1 and cfg.profile_dir:
        raise ValueError("profile_dir requires steps_per_call=1 (per-epoch trace windows)")
    if cfg.neg_mode not in ("uniform", "hard"):
        raise ValueError(f"unknown neg_mode {cfg.neg_mode!r}")
    if cfg.neg_metric not in METRICS:
        raise ValueError(f"unknown neg_metric {cfg.neg_metric!r}; expected one of {METRICS}")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _start_profile(dev: torch.device) -> torch.profiler.profile:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof: torch.profiler.profile, dev: torch.device, directory: str,
                  first: int, last: int) -> None:
    """Stop the trace and write it as ``trace-epochs-<first>-<last>.json``
    (Chrome trace format) under ``directory``."""
    _sync(dev)
    prof.stop()
    os.makedirs(directory, exist_ok=True)
    prof.export_chrome_trace(os.path.join(directory, f"trace-epochs-{first}-{last}.json"))


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


def _non_finite(epochs: str, what: str = "a non-finite loss, gradient or parameter"):
    return FloatingPointError(f"debug_nans: {epochs}: {what}")


def train_loop(cfg: TrainConfig, task: AlignTask, parts: StepParts, dev: torch.device,
               verbose: bool = False, debug_nans: bool = False) -> TrainResult:
    """The epoch loop shared by ``fit`` and ``fit_mtl`` over a trainer's
    ``parts`` (``StepParts``); a checkpoint saves the interval's draws
    ``parts.extra_keys``.  A checkpoint's ``params.pt`` holds what the
    evaluation table reads (``convert.embed_params``).  ``debug_nans``:
    see the module's docstring."""
    t_setup = time.perf_counter()
    model, op, loss_fn, embed_fn = parts.model, parts.op, parts.loss_fn, parts.embed_fn
    draw_extra, extra_keys = parts.draw_extra, parts.extra_keys
    steps = max(1, cfg.steps_per_call)
    captured_on_card = steps > 1 and dev.type == "cuda"
    opt, sched = make_optimizer(cfg, model.parameters(), capturable=captured_on_card)
    interval_batch = IntervalBatch(cfg, task, dev)
    pairs = interval_batch.pairs
    n1, n = task.kg1.n_ent, task.n_ent
    logger = MetricsLogger(cfg.metrics_path, config=cfg.to_dict(), tb_dir=cfg.tb_dir)
    history, losses = [], []
    timings = {"load_s": 0.0, "train_s": 0.0, "step_s": [], "capture_s": 0.0,
               "forward_s": 0.0, "propose_s": 0.0, "mine_s": 0.0, "draw_s": 0.0,
               "eval_s": 0.0, "final_eval_s": 0.0, "save_s": 0.0,
               "steps": 0, "forwards": 0, "proposals": 0, "minings": 0, "draws": 0, "evals": 0,
               "saves": 0}

    use_boot, placeholder = interval_batch.use_boot, interval_batch.placeholder

    def mine_fn(emb, pairs_t):
        return sample_hard_negatives(emb, pairs_t, n1, n, cfg.k_neg, metric=cfg.neg_metric,
                                     approx=cfg.neg_approx, csls_k=cfg.neg_csls_k)

    def timed(key, count, fn):
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        timings[key] += time.perf_counter() - t0
        timings[count] += 1
        return out

    def evaluate_now(approx_k):
        t0 = time.perf_counter()
        emb = timed("eval_s", "evals", embed_fn)
        t1 = time.perf_counter()
        m = hits_at_k(emb, task.test_pairs, csls_k=cfg.eval_csls_k, approx_k=approx_k)
        timings["eval_s"] += time.perf_counter() - t1
        return emb, m, time.perf_counter() - t0

    ckpt = Checkpointer(cfg.checkpoint_dir, cfg.checkpoint_every)
    start_epoch, batch, boot = 0, None, None
    loss, aux = torch.tensor(float("nan")), {}
    t0 = time.perf_counter()
    restored = ckpt.restore_latest(dev)
    if restored is not None:
        epoch, state = restored
        if steps > 1 and (epoch + 1) % steps:
            raise ValueError(
                f"checkpoint at {cfg.checkpoint_dir!r} resumes at epoch {epoch + 1}, "
                f"mid-interval for steps_per_call={steps} — it was saved under "
                f"steps_per_call=1 (fused chunks always save at interval ends); resume with "
                f"steps_per_call=1 or retrain.  A misaligned fused resume would silently "
                f"train past cfg.epochs with wrong interval keys")
        _check_resume(cfg, state, pairs.shape[0] + (cfg.boot_cap if use_boot else 0),
                      extra_keys)
        model.load_state_dict(state["model"])
        load_optimizer_state(opt, state["opt"])
        sched.load_state_dict(state["sched"])
        boot = (state["boot_pairs"], state["boot_w"]) if use_boot else None
        batch = interval_batch(boot, state["neg_l"], state["neg_r"])
        batch.update({k: state["extra"][k] for k in extra_keys})
        loss, start_epoch = state["loss"], epoch + 1
    timings["load_s"] = time.perf_counter() - t0
    timings["start_epoch"] = start_epoch

    def save_now(epoch):
        neg_l, neg_r, boot_s = batch["neg_l"], batch["neg_r"], boot
        if steps > 1:  # a fused resume starts at a boundary and re-mines (and re-proposes)
            neg_l = neg_r = torch.zeros_like(neg_l)
            boot_s = placeholder
        state = {"model": model.state_dict(), "opt": optimizer_state(opt),
                 "sched": sched.state_dict(), "neg_l": neg_l, "neg_r": neg_r,
                 "loss": loss.detach()}
        if use_boot:
            state["boot_pairs"], state["boot_w"] = boot_s
        if extra_keys:
            state["extra"] = {k: batch[k] for k in extra_keys}
        timed("save_s", "saves",
              lambda: ckpt.save(epoch, state, embed_params(model.state_dict())))

    def eager_step(epoch):
        gen = step_generator(cfg, epoch, dev) if cfg.dropout > 0.0 else None
        out = train_step(opt, loss_fn, batch, gen)
        sched.step()
        return out

    def checked_step(epoch):
        """An unfused step under debug_nans: anomaly detection in its
        backward, then the finite check, each raising for its epoch."""
        try:
            loss, aux = eager_step(epoch)
        except RuntimeError as err:  # anomaly mode's report of a NaN in the backward
            if "nan" not in str(err).lower():
                raise
            raise _non_finite(f"epoch {epoch}", str(err).splitlines()[0]) from err
        if not bool(finite_flag(opt, loss)):
            raise _non_finite(f"epoch {epoch}")
        return loss, aux

    captured = None
    prof, prof_first = None, None  # the profiler over epochs start_epoch + 2 to + 5
    anomaly_was = torch.is_anomaly_enabled()
    t_start = time.perf_counter()
    timings["setup_s"] = t_start - t_setup - timings["load_s"]
    ckpt.install_preemption_handler()
    try:
        # anomaly detection names the op whose backward made a NaN (unfused only:
        # its checks synchronise, which a captured step cannot)
        torch.autograd.set_detect_anomaly(anomaly_was or (debug_nans and steps == 1))
        for epoch in range(start_epoch, cfg.epochs, steps):
            if epoch % cfg.neg_every == 0 or batch is None:
                batch, boot = interval_batch.at_boundary(epoch, embed_fn, mine_fn, draw_extra,
                                                         timed)
            if captured_on_card and captured is None:
                t0 = time.perf_counter()
                captured = CapturedStep(opt, loss_fn, batch, dev, cfg.dropout > 0.0,
                                        check_finite=debug_nans)
                _sync(dev)
                timings["capture_s"] = time.perf_counter() - t0
            last = epoch + steps - 1  # the interval's last epoch: the JAX fused windows
            if cfg.profile_dir and prof_first is None and last >= start_epoch + 2:
                prof, prof_first = _start_profile(dev), epoch
            # a fused interval's finite flag under debug_nans (the host's too)
            finite = (torch.ones((), dtype=torch.bool, device=dev)
                      if debug_nans and steps > 1 else None)
            t0 = time.perf_counter()
            if captured is not None:  # the interval's steps as replays, no synchronise
                captured.load(batch)
                for i in range(steps):
                    losses.append(captured.replay(step_seed(cfg, epoch + i)))
                    sched.step()
                loss, aux = losses[-1], {k: v.clone() for k, v in captured.aux.items()}
                finite = captured.finite
            else:
                for i in range(steps):
                    loss, aux = (checked_step if debug_nans and steps == 1
                                 else eager_step)(epoch + i)
                    if finite is not None:
                        finite &= finite_flag(opt, loss)
                    losses.append(loss)
            _sync(dev)
            dt = time.perf_counter() - t0
            timings["step_s"].append(dt / steps)
            timings["train_s"] += dt
            timings["steps"] += steps
            if finite is not None and not bool(finite):
                raise _non_finite(f"the interval of epochs {epoch}-{last}")
            if prof is not None and last >= start_epoch + 5:
                _stop_profile(prof, dev, cfg.profile_dir, prof_first, last)
                prof = None
            if ckpt.enabled and ((last > 0 and last % cfg.checkpoint_every < steps)
                                 or last >= cfg.epochs - 1 or ckpt.preempted):
                save_now(last)
            if cfg.eval_every and (last % cfg.eval_every < steps or last >= cfg.epochs - 1):
                _, m, _ = evaluate_now(cfg.eval_approx_k)  # the history: shortlists if set
                wall = time.perf_counter() - t_start
                rec = {
                    "epoch": last,
                    "loss": loss.item(),
                    "wall_s": round(wall, 3),
                    # epochs run in this process: the wall covers only those
                    "edges_per_s": round(epoch_edge_ops(op.nnz, cfg.use_attr_channel)
                                         * (last + 1 - start_epoch) / max(wall, 1e-9), 1),
                    **{f"loss_{k}": v.item() for k, v in aux.items()},
                    **{k: round(v, 4) for k, v in m.items()},
                }
                history.append(rec)
                logger.log(rec)
                if verbose:
                    print(f"[{cfg.name}] epoch {last} loss {rec['loss']:.4f} "
                          f"hits@1 {m['hits@1']:.3f} hits@10 {m['hits@10']:.3f}")
            if ckpt.preempted:
                save_now(last)  # the latch may have fired after the save above
                break  # exit cleanly for a relaunch
        if prof is not None:  # a run that ended before start_epoch + 5
            _stop_profile(prof, dev, cfg.profile_dir, prof_first, last)
            prof = None
        final_emb, final, timings["final_eval_s"] = evaluate_now(0)  # always exact
        final["final_loss"] = loss.item()
        if cfg.save_emb_path:  # hand the table to the serving path (tpugraph_torch.serve)
            from tpugraph_torch.serve import save_embeddings

            save_embeddings(cfg.save_emb_path, final_emb)
    finally:
        torch.autograd.set_detect_anomaly(anomaly_was)
        if prof is not None:
            prof.stop()
        ckpt.restore_handler()
        logger.close()
    return TrainResult(params={k: v.detach() for k, v in model.state_dict().items()},
                       metrics=final, history=history, op=op, model=model, task=task,
                       losses=torch.stack(losses).tolist() if losses else [],
                       timings=timings)


def build_operator(cfg: TrainConfig, task: AlignTask,
                   dev: torch.device) -> EllOperator | SpMMOperator:
    """The merged adjacency in the layout of ``cfg.spmm_impl``, on ``dev``."""
    return build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel,
                           weighting=cfg.weighting, norm=cfg.norm, bucket=cfg.pad_bucket,
                           fmt=operator_format(cfg.spmm_impl)).to(dev)


def margin_parts(cfg: TrainConfig, task: AlignTask, dev: torch.device) -> StepParts:
    """``fit``'s model (AlignGCN, from ``init_params(seed=cfg.seed)``) and
    margin loss over the batch's margin pairs and weights."""
    op = build_operator(cfg, task, dev)
    model = build_model(cfg, task, device=dev)
    model.load_state_dict(init_params(task.n_ent, cfg.dim, cfg.hidden, seed=cfg.seed,
                                      highway=cfg.highway))

    def loss_fn(batch, generator):
        loss = margin_align_loss(model(op, train=True, generator=generator),
                                 batch.get("pairs_aug", batch["pairs"]),
                                 batch["neg_l"], batch["neg_r"], cfg.gamma, batch.get("w"))
        return loss, {"margin": loss}

    return StepParts(model, op, loss_fn, lambda: embed(model, op))


def fit(cfg: TrainConfig, task: AlignTask | None = None, verbose: bool = False,
        device: str | torch.device = "cuda", debug_nans: bool = False) -> TrainResult:
    """Train an AlignGCN with the margin loss per ``cfg`` (configs ``base``
    and ``highway``; ``margin_parts``)."""
    dev = resolve_device(device)
    check_trainable(cfg, refuse_fused_profile=True)
    task = task or load_task(cfg)
    return train_loop(cfg, task, margin_parts(cfg, task, dev), dev, verbose, debug_nans)
