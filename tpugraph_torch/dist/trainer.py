"""Edge-partitioned distributed trainer, config ``dwy100k_dist``
(counterpart of ``tpugraph/dist/trainer.py``).

The encoder is ``AlignGCN``'s with one change: each layer's SpMM is the
halo SpMM over the rank's graph shards (``dist/halo.py``), with the
embedding table split by entity range as the shards are
(``sparse/partition.py``).  The rest of the step is replicated: the
encoder's output is all-gathered to every rank (the gather's backward
keeps the rank's own rows of the gradient, with no sum: every rank holds
the whole, identical gradient of the loss), every rank computes the same
margin loss, and the gradients of the replicated weights (the layers', the
gates') are summed over the ranks before Adam (``train/optim.py``).  A
reduce-scatter there would count the embedding gradient R times.

The loss is ``AlignMTL``'s on the gathered table
(``models/align.py::table_losses``): the margin over the seed pairs and,
with ``boot_cap > 0``, the proposals at their weights; the OT head on the
interval's ``ot_pairs`` (the ring loss
``dist/ring.py::ring_sinkhorn_align_loss``, for every S: the JAX trainer
takes the single-device loss at S = 1, which the ring equals there within
rounding); the relation and attribute heads
(``models/heads.py``, parameters ``rel_head.*`` and ``attr_head.*``,
replicated: every rank holds their whole gradient, so they are not summed).

The interval batch is ``train/loop.py::train_loop``'s
(``loop.IntervalBatch.at_boundary``): at each ``neg_every`` boundary, from
``boot_start`` on, the mutual-NN proposals of
``train/bootstrap.py::propose_mutual_nn_pairs`` on the gathered table;
then negatives over the seed pairs and proposals, uniform at epoch 0 from
``loop.interval_generator`` (seed, the interval's first epoch), then hard
ones mined by ``dist/ring.py::ring_knn`` (CSLS with ``neg_csls_k``); then
``train/mtl.py::draw_interval``'s draws (the OT subsample, the relation
corruptions, the attribute batch).  The evals are ``ring_hits_at_k``
(CSLS with ``eval_csls_k``), exact.  Draws and initialisation are the same
on every rank and for every R and S: the parameters are
``models/align.py::init_mtl_params``'s for the n real rows (the
single-device trainer's), the padding rows 0, so a run starts where
``train/mtl.py::fit_mtl`` (or ``train/loop.py::fit``) starts.

Refused, with ``NotImplementedError`` naming ROADMAP.md, where they are
queued (``check_distributed``): checkpoints, the attribute channel, the
approximate ring stages, bf16, dropout and ``l2_normalize``, the fused
interval, ``profile_dir``, tensor parallelism, slices and the grouped
exchange.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch import nn

from tpugraph_torch import resolve_device
from tpugraph_torch.configs.configs import TrainConfig
from tpugraph_torch.dist.halo import HaloOperator, halo_spmm, halo_spmm_ell
from tpugraph_torch.dist.mesh import ShardMesh, make_mesh, shard_operator
from tpugraph_torch.dist.ring import ring_hits_at_k, ring_knn, ring_sinkhorn_align_loss
from tpugraph_torch.models.align import table_losses
from tpugraph_torch.models.encoder import init_params as single_device_init
from tpugraph_torch.models.heads import AttributeHead, RelationHead, init_head_params
from tpugraph_torch.nn.graphconv import operator_format
from tpugraph_torch.nn.highway import Highway
from tpugraph_torch.sparse.build import coo_from_triples, coo_normalize
from tpugraph_torch.sparse.graph import AlignTask
from tpugraph_torch.sparse.partition import HaloGraph, partition_edges
from tpugraph_torch.train.loop import IntervalBatch, TrainResult, check_schedule, load_task
from tpugraph_torch.train.metrics import MetricsLogger, epoch_edge_ops
from tpugraph_torch.train.mtl import attr_triples_of, check_ot_size, draw_interval, interval_keys
from tpugraph_torch.train.optim import make_optimizer

# what the port's distributed trainer does not do yet, in ROADMAP.md's order
UNPORTED = (
    ("checkpoint and resume (checkpoint_dir)", lambda c: bool(c.checkpoint_dir)),
    ("the attribute channel", lambda c: c.use_attr_channel),
    ("the approximate ring stages (neg_approx, eval_approx_k)",
     lambda c: c.neg_approx or c.eval_approx_k > 0),
    ("bf16, dropout and l2_normalize in the distributed encoder",
     lambda c: c.param_dtype != "float32" or c.dropout > 0 or c.l2_normalize),
    ("steps_per_call > 1", lambda c: c.steps_per_call > 1),
    ("profile_dir", lambda c: bool(c.profile_dir)),
    ("feature_shards > 1 (tensor parallelism)", lambda c: c.feature_shards > 1),
    ("slice_shards > 1", lambda c: c.slice_shards > 1),
    ("halo_grouped", lambda c: c.halo_grouped),
)


def check_distributed(cfg: TrainConfig, task: AlignTask) -> None:
    """Refuse, before any work, what the JAX trainer refuses (ValueError,
    in its order), then what the port does not do yet (NotImplementedError
    naming ROADMAP.md, in the order queued there)."""
    if cfg.param_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unsupported param_dtype {cfg.param_dtype!r}")
    check_ot_size(cfg, len(task.train_pairs))
    no_attr = task.merged_attr_triples is None or task.n_attr == 0
    if cfg.use_attr_channel and no_attr:
        raise ValueError("attribute channel enabled but the task has no attribute triples")
    if cfg.use_attr_head and no_attr:
        raise ValueError("attribute head enabled but the task has no attribute triples")
    if cfg.use_rel_head and task.n_rel == 0:
        raise ValueError("relation head enabled but the task has no relation types")
    if cfg.halo_grouped and (cfg.n_shards < 2 or cfg.n_shards % 2):
        raise ValueError("halo_grouped requires an even n_shards >= 2")
    hidden = cfg.hidden or cfg.dim
    if cfg.highway and hidden != cfg.dim:
        raise ValueError("highway gates require hidden == dim")
    n_feat = max(1, cfg.feature_shards)
    if cfg.dim % n_feat or hidden % n_feat:
        raise ValueError(f"feature_shards={n_feat} must divide dim={cfg.dim} and hidden={hidden}")
    check_schedule(cfg, refuse_fused_profile=True)
    operator_format(cfg.spmm_impl)  # an unknown impl raises
    for what, refused in UNPORTED:
        if refused(cfg):
            raise NotImplementedError(
                f"the distributed trainer does not port {what} yet; see ROADMAP.md")


def init_params(n_rows: int, n_pad: int, dim: int, hidden: int | None = None,
                seed: int = 0, highway: bool = False, n_rel: int = 0,
                n_attr: int = 0) -> dict[str, torch.Tensor]:
    """The whole parameter set, the same on every rank for every R and S:
    ``models/encoder.py::init_params`` for the n real rows, the table's
    padding rows (n_pad − n) zero; ``n_rel`` > 0 adds the relation head's
    ``rel_head.rel``, ``n_attr`` > 0 the attribute head's ``attr_head.w``
    and ``attr_head.b`` (``models/heads.py::init_head_params``, as
    ``init_mtl_params`` draws them)."""
    p = single_device_init(n_rows, dim, hidden, seed=seed, highway=highway)
    p["emb"] = torch.cat([p["emb"], p["emb"].new_zeros((n_pad - n_rows, dim))])
    p.update(init_head_params(dim, n_rel, n_attr, seed=seed))
    return p


class _GatherRows(torch.autograd.Function):
    """The rank's rows -> every rank's rows; the backward keeps the rank's
    own rows of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(mesh.world)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        r0 = ctx.mesh.rank * ctx.rows
        return g[r0:r0 + ctx.rows].contiguous(), None


def gather_rows(x: torch.Tensor, mesh: ShardMesh) -> torch.Tensor:
    return _GatherRows.apply(x, mesh)


class HaloConv(nn.Module):
    """A GCN layer over the rank's shards: halo(x·W) + b, the JAX
    layer's order (``graphconv``'s sorted path)."""

    def __init__(self, in_dim: int, out_dim: int, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(in_dim, out_dim, device=device))
        self.b = nn.Parameter(torch.zeros(out_dim, device=device))

    def forward(self, x: torch.Tensor, op: HaloOperator) -> torch.Tensor:
        spmm = halo_spmm_ell if op.impl == "ell" else halo_spmm
        return spmm(x @ self.w, op) + self.b


# the parameters of the heads, whose gradient every rank holds whole
HEADS = ("rel_head.", "attr_head.")


class DistEncoder(nn.Module):
    """``AlignGCN`` (fp32, no dropout) over the rank's shards.  Parameters
    ``emb`` (the rank's per_rank·n_loc rows), ``gc1``, ``gc2`` and with
    highway gates ``hw1``, ``hw2``: the names of ``AlignGCN``'s; with
    ``n_rel`` or ``n_attr`` the heads ``rel_head`` and ``attr_head``
    (``AlignMTL``'s names), which read the gathered table."""

    def __init__(self, op: HaloOperator, dim: int = 128, hidden: int | None = None,
                 highway: bool = False, device=None, n_rel: int = 0, n_attr: int = 0):
        super().__init__()
        hidden = hidden or dim
        self.op = op
        self.emb = nn.Parameter(torch.empty(len(op.loc) * op.n_loc, dim, device=device))
        self.gc1 = HaloConv(dim, hidden, device=device)
        self.gc2 = HaloConv(hidden, dim, device=device)
        self.hw1 = Highway(dim, device=device) if highway else None
        self.hw2 = Highway(dim, device=device) if highway else None
        self.rel_head = RelationHead(n_rel, dim, device) if n_rel else None
        self.attr_head = AttributeHead(dim, n_attr, device) if n_attr else None

    @property
    def first_row(self) -> int:
        return self.op.mesh.shards.start * self.op.n_loc

    def forward(self) -> torch.Tensor:
        """The rank's rows of the encoder output."""
        x = self.emb
        h = torch.relu(self.gc1(x, self.op))
        if self.hw1 is not None:
            h = self.hw1(x, h)
        h2 = self.gc2(h, self.op)
        if self.hw2 is not None:
            h2 = self.hw2(h, h2)
        return h2.float()

    def load_full(self, params: dict[str, torch.Tensor]) -> None:
        """Load a whole parameter set (``init_params``, ``full_state``, or
        ``convert.params_from_jax`` of the JAX trainer's tree), keeping the
        rank's rows of its table."""
        rows = self.emb.shape[0]
        state = {**params, "emb": params["emb"][self.first_row:self.first_row + rows]}
        self.load_state_dict(state)

    def full_state(self) -> dict[str, torch.Tensor]:
        """The state dict with the whole (n_pad, dim) table, on every rank."""
        state = {k: v.detach() for k, v in self.state_dict().items()}
        with torch.no_grad():
            state["emb"] = gather_rows(self.emb.detach(), self.op.mesh)
        return state


@dataclass
class DistParts:
    """The distributed step's pieces on one rank (``dist_parts``)."""

    model: DistEncoder
    op: HaloOperator
    hg: HaloGraph
    cfg: TrainConfig
    rel_triples: torch.Tensor | None = None  # the relation head's constant (T, 3)
    aux: dict = field(default_factory=dict)  # the last step's loss terms

    def table(self) -> torch.Tensor:
        """The whole (n_pad, dim) encoder output, with its gradient."""
        return gather_rows(self.model(), self.op.mesh)

    def embed(self) -> torch.Tensor:
        """The whole output table, forward only."""
        with torch.no_grad():
            return self.table()

    def loss(self, batch: dict[str, torch.Tensor]) -> tuple[torch.Tensor, dict]:
        """(loss, its terms): ``models/align.py::table_losses`` of ``batch``
        (``AlignMTL.forward``'s keys) on the table, with the ring OT."""
        mesh = self.op.mesh

        def ot(emb, pairs, **kw):
            return ring_sinkhorn_align_loss(emb, pairs, mesh, **kw)

        return table_losses(self.cfg, self.table(), {**batch, "rel_triples": self.rel_triples},
                            self.model.rel_head, self.model.attr_head, ot)

    def grads(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        """One step's loss (its terms in ``aux``) and gradients: the
        encoder's replicated weights' summed over the ranks, the table's the
        rank's own rows, the heads' whole on every rank."""
        self.model.zero_grad(set_to_none=True)
        loss, aux = self.loss(batch)
        loss.backward()
        self.aux = {k: v.detach() for k, v in aux.items()}
        shared = [p for n, p in self.model.named_parameters()
                  if n != "emb" and not n.startswith(HEADS)]
        flat = torch.cat([p.grad.reshape(-1) for p in shared])
        dist.all_reduce(flat)
        for p, g in zip(shared, flat.split([p.numel() for p in shared])):
            p.grad.copy_(g.view_as(p))
        return loss.detach()


def dist_parts(cfg: TrainConfig, task: AlignTask, mesh: ShardMesh) -> DistParts:
    """The adjacency of ``task`` partitioned into ``cfg.n_shards`` shards,
    the rank's halo operator on its device, and the encoder with the heads
    ``cfg`` turns on, loaded with ``init_params(seed=cfg.seed)``."""
    src, dst, w = coo_from_triples(task.n_ent, task.merged_triples, n_rel=task.n_rel,
                                   weighting=cfg.weighting)
    w = coo_normalize(src, dst, w, task.n_ent, norm=cfg.norm)
    hg = partition_edges(src, dst, w, task.n_ent, cfg.n_shards)
    op = shard_operator(hg, mesh, operator_format(cfg.spmm_impl))
    heads = dict(n_rel=task.n_rel if cfg.use_rel_head else 0,
                 n_attr=max(task.n_attr, 1) if cfg.use_attr_head else 0)
    model = DistEncoder(op, cfg.dim, cfg.hidden, cfg.highway, device=mesh.device, **heads)
    model.load_full(init_params(task.n_ent, hg.n_loc * hg.n_shards, cfg.dim, cfg.hidden,
                                seed=cfg.seed, highway=cfg.highway, **heads))
    rel = (torch.as_tensor(task.merged_triples, dtype=torch.int64, device=mesh.device)
           if cfg.use_rel_head else None)
    return DistParts(model=model, op=op, hg=hg, cfg=cfg, rel_triples=rel)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def fit_distributed(cfg: TrainConfig, task: AlignTask | None = None, verbose: bool = False,
                    device: str | torch.device = "cuda") -> TrainResult:
    """Train ``cfg`` over ``cfg.n_shards`` shards on the group of
    ``dist/mesh.py::make_mesh`` (NCCL on the card, gloo on the host).
    ``TrainResult.params`` holds the whole parameter set on every rank;
    ``op`` the rank's ``HaloOperator``; ``timings`` the host wall seconds
    of build_s (partition and operators), train_s and step_s (each step's,
    ended by a synchronise), forward_s (the boundaries' encoder forwards),
    propose_s, mine_s, draw_s (the interval's draws), eval_s and
    final_eval_s, with the counts steps, forwards, proposals, minings,
    draws and evals."""
    dev = resolve_device(device)
    task = task or load_task(cfg)
    check_distributed(cfg, task)
    with make_mesh(cfg.n_shards, dev) as mesh:
        return _fit(cfg, task, mesh, verbose)


def _fit(cfg: TrainConfig, task: AlignTask, mesh: ShardMesh, verbose: bool) -> TrainResult:
    dev = mesh.device
    timings = {"build_s": 0.0, "train_s": 0.0, "step_s": [], "forward_s": 0.0,
               "propose_s": 0.0, "mine_s": 0.0, "draw_s": 0.0, "eval_s": 0.0,
               "final_eval_s": 0.0, "steps": 0, "forwards": 0, "proposals": 0, "minings": 0,
               "draws": 0, "evals": 0}

    def timed(key, count, fn):
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        timings[key] += time.perf_counter() - t0
        timings[count] += 1
        return out

    t0 = time.perf_counter()
    parts = dist_parts(cfg, task, mesh)
    _sync(dev)
    timings["build_s"] = time.perf_counter() - t0
    hg = parts.hg
    opt, sched = make_optimizer(cfg, parts.model.parameters())
    make = IntervalBatch(cfg, task, dev)
    pairs = make.pairs
    n1, n = task.kg1.n_ent, task.n_ent
    attr = (torch.as_tensor(attr_triples_of(cfg, task), dtype=torch.int64, device=dev)
            if cfg.use_attr_head else None)
    draws = bool(interval_keys(cfg, len(pairs)))
    rank0 = mesh.rank == 0  # the one writer of the shared sinks
    logger = MetricsLogger(cfg.metrics_path if rank0 else None, config=cfg.to_dict(),
                           tb_dir=cfg.tb_dir if rank0 else None)

    def mine(emb, pairs_t):
        kw = dict(metric=cfg.neg_metric, csls_k=cfg.neg_csls_k)
        return (ring_knn(emb[pairs_t[:, 1]], emb[:n1], pairs_t[:, 0], cfg.k_neg, mesh, **kw),
                ring_knn(emb[pairs_t[:, 0]], emb[n1:n], pairs_t[:, 1] - n1, cfg.k_neg, mesh,
                         **kw) + n1)

    def draw(epoch0):
        return draw_interval(cfg, epoch0, pairs, n, len(task.merged_triples), attr)

    def evaluate():
        t0 = time.perf_counter()
        m = ring_hits_at_k(parts.embed(), task.test_pairs, mesh, csls_k=cfg.eval_csls_k)
        timings["eval_s"] += time.perf_counter() - t0
        timings["evals"] += 1
        return m

    history, losses, batch = [], [], None
    loss = torch.tensor(float("nan"))
    t_start = time.perf_counter()
    try:
        for epoch in range(cfg.epochs):
            if epoch % cfg.neg_every == 0 or batch is None:
                batch, _ = make.at_boundary(epoch, parts.embed, mine, draw if draws else None,
                                            timed)
            t0 = time.perf_counter()
            loss = parts.grads(batch)
            opt.step()
            sched.step()
            _sync(dev)
            dt = time.perf_counter() - t0
            timings["step_s"].append(dt)
            timings["train_s"] += dt
            timings["steps"] += 1
            losses.append(loss)
            if cfg.eval_every and (epoch % cfg.eval_every == 0 or epoch >= cfg.epochs - 1):
                m = evaluate()
                wall = time.perf_counter() - t_start
                eps = epoch_edge_ops(hg.nnz) * (epoch + 1) / max(wall, 1e-9)
                rec = {"epoch": epoch, "loss": loss.item(), "wall_s": round(wall, 3),
                       # unrounded, so the two rates compare exactly (ROADMAP.md Queue C 2)
                       "edges_per_s": eps, "edges_per_s_chip": eps / mesh.world,
                       **{f"loss_{k}": v.item() for k, v in parts.aux.items()},
                       **{k: round(v, 4) for k, v in m.items()}}
                history.append(rec)
                logger.log(rec)
                if verbose and rank0:
                    print(f"[dist:{cfg.name}@{cfg.n_shards}/{mesh.world}] epoch {epoch} loss "
                          f"{rec['loss']:.4f} hits@1 {m['hits@1']:.3f}")
        t0 = time.perf_counter()
        final = evaluate()  # always exact
        timings["final_eval_s"] = time.perf_counter() - t0
        final["final_loss"] = loss.item()
        params = parts.model.full_state()
        if cfg.save_emb_path:
            emb = parts.embed()  # a collective: every rank joins it
            if rank0:  # row == entity id: the serving path's table
                from tpugraph_torch.serve import save_embeddings

                save_embeddings(cfg.save_emb_path, emb[:n])
    finally:
        logger.close()
    return TrainResult(params=params, metrics=final, history=history, op=parts.op,
                       model=parts.model, task=task,
                       losses=torch.stack(losses).tolist() if losses else [], timings=timings)
