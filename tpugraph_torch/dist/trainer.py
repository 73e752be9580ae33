"""Edge-partitioned distributed trainer, config ``dwy100k_dist``
(counterpart of ``tpugraph/dist/trainer.py``).

The encoder is ``AlignGCN``'s with one change: each layer's SpMM is the
halo SpMM over the rank's graph shards (``dist/halo.py``: at Gr = 1 the
boundary reads the table's own rows and no exchange runs; at Gr > 1 the
exchange overlaps the local aggregation), with the embedding table split
by entity range as the shards are (``sparse/partition.py``).  The ranks
form the grid of ``dist/mesh.py`` (slices L, graph ranks Gr, feature ranks
F; at W = 1 one rank holds every block and the step runs no collective):

* **Tensor parallelism** (F > 1) is the JAX body's column-parallel
  encoder: each rank holds the f-th column block of the table and of every
  encoder weight (``DistEncoder``); each layer's input is all-gathered to
  full width over the feature group (``gather_f``, whose backward sums the
  cotangent over the feature group and keeps the rank's columns: each
  rank's GEMM touches only its own columns of W), the rank computes its
  output columns, and the halo SpMM runs on those d/F columns.
* **Slices** (L > 1) split the loss: the interval batch is drawn whole on
  every rank and each slice scores a contiguous stripe of it
  (``DistParts.slice_loss``); the gradients are summed over the slice
  group.

The rest of the step is replicated within a slice: the encoder's output
is gathered to the whole table on every rank (columns over the feature
group, rows over the graph group; the gather's backward keeps the rank's
own block, with no sum: every rank holds the whole, identical gradient of
its slice's loss), every rank computes the same loss, and the gradients of
the encoder's weights (the layers', the gates', the attribute channel's)
are summed over the graph group before Adam (``train/optim.py``;
``DistParts.sum_grads``).  A reduce-scatter there would count the
embedding gradient Gr times.  The gathers and sums are skipped in a group
of one rank, as the ring's collectives are, so a step at W = 1 calls no
``torch.distributed`` function.

The encoder's options are the JAX ``make_encoder``'s:
``param_dtype="bfloat16"`` runs the activations, the GEMMs, the SpMMs (the
bf16 instances of ``spmm_ell`` / ``spmm_sorted``) and the halo exchange's
rows in bf16 over fp32 parameters, cast at use, and returns fp32; the
layers' weight and bias gradients are summed over the rows in fp32 and
not rounded to bf16, so a step's gradients do not depend on R;
``dropout`` masks gc2's input (the highway gate reads it unmasked) with
one global (n_pad, hidden) keep mask per epoch: the n real rows drawn as
the single-device encoder draws its mask (``models/encoder.py::keep_mask``
from ``loop.step_generator(cfg, epoch)``), the padding rows kept, each
rank taking its rows, so every R and S sees the mask of the single-device
run (under tensor parallelism the mask is full width: it multiplies the
gathered h); ``l2_normalize`` divides the fp32 output by its row norm +
1e-8 (under tensor parallelism the row's squared sum is summed over the
feature group, the JAX ``psum``).
With ``use_attr_channel`` the GCN-Align attribute (AE) channel runs beside
it (``DistAttrChannel``: the rank's shard rows of the entity × attribute
incidence, ``sparse/halo_ell.py::build_attr_incidence_ell``, one
``spmm_ell`` per shard each way, times the replicated ``attr_emb``, then
two halo layers); the loss adds ``attr_channel_weight`` × its margin, and
the evals, proposals and mining read ``combine_channels`` of the gathered
tables, as the single-device ``AlignMTL.embed``.

The loss is ``AlignMTL``'s on the gathered table
(``models/align.py::table_losses``): the margin over the seed pairs and,
with ``boot_cap > 0``, the proposals at their weights; the OT head on the
interval's ``ot_pairs`` (the ring loss
``dist/ring.py::ring_sinkhorn_align_loss``, for every S: the JAX trainer
takes the single-device loss at S = 1, which the ring equals there within
rounding); the relation and attribute heads
(``models/heads.py``, parameters ``rel_head.*`` and ``attr_head.*``,
replicated: every rank of a slice holds their whole gradient, so they are
summed over the slices only).

The interval batch is ``train/loop.py::train_loop``'s
(``loop.IntervalBatch.at_boundary``): at each ``neg_every`` boundary, from
``boot_start`` on, the mutual-NN proposals of
``train/bootstrap.py::propose_mutual_nn_pairs`` on the gathered table;
then negatives over the seed pairs and proposals, uniform at epoch 0 from
``loop.interval_generator`` (seed, the interval's first epoch), then hard
ones mined by ``dist/ring.py::ring_knn`` (CSLS with ``neg_csls_k``,
shortlisted with ``neg_approx``); then ``train/mtl.py::draw_interval``'s
draws (the OT subsample, the relation corruptions, the attribute batch).
The evals are ``ring_hits_at_k`` (CSLS with ``eval_csls_k``): the history
within shortlists with ``eval_approx_k``, the final one exact.  Draws and
initialisation are the same on every rank and for every R and S: the
parameters are ``models/align.py::init_mtl_params``'s for the n real rows
(the single-device trainer's), the padding rows 0, so a run starts where
``train/mtl.py::fit_mtl`` (or ``train/loop.py::fit``) starts.

The epochs run an interval (``steps_per_call``) at a time, as
``train/loop.py::train_loop`` runs them: the boundary stays eager
(``IntervalBatch.at_boundary``: ring mining, proposals, draws); with
``steps_per_call = neg_every > 1`` (the JAX ``train_interval``, ``--fast``)
the card replays one captured distributed step
(``train/fused.py::CapturedStep``, a capturable Adam, the dropout mask from
its registered generator reseeded with ``loop.step_seed``; the gradient
sum over the ranks runs inside the capture, ``after_backward``) once per
epoch with no host synchronise between replays, and the host runs the
same steps eagerly.  The saves and evals fall in the JAX fused windows
(``last % every < steps``).

Checkpoints (``checkpoint_dir``, ``checkpoint_every``;
``train/checkpoint.py``) hold the whole parameter set with the gathered
(n_pad, dim) table and full-width weights, Adam's state with its moments
gathered the same way, the
schedule, the loss, the row-layout stamp (halo_grouped, kg2_base) and,
unfused, the interval's batch (negatives, proposals, draws), so a resume
in the middle of an interval rebuilds the batch it was cut in; a fused
save, always at an interval's end, carries no batch, and a resume across
the two modes is refused with the JAX messages.  Rank 0 of the world
writes, then the ranks meet at a barrier; a restore cuts each tensor and
its moments to this run's block (rows and columns, for this run's grid;
the table re-padded for this run's S), so a run saved on one grid resumes
on another, and refuses another layout stamp with the JAX messages (F and
L move no rows).  SIGTERM latches ``Checkpointer.preempted`` on the rank
it reaches; the ranks agree on the latch once after each interval and
again after the eval (an ``all_reduce(MAX)``), so all of them save and
leave the loop at the same epoch; these agreements and the barrier run on
the world group.  ``debug_nans`` checks each step's loss,
gradients and updated parameters (``train/fused.py::finite_flag``; fused,
folded into one flag per interval), agreed over the ranks
(``all_reduce(MIN)``) before any raises, so every rank raises
``FloatingPointError`` naming the same epoch (or interval).  (Autograd's
anomaly mode, which the single-device check adds, would raise on one rank
inside the backward and leave the others waiting in its collectives.)
``profile_dir`` traces epochs start + 2 to start + 5 on rank 0 (the JAX
window, ``train/loop.py``'s trace file); the other ranks trace nothing.

``halo_grouped`` (an even ``n_shards``) is the JAX trainer's
component-grouped exchange: the table's rows follow ``RowLayout``, KG1 in
the first half of the shards and KG2 from row r0 in the second, so that
the merged graph's two components never share an edge across the halves
and each shard's halo comes from its own half (``partition_edges(...,
n_groups=2)``: send lists of G = S/2 receivers).  Every entity id the
trainer reads is moved to its row: the seed, test and relation triples'
ids, the attribute triples' entities, the proposals' masks (padding rows
never eligible), the negatives (KG2's uniform draws and ring mining over
rows [r0, r1)), the relation corruptions (drawn as entity ids, then
moved), the initial table and the dropout mask (entity j's row at its
row).  The saved evaluation table and ``save_emb_path`` are in entity
order; ``TrainResult.params`` and the checkpoints keep the rows.  The
exchange (``dist/mesh.py::shard_operator``): at Gr = 1 and Gr = 2 a rank
holds whole halves and its boundary reads its own rows, no collective; at
Gr >= 4 one ``all_to_all_single`` in the rank's halo group, its half of
the graph group.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tpugraph_torch import resolve_device
from tpugraph_torch.configs.configs import TrainConfig
from tpugraph_torch.dist.halo import HaloOperator, halo_spmm, halo_spmm_ell
from tpugraph_torch.dist.mesh import ShardMesh, make_mesh, shard_operator
from tpugraph_torch.dist.ring import ring_hits_at_k, ring_knn, ring_sinkhorn_align_loss
from tpugraph_torch.kernels.spmm_ell import spmm_ell
from tpugraph_torch.models.align import table_losses, weighted_loss
from tpugraph_torch.models.attr_channel import combine_channels, init_attr_channel_params
from tpugraph_torch.models.encoder import _COMPUTE_DTYPES, dropout, keep_mask
from tpugraph_torch.models.encoder import init_params as single_device_init
from tpugraph_torch.models.heads import AttributeHead, RelationHead, init_head_params
from tpugraph_torch.nn.graphconv import operator_format
from tpugraph_torch.nn.highway import Highway
from tpugraph_torch.sparse.build import coo_from_triples, coo_normalize
from tpugraph_torch.sparse.ell import EllOperator
from tpugraph_torch.sparse.graph import AlignTask
from tpugraph_torch.sparse.halo_ell import build_attr_incidence_ell
from tpugraph_torch.sparse.partition import HaloGraph, partition_edges
from tpugraph_torch.train.checkpoint import Checkpointer
from tpugraph_torch.train.fused import CapturedStep, finite_flag
from tpugraph_torch.train.loop import (IntervalBatch, TrainResult, _check_resume, _non_finite,
                                       _start_profile, _stop_profile, check_schedule, load_task,
                                       step_generator, step_seed)
from tpugraph_torch.train.losses import margin_align_loss
from tpugraph_torch.train.metrics import MetricsLogger, epoch_edge_ops
from tpugraph_torch.train.mtl import attr_triples_of, check_ot_size, draw_interval, interval_keys
from tpugraph_torch.train.optim import load_optimizer_state, make_optimizer, optimizer_state

def check_distributed(cfg: TrainConfig, task: AlignTask) -> None:
    """Refuse, before any work, what the JAX trainer refuses (ValueError,
    in its order)."""
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


@dataclass(frozen=True)
class RowLayout:
    """The table's rows of the entities (the JAX trainer's ``row_of``).
    Ungrouped, row = entity id.  Under ``halo_grouped`` each KG takes one
    contiguous half of the shards, G = S/2 shards of n_loc =
    ceil(max(n1, n2)/G) rows, so that no edge crosses the halves: KG1 keeps
    rows [0, n1), rows [n1, r0) are padding, KG2 entity n1 + j lives at row
    r0 + j, r0 = G·n_loc, and the partition spans 2·r0 rows.  r0 (KG2's
    first row) is the checkpoints' layout stamp."""

    n1: int  # KG1's entities
    n: int  # all entities
    r0: int  # KG2's first row: n1 ungrouped
    n_rows: int  # the rows the partition spans: n ungrouped, 2·r0 grouped

    @classmethod
    def of(cls, cfg: TrainConfig, task: AlignTask) -> RowLayout:
        n1, n = task.kg1.n_ent, task.n_ent
        if not cfg.halo_grouped:
            return cls(n1, n, n1, n)
        half = cfg.n_shards // 2
        r0 = half * -(-max(n1, n - n1) // half)
        return cls(n1, n, r0, 2 * r0)

    @property
    def r1(self) -> int:
        """The row after KG2's last."""
        return self.r0 + self.n - self.n1

    def rows(self, ids):
        """The rows of entity ids (a numpy array or a tensor, any shape)."""
        lib = np if isinstance(ids, np.ndarray) else torch
        return lib.where(ids < self.n1, ids, ids - self.n1 + self.r0)

    def entity_rows(self, device=None) -> torch.Tensor:
        """The n entities' rows, in entity order."""
        return self.rows(torch.arange(self.n, device=device))

    def entities(self, t: torch.Tensor) -> torch.Tensor:
        """A table (or its moments) in entity order: its n real rows."""
        return torch.cat([t[:self.n1], t[self.r0:self.r1]])

    def triples(self, t: np.ndarray | None, cols: tuple[int, ...]) -> np.ndarray | None:
        """Triples (or None) with the entity ids of columns ``cols`` moved
        to their rows: the relation triples' head and tail, the attribute
        triples' entity."""
        if t is None:
            return None
        t = np.array(t)
        for c in cols:
            t[:, c] = self.rows(t[:, c])
        return t


def init_params(n_rows: int, n_pad: int, dim: int, hidden: int | None = None,
                seed: int = 0, highway: bool = False, n_rel: int = 0,
                n_attr: int = 0, n_attr_channel: int = 0,
                rows: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """The whole parameter set, the same on every rank for every R and S:
    ``models/encoder.py::init_params`` for the n real rows, entity j's at
    row ``rows[j]`` (default j; ``RowLayout.entity_rows``), the table's
    padding rows (n_pad − n) zero; ``n_rel`` > 0 adds the relation head's
    ``rel_head.rel``, ``n_attr`` > 0 the attribute head's ``attr_head.w``
    and ``attr_head.b`` (``models/heads.py::init_head_params``), and
    ``n_attr_channel`` > 0 the attribute channel's ``ae_encoder.attr_emb``,
    ``ae_encoder.gc1.*`` and ``ae_encoder.gc2.*``
    (``models/attr_channel.py::init_attr_channel_params``), as
    ``init_mtl_params`` draws them."""
    p = single_device_init(n_rows, dim, hidden, seed=seed, highway=highway)
    rows = torch.arange(n_rows) if rows is None else rows
    p["emb"] = p["emb"].new_zeros((n_pad, dim)).index_copy_(0, rows, p["emb"])
    p.update(init_head_params(dim, n_rel, n_attr, seed=seed))
    if n_attr_channel:
        p.update({f"ae_encoder.{k}": v for k, v in
                  init_attr_channel_params(n_attr_channel, dim, seed).items()})
    return p


class _GatherRows(torch.autograd.Function):
    """The rank's rows -> every graph rank's rows; the backward keeps the
    rank's own rows of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        parts = [torch.empty_like(x) for _ in range(mesh.n_graph)]
        dist.all_gather(parts, x.contiguous(), group=mesh.group("graph"))
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        r0 = ctx.mesh.graph_rank * ctx.rows
        return g[r0:r0 + ctx.rows].contiguous(), None


class _GatherCols(torch.autograd.Function):
    """The rank's column block -> the full width (an ``all_gather`` over
    the feature group along the last dim).  The backward keeps the rank's
    own columns; with ``reduce`` it first sums the cotangent over the
    feature group (a reduce-scatter, in fp32): a layer input, whose every
    feature rank's GEMM touches only its own columns of W.  Without it the
    cotangent is the replicated loss's, whole on every rank."""

    @staticmethod
    def forward(ctx, x, mesh, reduce):
        ctx.mesh, ctx.reduce, ctx.cols = mesh, reduce, x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(mesh.n_feature)]
        dist.all_gather(parts, x.contiguous(), group=mesh.group("feature"))
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            total = g.to(torch.float32, copy=True)
            dist.all_reduce(total, group=ctx.mesh.group("feature"))
            g = total.to(g.dtype)
        c0 = ctx.mesh.feature_rank * ctx.cols
        return g[..., c0:c0 + ctx.cols].contiguous(), None, None


def gather_f(x: torch.Tensor, mesh: ShardMesh) -> torch.Tensor:
    """A layer input at full width from the rank's column block (the JAX
    ``gather_f``: an ``all_gather`` over the feature group whose backward
    is a reduce-scatter); x itself at F = 1."""
    return x if mesh.n_feature == 1 else _GatherCols.apply(x, mesh, True)


def gather_rows(x: torch.Tensor, mesh: ShardMesh) -> torch.Tensor:
    """The whole table from the rank's block of it: its columns gathered
    over the feature group, then its rows over the graph group; the
    backward keeps the rank's own block and sums nothing.  x itself at
    Gr = F = 1: no collective."""
    if mesh.n_feature > 1:
        x = _GatherCols.apply(x, mesh, False)
    return x if mesh.n_graph == 1 else _GatherRows.apply(x, mesh)


class _SumFeature(torch.autograd.Function):
    """A per-row partial sum -> its sum over the feature group (the JAX
    ``psum`` over 'feature'); each rank's cotangent is its own share of the
    sum's, so the backward sums them too."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        x = x.clone()
        dist.all_reduce(x, group=mesh.group("feature"))
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.mesh.group("feature"))
        return g, None


class _Whole(torch.autograd.Function):
    """The slice's share of a value -> ``whole``, the shares' sum over the
    slice group (computed by the caller); the backward passes the gradient
    to the share: each slice backpropagates its own share, and
    ``DistParts.sum_grads`` sums the gradients over the slices."""

    @staticmethod
    def forward(ctx, share, whole):
        return whole.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CastMatmul(torch.autograd.Function):
    """x·W with the fp32 W cast to x's (bf16) type at use; the backward's
    W̄ = xᵀ·ḡ summed in fp32 and left fp32 (not rounded to bf16), so that a
    replicated weight's gradient is the same fp32 sum over the rows
    whatever rows each rank holds."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x @ w.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return g @ w.to(g.dtype).t(), x.float().t() @ g.float()


class _CastBias(torch.autograd.Function):
    """y + b with the fp32 b cast to y's (bf16) type; b̄ summed over the
    rows in fp32, as ``_CastMatmul``'s W̄."""

    @staticmethod
    def forward(ctx, y, b):
        return y + b.to(y.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, g.float().sum(0)


class HaloConv(nn.Module):
    """A GCN layer over the rank's shards: halo(x·W) + b, the JAX
    layer's order (``graphconv``'s sorted path), in x's type (W and b
    cast at use; in bf16 their gradients summed in fp32: ``_CastMatmul``,
    ``_CastBias``).  Under tensor parallelism W and b are the rank's output
    column block (``out_dim`` = the layer's width / F) and x is the
    full-width input: column-parallel, as the JAX layer."""

    def __init__(self, in_dim: int, out_dim: int, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(in_dim, out_dim, device=device))
        self.b = nn.Parameter(torch.zeros(out_dim, device=device))

    def forward(self, x: torch.Tensor, op: HaloOperator) -> torch.Tensor:
        spmm = halo_spmm_ell if op.impl == "ell" else halo_spmm
        if x.dtype == self.w.dtype:
            return spmm(x @ self.w, op) + self.b
        return _CastBias.apply(spmm(_CastMatmul.apply(x, self.w), op), self.b)


class DistAttrChannel(nn.Module):
    """The attribute (AE) channel over the rank's shards, with
    ``AttrChannelGCN``'s parameters ``attr_emb`` (replicated over the
    graph ranks; a column block under tensor parallelism), ``gc1`` and
    ``gc2``: each shard's rows of the incidence (``inc``, one
    ``EllOperator`` per shard of the rank) times ``attr_emb``, gathered to
    full width, then two halo layers over the structure's operator."""

    def __init__(self, inc: list[EllOperator], n_attr: int, dim: int, cols: int, device=None):
        super().__init__()
        self.inc = inc
        self.attr_emb = nn.Parameter(torch.empty(n_attr, cols, device=device))
        self.gc1 = HaloConv(dim, cols, device=device)
        self.gc2 = HaloConv(dim, cols, device=device)

    def forward(self, op: HaloOperator, dtype: torch.dtype) -> torch.Tensor:
        mesh = op.mesh
        # a cast per shard: the shards' gradients of attr_emb add up in fp32
        x0 = gather_f(torch.cat([spmm_ell(m, self.attr_emb.to(dtype)) for m in self.inc]), mesh)
        ah = gather_f(torch.relu(self.gc1(x0, op)), mesh)
        return self.gc2(ah, op).float()


# the parameters of the heads, whose gradient every rank holds whole
HEADS = ("rel_head.", "attr_head.")


def column_split(name: str) -> bool:
    """Whether a rank holds a column block of parameter ``name`` (its last
    dim split over the feature group): every one but the heads'."""
    return not name.startswith(HEADS)


class DistEncoder(nn.Module):
    """``AlignGCN`` over the rank's shards (``compute_dtype``, ``dropout``
    and ``l2_normalize`` as the JAX ``make_encoder``'s).  Parameters
    ``emb`` (the rank's per_rank·n_loc rows), ``gc1``, ``gc2`` and with
    highway gates ``hw1``, ``hw2``: the names of ``AlignGCN``'s; with
    ``n_rel`` or ``n_attr`` the heads ``rel_head`` and ``attr_head``
    (``AlignMTL``'s names), which read the gathered table; with ``inc``
    (the attribute incidence's shard operators) the AE channel
    ``ae_encoder`` over ``n_attr_channel`` attributes.  Under tensor
    parallelism (F = ``op.mesh.n_feature`` > 1) the rank holds the f-th
    column block of every parameter but the heads' (``column_split``):
    ``emb`` (rows, dim/F), W (in, out/F), b (out/F,), ``attr_emb`` (n_attr,
    dim/F); the heads stay whole."""

    def __init__(self, op: HaloOperator, dim: int = 128, hidden: int | None = None,
                 highway: bool = False, device=None, n_rel: int = 0, n_attr: int = 0,
                 compute_dtype: str = "float32", dropout: float = 0.0,
                 l2_normalize: bool = False, inc: list[EllOperator] | None = None,
                 n_attr_channel: int = 0):
        super().__init__()
        hidden = hidden or dim
        n_f = op.mesh.n_feature
        self.op = op
        self.cdt = _COMPUTE_DTYPES[compute_dtype]
        self.dropout, self.l2_normalize = dropout, l2_normalize
        self.emb = nn.Parameter(torch.empty(op.n_rows, dim // n_f, device=device))
        self.gc1 = HaloConv(dim, hidden // n_f, device=device)
        self.gc2 = HaloConv(hidden, dim // n_f, device=device)
        self.hw1 = Highway(dim, device=device, cols=dim // n_f) if highway else None
        self.hw2 = Highway(dim, device=device, cols=dim // n_f) if highway else None
        self.rel_head = RelationHead(n_rel, dim, device) if n_rel else None
        self.attr_head = AttributeHead(dim, n_attr, device) if n_attr else None
        self.ae_encoder = (DistAttrChannel(inc, n_attr_channel, dim, dim // n_f, device)
                           if inc is not None else None)

    @property
    def first_row(self) -> int:
        return self.op.mesh.shards.start * self.op.n_loc

    def forward(self, mask: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The rank's block of the encoder output (fp32) and of the AE
        channel's (None without it); ``mask``: the rank's rows of the
        epoch's keep mask, full width (a training step with dropout).  The
        JAX body's order: each layer's input gathered to full width, the
        highway gates reading it and mixing the rank's columns, the mask on
        the gathered h."""
        mesh = self.op.mesh
        x_c = self.emb.to(self.cdt)
        x = gather_f(x_c, mesh)
        h_c = torch.relu(self.gc1(x, self.op))
        if self.hw1 is not None:
            h_c = self.hw1(x, h_c, mix=x_c)
        h = gather_f(h_c, mesh)
        h_in = h if mask is None else dropout(h, self.dropout, None, mask=mask)
        h2 = self.gc2(h_in, self.op)
        if self.hw2 is not None:
            h2 = self.hw2(h, h2, mix=h_c)  # the gate reads the unmasked h
        se = h2.float()
        if self.l2_normalize and mesh.n_feature == 1:
            se = se / (torch.linalg.vector_norm(se, dim=-1, keepdim=True) + 1e-8)
        elif self.l2_normalize:  # the row's squared sum over its column blocks
            ss = _SumFeature.apply((se * se).sum(-1, keepdim=True), mesh)
            se = se / (torch.sqrt(ss) + 1e-8)
        ae = None if self.ae_encoder is None else self.ae_encoder(self.op, self.cdt)
        return se, ae

    def block(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The rank's block of a whole tensor of parameter ``name`` (or of
        its Adam moments): the table's rows, and the f-th column block of
        every parameter but the heads'."""
        if name == "emb":
            t = t[self.first_row:self.first_row + self.emb.shape[0]]
        if column_split(name) and self.op.mesh.n_feature > 1:
            c = t.shape[-1] // self.op.mesh.n_feature
            t = t[..., self.op.mesh.feature_rank * c:(self.op.mesh.feature_rank + 1) * c]
        return t

    def whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of parameter ``name`` from the rank's block of
        it (the inverse of ``block``; a collective: every rank calls it)."""
        mesh = self.op.mesh
        with torch.no_grad():
            if name == "emb":
                return gather_rows(t, mesh)
            if column_split(name) and mesh.n_feature > 1:
                return _GatherCols.apply(t, mesh, False)
        return t

    def load_full(self, params: dict[str, torch.Tensor]) -> None:
        """Load a whole parameter set (``init_params``, ``full_state``, or
        ``convert.params_from_jax`` of the JAX trainer's tree), keeping the
        rank's block of each."""
        self.load_state_dict({k: self.block(k, v) for k, v in params.items()})

    def full_state(self) -> dict[str, torch.Tensor]:
        """The whole state dict, the (n_pad, dim) table and the full-width
        weights, on every rank (a collective: every rank calls it)."""
        return {k: self.whole(k, v.detach()) for k, v in self.state_dict().items()}


@dataclass
class DistParts:
    """The distributed step's pieces on one rank (``dist_parts``)."""

    model: DistEncoder
    op: HaloOperator
    hg: HaloGraph
    cfg: TrainConfig
    layout: RowLayout
    rel_triples: torch.Tensor | None = None  # the relation head's constant (T, 3), rows
    attr_triples: torch.Tensor | None = None  # the attribute head's source (Ta, 2), rows
    aux: dict = field(default_factory=dict)  # the last step's loss terms

    def tables(self, mask: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The whole (n_pad, dim) encoder output and AE channel output
        (None without it), with their gradients."""
        se, ae = self.model(mask)
        mesh = self.op.mesh
        return gather_rows(se, mesh), (None if ae is None else gather_rows(ae, mesh))

    def embed(self) -> torch.Tensor:
        """The evaluation table, forward only: the encoder's output, or with
        the AE channel ``combine_channels`` of both."""
        with torch.no_grad():
            se, ae = self.tables()
            return se if ae is None else combine_channels(se, ae, self.cfg.attr_beta)

    def mask_of(self, gen: torch.Generator | None) -> torch.Tensor | None:
        """The rank's rows of a step's keep mask (None without dropout):
        the n real rows from ``gen``, as the single-device encoder draws its
        (n, hidden) mask, entity j's row at its table row (``RowLayout``),
        the padding kept: each entity sees the single-device run's mask
        under every layout, R and S."""
        cfg = self.cfg
        if cfg.dropout <= 0.0:
            return None
        dev, model, n = self.op.mesh.device, self.model, self.layout.n
        n_pad, hidden = self.hg.n_loc * self.hg.n_shards, cfg.hidden or cfg.dim
        full = torch.ones((n_pad, hidden), dtype=torch.bool, device=dev)
        full[self.layout.entity_rows(dev)] = keep_mask((n, hidden), cfg.dropout, gen, dev)
        return full[model.first_row:model.first_row + model.emb.shape[0]]

    def drop_mask(self, epoch: int) -> torch.Tensor | None:
        """The rank's rows of epoch ``epoch``'s keep mask
        (``mask_of(step_generator(cfg, epoch))``), None without dropout."""
        if self.cfg.dropout <= 0.0:
            return None
        return self.mask_of(step_generator(self.cfg, epoch, self.op.mesh.device))

    def loss_fn(self, batch: dict[str, torch.Tensor],
                gen: torch.Generator | None) -> tuple[torch.Tensor, dict]:
        """``loss`` with the keep mask drawn from ``gen``: the step
        ``train/fused.py::train_step`` runs and ``CapturedStep`` captures."""
        return self.loss(batch, self.mask_of(gen))

    def loss(self, batch: dict[str, torch.Tensor],
             mask: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
        """(loss, its terms): ``models/align.py::table_losses`` of ``batch``
        (``AlignMTL.forward``'s keys) on the table, with the ring OT, and
        with the AE channel ``attr_channel_weight`` × its margin.  Across L
        > 1 slice ranks, the rank's slice's share of it (``slice_loss``),
        whose value is the whole loss."""
        cfg, mesh = self.cfg, self.op.mesh
        se, ae = self.tables(mask)
        batch = {**batch, "rel_triples": self.rel_triples}
        if mesh.n_slice > 1:
            return self.slice_loss(se, ae, batch)

        def ot(emb, pairs, **kw):
            return ring_sinkhorn_align_loss(emb, pairs, mesh, **kw)

        _, aux = table_losses(cfg, se, batch, self.model.rel_head, self.model.attr_head, ot)
        if ae is not None:
            aux["ae"] = margin_align_loss(ae, batch.get("pairs_aug", batch["pairs"]),
                                          batch["neg_l"], batch["neg_r"], cfg.gamma,
                                          batch.get("w"))
        return weighted_loss(cfg, aux), aux

    def slice_loss(self, se: torch.Tensor, ae: torch.Tensor | None,
                   batch: dict[str, torch.Tensor]) -> tuple[torch.Tensor, dict]:
        """The rank's slice's share of ``loss``: ``table_losses`` (and the
        AE channel's margin) on the batch with each leaf that JAX's
        ``shard_slice`` stripes cut to the slice's contiguous stripe
        (``_stripe``: the margin's pairs, weights and negatives, the
        relation triples with their corruptions, the attribute batch; the
        OT pairs stay whole), each term, a mean over its leaf's rows, times
        its stripe's share of the whole batch (``share``).  What is computed
        whole (the ring OT, a leaf L does not divide) counts on slice 0
        alone, so that it counts once in the gradient summed over the
        slices.  The value returned is the whole loss (the shares summed
        over the slice group; its gradient the share's), and the terms are
        whole."""
        cfg, mesh = self.cfg, self.op.mesh
        first = mesh.slice_rank == 0
        whole = {**batch, "ot_pairs": batch.get("ot_pairs", batch["pairs"])}
        rows = {k: None if k == "ot_pairs" or v is None else _stripe(v.shape[0], mesh)
                for k, v in whole.items()}
        part = {k: v if rows[k] is None else v[rows[k]] for k, v in whole.items()}
        pk = "pairs_aug" if "pairs_aug" in whole else "pairs"

        def share(key: str):
            """The stripe's share of a mean over leaf ``key``'s rows (of the
            margin's over the weights, with weights); for a whole leaf 1 on
            slice 0, 0 elsewhere."""
            r, w = rows[key], whole.get("w")
            if r is None:
                return float(first)
            if key == pk and w is not None:
                return w[r].sum() / w.sum().clamp_min(1e-9)
            return (r.stop - r.start) / whole[key].shape[0]

        def ot(emb, pairs, **kw):  # whole, on slice 0 alone
            return ring_sinkhorn_align_loss(emb, pairs, mesh, **kw) if first else se[:0].sum()

        _, aux = table_losses(cfg, se, part, self.model.rel_head, self.model.attr_head, ot)
        if ae is not None:
            aux["ae"] = margin_align_loss(ae, part[pk], part["neg_l"], part["neg_r"], cfg.gamma,
                                          part.get("w"))
        of = {"margin": pk, "ae": pk, "rel": "rel_neg_t", "attr": "attr_triples"}
        aux = {k: v * share(of[k]) if k in of else v for k, v in aux.items()}
        loss = weighted_loss(cfg, aux)
        summed = torch.stack([loss.detach(), *(v.detach() for v in aux.values())])
        dist.all_reduce(summed, group=mesh.group("slice"))
        return _Whole.apply(loss, summed[0]), dict(zip(aux, summed[1:]))

    def grads(self, batch: dict[str, torch.Tensor],
              mask: torch.Tensor | None = None) -> torch.Tensor:
        """One step's loss (its terms in ``aux``) and gradients
        (``sum_grads``): the table's the rank's own block, the encoder's
        weights' the rank's column blocks, the heads' whole on every rank."""
        self.model.zero_grad(set_to_none=True)
        loss, aux = self.loss(batch, mask)
        loss.backward()
        self.aux = {k: v.detach() for k, v in aux.items()}
        self.sum_grads()
        return loss.detach()

    def sum_grads(self) -> None:
        """Sum the gradients over the grid (nothing at W = 1): the
        encoder's weights' column blocks over the graph group (each graph
        rank computed them from its rows; never over the feature group,
        whose ranks hold other columns), then every parameter's over the
        slice group (each slice computed its share of the loss).  One
        ``all_reduce`` each."""
        mesh = self.op.mesh
        named = list(self.model.named_parameters())
        if mesh.n_graph > 1:
            _sum_grads([p for n, p in named if n != "emb" and column_split(n)],
                       mesh.group("graph"))
        if mesh.n_slice > 1:
            _sum_grads([p for _, p in named], mesh.group("slice"))


def _sum_grads(params: list[nn.Parameter], group) -> None:
    """Each parameter's gradient summed over ``group`` (one flat
    ``all_reduce``)."""
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(flat, group=group)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad.copy_(g.view_as(p))


def _stripe(n: int, mesh: ShardMesh) -> slice | None:
    """The rank's slice's contiguous stripe of a leaf of n rows (JAX's
    ``shard_slice``); None where L does not divide n: the leaf stays
    whole."""
    if n % mesh.n_slice:
        return None
    m = n // mesh.n_slice
    return slice(mesh.slice_rank * m, (mesh.slice_rank + 1) * m)


def dist_parts(cfg: TrainConfig, task: AlignTask, mesh: ShardMesh,
               exchange: bool | None = None) -> DistParts:
    """The adjacency of ``task`` over the rows of its ``RowLayout``
    partitioned into ``cfg.n_shards`` shards (with ``halo_grouped`` into
    two groups, one KG each), the rank's halo operator on its device
    (``exchange``: its route, as ``dist/mesh.py::shard_operator`` takes it;
    and with the AE channel the rank's shards of the attribute incidence),
    and the encoder with the heads and options ``cfg`` turns on, loaded with
    ``init_params(seed=cfg.seed)``."""
    layout = RowLayout.of(cfg, task)
    src, dst, w = coo_from_triples(task.n_ent, task.merged_triples, n_rel=task.n_rel,
                                   weighting=cfg.weighting)
    w = coo_normalize(src, dst, w, task.n_ent, norm=cfg.norm)
    hg = partition_edges(layout.rows(src), layout.rows(dst), w, layout.n_rows, cfg.n_shards,
                         n_groups=2 if cfg.halo_grouped else 1)
    op = shard_operator(hg, mesh, operator_format(cfg.spmm_impl), exchange)
    n_pad = hg.n_loc * hg.n_shards
    heads = dict(n_rel=task.n_rel if cfg.use_rel_head else 0,
                 n_attr=max(task.n_attr, 1) if cfg.use_attr_head else 0)
    # one remapped copy of the attribute triples feeds the incidence and the head
    attr = layout.triples(attr_triples_of(cfg, task), (0,))
    inc, n_ch = None, 0
    if cfg.use_attr_channel:
        n_ch = task.n_attr
        stacked = build_attr_incidence_ell(attr, n_pad, n_ch, cfg.n_shards, hg.n_loc)
        inc = [stacked.shard(s).to(mesh.device) for s in mesh.shards]
    model = DistEncoder(op, cfg.dim, cfg.hidden, cfg.highway, device=mesh.device,
                        compute_dtype=cfg.param_dtype, dropout=cfg.dropout,
                        l2_normalize=cfg.l2_normalize, inc=inc, n_attr_channel=n_ch, **heads)
    model.load_full(init_params(task.n_ent, n_pad, cfg.dim, cfg.hidden, seed=cfg.seed,
                                highway=cfg.highway, n_attr_channel=n_ch,
                                rows=layout.entity_rows(), **heads))

    def on_dev(t):
        return torch.as_tensor(t, dtype=torch.int64, device=mesh.device)

    rel = on_dev(layout.triples(task.merged_triples, (0, 2))) if cfg.use_rel_head else None
    head_attr = on_dev(attr) if cfg.use_attr_head else None
    return DistParts(model=model, op=op, hg=hg, cfg=cfg, layout=layout, rel_triples=rel,
                     attr_triples=head_attr)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _pad_rows(t: torch.Tensor, layout: RowLayout, n_pad: int) -> torch.Tensor:
    """A saved table (or its moments) re-padded to this run's n_pad rows:
    the layout's real rows kept where they are, zeros elsewhere (another S
    pads to another n_pad; a checkpoint of another layout is refused before,
    ``check_layout``)."""
    if t.shape[0] == n_pad:
        return t
    rows = layout.entity_rows(t.device)
    return t.new_zeros((n_pad,) + tuple(t.shape[1:])).index_copy_(0, rows, t[rows])


def _full_optimizer_state(opt: torch.optim.Adam, model: DistEncoder) -> dict:
    """``optimizer_state`` with each parameter's moments whole: the
    table's gathered over rows and columns, the weights' over columns (a
    collective)."""
    sd = optimizer_state(opt)
    names = [n for n, _ in model.named_parameters()]
    state = {}
    for i, st in sd["state"].items():
        st = dict(st)
        for key in ("exp_avg", "exp_avg_sq"):
            st[key] = model.whole(names[i], st[key])
        state[i] = st
    return {**sd, "state": state}


def _load_rank_state(model: DistEncoder, opt: torch.optim.Adam, state: dict,
                     layout: RowLayout, n_pad: int) -> None:
    """A checkpoint's parameters and Adam state into this rank: the table
    and its moments re-padded to n_pad rows, then each parameter and its
    moments cut to the rank's block (``DistEncoder.block``)."""
    model.load_full({**state["model"], "emb": _pad_rows(state["model"]["emb"], layout, n_pad)})
    sd, names = state["opt"], [n_ for n_, _ in model.named_parameters()]
    rank_state = {}
    for i, st in sd["state"].items():
        st = dict(st)
        for key in ("exp_avg", "exp_avg_sq"):
            t = _pad_rows(st[key], layout, n_pad) if names[i] == "emb" else st[key]
            st[key] = model.block(names[i], t)
        rank_state[i] = st
    load_optimizer_state(opt, {**sd, "state": rank_state})


def check_layout(cfg: TrainConfig, state: dict, kg2_base: int) -> None:
    """Refuse a checkpoint without the row-layout stamp, or with another
    one, with the JAX trainer's messages: restoring would permute entity
    rows silently."""
    if "layout" not in state:
        raise ValueError(
            f"checkpoint at {cfg.checkpoint_dir!r} predates the row-layout stamp — its "
            f"partition layout cannot be verified; retrain or point checkpoint_dir elsewhere")
    got, want = tuple(int(v) for v in state["layout"]), (int(cfg.halo_grouped), int(kg2_base))
    if got != want:
        raise ValueError(
            f"checkpoint at {cfg.checkpoint_dir!r} was written with row layout "
            f"(halo_grouped, kg2_base)={got} but this run uses {want} — restoring would "
            f"permute entity rows silently; retrain or point checkpoint_dir elsewhere")


def check_mode(cfg: TrainConfig, state: dict) -> None:
    """Refuse a resume across a change of mode, with the JAX trainer's
    messages: an unfused save carries the interval's batch, a fused one
    (always at an interval's end) does not."""
    has_batch = "neg_l" in state
    if cfg.steps_per_call <= 1 and not has_batch:
        raise ValueError(
            f"checkpoint at {cfg.checkpoint_dir!r} was saved with steps_per_call > 1 (no "
            f"interval-batch state) — resume it with the same fused steps_per_call, or retrain")
    if cfg.steps_per_call > 1 and has_batch:
        raise ValueError(
            f"checkpoint at {cfg.checkpoint_dir!r} was saved with steps_per_call == 1 (carries "
            f"interval-batch state) — resume it with steps_per_call=1, or retrain")


def fit_distributed(cfg: TrainConfig, task: AlignTask | None = None, verbose: bool = False,
                    device: str | torch.device = "cuda",
                    debug_nans: bool = False) -> TrainResult:
    """Train ``cfg`` over ``cfg.n_shards`` shards on the group of
    ``dist/mesh.py::make_mesh`` (NCCL on the card, gloo on the host).
    ``TrainResult.params`` holds the whole parameter set on every rank;
    ``op`` the rank's ``HaloOperator``; ``timings`` the host wall seconds
    of build_s (partition and operators), load_s (a restore), capture_s
    (the fused step's warm-up and capture, on the card), train_s and step_s
    (each step's, ended by a synchronise; fused, each interval's over its
    steps), forward_s (the
    boundaries' encoder forwards), propose_s, mine_s, draw_s (the
    interval's draws), eval_s, final_eval_s and save_s, with the counts
    steps, forwards, proposals, minings, draws, evals and saves, and
    start_epoch.  ``debug_nans``: see the module docstring."""
    dev = resolve_device(device)
    task = task or load_task(cfg)
    check_distributed(cfg, task)
    with make_mesh(cfg.n_shards, dev, cfg.feature_shards, cfg.slice_shards,
                   cfg.halo_grouped) as mesh:
        return _fit(cfg, task, mesh, verbose, debug_nans)


def _fit(cfg: TrainConfig, task: AlignTask, mesh: ShardMesh, verbose: bool,
         debug_nans: bool) -> TrainResult:
    dev = mesh.device
    timings = {"build_s": 0.0, "load_s": 0.0, "capture_s": 0.0, "train_s": 0.0, "step_s": [],
               "forward_s": 0.0, "propose_s": 0.0, "mine_s": 0.0, "draw_s": 0.0, "eval_s": 0.0,
               "final_eval_s": 0.0, "save_s": 0.0, "steps": 0, "forwards": 0, "proposals": 0,
               "minings": 0, "draws": 0, "evals": 0, "saves": 0}

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
    model, hg = parts.model, parts.hg
    n_pad = hg.n_loc * hg.n_shards
    steps = max(1, cfg.steps_per_call)
    captured_on_card = steps > 1 and dev.type == "cuda"
    opt, sched = make_optimizer(cfg, model.parameters(), capturable=captured_on_card)
    rows = parts.layout  # the ids of every batch, mining and eval are table rows
    make = IntervalBatch(cfg, task, dev, kg2_row=rows.r0)
    pairs = make.pairs
    n1, n, r0, r1 = rows.n1, rows.n, rows.r0, rows.r1
    extra_keys = interval_keys(cfg, len(pairs))
    layout = [int(cfg.halo_grouped), r0]  # the row-layout stamp: KG2's rows start at r0
    test_rows = rows.rows(task.test_pairs)
    rank0 = mesh.rank == 0  # the one writer of the shared sinks and checkpoints
    logger = MetricsLogger(cfg.metrics_path if rank0 else None, config=cfg.to_dict(),
                           tb_dir=cfg.tb_dir if rank0 else None)

    def mine(emb, pairs_t):
        kw = dict(metric=cfg.neg_metric, csls_k=cfg.neg_csls_k, approx=cfg.neg_approx)
        return (ring_knn(emb[pairs_t[:, 1]], emb[:n1], pairs_t[:, 0], cfg.k_neg, mesh, **kw),
                ring_knn(emb[pairs_t[:, 0]], emb[r0:r1], pairs_t[:, 1] - r0, cfg.k_neg, mesh,
                         **kw) + r0)

    def draw(epoch0):
        """The interval's draws over the rows: the relation corruptions
        drawn as entity ids, then moved to their rows (a draw over the rows
        would hit the grouped layout's padding)."""
        out = draw_interval(cfg, epoch0, pairs, n, len(task.merged_triples),
                            parts.attr_triples)
        return {k: rows.rows(v) if k.startswith("rel_neg") else v for k, v in out.items()}

    def evaluate(approx_k):
        t0 = time.perf_counter()
        m = ring_hits_at_k(parts.embed(), test_rows, mesh, csls_k=cfg.eval_csls_k,
                           approx_k=approx_k)
        timings["eval_s"] += time.perf_counter() - t0
        timings["evals"] += 1
        return m

    def agreed(flag: bool, op=dist.ReduceOp.MAX) -> bool:
        """``flag`` reduced over the ranks (one collective)."""
        t = torch.tensor([int(flag)], dtype=torch.int32, device=dev)
        if mesh.world > 1:
            dist.all_reduce(t, op=op)
        return bool(t.item())

    ckpt = Checkpointer(cfg.checkpoint_dir, cfg.checkpoint_every)
    start_epoch, batch, boot, saved = 0, None, None, None
    loss = torch.tensor(float("nan"))
    t0 = time.perf_counter()
    restored = ckpt.restore_latest(dev)
    if restored is not None:
        epoch, state = restored
        check_layout(cfg, state, r0)
        check_mode(cfg, state)
        if steps == 1:
            _check_resume(cfg, state, len(pairs) + (cfg.boot_cap if make.use_boot else 0),
                          extra_keys)
        _load_rank_state(model, opt, state, rows, n_pad)
        sched.load_state_dict(state["sched"])
        if steps == 1:  # a fused resume starts at a boundary and rebuilds the batch there
            boot = (state["boot_pairs"], state["boot_w"]) if make.use_boot else None
            batch = make(boot, state["neg_l"], state["neg_r"])
            batch.update({k: state["extra"][k] for k in extra_keys})
        loss, start_epoch, saved = state["loss"], epoch + 1, epoch
    _sync(dev)
    timings["load_s"] = time.perf_counter() - t0
    timings["start_epoch"] = start_epoch

    def save_now(epoch):
        """Every rank gathers the table and its moments; rank 0 writes."""
        nonlocal saved
        if saved == epoch:
            return

        def write():
            full = model.full_state()
            state = {"model": full, "opt": _full_optimizer_state(opt, model),
                     "sched": sched.state_dict(), "layout": layout, "loss": loss.detach()}
            if steps == 1:  # the interval's batch: a resume may start mid-interval
                state.update(neg_l=batch["neg_l"], neg_r=batch["neg_r"])
                if make.use_boot:
                    state["boot_pairs"], state["boot_w"] = boot
                if extra_keys:
                    state["extra"] = {k: batch[k] for k in extra_keys}
            if rank0:  # what the evaluation table reads: the encoder's, the channel's
                ckpt.save(epoch, state, {**{k: v for k, v in full.items()
                                            if not k.startswith(HEADS)},
                                         "emb": rows.entities(full["emb"])})
            if mesh.world > 1:
                dist.barrier()

        timed("save_s", "saves", write)
        saved = epoch

    def eager_steps(epoch, finite):
        """The interval's steps eagerly (each through ``DistParts.grads``);
        ``finite`` (fused under debug_nans) folds each step's flag."""
        out = []
        for e in range(epoch, epoch + steps):
            step_loss = parts.grads(batch, parts.drop_mask(e))
            opt.step()
            sched.step()
            if finite is not None:
                finite &= finite_flag(opt, step_loss)
            out.append(step_loss)
        return out

    history, losses = [], []
    captured, prof, prof_first, last = None, None, None, start_epoch - 1
    t_start = time.perf_counter()
    ckpt.install_preemption_handler()
    try:
        for epoch in range(start_epoch, cfg.epochs, steps):
            if epoch % cfg.neg_every == 0 or batch is None:
                batch, boot = make.at_boundary(epoch, parts.embed, mine,
                                               draw if extra_keys else None, timed)
            if captured_on_card and captured is None:
                t0 = time.perf_counter()
                captured = CapturedStep(opt, parts.loss_fn, batch, dev, cfg.dropout > 0.0,
                                        check_finite=debug_nans, after_backward=parts.sum_grads)
                _sync(dev)
                timings["capture_s"] = time.perf_counter() - t0
            last = epoch + steps - 1  # the interval's last epoch: the JAX fused windows
            if cfg.profile_dir and rank0 and prof_first is None and epoch >= start_epoch + 2:
                prof, prof_first = _start_profile(dev), epoch
            finite = (torch.ones((), dtype=torch.bool, device=dev)
                      if debug_nans and steps > 1 else None)
            t0 = time.perf_counter()
            if captured is not None:  # the interval's steps as replays, no synchronise
                captured.load(batch)
                for e in range(epoch, epoch + steps):
                    losses.append(captured.replay(step_seed(cfg, e)))
                    sched.step()
                parts.aux = {k: v.clone() for k, v in captured.aux.items()}
                finite = captured.finite
            else:
                losses += eager_steps(epoch, finite)
            loss = losses[-1]
            _sync(dev)
            dt = time.perf_counter() - t0
            timings["step_s"].append(dt / steps)
            timings["train_s"] += dt
            timings["steps"] += steps
            if debug_nans:
                ok = finite if finite is not None else finite_flag(opt, loss)
                if not agreed(bool(ok), dist.ReduceOp.MIN):
                    raise _non_finite(f"epoch {epoch}" if steps == 1 else
                                      f"the interval of epochs {epoch}-{last}")
            if prof is not None and last >= start_epoch + 5:
                _stop_profile(prof, dev, cfg.profile_dir, prof_first, last)
                prof = None
            stop = ckpt.enabled and agreed(ckpt.preempted)
            if ckpt.enabled and ((last > 0 and last % cfg.checkpoint_every < steps)
                                 or last >= cfg.epochs - 1 or stop):
                save_now(last)
            if cfg.eval_every and (last % cfg.eval_every < steps or last >= cfg.epochs - 1):
                m = evaluate(cfg.eval_approx_k)  # the history: shortlists if set
                wall = time.perf_counter() - t_start
                eps = (epoch_edge_ops(hg.nnz, cfg.use_attr_channel) * (last + 1 - start_epoch)
                       / max(wall, 1e-9))  # epochs run in this process
                rec = {"epoch": last, "loss": loss.item(), "wall_s": round(wall, 3),
                       # unrounded, so the two rates compare exactly
                       "edges_per_s": eps, "edges_per_s_chip": eps / mesh.world,
                       **{f"loss_{k}": v.item() for k, v in parts.aux.items()},
                       **{k: round(v, 4) for k, v in m.items()}}
                history.append(rec)
                logger.log(rec)
                if verbose and rank0:
                    print(f"[dist:{cfg.name}@{cfg.n_shards}/{mesh.world}] epoch {last} loss "
                          f"{rec['loss']:.4f} hits@1 {m['hits@1']:.3f}")
            # the latch may fire after the check above: every rank takes this
            # branch at the same epoch
            if ckpt.enabled and (stop or agreed(ckpt.preempted)):
                save_now(last)
                break  # exit cleanly for a relaunch
        if prof is not None:  # a run that ended before start_epoch + 5
            _stop_profile(prof, dev, cfg.profile_dir, prof_first, last)
            prof = None
        ckpt.restore_handler()
        t0 = time.perf_counter()
        final = evaluate(0)  # always exact
        timings["final_eval_s"] = time.perf_counter() - t0
        final["final_loss"] = loss.item()
        params = model.full_state()
        if cfg.save_emb_path:
            emb = parts.embed()  # a collective: every rank joins it
            if rank0:  # row == entity id: the serving path's table
                from tpugraph_torch.serve import save_embeddings

                save_embeddings(cfg.save_emb_path, rows.entities(emb))
    finally:
        if prof is not None:
            prof.stop()
        ckpt.restore_handler()
        logger.close()
    return TrainResult(params=params, metrics=final, history=history, op=parts.op,
                       model=model, task=task,
                       losses=torch.stack(losses).tolist() if losses else [], timings=timings)
