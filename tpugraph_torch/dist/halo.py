"""Halo-exchange SpMM over a rank's graph shards (counterpart of
``tpugraph/dist/halo.py``).

A rank holds ``per_rank`` = P shards of n_loc rows each, as one
(P·n_loc, d) tensor x, and each group of its shards' edges as one stacked
operator (``sparse/halo_ell.py::rank_operators``): the local groups, over
x, and the boundary groups.  One SpMM over them is the local aggregation
plus the boundary aggregation, each one ``kernels/spmm_ell.py::spmm_ell``
launch each way with ``impl`` "ell", one ``kernels/spmm.py::spmm`` launch
with "sorted" (the JAX ``_segsum``).  Where the boundary rows come from:

* **One rank holding every shard of its exchange group** (Gr = 1 graph
  ranks: W = 1, the trainer's route on one card, or a grid of slices and
  feature blocks only; under ``halo_grouped`` also Gr = 2, each rank
  holding one KG's half): the boundary operator reads the rows of x the
  receive slots would carry (``direct``), so no exchange runs: no
  collective, no receive buffer, no copy.  Its backward is the operator's transpose, a fixed-order
  sum by construction.  Each row keeps its entries in their order, so the
  forward sums are bitwise those of the exchange route.
* **The exchange** (an exchange group of Q > 1 ranks, or asked for with
  ``shard_operator(..., exchange=True)``; ``_Exchange``, an autograd
  Function), within the exchange group (``dist/mesh.py``): the graph
  group, or under ``halo_grouped`` at Gr >= 4 the rank's halo group, the
  half of the graph group holding its KG's shards (the JAX
  ``axis_index_groups``): the live send rows gathered into a zeroed
  buffer already laid out as the collective sends it, [receiver's rank in
  the group, my shard, its shard, slot] (``send_mask``'s ones: the JAX
  gather-and-mask without gathering the pad slots), one ``all_to_all_single`` issued with
  ``async_op=True`` (under tensor parallelism x holds the rank's d/F
  columns, so each rank moves 1/F of the bytes); the boundary
  operator reads the received buffer as delivered, so nothing is permuted.
  The local aggregation runs while the exchange is in flight and the
  boundary aggregation waits on it, the JAX schedule ("local aggregation —
  no data dependence on ``recv``; overlaps the exchange");
  ``force_serialize`` waits first, the JAX ablation
  (``scripts/overlap_probe.py``).  The backward is the reverse exchange,
  then the send map's transpose (one weight-1 ELL matrix, ``send_t``: a
  row of x, the live slots that carry it, in slot order) applied by
  ``ell_spmm``: the returned rows sum into x in a fixed order on the card
  as on the host.

Without a halo (``has_halo`` false: one shard, or no edge between shards)
there is no boundary group, as in the JAX trainer.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from tpugraph_torch.dist.mesh import ShardMesh
from tpugraph_torch.kernels.spmm import spmm
from tpugraph_torch.kernels.spmm_ell import ell_spmm, spmm_ell
from tpugraph_torch.sparse.ell import EllMatrix, EllOperator
from tpugraph_torch.sparse.graph import SpMMOperator


@dataclass
class HaloOperator:
    """A rank's stacked operators and exchange lists, on its device
    (``dist/mesh.py::shard_operator``)."""

    loc: EllOperator | SpMMOperator  # (P·n_loc)², the local groups block-diagonal
    bnd: EllOperator | SpMMOperator | None  # P·n_loc rows, over x (direct) or the buffer
    direct: bool  # the boundary reads x's rows: no exchange
    live: torch.Tensor  # (L,) int64: the live slots of the flat send buffer
    live_rows: torch.Tensor  # (L,) int64: the rows of x they carry
    send_t: EllMatrix  # the send map's transpose: P·n_loc × (Q·P·P·B), weight 1
    per_rank: int
    n_loc: int
    halo_b: int
    has_halo: bool
    impl: str  # "ell" or "sorted"
    mesh: ShardMesh
    geometry: dict  # the partition's shapes (sparse/partition.py::HaloGraph.geometry)
    n_peers: int = 1  # Q: the ranks of the exchange group (Gr ungrouped, Gr/2 grouped)
    group: object = None  # the exchange's process group (None: the rank alone)

    @property
    def n_rows(self) -> int:
        return self.per_rank * self.n_loc

    @property
    def slots(self) -> int:
        """The rows of the send (and of the receive) buffer: Q·P·P·B
        (S·P·B ungrouped)."""
        return self.n_peers * self.per_rank * self.per_rank * self.halo_b


def _all_to_all(buf: torch.Tensor, group, async_op: bool = False):
    """Chunk k of ``buf`` (its rows split evenly over the group's
    ranks) to its k-th rank; with ``async_op`` also the collective's
    handle."""
    out = torch.empty_like(buf)
    work = dist.all_to_all_single(out, buf, group=group, async_op=async_op)
    return (out, work) if async_op else out


class _Exchange(torch.autograd.Function):
    """x (P·n_loc, d) -> the receive buffer (Q·P·P·B, d), laid out [sender
    shard, my shard, slot]; the collective's handle appended to
    ``pending`` (the caller waits on it before reading the buffer)."""

    @staticmethod
    def forward(ctx, x, op, pending):
        ctx.op = op
        send = x.new_zeros((op.slots, x.shape[1]))  # the pad slots stay 0
        send.index_copy_(0, op.live, x.index_select(0, op.live_rows))
        recv, work = _all_to_all(send, op.group, async_op=True)
        pending.append(work)
        return recv

    @staticmethod
    def backward(ctx, g):
        # back to the senders, in the send buffer's layout; then each row of
        # x sums its live slots in slot order
        back = _all_to_all(g.contiguous(), ctx.op.group)
        return ell_spmm(ctx.op.send_t, None, back), None, None


def exchange(x: torch.Tensor, op: HaloOperator) -> torch.Tensor:
    """The halo exchange with its gradient: each of the rank's shards'
    receive buffer, (P, Q·P·B, d), laid out [owner, slot]: the owner shard
    ungrouped (S·B rows), its index in the receiver's KG half under the
    grouped layout across ranks (G·B rows, the JAX buffer)."""
    pending = []
    recv = _Exchange.apply(x, op, pending)
    pending[0].wait()
    per, b = op.per_rank, op.halo_b
    return recv.view(op.n_peers * per, per, b, -1).transpose(0, 1).reshape(
        per, op.n_peers * per * b, -1)


def _halo(x: torch.Tensor, op: HaloOperator, aggregate, force_serialize: bool) -> torch.Tensor:
    if x.shape[0] != op.n_rows:
        raise ValueError(f"x has {x.shape[0]} rows, the rank's shards {op.n_rows}")
    if op.bnd is None:
        return aggregate(op.loc, x)
    if op.direct:
        return aggregate(op.loc, x) + aggregate(op.bnd, x)
    pending = []
    recv = _Exchange.apply(x, op, pending)
    if force_serialize:
        pending[0].wait()
    y = aggregate(op.loc, x)  # no data dependence on recv: overlaps the exchange
    pending[0].wait()
    return y + aggregate(op.bnd, recv)


def halo_spmm_ell(x: torch.Tensor, op: HaloOperator, force_serialize: bool = False
                  ) -> torch.Tensor:
    """A·x over the rank's shards, aggregated by the ELL SpMM kernel
    forward and backward (``op.impl == "ell"``); ``force_serialize``: the
    local aggregation starts after the exchange completes."""
    return _halo(x, op, spmm_ell, force_serialize)


def halo_spmm(x: torch.Tensor, op: HaloOperator, force_serialize: bool = False
              ) -> torch.Tensor:
    """A·x over the rank's shards, aggregated by the sorted-segment SpMM
    kernel forward and backward (``op.impl == "sorted"``);
    ``force_serialize`` as ``halo_spmm_ell``'s."""
    return _halo(x, op, spmm, force_serialize)
