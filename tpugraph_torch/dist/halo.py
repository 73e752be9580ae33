"""Halo-exchange SpMM over a rank's graph shards (counterpart of
``tpugraph/dist/halo.py``).

A rank holds ``per_rank`` shards of n_loc rows each, as one
(per_rank·n_loc, d) tensor x.  One SpMM over them:

1. the exchange (``_Exchange``, an autograd Function): gather each shard's
   send rows into the live slots of a zeroed (per_rank, S, B, d) buffer
   (``send_mask``'s ones: the JAX gather-and-mask without gathering the
   pad slots), and carry the blocks to their receivers with one
   ``all_to_all_single`` over the ranks; the blocks between two shards of
   one rank travel in the collective's own chunk for this rank (a copy on
   the device).  Each receiving shard gets its (S·B, d) buffer laid out
   [owner shard, slot].  The backward is the reverse exchange, then an
   ``index_add_`` of the returned live rows into x at their send rows (on
   the card its sums run in no fixed order);
2. per shard, the local edge group over its own rows (the operator with
   the diagonal) plus the boundary group over its received buffer: with
   ``impl`` "ell" two ``kernels/spmm_ell.py::spmm_ell`` launches each way
   (the boundary's transpose, G·B rows, in the backward), with "sorted"
   two ``kernels/spmm.py::spmm`` launches (the JAX ``_segsum``).

The collective is called whatever the number of ranks.  Without a halo
(``has_halo`` false: one shard, or no edge between shards) there is no
exchange and no boundary group, as in the JAX trainer.  The exchange and
the local aggregation run one after the other; overlapping them is not
done yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from tpugraph_torch.dist.mesh import ShardMesh
from tpugraph_torch.kernels.spmm import spmm
from tpugraph_torch.kernels.spmm_ell import spmm_ell
from tpugraph_torch.sparse.ell import EllOperator
from tpugraph_torch.sparse.graph import SpMMOperator


@dataclass
class HaloOperator:
    """A rank's shards' operators and exchange lists, on its device
    (``dist/mesh.py::shard_operator``)."""

    loc: list[EllOperator | SpMMOperator]  # per shard of the rank: n_loc × n_loc
    bnd: list[EllOperator | SpMMOperator]  # per shard: n_loc × S·B, over the receive buffer
    send_idx: torch.Tensor  # (per_rank, S, B) int64: local rows each shard sends to each shard
    send_mask: torch.Tensor  # (per_rank, S, B) float32
    n_loc: int
    halo_b: int
    has_halo: bool
    impl: str  # "ell" or "sorted"
    mesh: ShardMesh
    geometry: dict  # the partition's shapes (sparse/partition.py::HaloGraph.geometry)

    def __post_init__(self):
        per = self.send_idx.shape[0]
        base = torch.arange(per, device=self.send_idx.device) * self.n_loc
        # the live send slots (mask 1) of the flattened (per_rank, S, B)
        # buffer, and the rows of the rank's x they carry
        self.live = torch.nonzero(self.send_mask.reshape(-1)).reshape(-1)
        self.live_rows = (self.send_idx + base[:, None, None]).reshape(-1)[self.live]


def _all_to_all(buf: torch.Tensor) -> torch.Tensor:
    """Chunk k of ``buf`` (its leading axis has one entry per rank) to rank k."""
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf)
    return out


class _Exchange(torch.autograd.Function):
    """x (per_rank·n_loc, d) -> each shard's receive buffer (per_rank, S·B, d)."""

    @staticmethod
    def forward(ctx, x, op):
        ctx.op, ctx.n_rows = op, x.shape[0]
        per, s, b = op.send_idx.shape
        d, r = x.shape[1], op.mesh.world
        send = x.new_zeros((per * s * b, d))  # the pad slots stay 0
        send.index_copy_(0, op.live, x.index_select(0, op.live_rows))
        send = send.view(per, s, b, d)
        # [my shard j, receiver k·per + i] -> [rank k, j, i]
        recv = _all_to_all(send.view(per, r, per, b, d).transpose(0, 1).contiguous())
        # [sender rank k, its shard j, my shard i] -> [i, owner k·per + j, slot]
        return recv.permute(2, 0, 1, 3, 4).reshape(per, s * b, d)

    @staticmethod
    def backward(ctx, g):
        op = ctx.op
        per, s, b = op.send_idx.shape
        d, r = g.shape[-1], op.mesh.world
        # [my shard i, owner k·per + j] -> [rank k, j, i]: back to the sender
        back = _all_to_all(g.reshape(per, r, per, b, d).permute(1, 2, 0, 3, 4).contiguous())
        # [receiver rank k, my shard j, its shard i] -> [j, k·per + i]
        g_send = back.transpose(0, 1).reshape(per * s * b, d)
        gx = torch.zeros((ctx.n_rows, d), dtype=g.dtype, device=g.device)
        gx.index_add_(0, op.live_rows, g_send.index_select(0, op.live))
        return gx, None


def exchange(x: torch.Tensor, op: HaloOperator) -> torch.Tensor:
    """The halo exchange with its gradient: each of the rank's shards'
    receive buffer, (per_rank, S·B, d)."""
    return _Exchange.apply(x, op)


def _halo(x: torch.Tensor, op: HaloOperator, aggregate) -> torch.Tensor:
    n = op.n_loc
    if x.shape[0] != len(op.loc) * n:
        raise ValueError(f"x has {x.shape[0]} rows, the rank's shards {len(op.loc) * n}")
    # split and unbind (not indexing): their backwards concatenate the
    # shards' gradients once, where each index's would fill and add a
    # zero tensor of the whole input
    recv = exchange(x, op).unbind(0) if op.has_halo else None
    out = []
    for j, (loc, xj) in enumerate(zip(op.loc, x.split(n))):
        y = aggregate(loc, xj)
        if recv is not None:
            y = y + aggregate(op.bnd[j], recv[j])
        out.append(y)
    return torch.cat(out)


def halo_spmm_ell(x: torch.Tensor, op: HaloOperator) -> torch.Tensor:
    """A·x over the rank's shards, aggregated by the ELL SpMM kernel
    forward and backward (``op.impl == "ell"``)."""
    return _halo(x, op, spmm_ell)


def halo_spmm(x: torch.Tensor, op: HaloOperator) -> torch.Tensor:
    """A·x over the rank's shards, aggregated by the sorted-segment SpMM
    kernel forward and backward (``op.impl == "sorted"``)."""
    return _halo(x, op, spmm)
