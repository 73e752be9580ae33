"""Process group and shard placement of the distributed trainer
(counterpart of ``tpugraph/dist/mesh.py``).

The JAX package maps one graph shard to one device of a ``shard_map``
mesh.  Here a ``torch.distributed`` group of R ranks holds ``n_shards`` =
S shards, R dividing S: rank r owns the contiguous shards
[r·S/R, (r+1)·S/R), and with them the embedding rows of those shards.

* The backend follows the device: NCCL for a CUDA device, gloo for the
  CPU.  Nothing falls back from one to the other.  NCCL allows one rank
  per device, so on one card R = 1 and that rank holds all S shards; on a
  box of S cards ``torchrun --nproc_per_node=S`` gives one shard per rank.
* Under torchrun (``RANK`` and ``WORLD_SIZE`` set) ``make_mesh`` joins the
  group torchrun describes, on ``cuda:LOCAL_RANK``; without them it starts
  a world-size-1 group in this process on a ``HashStore``; inside a group
  the caller started (the multi-process tests), it uses that group.  A
  group it started, it destroys on leaving.
* ``shard_operator`` stacks the rank's shards' operators, builds the
  exchange lists and moves them to the rank's device
  (``dist/halo.py::HaloOperator``).
"""

from __future__ import annotations

import contextlib
import os
from collections.abc import Iterator
from dataclasses import dataclass

import torch
import torch.distributed as dist

from tpugraph_torch.sparse.halo_ell import rank_operators, send_transpose
from tpugraph_torch.sparse.partition import HaloGraph


def backend_for(device: torch.device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    if device.type == "cuda":
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"the distributed trainer runs on cuda or cpu, not {device}")


def shards_of(n_shards: int, world: int, rank: int) -> range:
    """The contiguous shards rank ``rank`` of ``world`` owns."""
    if world < 1 or n_shards % world:
        raise ValueError(f"n_shards={n_shards} must be a multiple of the world size {world}: "
                         f"every rank holds the same number of shards")
    per = n_shards // world
    return range(rank * per, (rank + 1) * per)


@dataclass
class ShardMesh:
    """This rank's place in the group: its shards and its device."""

    n_shards: int
    rank: int
    world: int
    device: torch.device

    @property
    def shards(self) -> range:
        return shards_of(self.n_shards, self.world, self.rank)

    @property
    def per_rank(self) -> int:
        return self.n_shards // self.world


@contextlib.contextmanager
def make_mesh(n_shards: int, device: torch.device) -> Iterator[ShardMesh]:
    """The group of the run on ``device`` (see the module docstring)."""
    backend = backend_for(device)
    started = False
    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) if torchrun
                              else torch.cuda.current_device())
    if not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(device)
        if torchrun:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        started = True
    try:
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()}, but a run on "
                             f"{device} needs {backend}")
        mesh = ShardMesh(n_shards=n_shards, rank=dist.get_rank(), world=dist.get_world_size(),
                         device=device)
        mesh.shards  # S % R raises here
        yield mesh
    finally:
        if started:
            dist.destroy_process_group()


def shard_operator(hg: HaloGraph, mesh: ShardMesh, impl: str, exchange: bool | None = None):
    """The rank's part of the halo SpMM on its device: its shards' local
    and boundary groups, each stacked into one operator (``impl`` "ell" or
    "sorted"; ``sparse/halo_ell.py::rank_operators``), and the exchange
    lists.  ``exchange`` (default: R > 1) builds the boundary over the
    exchange's receive buffers; without it (R = 1 only) the boundary reads
    x's rows and no exchange runs."""
    from tpugraph_torch.dist.halo import HaloOperator

    if impl not in ("ell", "sorted"):
        raise ValueError(f"unknown halo impl {impl!r}; expected 'ell' or 'sorted'")
    if exchange is None:
        exchange = mesh.world > 1
    if not exchange and mesh.world > 1:
        raise ValueError("a boundary over x's rows needs one rank holding every shard")
    loc, bnd = rank_operators(hg, mesh.shards, impl, direct=not exchange)
    sh = slice(mesh.shards.start, mesh.shards.stop)
    live, rows, send_t = send_transpose(hg.send_idx[sh], hg.send_mask[sh], hg.n_loc)
    dev = mesh.device
    return HaloOperator(
        loc=loc.to(dev), bnd=None if bnd is None else bnd.to(dev), direct=not exchange,
        live=torch.from_numpy(live).to(dev), live_rows=torch.from_numpy(rows).to(dev),
        send_t=send_t.to(dev), per_rank=mesh.per_rank, n_loc=hg.n_loc, halo_b=hg.halo_b,
        has_halo=hg.has_halo, impl=impl, mesh=mesh, geometry=hg.geometry())
