"""Process groups and shard placement of the distributed trainer
(counterpart of ``tpugraph/dist/mesh.py``).

The JAX package maps one graph shard to one device of a ``shard_map``
mesh of axes ('slice', 'graph', 'feature').  Here a ``torch.distributed``
world of W ranks is one of two cases (``grid_of``):

* **W = 1**: the rank holds every one of the ``n_shards`` = S shards,
  every feature block and every slice; it runs no collective.  This is the
  case on one card, whatever ``feature_shards`` and ``slice_shards`` say.
* **W = L·Gr·F** (L = ``slice_shards``, F = ``feature_shards``, Gr
  dividing S): rank r = (s·Gr + g)·F + f, the JAX mesh's order (slice
  outermost, feature innermost).  It holds the S/Gr contiguous shards
  [g·S/Gr, (g+1)·S/Gr), the embedding rows of those shards, the f-th
  column block (d/F wide) of the table and of the encoder's weights, and
  the s-th stripe of the loss batch.

Any other W raises ``ValueError``.  ``make_mesh`` builds the subgroups
with ``dist.new_group``, every rank creating every group in one fixed
order (``group_members``): the **graph** group, the ranks of the same
(s, f) (the halo exchange, the ring, the row gathers, the sum of the
weights' gradients); the **feature** group, the same (s, g) (the column
gathers, ``l2_normalize``'s sum of squares); the **slice** group, the same
(g, f) (the gradient sum over the loss stripes); with ``halo_grouped`` at
Gr >= 4 also the **halo** groups, each graph group's two halves (the
grouped exchange, one KG's shards each).  A group of one rank is not
created and runs no collective; a group of the whole world is the default
group.

* The backend follows the device: NCCL for a CUDA device, gloo for the
  CPU.  Nothing falls back from one to the other.  NCCL allows one rank
  per device, so on one card W = 1 and that rank holds all S shards; on a
  box of L·Gr·F cards ``torchrun --nproc_per_node=<L·Gr·F>`` gives each
  rank its block.
* Under torchrun (``RANK`` and ``WORLD_SIZE`` set) ``make_mesh`` joins the
  group torchrun describes, on ``cuda:LOCAL_RANK``; without them it starts
  a world-size-1 group in this process on a ``HashStore``; inside a group
  the caller started (the multi-process tests), it uses that group.  A
  group it started, it destroys on leaving; the subgroups it made, too.
* ``shard_operator`` stacks the rank's shards' operators, builds the
  exchange lists and moves them to the rank's device
  (``dist/halo.py::HaloOperator``).
"""

from __future__ import annotations

import contextlib
import os
from collections.abc import Iterator
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from tpugraph_torch.sparse.halo_ell import exchange_ranks, rank_operators, send_transpose
from tpugraph_torch.sparse.partition import HaloGraph


def backend_for(device: torch.device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    if device.type == "cuda":
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"the distributed trainer runs on cuda or cpu, not {device}")


def shards_of(n_shards: int, world: int, rank: int) -> range:
    """The contiguous shards graph rank ``rank`` of ``world`` graph ranks
    owns."""
    if world < 1 or n_shards % world:
        raise ValueError(f"n_shards={n_shards} must be a multiple of the world size over "
                         f"slice_shards·feature_shards ({world}): every rank holds the same "
                         f"number of shards")
    per = n_shards // world
    return range(rank * per, (rank + 1) * per)


def grid_of(world: int, n_slice: int, n_shards: int, n_feature: int) -> tuple[int, int, int]:
    """The rank grid (L, Gr, F) of a world of ``world`` ranks: (1, 1, 1) at
    W = 1 (the rank holds every block); else W = L·Gr·F with Gr dividing
    ``n_shards``.  Any other W raises ``ValueError`` naming the rule."""
    if min(world, n_slice, n_shards, n_feature) < 1:
        raise ValueError(f"world={world}, slice_shards={n_slice}, n_shards={n_shards} and "
                         f"feature_shards={n_feature} must be >= 1")
    if world == 1:
        return 1, 1, 1
    n_graph, rest = divmod(world, n_slice * n_feature)
    if rest or n_shards % n_graph:
        raise ValueError(
            f"a world of {world} ranks must be 1 (one rank holding every block) or "
            f"slice_shards·G·feature_shards = {n_slice}·G·{n_feature} with G dividing "
            f"n_shards={n_shards}")
    return n_slice, n_graph, n_feature


def coords_of(rank: int, grid: tuple[int, int, int]) -> tuple[int, int, int]:
    """(s, g, f) of global rank ``rank``: rank = (s·Gr + g)·F + f."""
    _, n_graph, n_feature = grid
    return rank // (n_graph * n_feature), rank // n_feature % n_graph, rank % n_feature


def rank_of(s: int, g: int, f: int, grid: tuple[int, int, int]) -> int:
    """The global rank at (s, g, f)."""
    _, n_graph, n_feature = grid
    return (s * n_graph + g) * n_feature + f


def group_members(grid: tuple[int, int, int],
                  halo_grouped: bool = False) -> dict[str, list[list[int]]]:
    """Every group of each axis as its global ranks in axis order, the
    groups in the order ``make_mesh`` creates them: graph groups by (s, f),
    feature groups by (s, g), slice groups by (g, f); with ``halo_grouped``
    and Gr >= 4 also the halo groups, each graph group's two halves in
    turn (the grouped exchange's, one KG's shards each: the JAX
    ``axis_index_groups``).  At Gr <= 2 a rank holds whole KG halves and
    the grouped exchange needs no group."""
    n_slice, n_graph, n_feature = grid
    out = {
        "graph": [[rank_of(s, g, f, grid) for g in range(n_graph)]
                  for s in range(n_slice) for f in range(n_feature)],
        "feature": [[rank_of(s, g, f, grid) for f in range(n_feature)]
                    for s in range(n_slice) for g in range(n_graph)],
        "slice": [[rank_of(s, g, f, grid) for s in range(n_slice)]
                  for g in range(n_graph) for f in range(n_feature)],
    }
    if halo_grouped and n_graph > 2:
        if n_graph % 2:
            raise ValueError(f"halo_grouped splits the graph ranks into two halves: "
                             f"{n_graph} graph ranks do not split")
        half = n_graph // 2
        out["halo"] = [ranks[h * half:(h + 1) * half] for ranks in out["graph"] for h in (0, 1)]
    return out


@dataclass
class ShardMesh:
    """This rank's place in the grid: its shards, its feature block, its
    slice, its device and its subgroups (``groups[axis]``, absent for a
    group of one rank; ``members[axis]``: the group's global ranks in axis
    order)."""

    n_shards: int
    rank: int  # global
    world: int  # W
    device: torch.device
    n_slice: int = 1  # L of the grid: 1 where the rank holds every slice
    n_feature: int = 1  # F of the grid: 1 where the rank holds every column
    groups: dict = field(default_factory=dict)
    members: dict = field(default_factory=dict)

    @property
    def grid(self) -> tuple[int, int, int]:
        return self.n_slice, self.world // (self.n_slice * self.n_feature), self.n_feature

    @property
    def n_graph(self) -> int:
        """Gr: the ranks that split the shards."""
        return self.grid[1]

    @property
    def coords(self) -> tuple[int, int, int]:
        return coords_of(self.rank, self.grid)

    @property
    def slice_rank(self) -> int:
        return self.coords[0]

    @property
    def graph_rank(self) -> int:
        return self.coords[1]

    @property
    def feature_rank(self) -> int:
        return self.coords[2]

    @property
    def shards(self) -> range:
        return shards_of(self.n_shards, self.n_graph, self.graph_rank)

    @property
    def per_rank(self) -> int:
        return self.n_shards // self.n_graph

    def group(self, axis: str):
        """The process group of ``axis`` (None for a group of one rank)."""
        return self.groups.get(axis)

    def peer(self, axis: str, step: int) -> int:
        """The global rank ``step`` places after this one in its ``axis``
        group (cyclically)."""
        ranks = self.members[axis]
        return ranks[(ranks.index(self.rank) + step) % len(ranks)]


@contextlib.contextmanager
def make_mesh(n_shards: int, device: torch.device, n_feature: int = 1,
              n_slice: int = 1, halo_grouped: bool = False) -> Iterator[ShardMesh]:
    """The group of the run on ``device`` and its grid of subgroups (see
    the module docstring; ``halo_grouped``: the grouped exchange's halo
    groups too, ``group_members``)."""
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
    made = []
    try:
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()}, but a run on "
                             f"{device} needs {backend}")
        rank, world = dist.get_rank(), dist.get_world_size()
        grid = grid_of(world, n_slice, n_shards, n_feature)
        groups, members = {}, {}
        for axis, all_ranks in group_members(grid, halo_grouped).items():
            for ranks in all_ranks:
                if rank in ranks:
                    members[axis] = ranks
                if len(ranks) == 1:
                    continue
                if len(ranks) == world:  # the default group: no second communicator
                    group = dist.group.WORLD
                else:  # every rank creates every group, in this order
                    group = dist.new_group(ranks)
                    made.append(group)
                if rank in ranks:
                    groups[axis] = group
        yield ShardMesh(n_shards=n_shards, rank=rank, world=world, device=device,
                        n_slice=grid[0], n_feature=grid[2], groups=groups, members=members)
    finally:
        if started:
            dist.destroy_process_group()
        else:
            for g in made:
                dist.destroy_process_group(g)


def shard_operator(hg: HaloGraph, mesh: ShardMesh, impl: str, exchange: bool | None = None):
    """The rank's part of the halo SpMM on its device: its shards' local
    and boundary groups, each stacked into one operator (``impl`` "ell" or
    "sorted"; ``sparse/halo_ell.py::rank_operators``), and the exchange
    lists.  ``exchange`` (default: an exchange group of Q > 1 ranks,
    ``exchange_ranks``) builds the boundary over the exchange's receive
    buffers, which runs in the exchange group: the graph group, or under
    the grouped layout (``hg.n_groups == 2``) the rank's halo group;
    without it (Q = 1 only: Gr = 1, or Gr = 2 grouped, each rank holding
    one KG's shards) the boundary reads x's rows and no exchange runs."""
    from tpugraph_torch.dist.halo import HaloOperator

    if impl not in ("ell", "sorted"):
        raise ValueError(f"unknown halo impl {impl!r}; expected 'ell' or 'sorted'")
    n_peers = exchange_ranks(hg, mesh.per_rank)
    if exchange is None:
        exchange = n_peers > 1
    if not exchange and n_peers > 1:
        raise ValueError("a boundary over x's rows needs one rank holding every shard of its "
                         "exchange group")
    if exchange and n_peers == 1 and mesh.world > 1:
        raise ValueError("the exchange within one rank runs on a world of one rank only")
    group = None
    if exchange and n_peers > 1:
        group = mesh.group("graph" if hg.n_groups == 1 else "halo")
        if group is None:
            raise ValueError("the grouped exchange across ranks needs the mesh's halo groups "
                             "(make_mesh(..., halo_grouped=True))")
    loc, bnd = rank_operators(hg, mesh.shards, impl, direct=not exchange)
    sh = slice(mesh.shards.start, mesh.shards.stop)
    live, rows, send_t = send_transpose(hg.send_idx[sh], hg.send_mask[sh], hg.n_loc,
                                        first=mesh.shards.start)
    dev = mesh.device
    return HaloOperator(
        loc=loc.to(dev), bnd=None if bnd is None else bnd.to(dev), direct=not exchange,
        live=torch.from_numpy(live).to(dev), live_rows=torch.from_numpy(rows).to(dev),
        send_t=send_t.to(dev), per_rank=mesh.per_rank, n_loc=hg.n_loc, halo_b=hg.halo_b,
        has_halo=hg.has_halo, impl=impl, mesh=mesh, geometry=hg.geometry(),
        n_peers=n_peers, group=group)
