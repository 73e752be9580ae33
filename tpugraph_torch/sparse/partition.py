"""Edge partitioner of the distributed trainer (counterpart of
``tpugraph/sparse/partition.py``).

Contiguous entity-range partition over ``n_shards`` graph shards:

* shard s owns entity rows [s·n_loc, (s+1)·n_loc) and every edge whose
  destination it owns, so aggregation is shard-local;
* the embedding table is split by entity id the same way;
* the source rows a shard does not own (its halo) arrive by one exchange
  before aggregation: shard o sends x_local[send_idx[o, s]] to shard s;
* each shard's edges are split into a LOCAL group (source owned by the
  shard) and a BOUNDARY group (source in the received halo buffer), so the
  local aggregation does not wait for the exchange.

Shapes are common across shards: per-shard edge counts padded to the most
over shards (each group apart), the halo block B to the most any
(sender, receiver) pair needs.  Local-group src is a local row id in
[0, n_loc); boundary-group src indexes the flattened receive buffer
[0, G·B) as owner-rank-within-group·B + slot (G = exchange-group size,
``n_shards`` when ungrouped); dst is a local row id in both groups, and a
pad edge points at the extra row n_loc, which the aggregators drop.

Host numpy only, the arrays equal to the JAX package's array for array;
``sparse/halo_ell.py`` and ``dist/mesh.py`` turn them into each shard's
operators on its device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class HaloGraph:
    """Stacked per-shard arrays, leading axis = n_shards (host numpy)."""

    # local edge group (src owned by the same shard), sorted by dst
    loc_src: np.ndarray  # (S, E_loc) int32: local row of the source
    loc_dst: np.ndarray  # (S, E_loc) int32: local dst row; pad = n_loc
    loc_w: np.ndarray  # (S, E_loc) float32
    # boundary edge group (src arrives by the halo exchange), sorted by dst
    bnd_src: np.ndarray  # (S, E_bnd) int32: index into the receive buffer [0, G·B)
    bnd_dst: np.ndarray  # (S, E_bnd) int32: local dst row; pad = n_loc
    bnd_w: np.ndarray  # (S, E_bnd) float32
    # the exchange's index lists: G = n_shards // n_groups members per group
    send_idx: np.ndarray  # (S, G, B) int32: local rows shard s sends to the
    #                       j-th member of its own group
    send_mask: np.ndarray  # (S, G, B) float32: 1.0 for real entries, 0.0 pad
    n_shards: int
    n_loc: int
    halo_b: int
    nnz: int
    n_rows: int  # the unpadded N
    n_groups: int = 1
    # False when no shard needs a remote row (n_shards = 1, or a partition
    # along the components): the encoder then skips the exchange and the
    # boundary aggregation, whose buffers would hold only padding
    has_halo: bool = True

    @property
    def group_size(self) -> int:
        return self.n_shards // self.n_groups

    def geometry(self) -> dict:
        """The partition's shapes: rows per shard, the halo block, the
        padded edge counts, and per shard its real local and boundary
        edges and the halo rows it receives."""
        return {"n_shards": self.n_shards, "n_loc": self.n_loc, "halo_b": self.halo_b,
                "e_loc_padded": int(self.loc_src.shape[1]),
                "e_bnd_padded": int(self.bnd_src.shape[1]), "nnz": self.nnz,
                "loc_edges": (self.loc_dst < self.n_loc).sum(1).tolist(),
                "bnd_edges": (self.bnd_dst < self.n_loc).sum(1).tolist(),
                "halo_rows": self.send_mask.sum((0, 2)).astype(int).tolist()}


def partition_edges(src: np.ndarray, dst: np.ndarray, w: np.ndarray, n_rows: int,
                    n_shards: int, pad_edges_to: int = 1024, pad_halo_to: int = 256,
                    n_groups: int = 1) -> HaloGraph:
    """COO (any order) -> HaloGraph; see the module docstring for the layout.

    ``n_groups > 1``: the component-grouped exchange, shards split into
    ``n_groups`` contiguous groups that exchange only within themselves
    (the JAX package's ``halo_grouped``); an edge across two groups raises.
    The distributed trainer refuses ``halo_grouped`` for now (ROADMAP.md),
    but the builder is held to the JAX one for both layouts."""
    if n_shards % n_groups:
        raise ValueError(f"n_groups={n_groups} must divide n_shards={n_shards}")
    g_size = n_shards // n_groups
    n_loc = _round_up(n_rows, n_shards) // n_shards
    owner_dst = np.minimum(dst // n_loc, n_shards - 1)
    owner_src = np.minimum(src // n_loc, n_shards - 1)
    if n_groups > 1:
        bad = (owner_dst // g_size) != (owner_src // g_size)
        if bad.any():
            i = int(np.argmax(bad))
            raise ValueError(
                f"grouped halo exchange requires a component-aligned partition, but edge "
                f"{int(src[i])}->{int(dst[i])} crosses shard groups "
                f"{int(owner_src[i]) // g_size}->{int(owner_dst[i]) // g_size}")

    loc_parts, bnd_parts, recv_maps = [], [], []
    for s in range(n_shards):
        mine = owner_dst == s
        e_src, e_dst, e_w, e_own = src[mine], dst[mine], w[mine], owner_src[mine]
        local = e_own == s
        loc_parts.append((e_src[local] - s * n_loc, e_dst[local] - s * n_loc, e_w[local]))
        # boundary group: the remote rows needed from each owner shard
        b_src, b_dst, b_w, b_own = e_src[~local], e_dst[~local], e_w[~local], e_own[~local]
        slots = np.empty(len(b_src), np.int64)
        needed = {}
        for o in range(n_shards):
            sel = b_own == o
            uniq, inv = np.unique(b_src[sel], return_inverse=True)
            needed[o] = uniq
            slots[sel] = inv  # position within the owner's block
        recv_maps.append(needed)
        bnd_parts.append((b_dst - s * n_loc, b_w, b_own, slots))

    halo_b = max([1] + [len(u) for m in recv_maps for u in m.values()])
    halo_b = _round_up(halo_b, pad_halo_to)
    send_idx = np.zeros((n_shards, g_size, halo_b), np.int32)
    send_mask = np.zeros((n_shards, g_size, halo_b), np.float32)
    for s in range(n_shards):  # receiver
        for o, uniq in recv_maps[s].items():  # sender
            if len(uniq):
                # the sender addresses the receiver by its rank within the group
                send_idx[o, s % g_size, :len(uniq)] = (uniq - o * n_loc).astype(np.int32)
                send_mask[o, s % g_size, :len(uniq)] = 1.0

    def e_max(parts):
        return max(_round_up(max((len(p[0]) for p in parts), default=1), pad_edges_to),
                   pad_edges_to)

    def pack(parts, n_edges, boundary):
        a_src = np.zeros((n_shards, n_edges), np.int32)
        a_dst = np.full((n_shards, n_edges), n_loc, np.int32)
        a_w = np.zeros((n_shards, n_edges), np.float32)
        for s, p in enumerate(parts):
            if boundary:
                p_dst, p_w, p_own, p_slots = p
                # the receive buffer is laid out [owner-rank-within-group, slot]
                p_src = (p_own % g_size) * halo_b + p_slots
            else:
                p_src, p_dst, p_w = p
            order = np.argsort(p_dst, kind="stable")
            k = len(p_dst)
            a_src[s, :k] = p_src[order]
            a_dst[s, :k] = p_dst[order]
            a_w[s, :k] = p_w[order]
        return a_src, a_dst, a_w

    l_src, l_dst, l_w = pack(loc_parts, e_max(loc_parts), boundary=False)
    b_src, b_dst, b_w = pack(bnd_parts, e_max(bnd_parts), boundary=True)
    return HaloGraph(loc_src=l_src, loc_dst=l_dst, loc_w=l_w,
                     bnd_src=b_src, bnd_dst=b_dst, bnd_w=b_w,
                     send_idx=send_idx, send_mask=send_mask,
                     n_shards=int(n_shards), n_loc=int(n_loc), halo_b=int(halo_b),
                     nnz=int(len(src)), n_rows=int(n_rows), n_groups=int(n_groups),
                     has_halo=bool(send_mask.any()))
