"""Per-shard operators of the edge-partitioned halo encoder (counterpart
of ``tpugraph/sparse/halo_ell.py``).

A ``HaloGraph`` (``sparse/partition.py``) becomes two ELL operators per
shard, each with its transpose for the backward:

* ``loc`` — the local edge group, (n_loc × n_loc) over the shard's own rows,
  its self-loops split out as the diagonal;
* ``bnd`` — the boundary group, (n_loc × G·B) over the received halo
  buffer; its transpose has G·B rows, most of them pad slots with no edge,
  which the kernel writes as 0.

The host layout is the JAX package's, array for array: every bucket is
stacked over shards with the shapes common to all of them (power-of-two
caps, each bucket as tall as its tallest shard; ``StackedEll``).  The
kernels take one shard at a time: ``StackedEll.shard`` cuts a shard's real
rows out of the stack into the port's ``EllMatrix`` (``sparse/ell.py``), so
each shard's ``spmm_ell`` launch walks only its own rows.

For ``spmm_impl="sorted"``, ``shard_edge_operators`` gives each shard's
local and boundary edge groups as ``SpMMOperator``s (``sparse/graph.py``):
the HaloGraph's own dst-sorted lists forward, re-sorted lists for the
transpose.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from tpugraph_torch.sparse.build import pad_sort_edges
from tpugraph_torch.sparse.ell import EllBucket, EllMatrix, EllOperator
from tpugraph_torch.sparse.graph import PaddedEdges, SpMMOperator
from tpugraph_torch.sparse.partition import HaloGraph


def _caps(max_deg: int) -> list[int]:
    """Power-of-two bucket caps, coarser than ``sparse/ell.py``'s exact
    small-degree buckets: every bucket is sized to its tallest shard, so
    finer buckets buy mostly empty buckets on some shards."""
    caps, k = [], 1
    while k < max_deg:
        caps.append(k)
        k *= 2
    caps.append(max(max_deg, 1))
    return caps


@dataclass
class StackedBucket:
    idx: np.ndarray  # (S, R, K) int32: source ids (pad: 0)
    w: np.ndarray  # (S, R, K) float32: weights (pad: 0.0)
    k: int
    rows: list[np.ndarray]  # per shard, the natural row ids of its first len(rows) rows


@dataclass
class StackedEll:
    """One ELL matrix per shard, stacked with common shapes (the JAX
    package's stacked ``EllMatrix``)."""

    buckets: list[StackedBucket]
    row_order: np.ndarray  # (S, n_rows) int32: row -> position in the concat; absent rows -> total
    n_rows: int
    nnz: int  # over all shards
    n_cols: int
    shard_nnz: list[int] = field(default_factory=list)

    def shard(self, s: int) -> EllMatrix:
        """Shard ``s``'s matrix as the port's ``EllMatrix`` on the host:
        its real rows only, in the stack's order."""
        buckets, rows = [], []
        for b in self.buckets:
            r = b.rows[s]
            if len(r):
                buckets.append(EllBucket(rows=torch.from_numpy(r.astype(np.int32)),
                                         idx=torch.from_numpy(b.idx[s, :len(r)].copy()),
                                         w=torch.from_numpy(b.w[s, :len(r)].copy()), k=b.k))
                rows.append(r)
        total = sum(len(r) for r in rows)
        row_order = np.full(self.n_rows, total, np.int32)
        if rows:
            row_order[np.concatenate(rows)] = np.arange(total, dtype=np.int32)
        return EllMatrix(buckets=buckets, row_order=torch.from_numpy(row_order),
                         n_rows=self.n_rows, nnz=self.shard_nnz[s], n_cols=self.n_cols)


@dataclass
class StackedOperator:
    """A stacked ``EllOperator``: A and Aᵀ, and with ``diag`` (S, n_rows)
    the split diagonal of a square A."""

    fwd: StackedEll
    bwd: StackedEll
    diag: np.ndarray | None = None
    n_diag: int = 0

    def shard(self, s: int) -> EllOperator:
        return EllOperator(fwd=self.fwd.shard(s), bwd=self.bwd.shard(s),
                           diag=None if self.diag is None else torch.from_numpy(self.diag[s]),
                           n_diag=0 if self.diag is None else int(np.count_nonzero(self.diag[s])))


def _build_stacked_ell(per_shard_edges, n_rows: int, n_cols: int | None = None) -> StackedEll:
    """per_shard_edges: a list of (src, dst, w) numpy triples, dst in
    [0, n_rows).  ``n_cols``: the x-row count the apply expects (per
    shard), checked against the src ids."""
    if n_cols is not None:
        mx = max((int(s.max()) for s, _, _ in per_shard_edges if len(s)), default=-1)
        if mx >= n_cols:
            raise ValueError(f"_build_stacked_ell: src id {mx} out of range for n_cols={n_cols}")
    n_sh = len(per_shard_edges)
    degs = [np.bincount(d, minlength=n_rows) for _, d, _ in per_shard_edges]
    caps = _caps(max(max((int(dg.max()) if dg.size else 0) for dg in degs), 1))
    members = []  # [cap][shard] -> row ids
    for i, cap in enumerate(caps):
        lo = caps[i - 1] if i > 0 else 0
        members.append([np.where((dg > lo) & (dg <= cap))[0] for dg in degs])
    keep = [i for i, m in enumerate(members) if any(len(r) for r in m)]
    caps, members = [caps[i] for i in keep], [members[i] for i in keep]

    offsets = np.cumsum([0] + [max(len(r) for r in m) for m in members])
    row_order = np.full((n_sh, n_rows), int(offsets[-1]), np.int64)  # default: the zero row
    buckets = []
    for bi, (cap, mem) in enumerate(zip(caps, members)):
        r_b = max(len(r) for r in mem)
        idx = np.zeros((n_sh, r_b, cap), np.int32)
        val = np.zeros((n_sh, r_b, cap), np.float32)
        for sh, rows in enumerate(mem):
            if len(rows) == 0:
                continue
            src, dst, w = per_shard_edges[sh]
            rpos = np.full(n_rows, -1, np.int64)
            rpos[rows] = np.arange(len(rows))
            sel = rpos[dst] >= 0
            order = np.argsort(dst[sel], kind="stable")
            ds, ss, ws = dst[sel][order], src[sel][order], w[sel][order]
            starts = np.concatenate([[0], np.cumsum(np.bincount(ds, minlength=n_rows))])
            pos = np.arange(len(ds)) - starts[ds]  # position within the row
            idx[sh, rpos[ds], pos] = ss
            val[sh, rpos[ds], pos] = ws
            row_order[sh, rows] = offsets[bi] + np.arange(len(rows))
        buckets.append(StackedBucket(idx=idx, w=val, k=int(cap), rows=mem))
    shard_nnz = [len(p[0]) for p in per_shard_edges]
    return StackedEll(buckets=buckets, row_order=row_order.astype(np.int32),
                      n_rows=int(n_rows), nnz=int(sum(shard_nnz)),
                      n_cols=int(n_cols if n_cols is not None else n_rows),
                      shard_nnz=shard_nnz)


def _extract(hg: HaloGraph, group: str) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Each shard's real edges of one group (the pad edges dropped)."""
    src, dst, w = (getattr(hg, f"{group}_{a}") for a in ("src", "dst", "w"))
    out = []
    for sh in range(hg.n_shards):
        real = dst[sh] < hg.n_loc
        out.append((src[sh][real].astype(np.int64), dst[sh][real].astype(np.int64),
                    w[sh][real].astype(np.float64)))
    return out


@dataclass
class HaloEll:
    """Every shard's ELL operators (stacked, on the host) and the exchange."""

    loc: StackedOperator
    bnd: StackedOperator
    send_idx: np.ndarray  # (S, G, B)
    send_mask: np.ndarray  # (S, G, B)
    n_shards: int
    n_loc: int
    halo_b: int
    nnz: int
    n_rows: int
    n_groups: int = 1
    has_halo: bool = True

    @property
    def group_size(self) -> int:
        return self.n_shards // self.n_groups


def build_halo_ell(hg: HaloGraph) -> HaloEll:
    loc_edges, bnd_edges = _extract(hg, "loc"), _extract(hg, "bnd")
    n_ext = hg.group_size * hg.halo_b  # the receive buffer: own-group rows only
    # the diagonal (self-loops, always shard-local) leaves the local group
    diag = np.zeros((hg.n_shards, hg.n_loc), np.float32)
    loc_off, n_diag = [], 0
    for sh, (s_, d_, w_) in enumerate(loc_edges):
        on_d = s_ == d_
        np.add.at(diag[sh], d_[on_d], w_[on_d])
        n_diag += int(on_d.sum())
        loc_off.append((s_[~on_d], d_[~on_d], w_[~on_d]))
    loc = StackedOperator(
        fwd=_build_stacked_ell(loc_off, hg.n_loc, n_cols=hg.n_loc),
        bwd=_build_stacked_ell([(d, s, w) for s, d, w in loc_off], hg.n_loc, n_cols=hg.n_loc),
        diag=diag, n_diag=n_diag)
    bnd = StackedOperator(
        fwd=_build_stacked_ell(bnd_edges, hg.n_loc, n_cols=n_ext),
        bwd=_build_stacked_ell([(d, s, w) for s, d, w in bnd_edges], n_ext, n_cols=hg.n_loc))
    return HaloEll(loc=loc, bnd=bnd, send_idx=hg.send_idx, send_mask=hg.send_mask,
                   n_shards=hg.n_shards, n_loc=hg.n_loc, halo_b=hg.halo_b, nnz=hg.nnz,
                   n_rows=hg.n_rows, n_groups=hg.n_groups, has_halo=hg.has_halo)


def build_attr_incidence_ell(attr_triples: np.ndarray, n_ent: int, n_attr: int,
                             n_shards: int, n_loc: int) -> StackedOperator:
    """The entity × attribute incidence of the attribute channel,
    edge-partitioned by entity row as ``partition_edges`` partitions the
    graph: per shard (n_loc × n_attr) forward, (n_attr × n_loc) transpose.
    Weights 1/deg with the degree over all shards, duplicate (entity,
    attribute) pairs counted once, as ``models/attr_channel.py`` builds
    the single-device operator.  (The distributed trainer refuses the
    attribute channel for now, ROADMAP.md; the builder is held to the JAX
    one.)"""
    ent = attr_triples[:, 0].astype(np.int64)
    att = attr_triples[:, 1].astype(np.int64)
    uniq = np.unique(ent * n_attr + att)
    ent, att = uniq // n_attr, uniq % n_attr
    deg = np.bincount(ent, minlength=n_ent).astype(np.float64)
    w = 1.0 / deg[ent]
    owner = np.minimum(ent // n_loc, n_shards - 1)
    fwd_parts, bwd_parts = [], []
    for s in range(n_shards):
        sel = owner == s
        a_s, e_s, w_s = att[sel], ent[sel] - s * n_loc, w[sel]
        fwd_parts.append((a_s, e_s, w_s))
        bwd_parts.append((e_s, a_s, w_s))
    return StackedOperator(fwd=_build_stacked_ell(fwd_parts, n_loc, n_cols=n_attr),
                           bwd=_build_stacked_ell(bwd_parts, n_attr, n_cols=n_loc))


def _group_edges(hg: HaloGraph, group: str, s: int, n_cols: int,
                 pad_to: int) -> SpMMOperator:
    """Shard ``s``'s edge group as a sorted operator: the HaloGraph's
    dst-sorted list (pad edges at the dump row n_loc) forward, the same
    edges sorted by source for the transpose."""
    src, dst, w = (getattr(hg, f"{group}_{a}")[s] for a in ("src", "dst", "w"))
    nnz = int((dst < hg.n_loc).sum())
    fwd = PaddedEdges(src=torch.from_numpy(src.copy()), dst=torch.from_numpy(dst.copy()),
                      w=torch.from_numpy(w.copy()), n_rows=hg.n_loc, nnz=nnz, n_cols=n_cols)
    bwd = pad_sort_edges(dst[:nnz].astype(np.int64), src[:nnz].astype(np.int64),
                         w[:nnz].astype(np.float64), n_cols, bucket=pad_to, n_cols=hg.n_loc)
    return SpMMOperator(fwd=fwd, bwd=bwd)


def shard_edge_operators(hg: HaloGraph, s: int,
                         pad_to: int = 1024) -> tuple[SpMMOperator, SpMMOperator]:
    """(local, boundary) sorted operators of shard ``s`` on the host, for
    ``spmm_impl="sorted"``: n_loc × n_loc and n_loc × G·B, with their
    transposes."""
    return (_group_edges(hg, "loc", s, hg.n_loc, pad_to),
            _group_edges(hg, "bnd", s, hg.group_size * hg.halo_b, pad_to))
