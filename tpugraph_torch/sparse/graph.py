"""Host-side KG containers and the sorted padded edge operator
(counterpart of ``tpugraph/sparse/graph.py``).

The KGs and alignment pairs are plain numpy dataclasses on the host; only
an operator built from them goes to the device: the degree-bucketed ELL
(``sparse/ell.py``) or, for ``spmm_impl`` ``sorted``/``xla``,
``SpMMOperator`` below, whose tensors move with ``.to(device)``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

PAD_BUCKET = 8192  # edges padded up to a multiple of this (the JAX package's)


@dataclass
class KG:
    """One knowledge graph: relation triples + optional attribute triples."""

    n_ent: int
    n_rel: int
    triples: np.ndarray  # (T, 3) int32 rows [head, rel, tail]
    attr_triples: np.ndarray | None = None  # (Ta, 2) int32 rows [ent, attr]
    n_attr: int = 0

    def __post_init__(self):
        self.triples = np.asarray(self.triples, dtype=np.int32)
        if self.triples.ndim != 2 or self.triples.shape[1] != 3:
            raise ValueError(f"triples must be (T,3), got {self.triples.shape}")
        if self.attr_triples is not None:
            self.attr_triples = np.asarray(self.attr_triples, dtype=np.int32)


@dataclass
class AlignTask:
    """A cross-KG entity-alignment task (the DBP15K/DWY100K shape).

    The two KGs are merged into one graph over the union entity set: kg2
    entity ids are offset by ``kg1.n_ent`` and kg2 relation ids by
    ``kg1.n_rel``.  Alignment pairs hold *global* (merged) ids in column 0
    (left/kg1) and column 1 (right/kg2).
    """

    kg1: KG
    kg2: KG
    train_pairs: np.ndarray  # (S, 2) int32 global ids
    test_pairs: np.ndarray  # (S', 2) int32 global ids
    name: str = "unnamed"

    def __post_init__(self):
        self.train_pairs = np.asarray(self.train_pairs, dtype=np.int32)
        self.test_pairs = np.asarray(self.test_pairs, dtype=np.int32)

    @property
    def n_ent(self) -> int:
        return self.kg1.n_ent + self.kg2.n_ent

    @property
    def n_rel(self) -> int:
        return self.kg1.n_rel + self.kg2.n_rel

    @property
    def n_attr(self) -> int:
        return max(self.kg1.n_attr, self.kg2.n_attr)

    @property
    def merged_triples(self) -> np.ndarray:
        """All relation triples in global ids, (T1+T2, 3)."""
        t2 = self.kg2.triples.copy()
        t2[:, 0] += self.kg1.n_ent
        t2[:, 2] += self.kg1.n_ent
        t2[:, 1] += self.kg1.n_rel
        return np.concatenate([self.kg1.triples, t2], axis=0)

    @property
    def merged_attr_triples(self) -> np.ndarray | None:
        """Attribute triples in global entity ids (attr vocab shared)."""
        parts = []
        if self.kg1.attr_triples is not None:
            parts.append(self.kg1.attr_triples)
        if self.kg2.attr_triples is not None:
            a2 = self.kg2.attr_triples.copy()
            a2[:, 0] += self.kg1.n_ent
            parts.append(a2)
        if not parts:
            return None
        return np.concatenate(parts, axis=0)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class PaddedEdges:
    """An edge list sorted by (dst, src) and padded to a bucket multiple.

    ``out = index_add(w[:, None] * x[src], dst)`` over ``n_rows + 1`` rows
    computes A @ x in rows [0, n_rows); row ``n_rows`` is the padding dump
    row, dropped by the consumer.  Padding edges have ``w == 0``,
    ``src == 0`` and ``dst == n_rows``.  The dst non-decreasing order is
    the builder's contract (``sparse/build.py::pad_sort_edges``)."""

    src: torch.Tensor  # (E_pad,) int32
    dst: torch.Tensor  # (E_pad,) int32, non-decreasing; padding uses n_rows
    w: torch.Tensor  # (E_pad,) float32
    n_rows: int
    nnz: int  # true edge count (pre-pad)
    n_cols: int | None = None  # the x-row count the gather expects
    # derived kernel layouts (kernels/spmm.py::segment_plan), built at first
    # use on this list's device; a moved copy starts empty
    cache: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def e_pad(self) -> int:
        return self.src.shape[0]

    @property
    def device(self) -> torch.device:
        return self.src.device

    def to(self, device) -> "PaddedEdges":
        return PaddedEdges(src=self.src.to(device), dst=self.dst.to(device),
                           w=self.w.to(device), n_rows=self.n_rows, nnz=self.nnz,
                           n_cols=self.n_cols)


@dataclass
class SpMMOperator:
    """A sparse matrix A for the sorted SpMM: ``fwd`` holds A's edges
    sorted by destination row, ``bwd`` the same edges re-sorted for Aᵀ, so
    the backward is another sorted-segment SpMM, not a scatter."""

    fwd: PaddedEdges
    bwd: PaddedEdges

    @property
    def n_rows(self) -> int:
        return self.fwd.n_rows

    @property
    def nnz(self) -> int:
        return self.fwd.nnz

    def to(self, device) -> "SpMMOperator":
        return SpMMOperator(fwd=self.fwd.to(device), bwd=self.bwd.to(device))
