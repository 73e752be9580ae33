"""Host-side KG containers (counterpart of ``tpugraph/sparse/graph.py``).

Plain numpy dataclasses: the KGs and alignment pairs live on the host; only
the operator built from them (``sparse/ell.py``) goes to the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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
