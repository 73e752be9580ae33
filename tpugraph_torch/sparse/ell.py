"""Degree-bucketed ELLPACK edge layout (counterpart of
``tpugraph/sparse/ell.py``).

* rows are bucketed by degree: exact buckets for K = 1..8, powers of two
  above, and the maximum degree last;
* each bucket stores its edges as (R, K) index/weight matrices (padding
  slots point at row 0 with weight 0) plus the R natural row ids it covers;
* ``row_order`` maps each natural row to its position in the concatenated
  bucket outputs; rows of degree 0 point one past the end (the appliers'
  zero row).

Built once on the host in numpy, then held as torch tensors that move with
``.to(device)``.  The fused GCN kernel (``kernels/gcn_fused.py``) writes
through each bucket's ``rows`` directly, so they are kept on device too.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class EllBucket:
    rows: torch.Tensor  # (R,) int32 — natural row ids of this bucket
    idx: torch.Tensor  # (R, K) int32 — source ids (pad: 0)
    w: torch.Tensor  # (R, K) float32 — edge weights (pad: 0.0)
    k: int

    def to(self, device) -> "EllBucket":
        return EllBucket(rows=self.rows.to(device), idx=self.idx.to(device),
                         w=self.w.to(device), k=self.k)


@dataclass
class EllMatrix:
    """Degree-bucketed ELL matrix; rows with degree 0 are absent from every
    bucket (their aggregate is zero)."""

    buckets: list[EllBucket]
    row_order: torch.Tensor  # (N,) int32: natural row id -> position in concat output
    n_rows: int
    nnz: int
    n_cols: int
    # derived per-kernel layouts (kernels/gcn_fused.py plan), built at first
    # use on this matrix's device; a moved copy starts empty
    cache: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def padded_edges(self) -> int:
        return sum(int(b.idx.numel()) for b in self.buckets)

    @property
    def device(self) -> torch.device:
        return self.row_order.device

    def to(self, device) -> "EllMatrix":
        return EllMatrix(buckets=[b.to(device) for b in self.buckets],
                         row_order=self.row_order.to(device),
                         n_rows=self.n_rows, nnz=self.nnz, n_cols=self.n_cols)


def _bucket_caps(max_deg: int) -> list[int]:
    """Exact-degree buckets for small degrees (zero padding where most rows
    live — KG degree distributions are bottom-heavy), power-of-two above."""
    caps = [k for k in range(1, 9) if k <= max_deg]
    k = 16
    while k < max_deg:
        caps.append(k)
        k *= 2
    if not caps or caps[-1] < max_deg:
        caps.append(max(max_deg, 1))
    return caps


def build_ell(
    src: np.ndarray, dst: np.ndarray, w: np.ndarray, n_rows: int,
    n_cols: int | None = None,
) -> EllMatrix:
    """COO (any order) -> degree-bucketed ELL. Vectorized host-side numpy.

    ``n_cols`` (the x-row count A applies to; defaults to n_rows) is checked
    against the src ids here: a CUDA gather reads out of bounds on a bad id
    where ``jnp.take`` would clamp, so a mis-sized build must fail on the
    host."""
    nnz = len(src)
    if n_cols is None:
        n_cols = n_rows
    if nnz and (int(src.max()) >= n_cols or int(src.min()) < 0):
        raise ValueError(
            f"build_ell: src ids span [{int(src.min())}, {int(src.max())}], "
            f"out of range for n_cols={n_cols} (rectangular matrix? pass "
            f"n_cols explicitly)")
    order = np.argsort(dst, kind="stable")
    src_s, dst_s, w_s = src[order], dst[order], w[order]
    deg = np.bincount(dst_s, minlength=n_rows)
    starts = np.concatenate([[0], np.cumsum(deg)])
    # position of each edge within its row
    pos = np.arange(nnz) - starts[dst_s]

    buckets = []
    out_rows = []
    max_deg = int(deg.max()) if nnz else 1
    caps = _bucket_caps(max_deg)
    for i, cap in enumerate(caps):
        lo = caps[i - 1] if i > 0 else 0
        rows = np.where((deg > lo) & (deg <= cap))[0]
        if len(rows) == 0:
            continue
        rpos = np.full(n_rows, -1, dtype=np.int64)
        rpos[rows] = np.arange(len(rows))
        mask = rpos[dst_s] >= 0
        idx = np.zeros((len(rows), cap), np.int32)
        val = np.zeros((len(rows), cap), np.float32)
        idx[rpos[dst_s[mask]], pos[mask]] = src_s[mask]
        val[rpos[dst_s[mask]], pos[mask]] = w_s[mask]
        buckets.append(EllBucket(rows=torch.from_numpy(rows.astype(np.int32)),
                                 idx=torch.from_numpy(idx),
                                 w=torch.from_numpy(val), k=int(cap)))
        out_rows.append(rows)
    # rows with degree 0 point at the applier's trailing zero row
    concat_rows = (
        np.concatenate(out_rows) if out_rows else np.zeros(0, np.int64)
    )
    total = sum(len(r) for r in out_rows)
    row_order = np.full(n_rows, total, np.int64)  # default: the zero row
    row_order[concat_rows] = np.arange(total)
    return EllMatrix(
        buckets=buckets,
        row_order=torch.from_numpy(row_order.astype(np.int32)),
        n_rows=int(n_rows),
        nnz=int(nnz),
        n_cols=int(n_cols),
    )


@dataclass
class EllOperator:
    """Forward (A) and transpose (Aᵀ) ELL matrices.

    ``diag`` (square A only): the matrix diagonal split out of both ELLs —
    self-loop edges need no gather.  ``n_diag`` counts the edges carried by
    ``diag`` so ``nnz`` still reports the full logical edge count.
    """

    fwd: EllMatrix
    bwd: EllMatrix
    diag: torch.Tensor | None = None  # (n_rows,) float32, or None
    n_diag: int = 0

    @property
    def n_rows(self) -> int:
        return self.fwd.n_rows

    @property
    def nnz(self) -> int:
        return self.fwd.nnz + self.n_diag

    def to(self, device) -> "EllOperator":
        return EllOperator(fwd=self.fwd.to(device), bwd=self.bwd.to(device),
                           diag=None if self.diag is None else self.diag.to(device),
                           n_diag=self.n_diag)


def build_ell_operator(
    src: np.ndarray,
    dst: np.ndarray,
    w: np.ndarray,
    n_rows: int,
    n_cols: int | None = None,
    split_diag: bool = False,
) -> EllOperator:
    """``n_cols`` (rectangular A): the transpose ELL has n_cols output rows.

    ``split_diag`` (square A only) routes diagonal entries through the
    gather-free ``diag`` vector instead of the ELL buckets."""
    if split_diag:
        if n_cols is not None and n_cols != n_rows:
            raise ValueError("split_diag requires a square matrix")
        on_diag = src == dst
        d = np.zeros(n_rows)
        np.add.at(d, src[on_diag], w[on_diag])
        src, dst, w = src[~on_diag], dst[~on_diag], w[~on_diag]
        return EllOperator(
            fwd=build_ell(src, dst, w, n_rows),
            bwd=build_ell(dst, src, w, n_rows),
            diag=torch.from_numpy(d.astype(np.float32)),
            n_diag=int(on_diag.sum()),
        )
    nc = n_cols if n_cols is not None else n_rows
    return EllOperator(
        fwd=build_ell(src, dst, w, n_rows, n_cols=nc),
        bwd=build_ell(dst, src, w, nc, n_cols=n_rows),
    )
