"""Adjacency construction: triples -> weighted COO -> normalized ELL or
sorted padded operator (counterpart of ``tpugraph/sparse/build.py``).

* undirected message edges from each relation triple (h, r, t): h->t, t->h;
* optional GCN-Align-style relation functionality weights ("funifun"):
  fun(r) = #distinct heads of r / #triples of r, ifun(r) likewise for tails;
  edge h->t accumulates ifun(r), edge t->h accumulates fun(r); duplicate
  entity pairs sum; weights floored at ``w_min``;
* self-loops with weight 1;
* degree normalization: 'sym' (D^-1/2 A D^-1/2), 'rw' (D^-1 A), or 'none'.

Runs on the host once per dataset, in float64 like the reference: the
numpy path's weights are bit-identical to the JAX package's numpy path,
and ``build_adjacency`` takes the native C++ builder (``native/``) first,
as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

from tpugraph_torch.sparse.graph import PAD_BUCKET, PaddedEdges, SpMMOperator, _round_up


def _funifun_weights(triples: np.ndarray, n_rel: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-relation (fun, ifun) statistics. Vectorized over triples."""
    r = triples[:, 1]
    counts = np.bincount(r, minlength=n_rel).astype(np.float64)
    # distinct (head, rel) and (tail, rel) pairs per relation
    hr = np.unique(triples[:, [0, 1]], axis=0)
    tr = np.unique(triples[:, [2, 1]], axis=0)
    n_heads = np.bincount(hr[:, 1], minlength=n_rel).astype(np.float64)
    n_tails = np.bincount(tr[:, 1], minlength=n_rel).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        fun = np.where(counts > 0, n_heads / counts, 0.0)
        ifun = np.where(counts > 0, n_tails / counts, 0.0)
    return fun, ifun


def coo_from_triples(
    n_ent: int,
    triples: np.ndarray,
    n_rel: int | None = None,
    weighting: str = "uniform",  # 'uniform' | 'funifun'
    w_min: float = 0.3,
    self_loops: bool = True,
    self_loop_w: float = 1.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build the merged message-passing adjacency as COO (src, dst, w).

    Duplicate (src, dst) pairs are accumulated by summation, then (for
    'funifun') floored at ``w_min``.  Returns deduplicated arrays.
    """
    triples = np.asarray(triples, dtype=np.int64)
    h, r, t = triples[:, 0], triples[:, 1], triples[:, 2]
    if weighting == "funifun":
        if n_rel is None:
            n_rel = int(r.max()) + 1 if len(r) else 0
        fun, ifun = _funifun_weights(triples, n_rel)
        w_ht = ifun[r]
        w_th = fun[r]
    elif weighting == "uniform":
        w_ht = np.ones(len(triples))
        w_th = np.ones(len(triples))
    else:
        raise ValueError(f"unknown weighting {weighting!r}")

    src = np.concatenate([h, t])
    dst = np.concatenate([t, h])
    w = np.concatenate([w_ht, w_th])

    # drop self-edges coming from reflexive triples; self-loops added uniformly
    keep = src != dst
    src, dst, w = src[keep], dst[keep], w[keep]

    # accumulate duplicates via a linear key
    key = dst * n_ent + src
    order = np.argsort(key, kind="stable")
    key, src, dst, w = key[order], src[order], dst[order], w[order]
    _, first_idx = np.unique(key, return_index=True)
    w_acc = np.add.reduceat(w, first_idx) if len(w) else w
    src, dst = src[first_idx], dst[first_idx]
    w = w_acc

    if weighting == "funifun":
        w = np.maximum(w, w_min)
    else:
        w = np.ones_like(w)  # uniform: dedup to weight 1 (binary adjacency)

    if self_loops:
        loops = np.arange(n_ent, dtype=np.int64)
        src = np.concatenate([src, loops])
        dst = np.concatenate([dst, loops])
        w = np.concatenate([w, np.full(n_ent, self_loop_w)])

    return src.astype(np.int64), dst.astype(np.int64), w.astype(np.float64)


def coo_normalize(
    src: np.ndarray, dst: np.ndarray, w: np.ndarray, n_ent: int, norm: str = "sym"
) -> np.ndarray:
    """Degree-normalize COO weights. Degree = incoming weighted degree."""
    if norm == "none":
        return w.copy()
    deg = np.bincount(dst, weights=w, minlength=n_ent)
    if norm == "rw":
        d_inv = np.where(deg > 0, 1.0 / deg, 0.0)
        return w * d_inv[dst]
    if norm == "sym":
        # use in- and out- weighted degrees for the two sides
        deg_out = np.bincount(src, weights=w, minlength=n_ent)
        di = np.where(deg > 0, 1.0 / np.sqrt(deg), 0.0)
        do = np.where(deg_out > 0, 1.0 / np.sqrt(deg_out), 0.0)
        return w * di[dst] * do[src]
    raise ValueError(f"unknown norm {norm!r}")


def pad_sort_edges(
    src: np.ndarray,
    dst: np.ndarray,
    w: np.ndarray,
    n_rows: int,
    bucket: int = PAD_BUCKET,
    sort_by: str = "dst",
    n_cols: int | None = None,
) -> PaddedEdges:
    """Sort edges by (dst, src) (or (src, dst)) and pad to a bucket
    multiple.  Padding edges: src=0, dst=n_rows (the dump row), w=0."""
    nnz = len(src)
    if sort_by == "dst":
        order = np.lexsort((src, dst))
    elif sort_by == "src":
        order = np.lexsort((dst, src))
    else:
        raise ValueError(sort_by)
    src, dst, w = src[order], dst[order], w[order]
    e_pad = max(_round_up(max(nnz, 1), bucket), bucket)
    pad = e_pad - nnz
    src_p = np.concatenate([src, np.zeros(pad, dtype=np.int64)])
    dst_p = np.concatenate([dst, np.full(pad, n_rows, dtype=np.int64)])
    w_p = np.concatenate([w, np.zeros(pad)])
    return PaddedEdges(
        src=torch.from_numpy(src_p.astype(np.int32)),
        dst=torch.from_numpy(dst_p.astype(np.int32)),
        w=torch.from_numpy(w_p.astype(np.float32)),
        n_rows=int(n_rows),
        nnz=int(nnz),
        n_cols=int(n_cols) if n_cols is not None else None,
    )


def build_spmm_operator(
    src: np.ndarray,
    dst: np.ndarray,
    w: np.ndarray,
    n_rows: int,
    bucket: int = PAD_BUCKET,
    n_cols: int | None = None,
) -> SpMMOperator:
    """A COO matrix as forward (A@x) and transpose (Aᵀ@g) sorted edge
    lists.  A rectangular A (n_rows × n_cols, e.g. the entity × attribute
    incidence) needs ``n_cols``: the transpose has that many output rows."""
    nc = n_cols if n_cols is not None else n_rows
    if len(src) and (int(np.max(src)) >= nc or int(np.min(src)) < 0):
        raise ValueError(
            f"build_spmm_operator: src ids span [{int(np.min(src))}, {int(np.max(src))}], "
            f"out of range for n_cols={nc} (rectangular matrix? pass n_cols explicitly)")
    fwd = pad_sort_edges(src, dst, w, n_rows, bucket, sort_by="dst", n_cols=nc)
    bwd = pad_sort_edges(dst, src, w, nc, bucket, sort_by="dst", n_cols=n_rows)
    return SpMMOperator(fwd=fwd, bwd=bwd)


def build_adjacency(
    n_ent: int,
    triples: np.ndarray,
    n_rel: int | None = None,
    weighting: str = "uniform",
    norm: str = "sym",
    self_loops: bool = True,
    w_min: float = 0.3,
    bucket: int = PAD_BUCKET,
    use_native: bool = True,
    fmt: str = "ell",
):
    """Full pipeline: triples -> weighted, normalized operator (host
    tensors; move it with ``.to(device)``).  The native C++ builder
    (``native/``) runs where a C++ compiler exists, else the numpy path.
    ``fmt`` selects the layout, which must match the layer's SpMM impl
    (``nn/graphconv.py::operator_format``): 'ell' -> EllOperator with the
    self-loops split out as the diagonal, 'sorted' -> SpMMOperator whose
    self-loops stay edges."""
    if fmt not in ("ell", "sorted"):
        raise ValueError(f"unknown fmt {fmt!r}; expected 'ell' or 'sorted'")
    out = None
    if use_native:
        from tpugraph_torch import native

        if native.available():
            out = native.native_coo_from_triples(
                n_ent, triples, n_rel=n_rel, weighting=weighting, w_min=w_min,
                self_loops=self_loops, norm=norm)
    if out is not None:
        src, dst, w = out
    else:
        src, dst, w = coo_from_triples(
            n_ent, triples, n_rel=n_rel, weighting=weighting, w_min=w_min,
            self_loops=self_loops,
        )
        w = coo_normalize(src, dst, w, n_ent, norm=norm)
    if fmt == "sorted":
        return build_spmm_operator(src, dst, w, n_ent, bucket=bucket)
    from tpugraph_torch.sparse.ell import build_ell_operator

    # self-loops (the diagonal) go through the gather-free diag vector
    return build_ell_operator(src, dst, w, n_ent, split_diag=self_loops)


def coo_to_dense(src, dst, w, n_rows, n_cols) -> np.ndarray:
    """Test oracle: the dense matrix, duplicates summed."""
    a = np.zeros((n_rows, n_cols))
    np.add.at(a, (dst, src), w)
    return a
