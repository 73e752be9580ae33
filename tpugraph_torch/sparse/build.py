"""Adjacency construction: triples -> weighted COO -> normalized ELL
operator (counterpart of ``tpugraph/sparse/build.py``, numpy path).

* undirected message edges from each relation triple (h, r, t): h->t, t->h;
* optional GCN-Align-style relation functionality weights ("funifun"):
  fun(r) = #distinct heads of r / #triples of r, ifun(r) likewise for tails;
  edge h->t accumulates ifun(r), edge t->h accumulates fun(r); duplicate
  entity pairs sum; weights floored at ``w_min``;
* self-loops with weight 1;
* degree normalization: 'sym' (D^-1/2 A D^-1/2), 'rw' (D^-1 A), or 'none'.

Runs on the host once per dataset, in float64 like the reference, so the
weights are bit-identical to the JAX package's numpy path.
"""

from __future__ import annotations

import numpy as np


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


def build_adjacency(
    n_ent: int,
    triples: np.ndarray,
    n_rel: int | None = None,
    weighting: str = "uniform",
    norm: str = "sym",
    self_loops: bool = True,
    w_min: float = 0.3,
    fmt: str = "ell",
):
    """Full pipeline: triples -> weighted, normalized ELL operator (host
    tensors; move it with ``.to(device)``).  Only ``fmt='ell'`` is ported:
    the sorted-COO layout waits for the ``sorted`` SpMM impl."""
    if fmt != "ell":
        raise NotImplementedError(f"fmt={fmt!r} is not ported yet (only 'ell')")
    from tpugraph_torch.sparse.ell import build_ell_operator

    src, dst, w = coo_from_triples(
        n_ent, triples, n_rel=n_rel, weighting=weighting, w_min=w_min,
        self_loops=self_loops,
    )
    w = coo_normalize(src, dst, w, n_ent, norm=norm)
    # self-loops (the diagonal) go through the gather-free diag vector
    return build_ell_operator(src, dst, w, n_ent, split_diag=self_loops)
