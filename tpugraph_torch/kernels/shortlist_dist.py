"""Gathered shortlist distances: the exact rerank that the approximate
search paths share.

    out[i, j] = Σ_c f(q[i, c] − table[idx[i, j], c]),
    f = |·| (``metric="cityblock"``) or (·)² (``"sqeuclidean"``)

q (S, d) float32, table (C, d) float32, idx (S, K) int64 in [0, C),
out (S, K) float32.  The JAX package has no Pallas kernel here: its
approximate paths gather each query's shortlisted rows into a
(block_q, K, d) tensor and reduce it, as XLA ops
(``tpugraph/train/negatives.py:179-180`` and ``:261-262``,
``train/bootstrap.py:132-137``, ``train/eval.py:158-159``,
``serve.py:87-88``).

* ``shortlist_dist`` — on a CUDA tensor one launch of the hand-written
  Hopper kernel ``csrc/shortlist_dist.cu``, which never stores the
  gathered rows; on a CPU tensor the plain version.  It never falls back
  from the card.
* ``shortlist_dist_plain`` — the plain version: gathers a block of queries
  at a time (at most ``PLAIN_BLOCK_ELEMS`` gathered values) and applies
  ``train/losses.py::pairwise_l1`` or the squared form.
"""

from __future__ import annotations

import ctypes

import torch

from tpugraph_torch.kernels import _build
from tpugraph_torch.train.losses import pairwise_l1

METRICS = ("cityblock", "sqeuclidean")
PLAIN_BLOCK_ELEMS = 1 << 26  # 256 MB of fp32 per gathered (rows, K, d) block

# kernel launches since the process started (or the caller last reset it)
launches = 0


def check_metric(metric: str) -> None:
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; expected one of {METRICS}")


def shortlist_dist_plain(q: torch.Tensor, table: torch.Tensor, idx: torch.Tensor,
                         metric: str = "cityblock") -> torch.Tensor:
    """The plain version: a block of queries' shortlisted rows gathered
    into a (rows, K, d) tensor, then the L1 or squared distance to the
    query, in float32."""
    check_metric(metric)
    s, k = idx.shape
    out = torch.empty((s, k), dtype=torch.float32, device=q.device)
    rows = max(1, PLAIN_BLOCK_ELEMS // max(1, k * q.shape[1]))
    for r0 in range(0, s, rows):
        a, g = q[r0:r0 + rows, None, :], table[idx[r0:r0 + rows]]
        if metric == "cityblock":
            out[r0:r0 + rows] = pairwise_l1(a, g).float()
        else:
            diff = a.float() - g.float()
            out[r0:r0 + rows] = (diff * diff).sum(-1)
    return out


def _lib():
    fn = _build.load("shortlist_dist").shortlist_dist_forward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, table: torch.Tensor, idx: torch.Tensor) -> None:
    if q.dim() != 2 or table.dim() != 2 or q.shape[1] != table.shape[1]:
        raise ValueError(f"q (S, d) and table (C, d) must share d, got {tuple(q.shape)}, "
                         f"{tuple(table.shape)}")
    if idx.dim() != 2 or idx.shape[0] != q.shape[0]:
        raise ValueError(f"idx must be (S, K) with S = {q.shape[0]}, got {tuple(idx.shape)}")
    for name, t, dtype in (("q", q, torch.float32), ("table", table, torch.float32),
                           ("idx", idx, torch.int64)):
        if t.dtype != dtype:
            raise TypeError(f"the shortlist kernel takes {name} as {dtype}, got {t.dtype}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous and on {q.device}")


def shortlist_dist(q: torch.Tensor, table: torch.Tensor, idx: torch.Tensor,
                   metric: str = "cityblock") -> torch.Tensor:
    """(S, K) distances of each query to its shortlisted table rows: the
    kernel on a CUDA tensor, ``shortlist_dist_plain`` on a CPU tensor."""
    check_metric(metric)
    if q.device.type == "cpu":
        return shortlist_dist_plain(q, table, idx, metric)
    if q.device.type != "cuda":
        raise ValueError(f"shortlist_dist runs on cuda or cpu, not {q.device}")
    _check(q, table, idx)
    s, k = idx.shape
    out = torch.empty((s, k), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    err = _lib()(q.data_ptr(), table.data_ptr(), idx.data_ptr(), out.data_ptr(), s, k,
                 q.shape[1], int(metric == "sqeuclidean"),
                 torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"shortlist_dist launch failed with CUDA error {err}")
    global launches
    launches += 1
    return out
