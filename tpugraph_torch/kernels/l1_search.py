"""The exact L1 search that mining, proposals, the CSLS eval, serving and
the ring's exact stages share.  For queries q (Q, d) against candidates
(C, d), both float32,

    d(i, j) = Σ_c |q[i, c] − cands[j, c]|
    s(i, j) = a·d(i, j) − bias[j]          (a = 1, no bias: raw L1; a = 2, bias r: CSLS)
    s(i, j) = +inf where col_mask[j] is false or j == exclude[i]

The JAX package runs this as XLA ops over blockwise L1 tiles
(``tpugraph/train/negatives.py:45``, ``train/bootstrap.py:26``,
``train/eval.py:25`` and ``:84``, ``serve.py:105``, ``dist/ring.py:40``,
``:258`` and ``:285``).

* ``l1_topk`` — (vals, idx), each (Q, k): per row the k least (s, column),
  ascending, ties to the lower column (``lax.top_k``'s and ``argmin``'s
  order); a masked column keeps its place at +inf, so a row with fewer than
  k eligible columns ends with masked ones, lowest column first; a NaN
  score (a diverged table) counts as +inf.  On a CUDA tensor with
  ``k ≤ QUEUE_MAX`` one launch of the hand-written Hopper kernel
  ``csrc/l1_search.cu::l1_topk_forward`` over every query, with no (Q, C)
  tile in device memory; a larger ``k`` takes the tile entry per block of
  ``TILE_BLOCK_Q`` queries and ``torch.topk``, chosen on the shape before
  any launch.
* ``l1_count`` — per row the int64 count of columns j ≠ ``self_col[i]``
  with s(i, j) < ``thresh[i]``: one launch of ``l1_count_forward``.
* ``l1_tile`` — the (Q, C) masked score tile: one launch of
  ``l1_tile_forward``.

On a CPU tensor each entry is its plain version (``l1_topk_plain``,
``l1_count_plain``, ``l1_tile_plain``): (BLOCK_Q, BLOCK_C, d) difference
blocks reduced by ``pairwise_l1``.  The kernel sums each distance in the
order c = 0, 1, …, d − 1, the plain version in PyTorch's; both depend only
on the two rows, never on the pair's place in a tile.  The kernel takes
d % 4 == 0 and 4 ≤ d ≤ ``MAX_D`` (the tables' widths are 128, 256 and 512)
and float32 rows that start 16-byte aligned.  No wrapper falls back from
the card.
"""

from __future__ import annotations

import ctypes

import torch

from tpugraph_torch.kernels import _build
from tpugraph_torch.kernels.shortlist_dist import QUEUE_MAX, _least_k, queue_len
from tpugraph_torch.train.losses import pairwise_l1

MAX_D = 512
BLOCK_Q = 256  # plain: queries per score tile
BLOCK_C = 1024  # plain: candidates per difference block; (256, 1024, 256) fp32 is 268 MB
TILE_BLOCK_Q = 4096  # the route above the queue: a (4,096, C) fp32 tile per launch

# kernel launches since the process started (or the caller last reset them)
topk_launches = 0
count_launches = 0
tile_launches = 0


def _scores_plain(qb: torch.Tensor, cands: torch.Tensor, a: float, bias, col_mask,
                  ex) -> torch.Tensor:
    """(rows, C) fp32 scores of one query block, masked to +inf."""
    s = torch.cat([pairwise_l1(qb[:, None, :], cands[None, c0:c0 + BLOCK_C, :]).float()
                   for c0 in range(0, cands.shape[0], BLOCK_C)], dim=1)
    if bias is not None:
        s = a * s - bias[None, :]
    elif a != 1.0:
        s = a * s
    if col_mask is not None:
        s.masked_fill_(~col_mask[None, :], float("inf"))
    if ex is not None:
        cols = torch.arange(cands.shape[0], device=qb.device)
        s.masked_fill_(cols[None, :] == ex[:, None], float("inf"))
    return s.masked_fill_(torch.isnan(s), float("inf"))  # a diverged table's NaN: masked


def l1_tile_plain(q, cands, *, a=1.0, bias=None, col_mask=None, exclude=None):
    """The plain version of ``l1_tile``."""
    if q.shape[0] == 0:
        return q.new_empty((0, cands.shape[0]), dtype=torch.float32)
    return torch.cat([
        _scores_plain(q[q0:q0 + BLOCK_Q], cands, a, bias, col_mask,
                      None if exclude is None else exclude[q0:q0 + BLOCK_Q])
        for q0 in range(0, q.shape[0], BLOCK_Q)], dim=0)


def l1_topk_plain(q, cands, k: int, *, a=1.0, bias=None, col_mask=None, exclude=None):
    """The plain version of ``l1_topk``: per block of BLOCK_Q queries the
    score tile, then the k least by (score, column)."""
    _check_k(k, cands.shape[0])
    vals = torch.empty((q.shape[0], k), dtype=torch.float32, device=q.device)
    idx = torch.empty((q.shape[0], k), dtype=torch.int64, device=q.device)
    for q0 in range(0, q.shape[0], BLOCK_Q):
        s = _scores_plain(q[q0:q0 + BLOCK_Q], cands, a, bias, col_mask,
                          None if exclude is None else exclude[q0:q0 + BLOCK_Q])
        idx[q0:q0 + BLOCK_Q], vals[q0:q0 + BLOCK_Q] = _least_k(s, k)
    return vals, idx


def l1_count_plain(q, cands, thresh, *, a=1.0, bias=None, self_col=None):
    """The plain version of ``l1_count``: per block of BLOCK_Q queries the
    score tile (the self column at +inf), compared with each row's
    threshold and summed."""
    count = torch.empty(q.shape[0], dtype=torch.int64, device=q.device)
    for q0 in range(0, q.shape[0], BLOCK_Q):
        s = _scores_plain(q[q0:q0 + BLOCK_Q], cands, a, bias, None,
                          None if self_col is None else self_col[q0:q0 + BLOCK_Q])
        count[q0:q0 + BLOCK_Q] = (s < thresh[q0:q0 + BLOCK_Q, None]).sum(dim=1)
    return count


def _check_k(k: int, c: int) -> None:
    if not 1 <= k <= c:
        raise ValueError(f"l1_topk takes 1 ≤ k ≤ C, got k = {k}, C = {c}")


def _on_cpu(q, *others) -> bool:
    """True for CPU operands, False for CUDA ones; raises on a mix."""
    for t in others:
        if t is not None and t.device != q.device:
            raise ValueError(f"l1_search: every operand must lie on {q.device}, got {t.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"l1_search runs on cuda or cpu, not {q.device}")
    return q.device.type == "cpu"


def _check(q, cands, **rows) -> None:
    """What the kernel takes: float32 (Q, d) and (C, d) rows, d % 4 == 0 and
    4 ≤ d ≤ MAX_D, contiguous and 16-byte aligned; each per-row or
    per-column operand of its type and length, contiguous."""
    if q.dim() != 2 or cands.dim() != 2 or q.shape[1] != cands.shape[1]:
        raise ValueError(f"q (Q, d) and cands (C, d) must share d, got {tuple(q.shape)}, "
                         f"{tuple(cands.shape)}")
    d = q.shape[1]
    if d % 4 != 0 or not 4 <= d <= MAX_D:
        raise ValueError(f"the L1 search kernel takes d % 4 == 0 and 4 ≤ d ≤ {MAX_D}, "
                         f"got d = {d}")
    if cands.shape[0] == 0:
        raise ValueError("the L1 search takes at least one candidate")
    n = {"q": None, "cands": None, "bias": cands.shape[0], "col_mask": cands.shape[0],
         "exclude": q.shape[0], "self_col": q.shape[0], "thresh": q.shape[0]}
    dtypes = {"col_mask": torch.bool, "exclude": torch.int64, "self_col": torch.int64}
    for name, t in (("q", q), ("cands", cands), *rows.items()):
        if t is None:
            continue
        want = dtypes.get(name, torch.float32)
        if t.dtype != want:
            raise TypeError(f"the L1 search kernel takes {name} as {want}, got {t.dtype}")
        if n[name] is not None and tuple(t.shape) != (n[name],):
            raise ValueError(f"{name} must be ({n[name]},), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if n[name] is None and t.data_ptr() % 16:
            raise ValueError(f"{name}'s rows must start 16-byte aligned")


def _fn(name: str, argtypes: list):
    fn = getattr(_build.load("l1_search"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(q: torch.Tensor) -> int:
    index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {err}")


def _mask_bytes(col_mask):
    return None if col_mask is None else col_mask.view(torch.uint8)


def l1_tile(q, cands, *, a: float = 1.0, bias=None, col_mask=None, exclude=None) -> torch.Tensor:
    """(Q, C) float32 scores s(i, j), +inf where masked: one launch of the
    kernel's tile entry on a CUDA tensor, ``l1_tile_plain`` on a CPU one."""
    if _on_cpu(q, cands, bias, col_mask, exclude):
        return l1_tile_plain(q, cands, a=a, bias=bias, col_mask=col_mask, exclude=exclude)
    _check(q, cands, bias=bias, col_mask=col_mask, exclude=exclude)
    s, c = q.shape[0], cands.shape[0]
    out = torch.empty((s, c), dtype=torch.float32, device=q.device)
    if s == 0:
        return out
    fn = _fn("l1_tile_forward", [_P, _P, _P, _P, _P, _F, _I, _I, _I, _P, _P])
    _raise_on(fn(q.data_ptr(), cands.data_ptr(), _ptr(bias), _ptr(_mask_bytes(col_mask)),
                 _ptr(exclude), float(a), s, c, q.shape[1], out.data_ptr(), _stream(q)),
              "l1_tile")
    global tile_launches
    tile_launches += 1
    return out


def l1_topk(q, cands, k: int, *, a: float = 1.0, bias=None, col_mask=None,
            exclude=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(vals (Q, k) float32, idx (Q, k) int64): each row's k least scores,
    ascending by (score, column).  On a CUDA tensor one kernel launch for
    ``k ≤ QUEUE_MAX``, above it ``l1_tile`` per block of TILE_BLOCK_Q
    queries and ``torch.topk``; on a CPU tensor ``l1_topk_plain``."""
    opts = dict(a=a, bias=bias, col_mask=col_mask, exclude=exclude)
    if _on_cpu(q, cands, bias, col_mask, exclude):
        return l1_topk_plain(q, cands, k, **opts)
    _check(q, cands, bias=bias, col_mask=col_mask, exclude=exclude)
    _check_k(k, cands.shape[0])
    s = q.shape[0]
    vals = torch.empty((s, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((s, k), dtype=torch.int64, device=q.device)
    if s == 0:
        return vals, idx
    if k > QUEUE_MAX:  # the unfused route, chosen before any launch
        for q0 in range(0, s, TILE_BLOCK_Q):
            ex = None if exclude is None else exclude[q0:q0 + TILE_BLOCK_Q]
            tile = l1_tile(q[q0:q0 + TILE_BLOCK_Q], cands, **{**opts, "exclude": ex})
            idx[q0:q0 + TILE_BLOCK_Q], vals[q0:q0 + TILE_BLOCK_Q] = _least_k(tile, k)
        return vals, idx
    fn = _fn("l1_topk_forward", [_P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _P, _P, _P])
    _raise_on(fn(q.data_ptr(), cands.data_ptr(), _ptr(bias), _ptr(_mask_bytes(col_mask)),
                 _ptr(exclude), float(a), s, cands.shape[0], q.shape[1], k, queue_len(k),
                 idx.data_ptr(), vals.data_ptr(), _stream(q)), "l1_topk")
    global topk_launches
    topk_launches += 1
    return vals, idx


def l1_count(q, cands, thresh, *, a: float = 1.0, bias=None, self_col=None) -> torch.Tensor:
    """(Q,) int64: per row the columns j ≠ ``self_col[i]`` (-1: none) with
    s(i, j) < ``thresh[i]``.  One kernel launch on a CUDA tensor,
    ``l1_count_plain`` on a CPU one."""
    if _on_cpu(q, cands, thresh, bias, self_col):
        return l1_count_plain(q, cands, thresh, a=a, bias=bias, self_col=self_col)
    _check(q, cands, bias=bias, thresh=thresh, self_col=self_col)
    s = q.shape[0]
    count = torch.empty(s, dtype=torch.int64, device=q.device)
    if s == 0:
        return count
    fn = _fn("l1_count_forward", [_P, _P, _P, _P, _P, _F, _I, _I, _I, _P, _P])
    _raise_on(fn(q.data_ptr(), cands.data_ptr(), _ptr(bias), thresh.data_ptr(), _ptr(self_col),
                 float(a), s, cands.shape[0], q.shape[1], count.data_ptr(), _stream(q)),
              "l1_count")
    global count_launches
    count_launches += 1
    return count
