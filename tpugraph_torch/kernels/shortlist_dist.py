"""The shortlist kernels that the approximate search paths share.

Select and rerank (``shortlist_select``): for queries q (S, d) against
candidates (C, d), both float32,

    sel[i, j]  = ‖q_i‖² + c2[j] − 2·q_i·c_j        (the expanded form, not clamped)
    sel[i, j]  = a·sel[i, j] − bias[j]             (CSLS: a = 2, bias = r_sel)
    sel[i, j]  = +inf where col_mask[j] is false or j == exclude[i]
    sidx[i, :] = the k columns of least sel, ascending by (sel, column)
    sval[i, :] = sel at those columns
    dist[i, :] = Σ_c f(q[i, c] − cands[sidx[i, :], c]),
                 f = |·| (``rerank="cityblock"``) or (·)² (``"sqeuclidean"``)

with ``bf16=True`` rounding both operands of the product to bf16 (the
norms stay those of the unrounded rows).  The JAX package runs this as XLA
ops and ``lax.approx_min_k`` (``tpugraph/train/negatives.py:178`` and
``:260-262``, ``train/bootstrap.py:125-137``, ``train/eval.py:112-159``,
``serve.py:85-88``); ``approx_min_k`` is exact on the CPU, where its order
is ``lax.top_k``'s.

* ``select_rerank`` — what the callers call.  On a CUDA tensor with
  ``k ≤ QUEUE_MAX`` it is one launch of ``shortlist_select``'s kernel over
  every query.  A larger ``k`` takes the unfused route, chosen on the shape
  before any launch: a (4,096, C) selection tile per query block,
  ``torch.topk``, then the gather kernel ``shortlist_dist``.  On a CPU tensor
  it is the plain version.
* ``shortlist_select`` — on a CUDA tensor one launch of the hand-written
  Hopper kernel ``csrc/shortlist_dist.cu::shortlist_select_forward``, which
  never writes an (S, C) tile; on a CPU tensor ``shortlist_select_plain``.
  It takes any d ≥ 1, rows of another width than a multiple of 4 (of 8
  with ``bf16``) padded with zero columns (``pad.pad_columns``), which
  change no score and no distance.  Up to ``SELECT_RESIDENT_D`` the query
  strip stays in shared memory; above it the strip streams beside the
  candidate tiles and the rerank reads its query row from L2, in shared
  memory that does not grow with d (``select_smem``).  It refuses
  (``ValueError``) a ``k`` above ``QUEUE_MAX``, and (``TypeError``) any
  operand that is not float32.
* ``shortlist_select_plain`` — the plain version: per block of
  ``PLAIN_BLOCK_Q`` queries the fp32 (or bf16-rounded) product tile, the
  bias and masks, the k least by ``torch.topk`` with ties at the k-th value
  taken in column order, sorted by (sel, column), then
  ``shortlist_dist_plain``.
* ``shortlist_dist`` — the gathered distances alone for a shortlist the
  caller holds, ``out[i, j] = Σ_c f(q[i, c] − table[idx[i, j], c])``: on a
  CUDA tensor one launch of ``csrc/shortlist_dist.cu::shortlist_dist_forward``,
  which never stores the gathered rows; on a CPU tensor
  ``shortlist_dist_plain`` (a block of queries' rows gathered into a
  (rows, K, d) tensor, at most ``PLAIN_BLOCK_ELEMS`` values, and reduced).

No wrapper falls back from the card.
"""

from __future__ import annotations

import ctypes

import torch

from tpugraph_torch.kernels import _build
from tpugraph_torch.kernels.pad import pad_columns
from tpugraph_torch.train.losses import pairwise_l1

METRICS = ("cityblock", "sqeuclidean")
PLAIN_BLOCK_ELEMS = 1 << 26  # 256 MB of fp32 per gathered (rows, K, d) block
PLAIN_BLOCK_Q = 4096  # queries per plain selection tile: 311 MB at 19,000 candidates
QUEUE_MAX = 256  # the select kernel's largest per-row queue
# the widest d whose query strip stays in shared memory (kResidentD in
# csrc/shortlist_dist.cu): the rows and queues fill up to 166 KB at 512
SELECT_RESIDENT_D = 512
# the select kernel's block (csrc/shortlist_dist.cu, topk_queue.cuh): strips
# of SELECT_BQ queries, tiles of SELECT_BC candidates, chunks of SELECT_KC
# of d through a SELECT_STAGES-deep ring, up to SELECT_SLOTS score tiles of
# rows SELECT_TSTRIDE floats apart, and each row's queue and KBUF buffer
SELECT_BQ, SELECT_BC, SELECT_KC, SELECT_STAGES, SELECT_SLOTS = 32, 128, 32, 2, 4
SELECT_TSTRIDE, SELECT_KBUF, SELECT_PAD = 132, 128, 16
# what one H100 block may take, and the block's static rows (thv, thi, cnt)
SELECT_ROOM = 232448 - 3 * 4 * SELECT_BQ

# kernel launches since the process started (or the caller last reset
# them): the gather kernel's, and the select-and-rerank kernel's
launches = 0
select_launches = 0


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


def _select_lib():
    fn = _build.load("shortlist_dist").shortlist_select_forward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, ctypes.c_float, i, i, i, i, i, i, i, p, p, p, p]
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


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Row squared norms in fp32, the ‖·‖² terms of the expanded form."""
    x = x.float()
    return (x * x).sum(1)


def queue_len(k: int) -> int:
    """The select kernel's per-row queue for k entries: a power of two ≥ 32."""
    return max(32, 1 << (k - 1).bit_length())


def _least_k(sel: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(columns, values) of the k least entries of each row, ascending by
    (value, column): ``torch.topk`` gives the k-th value; the entries equal
    to it are taken in column order."""
    kth = torch.topk(sel, k, dim=1, largest=False, sorted=True).values[:, -1:]
    below = sel < kth
    tied = sel == kth
    need = k - below.sum(1, keepdim=True)
    take = below | (tied & (tied.cumsum(1, dtype=torch.int32) <= need))
    cols = take.nonzero()[:, 1].view(sel.shape[0], k)  # ascending columns per row
    vals, order = torch.sort(sel.gather(1, cols), dim=1, stable=True)
    return cols.gather(1, order), vals


def _select_blocked(q, cands, k, dist_fn, q2=None, c2=None, a=1.0, bias=None, col_mask=None,
                    exclude=None, bf16=False, rerank=None):
    """The selection by product tiles of ``PLAIN_BLOCK_Q`` queries, then
    ``dist_fn`` (the gather kernel or its plain version) for the rerank."""
    s, c = q.shape[0], cands.shape[0]
    q2 = sq_norms(q) if q2 is None else q2
    c2 = sq_norms(cands) if c2 is None else c2
    ct = (cands.to(torch.bfloat16) if bf16 else cands).float().t()
    col_ids = torch.arange(c, device=q.device)
    sidx = torch.empty((s, k), dtype=torch.int64, device=q.device)
    sval = torch.empty((s, k), dtype=torch.float32, device=q.device)
    for r0 in range(0, s, PLAIN_BLOCK_Q):
        qq = q[r0:r0 + PLAIN_BLOCK_Q]
        qa = (qq.to(torch.bfloat16) if bf16 else qq).float()
        sel = q2[r0:r0 + PLAIN_BLOCK_Q, None] + c2[None, :] - 2.0 * (qa @ ct)
        if bias is not None:
            sel = a * sel - bias[None, :]
        elif a != 1.0:
            sel = a * sel
        if col_mask is not None:
            sel.masked_fill_(~col_mask[None, :], float("inf"))
        if exclude is not None:
            sel.masked_fill_(col_ids[None, :] == exclude[r0:r0 + PLAIN_BLOCK_Q, None],
                             float("inf"))
        sidx[r0:r0 + PLAIN_BLOCK_Q], sval[r0:r0 + PLAIN_BLOCK_Q] = _least_k(sel, k)
    dist = None if rerank is None else dist_fn(q, cands, sidx, rerank)
    return sidx, sval, dist


def shortlist_select_plain(q: torch.Tensor, cands: torch.Tensor, k: int, **opts):
    """The plain version of ``shortlist_select`` (the composite the kernel
    replaces): (sidx, sval, dist or None)."""
    if opts.get("rerank") is not None:
        check_metric(opts["rerank"])
    return _select_blocked(q, cands, k, shortlist_dist_plain, **opts)


def select_streams(d: int) -> bool:
    """Whether the select kernel streams the query strip at width d (the
    kernel's d, padded to a multiple of 4 or 8)."""
    return d > SELECT_RESIDENT_D


def select_smem(d: int, kq: int, n_slots: int) -> int:
    """Dynamic shared memory of one select block at width d, queue kq and
    ``n_slots`` score tiles (``select_smem`` in the kernel): the resident
    strip (none when it streams), the ring (with the strip's chunks when it
    streams), the score tiles, the queues and buffers."""
    d_pad = -(-d // SELECT_KC) * SELECT_KC
    strip = 0 if select_streams(d) else SELECT_BQ * (d_pad + SELECT_PAD)
    slot = (SELECT_BC + SELECT_BQ * select_streams(d)) * SELECT_KC
    tiles = n_slots * SELECT_BQ * SELECT_TSTRIDE
    return 4 * (strip + SELECT_STAGES * slot + tiles) + 8 * SELECT_BQ * (kq + SELECT_KBUF)


def _check_select(q, cands, k, q2, c2, bias, col_mask, exclude,
                  bf16: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's operands checked; returns q and cands with zero columns
    up to a multiple of 4 (8 with bf16: the kernel's d)."""
    if q.dim() != 2 or cands.dim() != 2 or q.shape[1] != cands.shape[1]:
        raise ValueError(f"q (S, d) and cands (C, d) must share d, got {tuple(q.shape)}, "
                         f"{tuple(cands.shape)}")
    s, c, d = q.shape[0], cands.shape[0], q.shape[1]
    if not 1 <= k <= min(c, QUEUE_MAX):
        raise ValueError(f"the select kernel takes 1 ≤ k ≤ min(C, {QUEUE_MAX}), got k = {k}, "
                         f"C = {c}")
    if d < 1:
        raise ValueError(f"the select kernel takes widths d ≥ 1, got d = {d}")
    q, cands = pad_columns(q, 8 if bf16 else 4), pad_columns(cands, 8 if bf16 else 4)
    for name, t, n, dtype in (("q", q, None, torch.float32),
                              ("cands", cands, None, torch.float32),
                              ("q2", q2, s, torch.float32), ("c2", c2, c, torch.float32),
                              ("bias", bias, c, torch.float32),
                              ("col_mask", col_mask, c, torch.bool),
                              ("exclude", exclude, s, torch.int64)):
        if t is None:
            continue
        if t.dtype != dtype:
            raise TypeError(f"the select kernel takes {name} as {dtype}, got {t.dtype}")
        if n is not None and tuple(t.shape) != (n,):
            raise ValueError(f"{name} must be ({n},), got {tuple(t.shape)}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous and on {q.device}")
        if n is None and t.data_ptr() % 16:
            raise ValueError(f"{name}'s rows must start 16-byte aligned")
    return q, cands


def shortlist_select(q: torch.Tensor, cands: torch.Tensor, k: int, *,
                     q2: torch.Tensor | None = None, c2: torch.Tensor | None = None,
                     a: float = 1.0, bias: torch.Tensor | None = None,
                     col_mask: torch.Tensor | None = None, exclude: torch.Tensor | None = None,
                     bf16: bool = False, rerank: str | None = None):
    """(sidx (S, k) int64, sval (S, k) float32, dist (S, k) float32 or None):
    the k least columns by the selection score, ascending by (sel, column),
    and with ``rerank`` each entry's exact distance.  The kernel on a CUDA
    tensor (one launch), ``shortlist_select_plain`` on a CPU tensor."""
    opts = dict(q2=q2, c2=c2, a=a, bias=bias, col_mask=col_mask, exclude=exclude, bf16=bf16,
                rerank=rerank)
    if rerank is not None:
        check_metric(rerank)
    if q.device.type == "cpu":
        return shortlist_select_plain(q, cands, k, **opts)
    q, cands = _check_select(q, cands, k, q2, c2, bias, col_mask, exclude, bf16)
    if q.device.type != "cuda":
        raise ValueError(f"shortlist_select runs on cuda or cpu, not {q.device}")
    s = q.shape[0]
    q2 = sq_norms(q) if q2 is None else q2
    c2 = sq_norms(cands) if c2 is None else c2
    sidx = torch.empty((s, k), dtype=torch.int64, device=q.device)
    sval = torch.empty((s, k), dtype=torch.float32, device=q.device)
    dist = None if rerank is None else torch.empty_like(sval)
    if s == 0:
        return sidx, sval, dist

    def ptr(t):
        return None if t is None else t.data_ptr()

    index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    err = _select_lib()(
        q.data_ptr(), cands.data_ptr(), q2.data_ptr(), c2.data_ptr(), ptr(bias),
        ptr(None if col_mask is None else col_mask.view(torch.uint8)), ptr(exclude), float(a), s,
        cands.shape[0], q.shape[1], k, queue_len(k), int(bf16),
        0 if rerank is None else 1 + METRICS.index(rerank), sidx.data_ptr(), sval.data_ptr(),
        ptr(dist), torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"shortlist_select launch failed with CUDA error {err}")
    global select_launches
    select_launches += 1
    return sidx, sval, dist


def select_rerank(q: torch.Tensor, cands: torch.Tensor, k: int, **opts):
    """The callers' entry, with ``shortlist_select``'s options and result.
    On a CUDA tensor a ``k`` above ``QUEUE_MAX`` takes the unfused route
    (product tiles, ``torch.topk``, the gather kernel ``shortlist_dist``);
    the choice is made on the shape, before any launch."""
    if q.device.type == "cuda" and k > QUEUE_MAX:
        if opts.get("rerank") is not None:
            check_metric(opts["rerank"])
        return _select_blocked(q, cands, k, shortlist_dist, **opts)
    return shortlist_select(q, cands, k, **opts)
