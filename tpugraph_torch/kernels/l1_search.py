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

Each launch spreads its work over ``units`` blocks by ``plan``: the
(strip of ``STRIP`` queries, tile of ``TILE`` candidates) pairs, strip-major,
cut into contiguous ranges of nearly equal length (``segments``), one
resident block each, so the grid fills whole waves whatever S and C.  A
strip that several units share is finished by the one that arrives last:
it merges their k keys a row by (score, column), or sums their counts, so
the result is the same number for any ``units``.  The top-k writes its
partials to scratch that the wrapper allocates; a strip's ticket (an int32
of ``_tickets``, kept per device and left at 0 by each launch) names the
last unit.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from tpugraph_torch.kernels import _build
from tpugraph_torch.kernels.shortlist_dist import QUEUE_MAX, _least_k, queue_len
from tpugraph_torch.train.losses import pairwise_l1

MAX_D = 512
BLOCK_Q = 256  # plain: queries per score tile
BLOCK_C = 1024  # plain: candidates per difference block; (256, 1024, 256) fp32 is 268 MB
TILE_BLOCK_Q = 4096  # the route above the queue: a (4,096, C) fp32 tile per launch

# the kernel's block (csrc/l1_search.cu): a strip of STRIP queries against
# tiles of TILE candidates, a ring of stages of KC of d, and KBUF survivors
# a row between merges of its queue
STRIP = 32
TILE = 256
KC = 8
KBUF = 128
STAGE_BYTES = (STRIP + TILE) * KC * 4
MIN_STAGES, MAX_STAGES = 3, 6
# an H100 SM's shared memory, what the card keeps of it per block, and the
# most one block may take
SM_SMEM_BYTES = 233472
BLOCK_SMEM_RESERVED = 1024
BLOCK_SMEM_MAX = 232448
ENTRIES = ("topk", "count", "tile")

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


def smem_bytes(entry: str, kq: int, stages: int) -> int:
    """Dynamic shared memory of one block (``l1_smem`` in the kernel): room
    to align the ring to 1,024 bytes, the ring and its two mbarriers a
    stage, a flag, the rows' excluded or own columns, thresholds and counts;
    for the top-k the rows' queues (kq) and buffers (KBUF)."""
    n = 1024 + stages * (STAGE_BYTES + 16) + 16 + 5 * STRIP * 4
    if entry == "topk":
        n += STRIP * (kq + KBUF) * 8
    return n


def ring_stages(entry: str, kq: int) -> int:
    """The ring's depth: the most stages (MIN_STAGES … MAX_STAGES) with which
    two blocks share an SM, else the most with which one block fits."""
    for per_sm in (2, 1):
        for stages in range(MAX_STAGES, MIN_STAGES - 1, -1):
            n = smem_bytes(entry, kq, stages)
            if n <= BLOCK_SMEM_MAX and per_sm * (n + BLOCK_SMEM_RESERVED) <= SM_SMEM_BYTES:
                return stages
    raise ValueError(f"no ring fits the {entry} block at kq = {kq}")


@dataclass(frozen=True)
class Plan:
    """How one launch spreads its work: ``strips`` strips of ``strip``
    queries, each ``tiles_per_strip`` tiles of ``tile`` candidates; ``tiles``
    = strips · tiles_per_strip pairs cut into ``units`` blocks of
    ⌊tiles/units⌋ or ⌈tiles/units⌉ each; ``slots`` blocks resident at once
    (SMs × blocks an SM); ``waves`` rounds of them; ``fill`` the share of the
    resident blocks' time that holds work (the tiles over slots × waves ×
    the longest unit)."""
    strip: int
    tile: int
    strips: int
    tiles_per_strip: int
    tiles: int
    units: int
    slots: int
    waves: int
    fill: float

    def splits(self) -> int:
        """The most units that one strip spans."""
        n = self.tiles_per_strip
        return max(unit_of(st * n + n - 1, self.tiles, self.units) - unit_of(st * n, self.tiles,
                                                                          self.units) + 1
                   for st in range(self.strips))


def plan(s: int, c: int, d: int, k: int, entry: str, n_sm: int, blocks_per_sm: int,
         units: int | None = None) -> Plan:
    """The work split of one launch, a pure function of the shape and the
    card: one unit per resident block (``units`` forces another count,
    clamped to the tiles), each a contiguous range of strip-major tiles, so
    the units differ by at most one tile and one wave holds them all.  d and
    k change the work of a tile, not the split; they are taken so that a
    plan names its whole shape."""
    if entry not in ENTRIES:
        raise ValueError(f"unknown entry {entry!r}; expected one of {ENTRIES}")
    if s < 1 or c < 1 or d < 1 or k < 0 or n_sm < 1 or blocks_per_sm < 1:
        raise ValueError(f"plan takes positive shapes, got S {s}, C {c}, d {d}, k {k}, "
                         f"{n_sm} SMs × {blocks_per_sm}")
    strips, per_strip = -(-s // STRIP), -(-c // TILE)
    tiles = strips * per_strip
    slots = n_sm * blocks_per_sm
    g = min(tiles, slots if units is None else max(1, units))
    waves = -(-g // slots)
    longest = -(-tiles // g)
    return Plan(STRIP, TILE, strips, per_strip, tiles, g, slots, waves,
                tiles / (slots * waves * longest))


def unit_of(u: int, tiles: int, units: int) -> int:
    """The unit whose range [b·tiles/units, (b + 1)·tiles/units) holds flat
    tile u (the kernel's ``unit_of``)."""
    return ((u + 1) * units + tiles - 1) // tiles - 1


def segments(p: Plan, s: int, c: int):
    """Each unit's pieces of strips, as the kernel walks them: (unit, strip,
    first column, end column, segment slot), the slot strip + unit being
    where the piece's partials go when other units share the strip."""
    for b in range(p.units):
        u, end = b * p.tiles // p.units, (b + 1) * p.tiles // p.units
        while u < end:
            strip = u // p.tiles_per_strip
            stop = min(end, (strip + 1) * p.tiles_per_strip)
            t0, t1 = u - strip * p.tiles_per_strip, stop - strip * p.tiles_per_strip
            yield b, strip, t0 * TILE, min(c, t1 * TILE), strip + b
            u = stop


_MODES = {"topk": 0, "count": 1, "tile": 2}
_BLOCKS_PER_SM: dict[tuple, int] = {}
_TICKETS: dict[int, list[torch.Tensor]] = {}


def _blocks_per_sm(dev: torch.device, entry: str, kq: int, stages: int) -> int:
    """Blocks of the entry an SM holds, from the CUDA occupancy calculator."""
    key = (dev.index, entry, kq, stages)
    if key not in _BLOCKS_PER_SM:
        out = ctypes.c_int(0)
        fn = _fn("l1_blocks_per_sm", [_I, _I, _I, _P])
        _raise_on(fn(_MODES[entry], kq, stages, ctypes.byref(out)), "l1_blocks_per_sm")
        if out.value < 1:
            raise RuntimeError(f"the L1 search's {entry} block does not fit an SM")
        _BLOCKS_PER_SM[key] = out.value
    return _BLOCKS_PER_SM[key]


def _tickets(dev: torch.device, strips: int) -> torch.Tensor:
    """The device's per-strip tickets, zero between launches (each launch's
    last unit of a strip resets its own).  Made at the first call, with
    room for 65,536 strips; a larger launch makes a larger buffer and keeps
    the old one alive (a captured graph may still use it).  Made only
    outside graph capture: inside one its zeros would not exist until a
    replay."""
    held = _TICKETS.setdefault(dev.index, [])
    if not held or held[-1].numel() < strips:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the L1 search's tickets must be made outside graph capture: "
                               "call it once before capturing")
        held.append(torch.zeros(max(strips, 65536), dtype=torch.int32, device=dev))
    return held[-1]


def _planned(q, c: int, k: int, entry: str, kq: int, units: int | None) -> tuple[Plan, int]:
    stages = ring_stages(entry, kq)
    props = torch.cuda.get_device_properties(q.device)
    return plan(q.shape[0], c, q.shape[1], k, entry, props.multi_processor_count,
                _blocks_per_sm(q.device, entry, kq, stages), units), stages


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


def l1_tile(q, cands, *, a: float = 1.0, bias=None, col_mask=None, exclude=None,
            units: int | None = None) -> torch.Tensor:
    """(Q, C) float32 scores s(i, j), +inf where masked: one launch of the
    kernel's tile entry on a CUDA tensor, ``l1_tile_plain`` on a CPU one.
    ``units``: the blocks of the launch (default: ``plan``'s)."""
    if _on_cpu(q, cands, bias, col_mask, exclude):
        return l1_tile_plain(q, cands, a=a, bias=bias, col_mask=col_mask, exclude=exclude)
    _check(q, cands, bias=bias, col_mask=col_mask, exclude=exclude)
    s, c = q.shape[0], cands.shape[0]
    out = torch.empty((s, c), dtype=torch.float32, device=q.device)
    if s == 0:
        return out
    p, stages = _planned(q, c, 0, "tile", 32, units)
    fn = _fn("l1_tile_forward", [_P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _P, _P])
    _raise_on(fn(q.data_ptr(), cands.data_ptr(), _ptr(bias), _ptr(_mask_bytes(col_mask)),
                 _ptr(exclude), float(a), s, c, q.shape[1], p.units, stages, out.data_ptr(),
                 _stream(q)), "l1_tile")
    global tile_launches
    tile_launches += 1
    return out


def l1_topk(q, cands, k: int, *, a: float = 1.0, bias=None, col_mask=None,
            exclude=None, units: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(vals (Q, k) float32, idx (Q, k) int64): each row's k least scores,
    ascending by (score, column).  On a CUDA tensor one kernel launch for
    ``k ≤ QUEUE_MAX`` over ``units`` blocks (default: ``plan``'s; any count
    gives the same result bit for bit), above it ``l1_tile`` per block of
    TILE_BLOCK_Q queries and ``torch.topk``; on a CPU tensor
    ``l1_topk_plain``."""
    opts = dict(a=a, bias=bias, col_mask=col_mask, exclude=exclude)
    if _on_cpu(q, cands, bias, col_mask, exclude):
        return l1_topk_plain(q, cands, k, **opts)
    _check(q, cands, bias=bias, col_mask=col_mask, exclude=exclude)
    _check_k(k, cands.shape[0])
    s, c = q.shape[0], cands.shape[0]
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
    kq = queue_len(k)
    p, stages = _planned(q, c, k, "topk", kq, units)
    n_part = (p.strips + p.units) * STRIP * k if p.units > 1 else 0
    part_v = torch.empty(n_part, dtype=torch.float32, device=q.device)
    part_i = torch.empty(n_part, dtype=torch.int32, device=q.device)
    fn = _fn("l1_topk_forward", [_P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                                 _P, _P, _P])
    _raise_on(fn(q.data_ptr(), cands.data_ptr(), _ptr(bias), _ptr(_mask_bytes(col_mask)),
                 _ptr(exclude), float(a), s, c, q.shape[1], k, kq, p.units, stages,
                 part_v.data_ptr(), part_i.data_ptr(), _tickets(q.device, p.strips).data_ptr(),
                 idx.data_ptr(), vals.data_ptr(), _stream(q)), "l1_topk")
    global topk_launches
    topk_launches += 1
    return vals, idx


def l1_count(q, cands, thresh, *, a: float = 1.0, bias=None, self_col=None,
             units: int | None = None) -> torch.Tensor:
    """(Q,) int64: per row the columns j ≠ ``self_col[i]`` (-1: none) with
    s(i, j) < ``thresh[i]``.  One kernel launch on a CUDA tensor over
    ``units`` blocks (default: ``plan``'s), ``l1_count_plain`` on a CPU
    one."""
    if _on_cpu(q, cands, thresh, bias, self_col):
        return l1_count_plain(q, cands, thresh, a=a, bias=bias, self_col=self_col)
    _check(q, cands, bias=bias, thresh=thresh, self_col=self_col)
    s, c = q.shape[0], cands.shape[0]
    count = torch.empty(s, dtype=torch.int64, device=q.device)
    if s == 0:
        return count
    p, stages = _planned(q, c, 0, "count", 32, units)
    part_i = torch.empty((p.strips + p.units) * STRIP if p.units > 1 else 0, dtype=torch.int32,
                         device=q.device)
    fn = _fn("l1_count_forward", [_P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _I, _P, _P, _P, _P])
    _raise_on(fn(q.data_ptr(), cands.data_ptr(), _ptr(bias), thresh.data_ptr(), _ptr(self_col),
                 float(a), s, c, q.shape[1], p.units, stages, part_i.data_ptr(),
                 _tickets(q.device, p.strips).data_ptr(), count.data_ptr(), _stream(q)),
              "l1_count")
    global count_launches
    count_launches += 1
    return count
