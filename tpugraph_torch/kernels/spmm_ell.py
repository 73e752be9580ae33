"""ELL SpMM forward and backward (counterpart of ``tpugraph/kernels/spmm_ell.py``).

out[row] = Σ_k w[row, k] · x[idx[row, k]] + diag[row] · x[row].

* ``ell_apply`` / ``apply_with_diag`` — the plain version: an
  ``index_select`` gather per degree bucket, an fp32 ``einsum`` over K, one
  ``row_order`` gather back to natural row order, plus ``diag ⊙ x``.
* ``ell_spmm`` — the same function by the hand-written Hopper kernel
  ``csrc/spmm_ell.cu`` on a CUDA tensor (fp32 or bf16, d ∈ {128, 256};
  fp32 sums, a bf16 row rounded once at the end), the plain version on a
  CPU tensor.  It never falls back from the card.  Applied to
  the prebuilt transpose ``op.bwd`` it is the backward of A·x with no
  scatter (``kernels/gcn_fused.py::gcn_layer``).  Pad slots hold
  ``idx = 0``, ``w = 0``: a non-finite x[0] poisons the padded rows
  (0·NaN), as in the JAX package.
* ``spmm_ell`` — A·x with a gradient for x (an autograd Function, the
  counterpart of the JAX ``spmm_ell`` custom VJP): ``ell_spmm`` over
  ``op.fwd`` forward, over ``op.bwd`` backward.  The attribute channel's
  rectangular entity × attribute incidence (no diagonal) runs through it.
* ``fused_plan`` — the tile table the fused GCN layer walks: every bucket
  cut into tiles of at most 32 rows (fewer for large K, so a tile holds
  about ``TILE_SLOTS`` slots), plus K = 0 tiles for the rows in no bucket,
  ordered heaviest first.  Its flattened rows/idx/w arrays serve both ELL
  kernels.
* ``segment_plan`` — the work table of the SpMM kernel: warp-sized items,
  either a run of short rows of one bucket (at most ``PACK_VSLOTS`` virtual
  slots: each row's K slots plus one for the diagonal) or one segment of a
  row whose K exceeds ``SEG_SLOTS``; a cut row's segments leave partial rows
  that the last of them sums in segment order.  Heaviest first.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from tpugraph_torch.kernels import _build
from tpugraph_torch.sparse.ell import EllMatrix, EllOperator

TILE_ROWS = 32  # kTileRows in csrc/gcn_fused.cu
TILE_SLOTS = 1024  # target ELL slots per tile: large-K buckets get fewer rows
SEG_SLOTS = 128  # longest run of one row's ELL slots in one SpMM work item
PACK_VSLOTS = 64  # virtual slots (K + 1 per row) of a packed SpMM item: two chunks
SUPPORTED_DIMS = (128, 256)  # csrc/spmm_ell.cu template instances
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the process started (or the caller last reset it)
launches = 0


def check_n_cols(m: EllMatrix, x: torch.Tensor) -> None:
    """A feature matrix of the wrong height would gather out of bounds on
    the card; refuse it on every device."""
    if x.shape[0] != m.n_cols:
        raise ValueError(f"x has {x.shape[0]} rows but the operator expects {m.n_cols}")


def ell_apply(m: EllMatrix, x: torch.Tensor) -> torch.Tensor:
    """A @ x via bucketed gather + dense reduce; output in natural row order.
    bf16 inputs gather in bf16 but accumulate in fp32, then cast back.  A
    trailing zero row catches the degree-0 rows through ``row_order``."""
    check_n_cols(m, x)
    d = x.shape[-1]
    outs = []
    for b in m.buckets:
        g = x.index_select(0, b.idx.reshape(-1)).reshape(b.idx.shape[0], b.k, d)
        acc = torch.einsum("rk,rkd->rd", b.w, g.float())
        outs.append(acc.to(x.dtype))
    outs.append(x.new_zeros((1, d)))
    return torch.cat(outs, dim=0).index_select(0, m.row_order)


def apply_with_diag(m: EllMatrix, diag: torch.Tensor | None, x: torch.Tensor) -> torch.Tensor:
    """ELL part + gather-free diagonal part; the diagonal multiply runs in
    fp32 like the einsum does."""
    y = ell_apply(m, x)
    if diag is not None:
        y = y + (diag[:, None] * x.float()).to(x.dtype)
    return y


@dataclass
class FusedPlan:
    """The ELL kernels' view of one EllMatrix, on that matrix's device."""

    rows: torch.Tensor  # (n_rows,) int32 natural row ids, tile by tile
    idx: torch.Tensor  # (slots,) int32 — every bucket's idx, flattened
    w: torch.Tensor  # (slots,) float32 — every bucket's w, flattened
    tiles: torch.Tensor  # (n_tiles, 4) int32: row_start, n_rows, K, slot_start
    n_zero_rows: int  # rows in no bucket (K = 0 tiles)


def _rows_per_tile(k: int) -> int:
    return max(1, min(TILE_ROWS, TILE_SLOTS // max(k, 1)))


def fused_plan(m: EllMatrix) -> FusedPlan:
    """Build (once per matrix, cached on it) the kernels' tile table."""
    plan = m.cache.get("tiles")
    if plan is not None:
        return plan
    rows, idx, w, tiles = [], [], [], []
    row_base = slot_base = 0
    for b in m.buckets:
        b_rows = b.rows.cpu().numpy()
        b_idx = b.idx.cpu().numpy()
        if b_idx.size and (int(b_idx.min()) < 0 or int(b_idx.max()) >= m.n_cols):
            raise ValueError(f"ELL source ids out of range for n_cols={m.n_cols}")
        rows.append(b_rows)
        idx.append(b_idx.reshape(-1))
        w.append(b.w.cpu().numpy().reshape(-1))
        tr = _rows_per_tile(b.k)
        for r0 in range(0, len(b_rows), tr):
            n = min(tr, len(b_rows) - r0)
            tiles.append((row_base + r0, n, b.k, slot_base + r0 * b.k))
        row_base += len(b_rows)
        slot_base += b_idx.size
    covered = np.zeros(m.n_rows, bool)
    for r in rows:
        covered[r] = True
    zero = np.flatnonzero(~covered).astype(np.int32)
    for r0 in range(0, len(zero), TILE_ROWS):
        tiles.append((row_base + r0, min(TILE_ROWS, len(zero) - r0), 0, slot_base))
    rows.append(zero)
    all_rows = np.concatenate(rows)
    if not np.array_equal(np.sort(all_rows), np.arange(m.n_rows)):
        raise ValueError("ELL buckets do not partition the rows")
    if slot_base >= 2**31:
        raise ValueError(f"{slot_base} ELL slots exceed the kernel's int32 tile table")
    t = np.asarray(tiles, np.int64).reshape(-1, 4)
    # heaviest tiles first, so the rows with K in the thousands do not trail
    t = t[np.argsort(-(t[:, 1] * (t[:, 2] + 1)), kind="stable")]
    dev = m.device
    plan = FusedPlan(
        rows=torch.from_numpy(all_rows.astype(np.int32)).to(dev),
        idx=torch.from_numpy(np.concatenate(idx or [np.zeros(0, np.int32)])).to(dev),
        w=torch.from_numpy(np.concatenate(w or [np.zeros(0, np.float32)])).to(dev),
        tiles=torch.from_numpy(t.astype(np.int32)).to(dev).contiguous(),
        n_zero_rows=int(len(zero)),
    )
    m.cache["tiles"] = plan
    return plan


@dataclass
class SegmentPlan:
    """The SpMM kernel's work table for one EllMatrix, on that matrix's
    device; the rows/idx/w arrays are ``base``'s (``fused_plan``)."""

    base: FusedPlan
    # (n_items, 8) int32: first row's position in base.rows, rows, K, first
    # slot; virtual slots [v0, v1) of those rows (K + 1 per row, the last
    # one the diagonal); partial index and cut-row index, or -1 for an item
    # that writes its rows itself
    items: torch.Tensor
    split_p0: torch.Tensor  # (n_split + 1,) int32: each cut row's first partial
    n_partials: int
    max_item_slots: int  # the most ELL slots of any item
    # (d, stream) -> the kernel's scratch there: the cut rows' fp32 partials
    # (for either type of x), then their counters, zeroed once (the kernel
    # leaves each counter at 0)
    scratch: dict = field(default_factory=dict)


def segment_plan(m: EllMatrix) -> SegmentPlan:
    """Build the SpMM kernel's work table (once per matrix, cached on it
    beside ``fused_plan``'s tiles)."""
    if "segments" in m.cache:
        return m.cache["segments"]
    cap, pack = SEG_SLOTS, PACK_VSLOTS
    base = fused_plan(m)
    items, slots, split_p0 = [], [], [0]
    pos = slot = 0
    groups = [(b.k, int(b.rows.shape[0])) for b in m.buckets] + [(0, base.n_zero_rows)]
    for k, n_rows in groups:
        if k <= cap:  # runs of whole rows, within both the packing and the cap
            per = max(1, min(pack // (k + 1), cap // k if k else pack))
            for r0 in range(0, n_rows, per):
                n = min(per, n_rows - r0)
                items.append((pos + r0, n, k, slot + r0 * k, 0, n * (k + 1), -1, -1))
                slots.append(n * k)
        else:  # each row cut into balanced segments of at most cap slots
            n_seg = -(-k // cap)
            bounds = [j * k // n_seg for j in range(n_seg + 1)]
            for r in range(n_rows):
                p0, s = split_p0[-1], len(split_p0) - 1
                for j in range(n_seg):
                    last = j == n_seg - 1  # carries the diagonal's slot
                    items.append((pos + r, 1, k, slot + r * k, bounds[j], bounds[j + 1] + last,
                                  p0 + j, s))
                    slots.append(bounds[j + 1] - bounds[j])
                split_p0.append(p0 + n_seg)
        pos += n_rows
        slot += n_rows * k
    t = np.asarray(items, np.int64).reshape(-1, 8)
    t = t[np.argsort(-(t[:, 5] - t[:, 4]), kind="stable")]  # heaviest first
    dev = m.device
    plan = SegmentPlan(
        base=base,
        items=torch.from_numpy(t.astype(np.int32)).to(dev).contiguous(),
        split_p0=torch.from_numpy(np.asarray(split_p0, np.int32)).to(dev),
        n_partials=int(split_p0[-1]),
        max_item_slots=max(slots, default=0),
    )
    m.cache["segments"] = plan
    return plan


def segment_scratch(plan, d: int, device: torch.device, stream: int) -> tuple[int, int]:
    """The addresses of the cut rows' fp32 partials and of their counters
    in a segment table's scratch for width d on ``stream`` (``plan`` has
    ``n_partials``, ``split_p0`` and the ``scratch`` dict: this module's
    ``SegmentPlan`` or the sorted kernel's).  Allocated and zeroed at the
    first call there, outside any capture; the kernels leave each counter
    at 0."""
    scratch = plan.scratch.get((d, stream))
    if scratch is None:
        scratch = torch.zeros(plan.n_partials * d + plan.split_p0.shape[0] - 1,
                              dtype=torch.float32, device=device)
        plan.scratch[(d, stream)] = scratch
    return scratch.data_ptr(), scratch.data_ptr() + 4 * plan.n_partials * d


def check_diag(m: EllMatrix, diag: torch.Tensor | None, dev: torch.device) -> None:
    if diag is None:
        return
    if m.n_rows != m.n_cols:
        raise ValueError("a split diagonal needs a square operator")
    if diag.dtype != torch.float32 or diag.shape != (m.n_rows,):
        raise ValueError(f"diag must be float32 of shape ({m.n_rows},)")
    if diag.device != dev or not diag.is_contiguous():
        raise ValueError(f"diag must be contiguous and on {dev}")


def _lib():
    fn = _build.load("spmm_ell").spmm_ell_forward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, p, p, p, p, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def ell_spmm(m: EllMatrix, diag: torch.Tensor | None, x: torch.Tensor) -> torch.Tensor:
    """A @ x + diag ⊙ x: the kernel on a CUDA tensor, ``apply_with_diag``
    on a CPU tensor.  x (n_cols, d) float32 or bfloat16, d ∈ {128, 256} on
    the card; the output has x's type."""
    if x.device.type == "cpu":
        return apply_with_diag(m, diag, x)
    if x.device.type != "cuda":
        raise ValueError(f"ell_spmm runs on cuda or cpu, not {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the ELL SpMM kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be a contiguous, 16-byte aligned (N, d) tensor")
    if x.shape[1] not in SUPPORTED_DIMS:
        raise ValueError(f"d={x.shape[1]} not in {SUPPORTED_DIMS}")
    check_n_cols(m, x)
    check_diag(m, diag, x.device)
    if m.device != x.device:
        raise ValueError(f"the operator must be on {x.device}")
    return _launch(m, diag, x, segment_plan(m))


def _launch(m: EllMatrix, diag: torch.Tensor | None, x: torch.Tensor,
            plan: SegmentPlan) -> torch.Tensor:
    """One kernel launch over ``plan``'s work items, on checked inputs."""
    d = x.shape[1]
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    partial, counters = segment_scratch(plan, d, x.device, stream)
    out = torch.empty((m.n_rows, d), dtype=x.dtype, device=x.device)
    err = _lib()(x.data_ptr(), None if diag is None else diag.data_ptr(),
                 plan.base.rows.data_ptr(), plan.base.idx.data_ptr(), plan.base.w.data_ptr(),
                 plan.items.data_ptr(), plan.items.shape[0], plan.split_p0.data_ptr(),
                 counters, partial, out.data_ptr(), d, _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"spmm_ell launch failed with CUDA error {err}")
    global launches
    launches += 1
    return out


class _SpmmEll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op):
        ctx.op = op
        return ell_spmm(op.fwd, op.diag, x)

    @staticmethod
    def backward(ctx, g):
        # the diagonal is symmetric, so Aᵀ = Bᵀ + diag with the same vector
        return ell_spmm(ctx.op.bwd, ctx.op.diag, g.contiguous()), None


def spmm_ell(op: EllOperator, x: torch.Tensor) -> torch.Tensor:
    """A·x (+ diag ⊙ x) with a gradient for x; the operator is a constant
    and gets none, as in the JAX package.  Forward and backward are one
    ``ell_spmm`` launch each on the card."""
    return _SpmmEll.apply(x, op)
