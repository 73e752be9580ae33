"""Fused GCN layer: out = (A @ x) @ W + b in one kernel launch (counterpart
of ``tpugraph/kernels/gcn_fused_pallas.py``).

On a CUDA tensor ``fused_gcn_layer`` launches the hand-written Hopper
kernel in ``csrc/gcn_fused.cu``; on a CPU tensor it runs the plain version,
``reference_layer`` (ELL aggregate via ``index_select``, then the GEMM).  It
never falls back from the card to the plain version.

The kernel walks a tile table built once per ELL matrix (``fused_plan``):
every bucket cut into tiles of at most 32 rows (fewer for large K, so a
tile holds about ``TILE_SLOTS`` slots), plus K = 0 tiles for the rows that
lie in no bucket, ordered heaviest first.  Each tile's rows are written
straight to their natural positions, so the buckets' outputs need no
concatenation and no ``row_order`` gather.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from tpugraph_torch.kernels import _build
from tpugraph_torch.kernels.spmm_ell import apply_with_diag, check_n_cols
from tpugraph_torch.sparse.ell import EllMatrix

TILE_ROWS = 32  # kTileRows in csrc/gcn_fused.cu
TILE_SLOTS = 1024  # target ELL slots per tile: large-K buckets get fewer rows
SUPPORTED_DIMS = {(128, 128), (128, 256), (256, 128)}  # template instances
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the process started (or the caller last reset it)
launches = 0


@dataclass
class FusedPlan:
    """The kernel's view of one EllMatrix, on that matrix's device."""

    rows: torch.Tensor  # (n_rows,) int32 natural row ids, tile by tile
    idx: torch.Tensor  # (slots,) int32 — every bucket's idx, flattened
    w: torch.Tensor  # (slots,) float32 — every bucket's w, flattened
    tiles: torch.Tensor  # (n_tiles, 4) int32: row_start, n_rows, K, slot_start
    n_zero_rows: int  # rows in no bucket (K = 0 tiles)


def _rows_per_tile(k: int) -> int:
    return max(1, min(TILE_ROWS, TILE_SLOTS // max(k, 1)))


def fused_plan(m: EllMatrix) -> FusedPlan:
    """Build (once per matrix, cached on it) the kernel's tile table."""
    plan = m.cache.get("gcn_fused")
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
    m.cache["gcn_fused"] = plan
    return plan


def reference_layer(m: EllMatrix, diag: torch.Tensor | None, x: torch.Tensor,
                    wmat: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version: ELL aggregate (gather + fp32 reduce), then the
    GEMM in fp32, cast to x's type, then the bias."""
    out = apply_with_diag(m, diag, x)
    out = torch.matmul(out.float(), wmat.float()).to(x.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def _lib():
    lib = _build.load("gcn_fused")
    fn = lib.gcn_fused_forward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(m: EllMatrix, diag, x, wmat, bias) -> None:
    dev = x.device
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be a contiguous, 16-byte aligned (N, d_in) tensor")
    check_n_cols(m, x)
    if wmat.dtype != x.dtype or wmat.dim() != 2 or wmat.shape[0] != x.shape[1]:
        raise ValueError(f"W must be ({x.shape[1]}, d_out) of {x.dtype}, got "
                         f"{tuple(wmat.shape)} of {wmat.dtype}")
    if (x.shape[1], wmat.shape[1]) not in SUPPORTED_DIMS:
        raise ValueError(f"(d_in, d_out)={x.shape[1], wmat.shape[1]} not in {SUPPORTED_DIMS}")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (wmat.shape[1],)):
        raise ValueError(f"bias must be float32 of shape ({wmat.shape[1]},)")
    if diag is not None:
        if m.n_rows != m.n_cols:
            raise ValueError("a split diagonal needs a square operator")
        if diag.dtype != torch.float32 or diag.shape != (m.n_rows,):
            raise ValueError(f"diag must be float32 of shape ({m.n_rows},)")
    for name, t in (("W", wmat), ("bias", bias), ("diag", diag), ("operator", m.row_order)):
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous and on {dev}")


def fused_gcn_layer(m: EllMatrix, diag: torch.Tensor | None, x: torch.Tensor,
                    wmat: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """out = (A @ x) @ W (+ b), A = the ELL matrix ``m`` plus ``diag``.

    x (N, d_in) float32 or bfloat16; W (d_in, d_out) of x's type; bias
    (d_out,) float32; output (n_rows, d_out) of x's type.  Forward only."""
    if x.device.type == "cpu":
        return reference_layer(m, diag, x, wmat, bias)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gcn_layer runs on cuda or cpu, not {x.device}")
    _check(m, diag, x, wmat, bias)
    plan = fused_plan(m)
    fn = _lib()
    out = torch.empty((m.n_rows, wmat.shape[1]), dtype=x.dtype, device=x.device)
    counter = torch.empty(1, dtype=torch.int32, device=x.device)
    err = fn(x.data_ptr(), wmat.data_ptr(),
             None if bias is None else bias.data_ptr(),
             None if diag is None else diag.data_ptr(),
             plan.rows.data_ptr(), plan.idx.data_ptr(), plan.w.data_ptr(),
             plan.tiles.data_ptr(), plan.tiles.shape[0], counter.data_ptr(),
             out.data_ptr(), x.shape[1], wmat.shape[1], _DTYPE_CODE[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gcn_fused launch failed with CUDA error {err}")
    global launches
    launches += 1
    return out
