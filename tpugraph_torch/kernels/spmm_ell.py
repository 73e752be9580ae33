"""ELL SpMM forward and backward (counterpart of ``tpugraph/kernels/spmm_ell.py``).

out[row] = Σ_k w[row, k] · x[idx[row, k]] + diag[row] · x[row].

* ``ell_apply`` / ``apply_with_diag`` — the plain version: an
  ``index_select`` gather per degree bucket, an fp32 ``einsum`` over K, one
  ``row_order`` gather back to natural row order, plus ``diag ⊙ x``.
* ``ell_spmm`` — the same function by the hand-written Hopper kernel
  ``csrc/spmm_ell.cu`` on a CUDA tensor (fp32, d ∈ {128, 256}), the plain
  version on a CPU tensor.  It never falls back from the card.  Applied to
  the prebuilt transpose ``op.bwd`` it is the backward of A·x with no
  scatter (``kernels/gcn_fused.py::gcn_layer``).  Pad slots hold
  ``idx = 0``, ``w = 0``: a non-finite x[0] poisons the padded rows
  (0·NaN), as in the JAX package.
* ``fused_plan`` — the tile table both ELL kernels walk (this one and the
  fused GCN layer): every bucket cut into tiles of at most 32 rows (fewer
  for large K, so a tile holds about ``TILE_SLOTS`` slots), plus K = 0 tiles
  for the rows in no bucket, ordered heaviest first.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from tpugraph_torch.kernels import _build
from tpugraph_torch.sparse.ell import EllMatrix

TILE_ROWS = 32  # kTileRows in csrc/gcn_fused.cu
TILE_SLOTS = 1024  # target ELL slots per tile: large-K buckets get fewer rows
SUPPORTED_DIMS = (128, 256)  # csrc/spmm_ell.cu template instances

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
        fn.argtypes = [p, p, p, p, p, p, i, p, p, i, p]
        fn.restype = ctypes.c_int
    return fn


def ell_spmm(m: EllMatrix, diag: torch.Tensor | None, x: torch.Tensor) -> torch.Tensor:
    """A @ x + diag ⊙ x: the kernel on a CUDA tensor, ``apply_with_diag``
    on a CPU tensor.  x (n_cols, d) float32, d ∈ {128, 256} on the card."""
    if x.device.type == "cpu":
        return apply_with_diag(m, diag, x)
    if x.device.type != "cuda":
        raise ValueError(f"ell_spmm runs on cuda or cpu, not {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the ELL SpMM kernel takes float32, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be a contiguous, 16-byte aligned (N, d) tensor")
    if x.shape[1] not in SUPPORTED_DIMS:
        raise ValueError(f"d={x.shape[1]} not in {SUPPORTED_DIMS}")
    check_n_cols(m, x)
    check_diag(m, diag, x.device)
    if m.device != x.device:
        raise ValueError(f"the operator must be on {x.device}")
    plan = fused_plan(m)
    out = torch.empty((m.n_rows, x.shape[1]), dtype=torch.float32, device=x.device)
    counter = torch.empty(1, dtype=torch.int32, device=x.device)
    err = _lib()(x.data_ptr(), None if diag is None else diag.data_ptr(),
                 plan.rows.data_ptr(), plan.idx.data_ptr(), plan.w.data_ptr(),
                 plan.tiles.data_ptr(), plan.tiles.shape[0], counter.data_ptr(),
                 out.data_ptr(), x.shape[1], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"spmm_ell launch failed with CUDA error {err}")
    global launches
    launches += 1
    return out
