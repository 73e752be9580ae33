"""Fused GCN layer: out = (A @ x) @ W + b in one kernel launch (counterpart
of ``tpugraph/kernels/gcn_fused_pallas.py``).

On a CUDA tensor ``fused_gcn_layer`` launches the hand-written Hopper
kernel in ``csrc/gcn_fused.cu``; on a CPU tensor it runs the plain version,
``reference_layer`` (ELL aggregate via ``index_select``, then the GEMM).  It
never falls back from the card to the plain version.

``layer_plan`` is the kernel's work, built once per ELL matrix from the two
tables the ELL kernels share (``kernels/spmm_ell.py``): the rows of
K > ``SEG_SLOTS`` as ``segment_plan``'s segments, then ``fused_plan``'s tiles
of the other rows, heaviest first.  Each tile's rows are aggregated in
shared memory (packed virtual-slot walks) and multiplied by W on the tensor
cores as a 3× TF32 split, each group of 16 k's summed outside the tensor
cores' accumulator in fp32 (bf16 at (128, 128) sums inside): fp32-accurate,
as measured on the H100 against a float64 layer
(``scripts/dist_step_probe.py``): 6.9e-8 to 7.8e-8 relative L2 at (128,
128) and (256, 128) on the zh-en and DWY100K operators, under the plain
fp32 layer's 9.4e-8 to 1.4e-7.  At (128, *) and (256, 128) the row's last
segment sums the partials in order and computes its product itself.

At (256, 256) each tile and each segment is gathered once while the tile
before it is multiplied (``csrc/gcn_fused.cu``, ``gcn_fused_kernel_wide``):
in fp32 by a cluster of two CTAs, each holding one 128-column panel of W
(``PANELS``), in bf16 by one CTA holding W whole and multiplying the
aggregate's three bf16 terms on the bf16 tensor cores (``PRODUCTS``).  There
the cut rows (``LayerPlan.hub``) are work units of their own, right after
the segments: each row's partials summed in segment order, then its product
(fp32: the narrow instances' SIMT row product, so the fp32 layer is bit for
bit what the two-panel kernel before it gave).  Every row is written
straight to its natural position, so the buckets' outputs need no
concatenation and no ``row_order`` gather.  The work counters and the
segments' partials are cached per (d_in, d_out, stream) and left at zero by
the kernel, so a call is one launch: no memset, no scratch allocation.

At every other (d_in, d_out) ≥ 1 an any-width kernel runs, by the host plan
``kernel_plan``.  Wherever d_in ≤ 768 and W does not fit whole in half an
SM, the wgmma kernel (``gcn_fused_kernel_wgmma``): a prologue launch lays
Wᵀ out in the product's layout once per call (``wt_layout_plain`` is its
plain version: fp32 as W's big and small TF32 planes, bf16 as W);
clusters of two CTAs take 64-row units (two plan tiles each) and stream
W's chunks by one multicast bulk copy each into a ring of shared memory,
so W moves from L2 once per 128 rows; eleven gather warps aggregate a unit
(rows split by their slots, up to three 128-column slabs a walk) while a
warpgroup multiplies the one before it on wgmma (two aggregate buffers up
to d_in 384, else one); fp32 as 3× TF32, bf16 as the aggregate's three
bf16 terms, each group of 16 k's summed outside the accumulator.  Elsewhere
the per-tile kernel (``gcn_fused_kernel_any``): W whole once per block where
it fits beside a 32-row aggregate, else (d_in above 768) streamed 64 k's a
tile.  ``fused_bucket_apply`` runs the layer over one ELL bucket (the JAX
entry of that name).

``gcn_layer`` is the trainable layer, a ``torch.autograd.Function``.  Its
forward is this kernel where ``fused_width`` says so (``FUSED_WIDTHS``: the
instances' widths and those where the card measured the any-width kernel
faster); at every other width it runs the JAX layer's own order: support =
x·W by ``torch.matmul`` in x's type (a plain matrix product, which the JAX
package leaves to XLA), then A·support + diag ⊙ support by the ELL SpMM
kernel over ``op.fwd`` (one launch), then the bias.  ``fused_width`` is the
one place that choice is made.  The backward is the same for both routes:
u = Aᵀ·ḡ by the ELL SpMM kernel over the prebuilt transpose (one launch, in
ḡ's type), then dx = u·Wᵀ, dW = xᵀ·u (plain matrix products in x's type,
bf16 under bf16 training, as the JAX package leaves them to XLA) and db =
Σ ḡ in fp32.  On CPU tensors both halves run their plain versions, so the
CPU tests exercise the backward formula itself; ``gcn_layer_plain`` is the
whole layer's plain version, by the same route.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from tpugraph_torch.kernels import _build
from tpugraph_torch.kernels.spmm_ell import (PANEL, SEG_SLOTS, TILE_ROWS, FusedPlan,
                                              apply_with_diag, check_diag, check_n_cols,
                                              ell_spmm, fused_plan, segment_plan)
from tpugraph_torch.sparse.ell import EllBucket, EllMatrix, EllOperator

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ELEM = {torch.float32: 4, torch.bfloat16: 2}
# (d_in, d_out, dtype) -> panels of W, the CTAs that share a tile, each
# staging one: the template instances of csrc/gcn_fused.cu.  At (256, 256)
# the fp32 Wᵀ (256 KB) does not fit in a block's shared memory, so a cluster
# of two CTAs holds one 128-column panel each; the bf16 W (128 KB) fits one.
PANELS = {(d_in, d_out, dt): 2 if (d_in, d_out, dt) == (256, 256, torch.float32) else 1
          for d_in, d_out in ((128, 128), (128, 256), (256, 128), (256, 256))
          for dt in _DTYPE_CODE}
WIDTHS = sorted({(d_in, d_out) for d_in, d_out, _ in PANELS})
# (d_in, d_out, dtype) -> the tensor-core products of a tile's aggregate by
# W: 3× TF32 (2× for a bf16 W, exact in TF32), or at bf16 (256, 256) the
# aggregate's three bf16 terms on the bf16 tensor cores
PRODUCTS = {key: (3, "bf16") if key == (256, 256, torch.bfloat16)
            else (3 if key[2] == torch.float32 else 2, "tf32") for key in PANELS}


def products(d_in: int, d_out: int, dtype: torch.dtype) -> tuple[int, str]:
    """The tensor-core products of a tile's aggregate by W at any width:
    ``PRODUCTS`` at an instance's, else the any-width kernel's: 3× TF32 in
    fp32, the aggregate's three bf16 terms in bf16."""
    return PRODUCTS.get((d_in, d_out, dtype),
                        (3, "tf32" if dtype == torch.float32 else "bf16"))


# The widths where gcn_layer runs the fused kernel: the instances', and the
# any-width widths where the plan's kernel measured faster on the card than
# x·W then spmm_ell (PERF.md §6): at (50, 300) and (64, 64) the per-tile kernel
# with W resident; the wgmma kernel beat that route at none of ANY_WIDTHS
FUSED_WIDTHS = frozenset(WIDTHS) | {(50, 300), (64, 64)}

# the per-tile any-width kernel's shape (csrc/gcn_fused.cu, namespace any; its
# tiles are TILE_ROWS rows, its gather panels PANEL columns, the aggregate's
# chunks multiples of PANEL)
W_CHUNK = 64  # kWChunk: k's of Wᵀ staged at a time when W is not resident
SMEM_BLOCK = 232_448  # shared memory a block may use on the H100
SMEM_DYNAMIC = SMEM_BLOCK - 1024  # less the kernel's static arrays, with room to spare
SMEM_TWO_BLOCKS = 114_688  # at most this, two blocks fit an SM (228 KB, 1 KB reserved each)

# the redesigned kernel's shape (csrc/gcn_fused.cu, namespace wg)
WG_ROWS = 64  # rows of a unit: two plan tiles, wgmma's M
WG_CLUSTER = 2  # CTAs that share each W chunk: one multicast copy from L2
WG_N = 64  # output columns of a product pass: wgmma's N
WG_PLANE_BYTES = 8192  # a W chunk's plane: 64 rows of Wᵀ × 128 bytes of k (32 TF32, 64 bf16)
WG_MAX_STAGES = 16  # W ring slots at most
WG_ALIGN = 1024  # the swizzled ring's alignment, reserved in the dynamic memory
SLAB_BYTES = 4 * WG_ROWS * PANEL  # an aggregate slab: WG_ROWS rows × PANEL fp32
# kernel launches since the process started (or the caller last reset it):
# the layer's, and the W prologue's (``wt_layout``, one before each launch of
# the wgmma kernel)
launches = 0
prologue_launches = 0


def fused_width(d_in: int, d_out: int) -> bool:
    """Whether the GCN layer at (d_in, d_out) runs the fused kernel, else
    x·W then the ELL SpMM: the one place ``gcn_layer`` and
    ``gcn_layer_plain`` choose their route."""
    return (d_in, d_out) in FUSED_WIDTHS


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def partial_floats(d_in: int) -> int:
    """Floats of a cut row's fp32 partial in every kernel's scratch: d_in
    rounded up to a whole gather panel (d_in itself at the instances')."""
    return _up(d_in, PANEL)


@dataclass(frozen=True)
class KernelPlan:
    """What a launch at (d_in, d_out, dtype) holds in a block and in scratch."""

    # "gcn_fused_kernel", "gcn_fused_kernel_wide", "gcn_fused_kernel_wgmma"
    # (the wgmma any-width kernel) or "gcn_fused_kernel_any" (the per-tile one,
    # where W stays resident in it or no layout of the redesign fits)
    kernel: str
    k_chunk: int  # columns of d_in aggregated in shared memory at once
    n_k_chunks: int
    panel: int  # output columns multiplied in one pass over the aggregate
    n_panels: int
    cluster: int  # CTAs that share a tile's aggregate or (wgmma) each W chunk
    w_resident: bool  # W staged whole once per block, else streamed
    w_chunk: int  # k's of W staged at a time (wgmma: of a chunk's 128-byte rows)
    smem_bytes: int  # dynamic shared memory a block
    # floats of a cut row's fp32 partial in the scratch, which holds the
    # partials, then the unit and done counters and one counter a cut row
    partial_pitch: int
    unit_rows: int = TILE_ROWS  # rows a CTA multiplies a unit
    # rows that share one pass of W from L2: a CTA's unit (resident W: every
    # unit of the block), a cluster's step with the multicast
    w_pass_rows: int = TILE_ROWS
    # bytes of W one pass reads: the padded grid of panels × k-chunks it
    # walks, at W's element size (the wgmma kernel's prologue layout)
    w_pass_bytes: int = 0
    agg_buffers: int = 1  # 2: the next unit gathered while this one is multiplied
    w_stages: int = 0  # the wgmma kernel's W ring slots

    @property
    def n_tiles_a_warp(self) -> int:
        """mma n-tiles of 8 columns a warp (the per-tile kernel: 1 or 2)."""
        return self.panel // 64

    def w_bytes_per_layer(self, n_rows: int, n_blocks: int = 132) -> int:
        """W bytes the layer reads over ``n_rows`` rows: once per block
        where W is resident (``n_blocks`` of them), else once per pass."""
        if self.w_resident:
            return n_blocks * self.w_pass_bytes
        return -(-n_rows // self.w_pass_rows) * self.w_pass_bytes


def chunk_k(dtype: torch.dtype) -> int:
    """k's of one 128-byte row of a W chunk: 32 TF32 (fp32) or 64 bf16."""
    return 128 // _ELEM[dtype]


def wg_planes(dtype: torch.dtype) -> int:
    """Planes of a W chunk: fp32 W's big and small TF32 parts, or bf16 W."""
    return 2 if dtype == torch.float32 else 1


def wgmma_layout(d_in: int, d_out: int, dtype: torch.dtype) -> tuple[int, int] | None:
    """(buffers, stages) of the wgmma kernel at (d_in, d_out), or None where
    no layout fits: two aggregate buffers where they fit beside two W
    slots, else one; then as many W slots as fit, at most WG_MAX_STAGES."""
    slabs = -(-d_in // PANEL)
    chunk = wg_planes(dtype) * WG_PLANE_BYTES
    for bufs in (2, 1):
        stages = min(WG_MAX_STAGES,
                     (SMEM_DYNAMIC - WG_ALIGN - bufs * slabs * SLAB_BYTES) // chunk)
        if stages >= 2:
            return bufs, stages
    return None


def wgmma_smem(d_in: int, dtype: torch.dtype, bufs: int, stages: int) -> int:
    """The wgmma kernel's dynamic shared memory (csrc/gcn_fused.cu,
    wg::smem_bytes): the alignment, the W ring's chunks, the aggregate
    buffers."""
    return (WG_ALIGN + stages * wg_planes(dtype) * WG_PLANE_BYTES
            + bufs * -(-d_in // PANEL) * SLAB_BYTES)


def wt_layout_bytes(d_in: int, d_out: int, dtype: torch.dtype) -> int:
    """The prologue's layout of Wᵀ: ceil(d_out / 64) panels × ceil(d_in /
    chunk_k) chunks of ``wg_planes`` planes of WG_PLANE_BYTES."""
    return -(-d_out // WG_N) * -(-d_in // chunk_k(dtype)) * wg_planes(dtype) * WG_PLANE_BYTES


def k_of(pos: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """The column of d_in at k position ``pos`` of a W chunk's rows
    (csrc/gcn_fused.cu, wg::k_of): each group of 16 k's permuted so that a
    lane's aggregate columns kk + 4t .. + 3 fill its fragment registers in
    order (TF32: k t, t + 4 of two k-steps; bf16: k 2t, 2t + 1, 2t + 8,
    2t + 9)."""
    j = pos % 16
    if dtype == torch.float32:
        d = 4 * (j % 4) + 2 * (j // 8) + (j % 8) // 4
    else:
        d = 4 * ((j % 8) // 2) + 2 * (j // 8) + j % 2
    return pos // 16 * 16 + d


def tf32_split(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``w`` = big + small, each rounded to TF32 as the kernels round
    (to nearest, ties away from zero: half a TF32 ulp added to the bits,
    then the low 13 cut; ``wide::split_tf32_bits``)."""
    def rna(t):
        bits = t.contiguous().view(torch.int32).to(torch.int64)
        return (((bits + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF).to(torch.uint32).view(torch.float32)
    big = rna(w)
    return big, rna(w - big)


def wt_layout_plain(wmat: torch.Tensor) -> torch.Tensor:
    """The W prologue's plain version: Wᵀ as (panels, k-chunks, planes,
    plane elements) of W's type, chunk (p, c) the 64 columns [64p, 64p + 64)
    of W as rows of 128 bytes (``chunk_k`` k's in ``k_of`` order from
    c·chunk_k), the 16-byte pieces of row n swizzled by n % 8 (the 128-byte
    swizzle wgmma reads); zero past W's edges.  fp32: the planes are W's
    big and small TF32 parts (``tf32_split``); bf16: W itself."""
    d_in, d_out = wmat.shape
    elem = _ELEM[wmat.dtype]
    ck, per = chunk_k(wmat.dtype), WG_PLANE_BYTES // elem
    n_pan, n_kc = -(-d_out // WG_N), -(-d_in // ck)
    b = np.arange(per) * elem
    n = b // 128
    pos = ((((b % 128) // 16) ^ (n % 8)) * 16 + b % 16) // elem
    k = np.arange(n_kc)[:, None] * ck + k_of(pos, wmat.dtype)[None, :]
    col = np.arange(n_pan)[:, None] * WG_N + n[None, :]
    wp = torch.zeros((n_kc * ck, n_pan * WG_N), dtype=wmat.dtype, device=wmat.device)
    wp[:d_in, :d_out] = wmat
    kt, ct = torch.from_numpy(k).to(wmat.device), torch.from_numpy(col).to(wmat.device)
    planes = tf32_split(wp) if wmat.dtype == torch.float32 else (wp,)
    return torch.stack([pl[kt[None, :, :], ct[:, None, :]] for pl in planes], 2)


def any_plan(d_in: int, d_out: int, dtype: torch.dtype) -> KernelPlan:
    """The per-tile any-width kernel's plan (``gcn_fused_kernel_any``):
    output panels of 64 or 128 columns, whichever pads d_out less (128 on a
    tie); the aggregate all of d_in (rounded up to 128 columns) when that
    fits beside one W chunk, else the widest multiple of 128 that does; W
    resident (whole, once per block) where it fits with a 32-row aggregate
    in half an SM, else streamed 64 k's a 32-row tile."""
    panel = 64 if _up(d_out, 64) < _up(d_out, 128) else 128
    kp = partial_floats(d_in)
    w_chunk_bytes = 4 * panel * W_CHUNK
    fit = (SMEM_DYNAMIC - w_chunk_bytes) // (4 * TILE_ROWS) // PANEL * PANEL
    k_chunk = min(kp, fit)
    a_bytes = 4 * TILE_ROWS * k_chunk
    w_bytes = 4 * _up(d_out, panel) * _up(d_in, 32)
    resident = a_bytes + w_bytes <= SMEM_TWO_BLOCKS
    return KernelPlan("gcn_fused_kernel_any", k_chunk, -(-kp // k_chunk), panel,
                      -(-d_out // panel), 1, resident, _up(d_in, 32) if resident else W_CHUNK,
                      a_bytes + (w_bytes if resident else w_chunk_bytes), kp,
                      w_pass_bytes=_ELEM[dtype] * _up(d_out, panel) * (
                          _up(d_in, 32) if resident else _up(_up(d_in, 16), W_CHUNK)))


def kernel_plan(d_in: int, d_out: int, dtype: torch.dtype,
                any_width: bool = False) -> KernelPlan:
    """The launch plan of the layer at (d_in, d_out): the instance's at
    ``WIDTHS`` (unless ``any_width``), else an any-width kernel's: the
    per-tile kernel's (``any_plan``) where it keeps W resident (there it
    measured faster on the H100 than the wgmma kernel: 0.120 against 0.141
    ms at (50, 300), 0.051 against 0.075 at (64, 64), PERF.md §6) or where
    no layout of the wgmma kernel fits (d_in above 768); everywhere else
    that kernel (``wgmma_plan``): 64-row units, a cluster of two CTAs
    sharing each W chunk by one multicast copy (W read once per 128 rows),
    the aggregate whole in slabs of 128 columns, double-buffered where two
    fit (``wgmma_layout``)."""
    if d_in < 1 or d_out < 1:
        raise ValueError(f"the fused layer takes widths >= 1, got ({d_in}, {d_out})")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"the fused layer takes float32 or bfloat16, got {dtype}")
    if (d_in, d_out) in WIDTHS and not any_width:
        pair = PANELS[d_in, d_out, dtype]
        if (d_in, d_out) == (256, 256):
            smem = 128 * 1024 + 2 * 4 * TILE_ROWS * 256
        else:
            smem = 4 * (d_in * d_out + TILE_ROWS * d_in)
        return KernelPlan("gcn_fused_kernel_wide" if (d_in, d_out) == (256, 256)
                          else "gcn_fused_kernel", d_in, 1, d_out // pair, pair, pair, True,
                          d_in, smem, partial_floats(d_in),
                          w_pass_bytes=_ELEM[dtype] * d_in * d_out)
    old = any_plan(d_in, d_out, dtype)
    new = wgmma_plan(d_in, d_out, dtype)
    return old if old.w_resident or new is None else new


def wgmma_plan(d_in: int, d_out: int, dtype: torch.dtype) -> KernelPlan | None:
    """The wgmma any-width kernel's plan at (d_in, d_out), or None where no
    layout of it fits (``wgmma_layout``)."""
    layout = wgmma_layout(d_in, d_out, dtype)
    if layout is None:
        return None
    bufs, stages = layout
    kp = partial_floats(d_in)
    return KernelPlan("gcn_fused_kernel_wgmma", kp, 1, WG_N, -(-d_out // WG_N), WG_CLUSTER,
                      False, chunk_k(dtype), wgmma_smem(d_in, dtype, bufs, stages), kp,
                      unit_rows=WG_ROWS, w_pass_rows=WG_CLUSTER * WG_ROWS,
                      w_pass_bytes=wt_layout_bytes(d_in, d_out, dtype), agg_buffers=bufs,
                      w_stages=stages)


def _add_bias(out: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    return out if bias is None else out + bias.to(out.dtype)


def reference_layer(m: EllMatrix, diag: torch.Tensor | None, x: torch.Tensor,
                    wmat: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version: ELL aggregate (gather + fp32 reduce), then the
    GEMM in fp32, cast to x's type, then the bias."""
    out = apply_with_diag(m, diag, x)
    return _add_bias(torch.matmul(out.float(), wmat.float()).to(x.dtype), bias)


def _lib(name: str = "gcn_fused_forward"):
    lib = _build.load("gcn_fused")
    fn = getattr(lib, name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, p, i, i, p, p, i, p, p, p, i, i, i]
        fn.argtypes += {"gcn_fused_any_forward": [i, i, i, i, p],
                        "gcn_fused_wgmma_forward": [p, i, i, i, p]}.get(name, [p])
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
    if x.shape[1] < 1 or wmat.shape[1] < 1:
        raise ValueError(f"the fused layer takes widths >= 1, got {x.shape[1], wmat.shape[1]}")
    if wmat.shape == (256, 256) and (not wmat.is_contiguous() or wmat.data_ptr() % 16):
        raise ValueError("W at (256, 256) must be contiguous and 16-byte aligned")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (wmat.shape[1],)):
        raise ValueError(f"bias must be float32 of shape ({wmat.shape[1]},)")
    check_diag(m, diag, dev)
    for name, t in (("W", wmat), ("bias", bias), ("operator", m.row_order)):
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous and on {dev}")


def fused_gcn_layer(m: EllMatrix, diag: torch.Tensor | None, x: torch.Tensor,
                    wmat: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """out = (A @ x) @ W (+ b), A = the ELL matrix ``m`` plus ``diag``.

    x (N, d_in) float32 or bfloat16; W (d_in, d_out) of x's type; bias
    (d_out,) float32; output (n_rows, d_out) of x's type.  Forward only:
    ``gcn_layer`` is the trainable form."""
    if x.device.type == "cpu":
        return reference_layer(m, diag, x, wmat, bias)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gcn_layer runs on cuda or cpu, not {x.device}")
    _check(m, diag, x, wmat, bias)
    return _launch(m, diag, x, wmat, bias, layer_plan(m))


def bucket_tile_rows(k: int) -> int:
    """The JAX kernel's tile rows for a bucket of K slots (its
    ``_tile_sizes``: TR = 8·CR, CR·K ≈ 256 DMAs in flight, TR at most 512):
    ``fused_bucket_apply`` pads its rows to a multiple of this."""
    return 8 * max(1, min(64, 256 // k))


def bucket_matrix(idx: torch.Tensor, w: torch.Tensor, n_cols: int) -> EllMatrix:
    """One (R, K) ELL bucket as an EllMatrix of R_pad rows (rows past R in
    no bucket, so zero), on idx's device: the operand of
    ``fused_bucket_apply``, built once per bucket by a caller that applies
    it often (the kernel's plans are cached on it)."""
    r, k = idx.shape
    r_pad = _up(r, bucket_tile_rows(k))
    dev = idx.device
    order = torch.full((r_pad,), r, dtype=torch.int32)
    order[:r] = torch.arange(r, dtype=torch.int32)
    bucket = EllBucket(rows=torch.arange(r, dtype=torch.int32, device=dev),
                       idx=idx.to(torch.int32).contiguous(), w=w.to(torch.float32).contiguous(),
                       k=int(k))
    return EllMatrix(buckets=[bucket], row_order=order.to(dev), n_rows=r_pad,
                     nnz=int(r * k), n_cols=int(n_cols))


def fused_bucket_apply_plain(idx: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
                             wmat: torch.Tensor) -> torch.Tensor:
    """``fused_bucket_apply``'s plain version, on x's device: Σ_k w·x[idx]
    in fp32, times W in fp32, cast to x's type, zero rows to R_pad."""
    r, k = idx.shape
    agg = torch.einsum("rk,rkd->rd", w.float(), x[idx.long()].float())
    out = torch.zeros((_up(r, bucket_tile_rows(k)), wmat.shape[1]), dtype=x.dtype,
                      device=x.device)
    out[:r] = (agg @ wmat.float()).to(x.dtype)
    return out


def fused_bucket_apply(idx: torch.Tensor, w: torch.Tensor, x: torch.Tensor, wmat: torch.Tensor,
                       matrix: EllMatrix | None = None) -> torch.Tensor:
    """(R, K) ELL bucket → (R_pad, d_out) = (the bucket's aggregate of x)·W,
    R_pad the multiple of ``bucket_tile_rows(K)`` at or above R, rows past R
    zero (``tpugraph/kernels/gcn_fused_pallas.py::fused_bucket_apply``;
    callers slice [:R]).  No diagonal, no bias.  On a CUDA tensor one launch
    of the any-width kernel over the bucket (``matrix``: its
    ``bucket_matrix``, else built here); on the CPU the weighted sums of
    x[idx] in fp32, then the product in fp32, cast to x's type."""
    if x.device.type == "cpu":
        return fused_bucket_apply_plain(idx, w, x, wmat)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bucket_apply runs on cuda or cpu, not {x.device}")
    m = bucket_matrix(idx, w, x.shape[0]) if matrix is None else matrix
    r, k = idx.shape
    if m.n_rows != _up(r, bucket_tile_rows(k)) or m.buckets[0].idx.shape != idx.shape:
        raise ValueError("matrix is not this bucket's bucket_matrix")
    _check(m, None, x, wmat, None)
    return _launch(m, None, x, wmat, None, layer_plan(m), any_width=True)


@dataclass
class LayerPlan:
    """The fused layer's work on one EllMatrix, on that matrix's device:
    ``fused_plan``'s tiles for the rows of K ≤ SEG_SLOTS (the kernel skips
    the other tiles), and ``segment_plan``'s segments of the rows it cuts."""

    tiles: FusedPlan
    segs: torch.Tensor  # (n_segs, 8) int32: the segment plan's items with a partial
    split_p0: torch.Tensor  # (n_split + 1,) int32: each cut row's first partial
    n_partials: int
    # (n_hub, 2) int32: (cut row, natural row) of each cut row whose segments
    # are all in ``segs``, in cut-row order: the (256, 256) kernel's last units
    hub: torch.Tensor
    # (d_in, d_out, stream) -> the kernel's scratch there: the cut rows'
    # partials, then the work counter, the done counter and one counter per
    # cut row, zeroed once (the kernel leaves each at 0)
    scratch: dict = field(default_factory=dict)


def layer_plan(m: EllMatrix) -> LayerPlan:
    """Build (once per matrix, cached on it) the fused layer's work."""
    plan = m.cache.get("layer")
    if plan is None:
        seg = segment_plan(m)
        segs = seg.items[seg.items[:, 6] >= 0].contiguous()
        it = segs.cpu().numpy()
        natural = np.zeros(seg.split_p0.shape[0] - 1, np.int32)
        natural[it[:, 7]] = seg.base.rows.cpu().numpy()[it[:, 0]]
        hub = np.stack([np.arange(natural.shape[0], dtype=np.int32), natural], 1)
        plan = LayerPlan(tiles=seg.base, segs=segs, split_p0=seg.split_p0,
                         n_partials=seg.n_partials,
                         hub=torch.from_numpy(hub).to(m.device).contiguous())
        m.cache["layer"] = plan
    return plan


def sub_plan(plan: LayerPlan, tiles: torch.Tensor, segs: torch.Tensor) -> LayerPlan:
    """``plan`` over part of its work (to time that part alone): the tiles
    and segments given, and the cut rows whose segments are all among them,
    so the (256, 256) kernel never waits on a segment it will not run.  The
    other rows are left unwritten."""
    counts = torch.bincount(segs[:, 7].long(), minlength=plan.hub.shape[0])
    whole = plan.split_p0[1:] - plan.split_p0[:-1]
    keep = (counts == whole)[plan.hub[:, 0].long()]
    return dataclasses.replace(plan, tiles=dataclasses.replace(plan.tiles, tiles=tiles),
                               segs=segs, hub=plan.hub[keep].contiguous(), scratch={})


def _scratch(plan: LayerPlan, d_in: int, d_out: int, device: torch.device,
             stream: int) -> torch.Tensor:
    scratch = plan.scratch.get((d_in, d_out, stream))
    if scratch is None:
        n_split = plan.split_p0.shape[0] - 1
        scratch = torch.zeros(plan.n_partials * partial_floats(d_in) + 2 + n_split,
                              dtype=torch.float32, device=device)
        plan.scratch[(d_in, d_out, stream)] = scratch
    return scratch


def _wt_scratch(plan: LayerPlan, d_in: int, d_out: int, dtype: torch.dtype,
                device: torch.device, stream: int) -> torch.Tensor:
    """The wgmma kernel's scratch for its prologue's layout of Wᵀ
    (``wt_layout_bytes``), cached per (d_in, d_out, dtype, stream)."""
    key = ("wt", d_in, d_out, dtype, stream)
    wt = plan.scratch.get(key)
    if wt is None:
        wt = torch.empty(wt_layout_bytes(d_in, d_out, dtype), dtype=torch.uint8, device=device)
        plan.scratch[key] = wt
    return wt


def counters(plan: LayerPlan, d_in: int, d_out: int, stream: int) -> torch.Tensor:
    """The kernel's int32 counters in ``plan``'s scratch for (d_in, d_out)
    on ``stream``: 0 after every launch."""
    pitch = partial_floats(d_in)
    return plan.scratch[(d_in, d_out, stream)][plan.n_partials * pitch:].view(torch.int32)


def _launch(m: EllMatrix, diag: torch.Tensor | None, x: torch.Tensor, wmat: torch.Tensor,
            bias: torch.Tensor | None, plan: LayerPlan, any_width: bool = False) -> torch.Tensor:
    """One kernel launch over ``plan``'s segments and tiles, on checked
    inputs: the instance at ``WIDTHS`` unless ``any_width``, else the
    any-width kernel."""
    d_in, d_out = x.shape[1], wmat.shape[1]
    kp = kernel_plan(d_in, d_out, x.dtype, any_width)
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    partial = _scratch(plan, d_in, d_out, x.device, stream).data_ptr()
    tiles = plan.tiles
    out = torch.empty((m.n_rows, d_out), dtype=x.dtype, device=x.device)
    args = (x.data_ptr(), wmat.data_ptr(), None if bias is None else bias.data_ptr(),
            None if diag is None else diag.data_ptr(), tiles.rows.data_ptr(),
            tiles.idx.data_ptr(), tiles.w.data_ptr(), tiles.tiles.data_ptr(),
            tiles.tiles.shape[0], plan.segs.data_ptr(), plan.segs.shape[0], SEG_SLOTS,
            plan.split_p0.data_ptr(), plan.hub.data_ptr(), plan.hub.shape[0],
            partial + 4 * plan.n_partials * kp.partial_pitch, partial, out.data_ptr(), d_in,
            d_out, _DTYPE_CODE[x.dtype])
    wgmma = kp.kernel == "gcn_fused_kernel_wgmma"
    if wgmma:  # two launches: the W prologue, then the layer
        wt = _wt_scratch(plan, d_in, d_out, x.dtype, x.device, stream)
        err = _lib("gcn_fused_wgmma_forward")(*args, wt.data_ptr(), kp.agg_buffers, kp.w_stages,
                                              kp.smem_bytes, stream)
    elif kp.kernel == "gcn_fused_kernel_any":
        err = _lib("gcn_fused_any_forward")(*args, kp.k_chunk, kp.n_tiles_a_warp,
                                            int(kp.w_resident), kp.smem_bytes, stream)
    else:
        err = _lib()(*args, stream)
    if err != 0:
        raise RuntimeError(f"gcn_fused launch failed with CUDA error {err}")
    global launches, prologue_launches
    launches += 1
    prologue_launches += wgmma
    return out


class _GcnLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wmat, bias, op):
        ctx.op = op
        ctx.save_for_backward(x, wmat)
        if fused_width(x.shape[1], wmat.shape[1]):
            return fused_gcn_layer(op.fwd, op.diag, x, wmat, bias)
        return _add_bias(ell_spmm(op.fwd, op.diag, torch.matmul(x, wmat)), bias)

    @staticmethod
    def backward(ctx, g):
        x, wmat = ctx.saved_tensors
        need_x, need_w, need_b, _ = ctx.needs_input_grad
        # Aᵀ·ḡ; the diagonal is symmetric, so Aᵀ = Bᵀ + diag with the same vector
        u = ell_spmm(ctx.op.bwd, ctx.op.diag, g.contiguous())
        dx = u @ wmat.t() if need_x else None
        dw = x.t() @ u if need_w else None
        db = g.float().sum(0) if need_b else None  # the bias is fp32 in both types
        return dx, dw, db, None


def gcn_layer(op: EllOperator, x: torch.Tensor, wmat: torch.Tensor,
              bias: torch.Tensor | None = None) -> torch.Tensor:
    """A·x·W + b with gradients for x, W and b; x and W float32, or both
    bfloat16 (W cast from the fp32 parameter, whose gradient flows back
    through the cast), b float32.  The operator is a constant and gets
    none, as in the JAX package's ``spmm_ell``."""
    return _GcnLayer.apply(x, wmat, bias, op)


def gcn_layer_plain(op: EllOperator, x: torch.Tensor, wmat: torch.Tensor,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """``gcn_layer``'s plain version by the same route, differentiated by
    autograd: ``reference_layer`` at a fused width, else x·W then
    ``apply_with_diag``."""
    if fused_width(x.shape[1], wmat.shape[1]):
        return reference_layer(op.fwd, op.diag, x, wmat, bias)
    return _add_bias(apply_with_diag(op.fwd, op.diag, torch.matmul(x, wmat)), bias)
