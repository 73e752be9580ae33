"""Fused GCN layer: out = (A @ x) @ W + b in one kernel launch (counterpart
of ``tpugraph/kernels/gcn_fused_pallas.py``).

On a CUDA tensor ``fused_gcn_layer`` launches the hand-written Hopper
kernel in ``csrc/gcn_fused.cu``; on a CPU tensor it runs the plain version,
``reference_layer`` (ELL aggregate via ``index_select``, then the GEMM).  It
never falls back from the card to the plain version.

``layer_plan`` is the kernel's work, built once per ELL matrix from the two
tables the ELL kernels share (``kernels/spmm_ell.py``): the rows of
K > ``SEG_SLOTS`` as ``segment_plan``'s segments, whose partial rows the
row's last segment sums in order before its own product, then
``fused_plan``'s tiles of the other rows, heaviest first.  At (256, 256)
each block owns one 128-column panel of W (``PANELS``) and both panels'
blocks walk the whole plan.  Each tile's rows
are aggregated in shared memory (packed virtual-slot walks) and multiplied
by W on the tensor cores as a 3× TF32 split, each group of 16 k's summed
outside the tensor cores' accumulator in fp32 (bf16 at (128, 128) sums
inside): fp32-accurate, as measured on the H100 against a float64 layer
(``scripts/dist_step_probe.py``): 6.9e-8 to 7.8e-8 relative L2 at (128,
128) and (256, 128) on the zh-en and DWY100K operators, under the plain
fp32 layer's 9.4e-8 to 1.4e-7.  Every row is
written straight to its natural position, so the buckets' outputs need no
concatenation and no ``row_order`` gather.  The work counters and the
segments' partials are cached per (d_in, d_out, stream) and left at zero by the
kernel, so a call is one launch: no memset, no scratch allocation.

``gcn_layer`` is the trainable layer, a ``torch.autograd.Function``: the
forward is this kernel; the backward is u = Aᵀ·ḡ by the ELL SpMM kernel
over the prebuilt transpose (one launch, in ḡ's type), then dx = u·Wᵀ,
dW = xᵀ·u (plain matrix products in x's type, bf16 under bf16 training, as
the JAX package leaves them to XLA) and db = Σ ḡ in fp32.  On CPU tensors
both halves run their plain versions, so the CPU tests exercise the
backward formula itself.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import torch

from tpugraph_torch.kernels import _build
from tpugraph_torch.kernels.spmm_ell import (SEG_SLOTS, FusedPlan, apply_with_diag,
                                              check_diag, check_n_cols, ell_spmm, fused_plan,
                                              segment_plan)
from tpugraph_torch.sparse.ell import EllMatrix, EllOperator

# (d_in, d_out) -> panels of W: the template instances of csrc/gcn_fused.cu.
# At (256, 256) the fp32 Wᵀ does not fit in a block's shared memory, so each
# block stages one 128-column panel and the grid holds both panels' blocks.
PANELS = {(128, 128): 1, (128, 256): 1, (256, 128): 1, (256, 256): 2}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the process started (or the caller last reset it)
launches = 0


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
        fn.argtypes = [p, p, p, p, p, p, p, p, i, p, i, i, p, p, p, p, i, i, i, p]
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
    if (x.shape[1], wmat.shape[1]) not in PANELS:
        raise ValueError(f"(d_in, d_out)={x.shape[1], wmat.shape[1]} not in {sorted(PANELS)}")
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


@dataclass
class LayerPlan:
    """The fused layer's work on one EllMatrix, on that matrix's device:
    ``fused_plan``'s tiles for the rows of K ≤ SEG_SLOTS (the kernel skips
    the other tiles), and ``segment_plan``'s segments of the rows it cuts."""

    tiles: FusedPlan
    segs: torch.Tensor  # (n_segs, 8) int32: the segment plan's items with a partial
    split_p0: torch.Tensor  # (n_split + 1,) int32: each cut row's first partial
    n_partials: int
    # (d_in, d_out, stream) -> the kernel's scratch there: the cut rows'
    # partials (one per panel), then the panels' work counters, the done
    # counter and one counter per cut row and panel, zeroed once (the kernel
    # leaves each at 0)
    scratch: dict = field(default_factory=dict)


def layer_plan(m: EllMatrix) -> LayerPlan:
    """Build (once per matrix, cached on it) the fused layer's work."""
    plan = m.cache.get("layer")
    if plan is None:
        seg = segment_plan(m)
        plan = LayerPlan(tiles=seg.base, segs=seg.items[seg.items[:, 6] >= 0].contiguous(),
                         split_p0=seg.split_p0, n_partials=seg.n_partials)
        m.cache["layer"] = plan
    return plan


def _launch(m: EllMatrix, diag: torch.Tensor | None, x: torch.Tensor, wmat: torch.Tensor,
            bias: torch.Tensor | None, plan: LayerPlan) -> torch.Tensor:
    """One kernel launch over ``plan``'s segments and tiles, on checked inputs."""
    d_in, d_out = x.shape[1], wmat.shape[1]
    n_panels = PANELS[(d_in, d_out)]
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    scratch = plan.scratch.get((d_in, d_out, stream))
    if scratch is None:
        n_split = plan.split_p0.shape[0] - 1
        scratch = torch.zeros(n_panels * (plan.n_partials * d_in + n_split) + n_panels + 1,
                              dtype=torch.float32, device=x.device)
        plan.scratch[(d_in, d_out, stream)] = scratch
    partial = scratch.data_ptr()
    tiles = plan.tiles
    out = torch.empty((m.n_rows, wmat.shape[1]), dtype=x.dtype, device=x.device)
    err = _lib()(x.data_ptr(), wmat.data_ptr(),
                 None if bias is None else bias.data_ptr(),
                 None if diag is None else diag.data_ptr(),
                 tiles.rows.data_ptr(), tiles.idx.data_ptr(), tiles.w.data_ptr(),
                 tiles.tiles.data_ptr(), tiles.tiles.shape[0], plan.segs.data_ptr(),
                 plan.segs.shape[0], SEG_SLOTS, plan.split_p0.data_ptr(),
                 partial + 4 * n_panels * plan.n_partials * d_in, partial, out.data_ptr(), d_in,
                 d_out, _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"gcn_fused launch failed with CUDA error {err}")
    global launches
    launches += 1
    return out


class _GcnLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wmat, bias, op):
        ctx.op = op
        ctx.save_for_backward(x, wmat)
        return fused_gcn_layer(op.fwd, op.diag, x, wmat, bias)

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
