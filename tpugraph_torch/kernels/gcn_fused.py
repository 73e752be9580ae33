"""Fused GCN layer: out = (A @ x) @ W + b in one kernel launch (counterpart
of ``tpugraph/kernels/gcn_fused_pallas.py``).

On a CUDA tensor ``fused_gcn_layer`` launches the hand-written Hopper
kernel in ``csrc/gcn_fused.cu``; on a CPU tensor it runs the plain version,
``reference_layer`` (ELL aggregate via ``index_select``, then the GEMM).  It
never falls back from the card to the plain version.

The kernel walks the tile table of ``kernels/spmm_ell.py::fused_plan``
(built once per ELL matrix, heaviest tiles first) and writes each tile's
rows straight to their natural positions, so the buckets' outputs need no
concatenation and no ``row_order`` gather.

``gcn_layer`` is the trainable layer, a ``torch.autograd.Function``: the
forward is this kernel; the backward is u = Aᵀ·ḡ by the ELL SpMM kernel
over the prebuilt transpose (one launch), then dx = u·Wᵀ, dW = xᵀ·u and
db = Σ ḡ as plain matrix products.  On CPU tensors both halves run their
plain versions, so the CPU tests exercise the backward formula itself.
"""

from __future__ import annotations

import ctypes

import torch

from tpugraph_torch.kernels import _build
from tpugraph_torch.kernels.spmm_ell import (apply_with_diag, check_diag, check_n_cols,
                                              ell_spmm, fused_plan)
from tpugraph_torch.sparse.ell import EllMatrix, EllOperator

SUPPORTED_DIMS = {(128, 128), (128, 256), (256, 128)}  # template instances
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
        db = g.sum(0) if need_b else None
        return dx, dw, db, None


def gcn_layer(op: EllOperator, x: torch.Tensor, wmat: torch.Tensor,
              bias: torch.Tensor | None = None) -> torch.Tensor:
    """A·x·W + b with gradients for x, W and b (float32); the operator is a
    constant and gets none, as in the JAX package's ``spmm_ell``."""
    return _GcnLayer.apply(x, wmat, bias, op)
