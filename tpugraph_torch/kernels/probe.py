"""Stage 0 of the fused GCN layer's probe: one row of x, chosen by an index
the kernel reads, copied out (counterpart of
``scripts/fused_gcn_probe.py:41`` ``tiny_kernel``, whose (16, 128) table and
index [[3]] give a (1, 128) row).

``row_copy`` launches ``csrc/row_copy.cu`` on a CUDA tensor and runs its
plain version, ``row_copy_plain`` (``x[idx[0, 0]][None]``), on a CPU
tensor; it never falls back from the card.  ``scripts/fused_gcn_probe_torch.py``
drives it.
"""

from __future__ import annotations

import ctypes

import torch

from tpugraph_torch.kernels import _build

# kernel launches since the process started (or the caller last reset it)
launches = 0


def row_copy_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out (1, d) = x[idx[0, 0]]."""
    return x[idx[0, 0].long()][None]


def _lib():
    fn = _build.load("row_copy").row_copy_forward
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_int, ctypes.c_long, p]
        fn.restype = ctypes.c_int
    return fn


def row_copy(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out (1, d) = x[idx[0, 0]]: the kernel on a CUDA tensor (x contiguous
    (n, d), idx int32 with at least one element, on x's device), the plain
    version on a CPU tensor.  An index outside [0, n) fails the launch on
    the card and raises ``IndexError`` on the host."""
    if x.device.type == "cpu":
        return row_copy_plain(x, idx)
    if x.device.type != "cuda":
        raise ValueError(f"row_copy runs on cuda or cpu, not {x.device}")
    if x.dim() != 2 or not x.is_contiguous() or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError("x must be a contiguous (n, d) tensor with n, d >= 1")
    if idx.dtype != torch.int32 or idx.numel() < 1 or idx.device != x.device:
        raise ValueError(f"idx must be int32 on {x.device} with at least one element")
    out = torch.empty((1, x.shape[1]), dtype=x.dtype, device=x.device)
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    err = _lib()(x.data_ptr(), idx.contiguous().data_ptr(), out.data_ptr(), x.shape[0],
                 x.shape[1] * x.element_size(), stream)
    if err != 0:
        raise RuntimeError(f"row_copy launch failed with CUDA error {err}")
    global launches
    launches += 1
    return out
