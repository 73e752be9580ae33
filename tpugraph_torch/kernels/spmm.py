"""Sorted-segment SpMM forward and backward (counterpart of
``tpugraph/kernels/spmm.py``), the layers' aggregation for ``spmm_impl``
``sorted`` and ``xla``.

out[i] = Σ_{e: dst[e]=i} w[e] · x[src[e]] over a ``PaddedEdges`` list.

* ``segment_spmm`` — the plain version: an fp32 gather·w, ``index_add_``
  into ``n_rows + 1`` rows (the last is the padding's dump row), sliced,
  cast to x's type.  On the card ``index_add_`` adds by atomics in no
  fixed order, so there it sums in float64, where the order moves a sum
  far below one fp32 rounding: its result is the same from run to run.
* ``sorted_spmm`` — the same function by the hand-written Hopper kernel
  ``csrc/spmm_sorted.cu`` on a CUDA tensor (fp32 or bf16, d ∈ {128, 256}),
  the plain version on a CPU tensor.  It never falls back from the card.
  Its work table (``segment_plan``) is built on the host once per edge list
  and cached on it, with its scratch once per (d, stream), so a call does
  no host work beyond its checks, allocates only its output and is legal
  inside a CUDA graph capture.
* ``segment_plan`` — the kernel's work table: warp-sized items, either a
  run of consecutive short rows (at most ``PACK_SLOTS`` slots: a row's
  edges plus one for its write, so rows with no edge are written too) or
  one balanced segment of a row of more than ``SEG_EDGES`` edges; a cut
  row's segments leave fp32 partial rows that the last of them sums in
  segment order.  Heaviest first.
* ``spmm`` — A·x with a gradient for x (an autograd Function, the
  counterpart of the JAX ``spmm`` custom VJP): ``sorted_spmm`` over
  ``op.fwd`` forward, over ``op.bwd`` backward.  The operator is a
  constant and gets no gradient (the contract of
  ``tpugraph/kernels/vjp_util.py``).
* ``spmm_xla`` — the plain composite on every device, with torch's
  autograd through it (the backward of the gather is a scatter): the
  counterpart of the JAX "XLA autodiff" baseline.  The JAX package's VMA
  tokens (``vjp_util.vma_token``) are ``shard_map`` plumbing and have no
  torch counterpart.

Unlike the ELL path, a pad edge drains to the dump row, so a non-finite
x[0] poisons no row: the path JAX points NaN-probing to.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from tpugraph_torch.kernels import _build
from tpugraph_torch.kernels.spmm_ell import segment_scratch
from tpugraph_torch.sparse.graph import PaddedEdges, SpMMOperator

SUPPORTED_DIMS = (64, 128, 256)  # csrc/spmm_sorted.cu template instances
# The work table's two constants, chosen on an H100 at zh-en scale (the
# sweep in PERF.md §6): caps of 64/96/128/192 edges by packings of 32/64/128
# slots; 96 and 32 were best, or within noise of it, at d = 128 and on the
# incidence, where a 128-edge cap was 5-20 % slower.
SEG_EDGES = 96  # the most edges of one row in one work item
PACK_SLOTS = 32  # slots of a packed item: a row's edges plus 1 for its write
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the process started (or the caller last reset it)
launches = 0


def check_n_cols(edges: PaddedEdges, x: torch.Tensor) -> None:
    """A feature matrix of the wrong height would gather out of bounds on
    the card; refuse it on every device."""
    if edges.n_cols is not None and x.shape[0] != edges.n_cols:
        raise ValueError(f"x has {x.shape[0]} rows but the operator expects {edges.n_cols}")


def segment_spmm(edges: PaddedEdges, x: torch.Tensor) -> torch.Tensor:
    """The plain version: rows [0, n_rows) of the dump-row-padded segment
    sum of fp32 messages, accumulated in fp32 on the host (in edge order)
    and in float64 on the card (atomics), and cast to x's type."""
    check_n_cols(edges, x)
    msg = x.index_select(0, edges.src).float() * edges.w[:, None]
    acc = torch.float64 if x.is_cuda else torch.float32
    out = torch.zeros((edges.n_rows + 1, x.shape[1]), dtype=acc, device=x.device)
    out.index_add_(0, edges.dst, msg.to(acc))
    return out[:edges.n_rows].to(x.dtype)


@dataclass
class SegmentPlan:
    """The kernel's work table for one edge list, on that list's device."""

    # (n_items, 8) int32: rows [r0, r1) and their edges [e0, e1); partial
    # index and cut-row index, or -1 for an item that writes its rows
    # itself; two unused
    items: torch.Tensor
    split_p0: torch.Tensor  # (n_split + 1,) int32: each cut row's first partial
    n_partials: int
    # (d, stream) -> the kernel's scratch there (spmm_ell.segment_scratch)
    scratch: dict = field(default_factory=dict)


def segment_plan(edges: PaddedEdges) -> SegmentPlan:
    """Build (once per edge list, cached on it) the kernel's work table,
    checking the builder's contract on the host: dst non-decreasing, the
    padding at the dump row, src within [0, n_cols)."""
    plan = edges.cache.get("segments")
    if plan is not None:
        return plan
    dst = edges.dst.cpu().numpy().astype(np.int64)
    src = edges.src[:edges.nnz].cpu().numpy()
    if np.any(np.diff(dst) < 0) or np.any(dst[edges.nnz:] != edges.n_rows) or (
            edges.nnz and (int(dst[:edges.nnz].max()) >= edges.n_rows or int(dst[0]) < 0)):
        raise ValueError("edges are not (dst)-sorted with the padding at the dump row")
    n_cols = edges.n_cols if edges.n_cols is not None else edges.n_rows
    if src.size and (int(src.min()) < 0 or int(src.max()) >= n_cols):
        raise ValueError(f"edge source ids out of range for n_cols={n_cols}")
    if edges.e_pad >= 2**31:
        raise ValueError(f"{edges.e_pad} edges exceed the kernel's int32 work table")
    rowptr = np.searchsorted(dst[:edges.nnz], np.arange(edges.n_rows + 1), side="left")
    deg = np.diff(rowptr)
    cost = np.concatenate([[0], np.cumsum(deg + 1)])  # slots before each row
    items, split_p0 = [], [0]
    r, n = 0, edges.n_rows
    while r < n:
        if deg[r] + 1 <= PACK_SLOTS:  # the longest run of whole rows within the packing
            r1 = int(np.searchsorted(cost, cost[r] + PACK_SLOTS, side="right")) - 1
            items.append((r, r1, rowptr[r], rowptr[r1], -1, -1))
            r = r1
            continue
        if deg[r] <= SEG_EDGES:  # a row of its own
            items.append((r, r + 1, rowptr[r], rowptr[r + 1], -1, -1))
        else:  # balanced segments of at most SEG_EDGES edges
            n_seg = -(-int(deg[r]) // SEG_EDGES)
            p0, s = split_p0[-1], len(split_p0) - 1
            bounds = rowptr[r] + np.arange(n_seg + 1) * int(deg[r]) // n_seg
            items += [(r, r + 1, bounds[j], bounds[j + 1], p0 + j, s) for j in range(n_seg)]
            split_p0.append(p0 + n_seg)
        r += 1
    t = np.zeros((len(items), 8), np.int64)
    t[:, :6] = np.asarray(items, np.int64).reshape(-1, 6)
    t = t[np.argsort(-(t[:, 3] - t[:, 2] + t[:, 1] - t[:, 0]), kind="stable")]  # heaviest first
    dev = edges.device
    plan = SegmentPlan(items=torch.from_numpy(t.astype(np.int32)).to(dev).contiguous(),
                       split_p0=torch.from_numpy(np.asarray(split_p0, np.int32)).to(dev),
                       n_partials=int(split_p0[-1]))
    edges.cache["segments"] = plan
    return plan


def _lib():
    fn = _build.load("spmm_sorted").spmm_sorted_forward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, p, p, p, p, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def sorted_spmm(edges: PaddedEdges, x: torch.Tensor) -> torch.Tensor:
    """A @ x over a sorted edge list: the kernel on a CUDA tensor,
    ``segment_spmm`` on a CPU tensor.  x (n_cols, d) float32 or bfloat16,
    d ∈ {128, 256} on the card; the output has x's type."""
    if x.device.type == "cpu":
        return segment_spmm(edges, x)
    if x.device.type != "cuda":
        raise ValueError(f"sorted_spmm runs on cuda or cpu, not {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the sorted SpMM kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be a contiguous, 16-byte aligned (N, d) tensor")
    if x.shape[1] not in SUPPORTED_DIMS:
        raise ValueError(f"d={x.shape[1]} not in {SUPPORTED_DIMS}")
    check_n_cols(edges, x)
    if edges.device != x.device:
        raise ValueError(f"the operator must be on {x.device}")
    return _launch(edges, x, segment_plan(edges))


def _launch(edges: PaddedEdges, x: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """One kernel launch over ``plan``'s work items, on checked inputs."""
    d = x.shape[1]
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    partial, counters = segment_scratch(plan, d, x.device, stream)
    out = torch.empty((edges.n_rows, d), dtype=x.dtype, device=x.device)
    err = _lib()(x.data_ptr(), edges.src.data_ptr(), edges.w.data_ptr(), edges.dst.data_ptr(),
                 plan.items.data_ptr(), plan.items.shape[0], plan.split_p0.data_ptr(),
                 counters, partial, out.data_ptr(), d, _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"spmm_sorted launch failed with CUDA error {err}")
    global launches
    launches += 1
    return out


class _Spmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op):
        ctx.op = op
        return sorted_spmm(op.fwd, x)

    @staticmethod
    def backward(ctx, g):
        return sorted_spmm(ctx.op.bwd, g.contiguous()), None


def spmm(op: SpMMOperator, x: torch.Tensor) -> torch.Tensor:
    """A·x with a gradient for x; the operator is a constant and gets none.
    Forward and backward are one ``sorted_spmm`` launch each on the card."""
    return _Spmm.apply(x, op)


def spmm_xla(op: SpMMOperator, x: torch.Tensor) -> torch.Tensor:
    """A·x by the plain composite, differentiated by torch's autograd (the
    backward of the gather is a scatter), on every device."""
    return segment_spmm(op.fwd, x)
