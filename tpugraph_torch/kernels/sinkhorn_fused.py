"""Fused sqeuclidean-cost + Sinkhorn potential update (counterpart of
``tpugraph/kernels/sinkhorn_pallas.py``).

    f_i = τ·(log μ_i − LSE_j[(g_j − C_ij)/τ]),
    C_ij = max(‖l_i‖² + ‖r_j‖² − 2·l_i·r_j, 0)

* ``sinkhorn_potential_update`` — one update: on a CUDA tensor one launch
  of the hand-written Hopper kernel ``csrc/sinkhorn_fused.cu``, which builds
  the cost tile by tile on the tensor cores (a 3× TF32 split, fp32's
  accuracy) and never stores it; on a CPU tensor the plain version
  ``sinkhorn_update_plain`` (a materialised cost, then ``torch.logsumexp``).
  Any d ≥ 1: rows of a width that is no multiple of 4 get zero columns
  (``pad.pad_columns``), which change no norm and no dot product; above
  256 the kernel streams the query strip beside the candidate tiles, in
  shared memory that does not grow with d.  It never falls back
  from the card.
* ``stream_plan`` — how the persistent kernel shares the work: one block
  per SM takes an equal run of the (query strip, candidate tile) units; the
  piece of a strip each block covers is one split of its candidate axis,
  whose partial (max, sumexp) the strip's last block merges in split order.
* ``sinkhorn_potentials_fused`` — the solver: alternate f- and g-updates by
  swapping the two sides, the squared norms computed once per solve.
* ``sinkhorn_reverse`` — the reverse of one update over a block of a
  materialised cost (the OT head's backward, ``train/ot.py`` and
  ``dist/ring.py``): adds ō⊙P to the block of C̄ in place and returns
  b̄ = −Σ ō⊙P along the update's axis.  On a CUDA tensor one launch of the
  hand-written Hopper kernel ``csrc/sinkhorn_reverse.cu`` (the elementwise
  pass with per-tile partial sums, then their sum in tile order); on a CPU
  tensor the plain version ``sinkhorn_reverse_plain``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from tpugraph_torch.kernels import _build
from tpugraph_torch.kernels.pad import pad_columns

TILE_Q, TILE_C = 64, 128  # kBQ, kBC in csrc/sinkhorn_fused.cu
PRECISION = "3xtf32"  # the kernel's product: big·big + big·small + small·big in TF32

# kernel launches since the process started (or the caller last reset them):
# the potential update's and the reverse update's
launches = 0
reverse_launches = 0
REV_TILE_Q, REV_TILE_C = 32, 256  # kTQ, kTC in csrc/sinkhorn_reverse.cu

# (q, c, device, stream) -> the kernel's scratch there: the splits' partial
# (max, sumexp), then the strips' counters, zeroed once (the kernel leaves
# each counter at 0)
_scratch: dict[tuple[int, int, int, int], torch.Tensor] = {}


def sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Row squared norms, the ‖·‖² terms of the expanded cost."""
    return (x * x).sum(1)


def sinkhorn_update_plain(l: torch.Tensor, r: torch.Tensor, g: torch.Tensor,
                          log_mu: torch.Tensor, tau: float, l_sq: torch.Tensor | None = None,
                          r_sq: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version: the (Q, C) cost, then one logsumexp over C."""
    l_sq = sq_norms(l) if l_sq is None else l_sq
    r_sq = sq_norms(r) if r_sq is None else r_sq
    cost = (l_sq[:, None] + r_sq[None, :] - 2.0 * (l @ r.t())).clamp_min(0.0)
    return tau * (log_mu - torch.logsumexp((g[None, :] - cost) / tau, dim=1))


@functools.cache
def stream_plan(q: int, c: int, n_sm: int) -> tuple[int, int]:
    """(grid, most splits of one strip): ``grid`` blocks, at most one per
    SM, share the ceil(q / TILE_Q) × ceil(c / TILE_C) units strip by strip,
    block b taking units [b·total/grid, (b+1)·total/grid)."""
    n_strips, n_tiles = -(-q // TILE_Q), -(-c // TILE_C)
    total = n_strips * n_tiles
    grid = min(n_sm, total)

    def owner(u):  # the block whose run holds unit u
        return ((u + 1) * grid - 1) // total

    return grid, max(owner((s + 1) * n_tiles - 1) - owner(s * n_tiles) + 1
                     for s in range(n_strips))


@functools.cache
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lib():
    fn = _build.load("sinkhorn_fused").sinkhorn_update_forward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, ctypes.c_float, i, i, i, i, i, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _check(l, r, g, log_mu, l_sq, r_sq) -> None:
    dev = l.device
    if l.dim() != 2 or r.dim() != 2 or l.shape[1] != r.shape[1]:
        raise ValueError(f"l (Q, d) and r (C, d) must share d, got {tuple(l.shape)}, "
                         f"{tuple(r.shape)}")
    if l.shape[1] % 4 or l.shape[1] == 0 or r.shape[0] == 0:
        raise ValueError(f"the kernel takes widths d ≥ 1 (padded to a multiple of 4) and "
                         f"C > 0, got d={l.shape[1]}, C={r.shape[0]}")
    q, c = l.shape[0], r.shape[0]
    for name, t, shape in (("l", l, tuple(l.shape)), ("r", r, tuple(r.shape)),
                           ("g", g, (c,)), ("log_mu", log_mu, (q,)),
                           ("l_sq", l_sq, (q,)), ("r_sq", r_sq, (c,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous and on {dev}")
    if l.data_ptr() % 16 or r.data_ptr() % 16:
        raise ValueError("l and r must be 16-byte aligned (the kernel reads float4)")


def sinkhorn_potential_update(l: torch.Tensor, r: torch.Tensor, g: torch.Tensor,
                              log_mu: torch.Tensor, tau: float,
                              l_sq: torch.Tensor | None = None,
                              r_sq: torch.Tensor | None = None) -> torch.Tensor:
    """One f-update: (Q,) new query potentials from l (Q, d), r (C, d),
    g (C,) and log μ (Q,), all float32.  ``l_sq``/``r_sq`` are the squared
    row norms, computed here when not given."""
    if l.device.type == "cpu":
        return sinkhorn_update_plain(l, r, g, log_mu, tau, l_sq, r_sq)
    if l.device.type != "cuda":
        raise ValueError(f"sinkhorn_potential_update runs on cuda or cpu, not {l.device}")
    l_sq = sq_norms(l) if l_sq is None else l_sq
    r_sq = sq_norms(r) if r_sq is None else r_sq
    if l.dim() == 2 and r.dim() == 2 and l.shape[1] == r.shape[1]:
        l, r = pad_columns(l, 4), pad_columns(r, 4)
    _check(l, r, g, log_mu, l_sq, r_sq)
    (q, d), c = l.shape, r.shape[0]
    index = l.device.index if l.device.index is not None else torch.cuda.current_device()
    grid, max_splits = stream_plan(q, c, _n_sm(index))
    n_strips = -(-q // TILE_Q)
    n_partial = n_strips * max_splits * TILE_Q * 2
    stream = torch._C._cuda_getCurrentRawStream(index)
    scratch = _scratch.get((q, c, index, stream))
    if scratch is None:
        # the float2 partials first, so their stores stay 8-byte aligned
        scratch = torch.zeros(n_partial + n_strips, dtype=torch.float32, device=l.device)
        _scratch[(q, c, index, stream)] = scratch
    base = scratch.data_ptr()
    out = torch.empty(q, dtype=torch.float32, device=l.device)
    err = _lib()(l.data_ptr(), r.data_ptr(), l_sq.data_ptr(), r_sq.data_ptr(), g.data_ptr(),
                 log_mu.data_ptr(), float(tau), q, c, d, grid, max_splits,
                 base, base + 4 * n_partial, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"sinkhorn_fused launch failed with CUDA error {err}")
    global launches
    launches += 1
    return out


def solve(l: torch.Tensor, r: torch.Tensor, tau: float,
          n_iters: int) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Every iterate of the solver: ([f_1..f_n], [g_1..g_n]), 2·n_iters
    updates, f first, from f = g = 0 and uniform marginals."""
    q, c = l.shape[0], r.shape[0]
    l_sq, r_sq = sq_norms(l), sq_norms(r)
    if l.is_cuda:  # the kernel's rows are padded once here, not in each update
        l, r = pad_columns(l, 4), pad_columns(r, 4)
    log_mu = torch.full((q,), -math.log(q), dtype=torch.float32, device=l.device)
    log_nu = torch.full((c,), -math.log(c), dtype=torch.float32, device=l.device)
    g = torch.zeros(c, dtype=torch.float32, device=l.device)
    fs, gs = [], []
    for _ in range(n_iters):
        f = sinkhorn_potential_update(l, r, g, log_mu, tau, l_sq, r_sq)
        g = sinkhorn_potential_update(r, l, f, log_nu, tau, r_sq, l_sq)
        fs.append(f)
        gs.append(g)
    return fs, gs


def sinkhorn_potentials_fused(l: torch.Tensor, r: torch.Tensor, tau: float = 0.05,
                              n_iters: int = 20) -> tuple[torch.Tensor, torch.Tensor]:
    """Full solver; matches ``kernels/sinkhorn.py::sinkhorn_potentials`` on
    cost = sqeuclidean(l, r)."""
    if n_iters < 1:
        raise ValueError("n_iters must be >= 1")
    fs, gs = solve(l.float().contiguous(), r.float().contiguous(), tau, n_iters)
    return fs[-1], gs[-1]


def sinkhorn_reverse_plain(cbar: torch.Tensor, cost: torch.Tensor, b: torch.Tensor,
                           lse: torch.Tensor, out_bar: torch.Tensor, tau: float,
                           rows: bool) -> torch.Tensor:
    """The plain version of ``sinkhorn_reverse``: torch's elementwise passes."""
    if rows:
        t = (b[None, :] - cost).div_(tau).sub_(lse[:, None]).exp_().mul_(out_bar[:, None])
    else:
        t = (b[:, None] - cost).div_(tau).sub_(lse[None, :]).exp_().mul_(out_bar[None, :])
    cbar.add_(t)
    return -t.sum(0 if rows else 1)


def _reverse_lib():
    fn = _build.load("sinkhorn_reverse").sinkhorn_reverse_forward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, ctypes.c_int64, i, i, p, p, p, ctypes.c_float, i, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def sinkhorn_reverse(cbar: torch.Tensor, cost: torch.Tensor, b: torch.Tensor,
                     lse: torch.Tensor, out_bar: torch.Tensor, tau: float,
                     rows: bool) -> torch.Tensor:
    """The reverse of one potential update out = τ(log m − LSE((b − C)/τ))
    over a block C (Q, C′) of the cost, float32, rows of any stride and
    columns contiguous (a column slice), with C̄ ``cbar`` of the same
    layout.  ``rows``: an f-update over the block's rows, b (C′,), the
    saved ``lse`` = log m − out/τ and ō (Q,); else a g-update over its
    columns, b (Q,), lse and ō (C′,).  With P = exp((b − C)/τ − lse) it
    adds ō⊙P to ``cbar`` in place and returns b̄ = −Σ ō⊙P, summed over the
    rows (rows) or the columns."""
    if cost.device.type == "cpu":
        return sinkhorn_reverse_plain(cbar, cost, b, lse, out_bar, tau, rows)
    if cost.device.type != "cuda":
        raise ValueError(f"sinkhorn_reverse runs on cuda or cpu, not {cost.device}")
    q, c = cost.shape
    if (cost.dtype != torch.float32 or cbar.dtype != torch.float32 or cbar.shape != cost.shape
            or cbar.stride() != cost.stride() or cost.stride(1) != 1
            or cost.stride(0) < c or cbar.device != cost.device):
        raise ValueError(f"cost and cbar must be float32 blocks of one layout with contiguous "
                         f"columns, got {cost.dtype} {tuple(cost.shape)} {cost.stride()} and "
                         f"{cbar.dtype} {tuple(cbar.shape)} {cbar.stride()}")
    n_b, n_o = (c, q) if rows else (q, c)
    vecs = []
    for name, t, n in (("b", b, n_b), ("lse", lse, n_o), ("out_bar", out_bar, n_o)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n,) or t.device != cost.device:
            raise ValueError(f"{name} must be float32 of shape ({n},) on {cost.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        vecs.append(t.contiguous())
    n_tiles = -(-q // REV_TILE_Q) if rows else -(-c // REV_TILE_C)
    partial = torch.empty(n_tiles * n_b, dtype=torch.float32, device=cost.device)
    out = torch.empty(n_b, dtype=torch.float32, device=cost.device)
    err = _reverse_lib()(cost.data_ptr(), cbar.data_ptr(), cost.stride(0), q, c,
                         *(t.data_ptr() for t in vecs), float(tau), int(rows),
                         partial.data_ptr(), out.data_ptr(),
                         torch._C._cuda_getCurrentRawStream(cost.device.index))
    if err != 0:
        raise RuntimeError(f"sinkhorn_reverse launch failed with CUDA error {err}")
    global reverse_launches
    reverse_launches += 1
    return out
