"""The L1 margin ranking loss (counterpart of the XLA ops of
``tpugraph/train/losses.py::margin_align_loss``, forward and autodiff):

    L = 0.5·(mean ReLU(d⁺ + γ − d(e_l, neg_r)) + mean ReLU(d⁺ + γ − d(neg_l, e_r)))

in L1, and with ``weights`` (S,) each side's mean Σ w·ReLU / (Σ w · k).

* ``margin_l1_loss`` — the loss as a ``torch.autograd.Function``
  (``MarginL1``).  On a CUDA table one launch of the hand-written Hopper
  kernel ``csrc/margin_l1.cu`` forward (two kernels: one warp a pair row,
  then a one-block sum of the rows' partials in a fixed order) and one
  backward, which writes each table row's gradient once, summing the
  row's contributions in the order of ``contribution_index`` (in items of
  ``SEG`` records, ``record_items``, then the items in order): two calls
  give the same bits.  On a CPU table the same arithmetic in torch
  (``forward_plain``, ``backward_plain``).  It never falls back from the
  card.
* ``margin_loss_plain`` — the plain version: the composite of gathers, the
  L1 distances and the means, differentiated by autograd.  The training
  path takes it on the CPU (``train/losses.py::margin_align_loss``).

What the forward keeps for the backward is one byte an entry (``flags``:
bit 0 the right side's hinge, bit 1 the left's, set where the hinge's
argument is ≥ 0 and the negative is not the pair's own partner, which the
pool-of-one fill hands back: there the hinge is γ whatever the rows) and
the denominator D.
"""

from __future__ import annotations

import ctypes

import torch

from tpugraph_torch.kernels import _build

WIDTHS = (16, 32, 64, 128, 256, 512)  # the kernel's instances (csrc/margin_l1.cu)
SEG = 32  # records an item of the backward (kSeg): a row of more spans several items

# kernel launches (forward and backward each count one) since the process
# started (or the caller last reset it)
launches = 0


def _l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().sum(-1)


def margin_loss_plain(emb: torch.Tensor, pairs: torch.Tensor, neg_l: torch.Tensor,
                      neg_r: torch.Tensor, gamma: float = 10.0,
                      weights: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version: (S, k, d) gathers and autograd."""
    e_l, e_r = emb[pairs[:, 0]], emb[pairs[:, 1]]
    d_pos = _l1(e_l, e_r)[:, None]  # (S, 1)
    d_neg_r = _l1(e_l[:, None, :], emb[neg_r])  # (S, k)
    d_neg_l = _l1(emb[neg_l], e_r[:, None, :])  # (S, k)
    h_r = (d_pos + gamma - d_neg_r).clamp_min(0.0)
    h_l = (d_pos + gamma - d_neg_l).clamp_min(0.0)
    if weights is None:
        return 0.5 * (h_r.mean() + h_l.mean())
    w = weights[:, None]
    denom = weights.sum().clamp_min(1e-9) * neg_r.shape[1]
    return 0.5 * ((w * h_r).sum() + (w * h_l).sum()) / denom


def forward_plain(emb, pairs, neg_l, neg_r, gamma: float, weights):
    """The kernel's forward in torch: (loss, flags (S, k) uint8, D (1,))."""
    s, k = neg_r.shape
    e_l, e_r = emb[pairs[:, 0]], emb[pairs[:, 1]]
    thr = _l1(e_l, e_r)[:, None] + gamma
    h_r = thr - _l1(e_l[:, None, :], emb[neg_r])
    h_l = thr - _l1(emb[neg_l], e_r[:, None, :])
    flags = (((h_r >= 0) & (neg_r != pairs[:, 1:])).to(torch.uint8)
             | (((h_l >= 0) & (neg_l != pairs[:, :1])).to(torch.uint8) << 1))
    row = (h_r.clamp_min(0.0) + h_l.clamp_min(0.0)).sum(1)
    if weights is None:
        denom = torch.full((1,), float(s * k), dtype=torch.float32, device=emb.device)
    else:
        row = weights * row
        denom = (weights.sum().clamp_min(1e-9) * k).reshape(1)
    return 0.5 * row.sum() / denom[0], flags, denom


def contribution_index(pairs: torch.Tensor, neg_l: torch.Tensor, neg_r: torch.Tensor,
                       n_rows: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward's index, built on the tensors' device with no host sync:
    the records are S pair-left rows, S pair-right rows, S·k right-side and
    S·k left-side negatives, numbered in that order; ``order`` lists them
    sorted stably by the table row each reaches (``keys``), and row r's
    records are ``order[row_ptr[r]:row_ptr[r + 1]]``."""
    keys = torch.cat([pairs[:, 0], pairs[:, 1], neg_r.reshape(-1), neg_l.reshape(-1)])
    sorted_keys, order = torch.sort(keys.to(torch.int32), stable=True)
    row_ptr = torch.searchsorted(sorted_keys, torch.arange(n_rows + 1, dtype=torch.int32,
                                                           device=keys.device))
    return keys, order, row_ptr


def record_items(row_ptr: torch.Tensor, n_records: int) -> tuple[torch.Tensor, int]:
    """The backward's work items, on ``row_ptr``'s device with no host sync:
    each row's records cut into items of ``SEG`` in order (a row of none is
    one item), ``item_ptr`` (N + 1,) each row's first item; and the bound
    N + ceil(R / SEG) on their number, which sizes the grid."""
    seg = ((row_ptr[1:] - row_ptr[:-1] + SEG - 1) // SEG).clamp_min(1)
    item_ptr = torch.cat([seg.new_zeros(1), seg.cumsum(0)])
    return item_ptr, len(seg) + -(-n_records // SEG)


def record_contributions(emb, pairs, neg_l, neg_r, weights, flags, denom, grad) -> torch.Tensor:
    """Each record's contribution to the row it reaches, in record order
    (2·S + 2·S·k, d), as the kernel forms it: a negative record
    c_i·sign(e_pair − x); a pair record c_i·(A_i·sign(x − other) −
    Σ_j sign(x − n_ij)) over its own side's active entries, A_i the row's
    active entries, with c_i = ḡ·0.5/D·w_i."""
    g = grad.reshape(()) * 0.5 / denom[0]
    coef = g * weights if weights is not None else g.expand(pairs.shape[0])
    e_l, e_r = emb[pairs[:, 0]], emb[pairs[:, 1]]
    act_r, act_l = (flags & 1).bool(), (flags & 2).bool()
    cnt = (act_r.sum(1) + act_l.sum(1)).to(emb.dtype)[:, None]
    sg_r = torch.sign(e_l[:, None, :] - emb[neg_r]) * act_r[..., None]  # sign(e_l − n) (S, k, d)
    sg_l = torch.sign(e_r[:, None, :] - emb[neg_l]) * act_l[..., None]  # sign(e_r − n)
    c = coef[:, None]
    pair_l = c * (cnt * torch.sign(e_l - e_r) - sg_r.sum(1))
    pair_r = c * (cnt * torch.sign(e_r - e_l) - sg_l.sum(1))
    d = emb.shape[1]
    return torch.cat([pair_l, pair_r, (c[..., None] * sg_r).reshape(-1, d),
                      (c[..., None] * sg_l).reshape(-1, d)])


def backward_plain(emb, pairs, neg_l, neg_r, weights, flags, denom, grad) -> torch.Tensor:
    """The kernel's backward in torch: every record's contribution summed
    into its item in ``contribution_index``'s order, then each row's items
    in item order (``record_items``)."""
    n = emb.shape[0]
    keys, order, row_ptr = contribution_index(pairs, neg_l, neg_r, n)
    item_ptr, _ = record_items(row_ptr, len(keys))
    contrib = record_contributions(emb, pairs, neg_l, neg_r, weights, flags, denom, grad)
    rows = keys[order]  # the sorted records' rows
    pos = torch.arange(len(keys), device=emb.device) - row_ptr[rows]  # place in its row
    items = torch.zeros((int(item_ptr[-1]), emb.shape[1]), dtype=emb.dtype, device=emb.device)
    items.index_add_(0, item_ptr[rows] + pos // SEG, contrib[order])
    item_rows = torch.repeat_interleave(torch.arange(n, device=emb.device),
                                        item_ptr[1:] - item_ptr[:-1])
    return torch.zeros_like(emb).index_add_(0, item_rows, items)


def _lib():
    lib = _build.load("margin_l1")
    fwd, bwd = lib.margin_l1_forward, lib.margin_l1_backward
    if fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fwd.argtypes = [p, p, p, p, p, ctypes.c_float, i, i, i, p, p, p, p, p]
        fwd.restype = ctypes.c_int
        bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, p, p, p]
        bwd.restype = ctypes.c_int
    return fwd, bwd


def _stream(t: torch.Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _forward_cuda(emb, pairs, neg_l, neg_r, gamma: float, weights):
    global launches
    (s, k), d = neg_r.shape, emb.shape[1]
    dev = emb.device
    flags = torch.empty((s, k), dtype=torch.uint8, device=dev)
    row_sum = torch.empty(s, dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    denom = torch.empty(1, dtype=torch.float32, device=dev)
    err = _lib()[0](emb.data_ptr(), pairs.data_ptr(), neg_l.data_ptr(), neg_r.data_ptr(),
                    None if weights is None else weights.data_ptr(), float(gamma), s, k, d,
                    flags.data_ptr(), row_sum.data_ptr(), loss.data_ptr(), denom.data_ptr(),
                    _stream(emb))
    if err != 0:
        raise RuntimeError(f"margin_l1 forward launch failed with CUDA error {err}")
    launches += 1
    return loss, flags, denom


def _backward_cuda(emb, pairs, neg_l, neg_r, weights, flags, denom, grad) -> torch.Tensor:
    global launches
    (s, k), (n, d) = neg_r.shape, emb.shape
    keys, order, row_ptr = contribution_index(pairs, neg_l, neg_r, n)
    item_ptr, n_items = record_items(row_ptr, len(keys))
    grad = grad.to(torch.float32).reshape(1).contiguous()
    partial = torch.empty((n_items, d), dtype=torch.float32, device=emb.device)
    out = torch.empty_like(emb)
    err = _lib()[1](emb.data_ptr(), pairs.data_ptr(), neg_l.data_ptr(), neg_r.data_ptr(),
                    None if weights is None else weights.data_ptr(), flags.data_ptr(),
                    denom.data_ptr(), grad.data_ptr(), order.data_ptr(), row_ptr.data_ptr(),
                    item_ptr.data_ptr(), n_items, n, s, k, d, partial.data_ptr(),
                    out.data_ptr(), _stream(emb))
    if err != 0:
        raise RuntimeError(f"margin_l1 backward launch failed with CUDA error {err}")
    launches += 1
    return out


class MarginL1(torch.autograd.Function):
    """The loss of ``margin_l1_loss``: the kernel on a CUDA table, its
    arithmetic in torch on a CPU one."""

    @staticmethod
    def forward(ctx, emb, pairs, neg_l, neg_r, weights, gamma):
        fwd = _forward_cuda if emb.is_cuda else forward_plain
        loss, flags, denom = fwd(emb, pairs, neg_l, neg_r, gamma, weights)
        ctx.save_for_backward(emb, pairs, neg_l, neg_r, weights, flags, denom)
        return loss

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None, None
        bwd = _backward_cuda if grad.is_cuda else backward_plain
        return bwd(*ctx.saved_tensors, grad), None, None, None, None, None


def _check(emb, pairs, neg_l, neg_r, weights) -> None:
    if emb.dim() != 2 or emb.dtype != torch.float32:
        raise ValueError(f"margin_l1 takes a float32 table (N, d), got {emb.dtype} "
                         f"{tuple(emb.shape)}")
    if emb.shape[1] not in WIDTHS:
        raise ValueError(f"margin_l1 has no instance for d={emb.shape[1]} (widths {WIDTHS})")
    s = neg_r.shape[0]
    if (pairs.shape != (s, 2) or neg_l.shape != neg_r.shape or neg_r.dim() != 2 or s == 0
            or neg_r.shape[1] == 0):
        raise ValueError(f"shapes: pairs {tuple(pairs.shape)}, neg_l {tuple(neg_l.shape)}, "
                         f"neg_r {tuple(neg_r.shape)}")
    if weights is not None and (weights.shape != (s,) or weights.requires_grad):
        raise ValueError(f"weights must be ({s},) and take no gradient")
    for name, t in (("pairs", pairs), ("neg_l", neg_l), ("neg_r", neg_r), ("weights", weights)):
        if t is not None and t.device != emb.device:
            raise ValueError(f"{name} on {t.device}, the table on {emb.device}")


def margin_l1_loss(emb: torch.Tensor, pairs: torch.Tensor, neg_l: torch.Tensor,
                   neg_r: torch.Tensor, gamma: float = 10.0,
                   weights: torch.Tensor | None = None) -> torch.Tensor:
    """The margin loss of the table ``emb`` (N, d) float32 over ``pairs``
    (S, 2) and the negatives (S, k); ids are taken as int64, ``weights``
    as float32.  On a CUDA table the kernel (d in ``WIDTHS``), on a CPU one
    its arithmetic in torch; any other device raises."""
    _check(emb, pairs, neg_l, neg_r, weights)
    if emb.device.type not in ("cuda", "cpu"):
        raise ValueError(f"margin_l1_loss runs on cuda or cpu, not {emb.device}")
    emb = emb.contiguous()
    if emb.is_cuda and emb.data_ptr() % 16:
        raise ValueError("the table must be 16-byte aligned (the kernel reads float4)")
    ids = [t.to(torch.int64).contiguous() for t in (pairs, neg_l, neg_r)]
    w = None if weights is None else weights.to(torch.float32).contiguous()
    return MarginL1.apply(emb, *ids, w, float(gamma))
