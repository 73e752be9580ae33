"""The L1 margin ranking loss (counterpart of the XLA ops of
``tpugraph/train/losses.py::margin_align_loss``, forward and autodiff):

    L = 0.5·(mean ReLU(d⁺ + γ − d(e_l, neg_r)) + mean ReLU(d⁺ + γ − d(neg_l, e_r)))

in L1, and with ``weights`` (S,) each side's mean Σ w·ReLU / (Σ w · k).

* ``margin_l1_loss`` — the loss as a ``torch.autograd.Function``
  (``MarginL1``).  On a CUDA table one launch of the hand-written Hopper
  kernel ``csrc/margin_l1.cu`` forward (two kernels: one warp a pair row,
  then a one-block sum of the rows' partials in a fixed order) and one
  backward, which reads no table row: it writes each table row's gradient
  once from what the forward kept, summing the row's contributions in the
  order of the batch's index (``build_index``: ``contribution_index`` cut
  into items of ``SEG`` records by ``record_items``, then the items in
  order), so two calls give the same bits.  A caller whose batch carries no
  index gets one built in the backward.  On a CPU table the same
  arithmetic in torch (``forward_plain``, ``backward_plain``).  It never
  falls back from the card.
* ``margin_loss_plain`` — the plain version: the composite of gathers, the
  L1 distances and the means, differentiated by autograd.  The training
  path takes it on the CPU (``train/losses.py::margin_align_loss``).
* ``gather_rows_sum`` — the forward's gather alone, a yardstick: the same
  rows read in the same order and summed.

What the forward keeps for the backward: one byte an entry (``flags``: bit
0 the right side's hinge, bit 1 the left's, set where the hinge's argument
is ≥ 0 and the negative is not the pair's own partner, which the
pool-of-one fill hands back: there the hinge is γ whatever the rows); the
denominator D; the sign planes of the active records, sign(e_pair − n) as
two bit planes "e > n" and "e < n", each lane's bits of the elements it
holds in the kernel's register layout (``pack_planes``; above ``SLAB``
columns a record's planes are its column slabs' planes, slab after slab,
each in the masked 512 instance's layout, and the kernel writes every
record's, active or not); and each pair
record's vector A_i·sign(x − partner) −
Σ_j sign(x − n_ij) over its side's active entries (exact integers).  Each
record's contribution c_i·(sign or vector), c_i = ḡ·0.5/D·w_i, is the one
``record_contributions`` forms from the table, bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpugraph_torch.kernels import _build

WIDTHS = (16, 32, 64, 128, 256, 384, 512)  # the instances whose rows are d wide (margin_l1.cu)
# the widest instance: any other d ≤ SLAB runs on a masked instance, any d
# above it on the slab kernels, in column slabs of SLAB (lane_width)
SLAB = 512
SEG = 32  # records an item of the backward (kSeg): a row of more spans several items

# kernel launches (forward and backward each count one) since the process
# started (or the caller last reset it); the backward's index builds (on
# any device); the gather-only entry's launches
launches = 0
index_builds = 0
gather_launches = 0


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


def lane_width(d: int) -> int:
    """The width of the kernel's layout that holds rows of width d: d at an
    instance's width (``WIDTHS``), the masked instance of the least of 32,
    64, 128, 192, …, 512 that is ≥ d (``masked_width`` in
    csrc/margin_l1.cu) up to ``SLAB``, and above it ``SLAB``·ceil(d /
    ``SLAB``), the slab kernels' column slabs; elements past d are 0."""
    if d in WIDTHS:
        return d
    if d > SLAB:
        return -(-d // SLAB) * SLAB
    return 32 if d <= 32 else -(-d // 64) * 64


def slabs(d: int) -> int:
    """Column slabs of a row of width d in the kernel's layout: 1 up to
    ``SLAB``, else ceil(d / ``SLAB``)."""
    return max(1, -(-d // SLAB))


@functools.lru_cache
def _lane_elems(d: int) -> torch.Tensor:
    """(slots, 32): the element that lane t holds in each register slot of
    the kernel's row at width d (``max(lane_width(d) / 32, 1)`` slots;
    float4 layout at an instance's width that 128 divides: slot 4c + u of
    lane t is element (32c + t)·4 + u; else slot s is element 32s + t, so
    above ``SLAB`` slot 16·b + u of slab b is element 512·b + 32u + t), d
    where the lane holds none."""
    t, lane = torch.arange(max(lane_width(d) // 32, 1))[:, None], torch.arange(32)[None, :]
    e = (t // 4 * 32 + lane) * 4 + t % 4 if d in WIDTHS and d % 128 == 0 else t * 32 + lane
    return torch.where(e < d, e, d)


def _slab_layout(d: int) -> tuple[int, int, int]:
    """(slabs, slots a lane holds of a slab, bytes of a lane's word of a
    slab): one slab of ``max(lane_width(d) / 32, 1)`` slots in 1, 2 or 4
    bytes up to ``SLAB``, else ``slabs(d)`` slabs of 16 slots in 4."""
    per = max(lane_width(d) // 32, 1) // slabs(d)
    return slabs(d), per, 1 if per <= 4 else 2 if per <= 8 else 4


def plane_bytes(d: int) -> int:
    """Bytes a lane holds of one record's sign planes: 2 bits for each of
    its ``max(lane_width(d) / 32, 1)`` slots, in 1, 2 or 4 bytes a slab
    (4·ceil(d / 512) above ``SLAB``)."""
    n, _, size = _slab_layout(d)
    return n * size


def pack_planes(signs: torch.Tensor) -> torch.Tensor:
    """Signs (R, d) in {−1, 0, 1} as the kernel's sign planes (R, 32·b)
    uint8, b = ``plane_bytes(d)``: per slab (one up to ``SLAB``), lane t's
    word of it, little-endian in the slab's bytes [t·w, (t + 1)·w), has bit
    u set where its element of the slab's slot u is > 0 and bit per + u
    where it is < 0 (per: the slab's slots a lane holds); the slabs' planes
    lie one after another."""
    d = signs.shape[1]
    n, per, size = _slab_layout(d)
    lanes = _lane_elems(d).to(signs.device).reshape(n, per, 32)
    padded = torch.cat([signs, signs.new_zeros((signs.shape[0], 1))], 1)[:, lanes]
    shift = torch.arange(per, device=signs.device)[:, None]
    value = (((padded > 0).long() << shift) | ((padded < 0).long() << (shift + per))).sum(2)
    octets = (value[..., None] >> (8 * torch.arange(size, device=signs.device))) & 0xFF
    return octets.to(torch.uint8).reshape(signs.shape[0], 32 * n * size)


def unpack_planes(planes: torch.Tensor, d: int) -> torch.Tensor:
    """``pack_planes`` undone: (R, 32·b) uint8 -> the signs (R, d) float32."""
    lanes = _lane_elems(d).to(planes.device)
    n, per, size = _slab_layout(d)
    j = torch.arange(2 * per, device=planes.device)
    octets = planes.reshape(planes.shape[0], n, 32, size)[..., j // 8]  # (R, slab, lane, bit)
    bits = ((octets >> (j % 8).to(torch.uint8)) & 1).to(torch.int8)
    signs = (bits[..., :per] - bits[..., per:]).transpose(2, 3).reshape(planes.shape[0], -1)
    out = torch.zeros((planes.shape[0], d + 1), dtype=torch.float32, device=planes.device)
    out[:, lanes.reshape(-1)] = signs.float()
    return out[:, :d]


def forward_plain(emb, pairs, neg_l, neg_r, gamma: float, weights):
    """The kernel's forward in torch: (loss, flags (S, k) uint8, D (1,),
    the sign planes (2·S·k, 32·b) uint8 of every record, 0 where it is
    inactive, the pair vectors (2·S, d))."""
    s, k = neg_r.shape
    e_l, e_r = emb[pairs[:, 0]], emb[pairs[:, 1]]
    n_r, n_l = emb[neg_r], emb[neg_l]
    thr = _l1(e_l, e_r)[:, None] + gamma
    h_r = thr - _l1(e_l[:, None, :], n_r)
    h_l = thr - _l1(n_l, e_r[:, None, :])
    act_r, act_l = (h_r >= 0) & (neg_r != pairs[:, 1:]), (h_l >= 0) & (neg_l != pairs[:, :1])
    flags = act_r.to(torch.uint8) | (act_l.to(torch.uint8) << 1)
    sg_r = torch.sign(e_l[:, None, :] - n_r) * act_r[..., None]  # sign(e_l − n) (S, k, d)
    sg_l = torch.sign(e_r[:, None, :] - n_l) * act_l[..., None]  # sign(e_r − n)
    d = emb.shape[1]
    planes = pack_planes(torch.cat([sg_r.reshape(-1, d), sg_l.reshape(-1, d)]))
    cnt = (act_r.sum(1) + act_l.sum(1)).to(emb.dtype)[:, None]
    vecs = torch.cat([cnt * torch.sign(e_l - e_r) - sg_r.sum(1),
                      cnt * torch.sign(e_r - e_l) - sg_l.sum(1)])
    row = (h_r.clamp_min(0.0) + h_l.clamp_min(0.0)).sum(1)
    if weights is None:
        denom = torch.full((1,), float(s * k), dtype=torch.float32, device=emb.device)
    else:
        row = weights * row
        denom = (weights.sum().clamp_min(1e-9) * k).reshape(1)
    return 0.5 * row.sum() / denom[0], flags, denom, planes, vecs


def contribution_index(pairs: torch.Tensor, neg_l: torch.Tensor, neg_r: torch.Tensor,
                       n_rows: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward's record order, built on the tensors' device with no
    host sync: the records are S pair-left rows, S pair-right rows, S·k
    right-side and S·k left-side negatives, numbered in that order;
    ``order`` lists them sorted stably by the table row each reaches
    (``keys``), and row r's records are ``order[row_ptr[r]:row_ptr[r + 1]]``."""
    keys = _record_rows(pairs, neg_l, neg_r)
    sorted_keys, order = torch.sort(keys, stable=True)
    row_ptr = torch.searchsorted(sorted_keys, torch.arange(n_rows + 1, dtype=torch.int32,
                                                           device=keys.device))
    return keys, order, row_ptr


def _record_rows(pairs, neg_l, neg_r) -> torch.Tensor:
    """The table row each record reaches, in record order, int32."""
    return torch.cat([pairs[:, 0], pairs[:, 1], neg_r.reshape(-1),
                      neg_l.reshape(-1)]).to(torch.int32)


def record_items(row_ptr: torch.Tensor, n_records: int) -> tuple[torch.Tensor, int]:
    """The backward's work items, on ``row_ptr``'s device with no host sync:
    each row's records cut into items of ``SEG`` in order (a row of none is
    one item), ``item_ptr`` (N + 1,) each row's first item; and the bound
    N + ceil(R / SEG) on their number, which sizes the grid."""
    seg = ((row_ptr[1:] - row_ptr[:-1] + SEG - 1) // SEG).clamp_min(1)
    item_ptr = torch.cat([seg.new_zeros(1), seg.cumsum(0)])
    return item_ptr, _n_items(n_records, len(seg))


def _n_items(n_records: int, n_rows: int) -> int:
    return n_rows + -(-n_records // SEG)


def index_size(n_pairs: int, k: int, n_rows: int) -> int:
    """Entries of the index of ``n_pairs`` pairs with k negatives a side
    over a table of ``n_rows`` rows (``build_index``)."""
    n_records = 2 * n_pairs * (k + 1)
    return 4 * _n_items(n_records, n_rows) + n_records + 2 * (n_rows + 1)


def build_index(pairs: torch.Tensor, neg_l: torch.Tensor, neg_r: torch.Tensor,
                n_rows: int) -> torch.Tensor:
    """The backward's index, once per batch of negatives, on the tensors'
    device with no host sync and of a shape the batch's shapes fix, one
    int32 tensor (``index_size``): each of the ``record_items`` bound's
    items as (row, its first record's place in ``order``, its records, 1
    where its row spans several items), (N, 0, 0, 0) past the last item;
    then ``contribution_index``'s order and row_ptr and ``record_items``'
    item_ptr.  On CUDA tensors the records' rows are sorted by torch and
    the rest is two launches of the kernel's index entries around one
    ``cumsum``; on CPU ones ``build_index_plain``."""
    global index_builds
    if index_size(*neg_r.shape, n_rows) >= 2**31:
        raise ValueError(f"{tuple(neg_r.shape)} negatives over {n_rows} rows exceed the "
                         f"int32 index")
    index_builds += 1
    if not neg_r.is_cuda:
        return build_index_plain(pairs, neg_l, neg_r, n_rows)
    keys, order = torch.sort(_record_rows(pairs, neg_l, neg_r), stable=True)
    n_records, n_items = len(order), _n_items(len(order), n_rows)
    index = torch.empty(index_size(*neg_r.shape, n_rows), dtype=torch.int32,
                        device=neg_r.device)
    counts = torch.empty(n_rows + 1, dtype=torch.int32, device=neg_r.device)
    lib = _lib()
    _raise(lib[3](keys.data_ptr(), order.data_ptr(), n_records, n_rows, n_items,
                  index.data_ptr(), counts.data_ptr(), _stream(neg_r)), "index rows")
    item_ptr = torch.cumsum(counts, 0, dtype=torch.int32)
    _raise(lib[4](item_ptr.data_ptr(), n_records, n_rows, n_items, index.data_ptr(),
                  _stream(neg_r)), "index items")
    return index


def build_index_plain(pairs: torch.Tensor, neg_l: torch.Tensor, neg_r: torch.Tensor,
                      n_rows: int) -> torch.Tensor:
    """The plain version of ``build_index``'s index, in torch."""
    _, order, row_ptr = contribution_index(pairs, neg_l, neg_r, n_rows)
    item_ptr, bound = record_items(row_ptr, len(order))
    it = torch.arange(bound, device=item_ptr.device)
    row = torch.searchsorted(item_ptr, it, right=True) - 1  # N past the last item
    # per row: item j's first record less j·SEG, the row's end, whether it
    # spans several items; gathered for every item at once
    per_row = torch.stack([row_ptr[:-1] - item_ptr[:-1] * SEG, row_ptr[1:],
                           item_ptr[1:] - item_ptr[:-1] > 1], 1)
    past = row >= n_rows
    base, end, several = per_row[row.clamp_max(n_rows - 1)].unbind(1)
    first = torch.where(past, 0, base + it * SEG)
    count = torch.where(past, 0, (end - first).clamp(0, SEG))
    items = torch.stack([row, first, count, several * ~past], 1).reshape(-1)
    return torch.cat([items, order, row_ptr, item_ptr]).to(torch.int32)


def split_index(index: torch.Tensor, n_records: int, n_rows: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(order, row_ptr, item_ptr, the items (n_items, 4)) of an index, int64."""
    n_items = _n_items(n_records, n_rows)
    items, order, row_ptr, item_ptr = index.long().split(
        [4 * n_items, n_records, n_rows + 1, n_rows + 1])
    return order, row_ptr, item_ptr, items.reshape(n_items, 4)


def record_contributions(emb, pairs, neg_l, neg_r, weights, flags, denom, grad) -> torch.Tensor:
    """Each record's contribution to the row it reaches, in record order
    (2·S + 2·S·k, d), formed from the table's rows: a negative record
    c_i·sign(e_pair − x); a pair record c_i·(A_i·sign(x − other) −
    Σ_j sign(x − n_ij)) over its own side's active entries, A_i the row's
    active entries, with c_i = ḡ·0.5/D·w_i.  The form of a backward that
    gathers the rows again, which ``plane_contributions`` holds to bit for
    bit."""
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


def plane_contributions(weights, flags, denom, planes, vecs, grad) -> torch.Tensor:
    """Each record's contribution in record order (2·S + 2·S·k, d) as the
    kernel forms it from the forward's planes and pair vectors: c_i·vector
    for a pair record, c_i·sign for an active negative record, 0 for an
    inactive one."""
    s, k = flags.shape
    g = grad.reshape(()) * 0.5 / denom[0]
    coef = g * weights if weights is not None else g.expand(s)
    act = torch.cat([(flags & 1).bool().reshape(-1), (flags & 2).bool().reshape(-1)])
    signs = unpack_planes(planes, vecs.shape[1]) * act[:, None]
    c = coef[:, None]
    return torch.cat([c * vecs[:s], c * vecs[s:], coef.repeat_interleave(k).repeat(2)[:, None]
                      * signs])


def sum_in_items(contrib: torch.Tensor, index: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The records' contributions (R, d) summed as the kernel sums them:
    into each item in the index's order, then each row's items in item
    order; every row written (0 where nothing reaches it)."""
    order, row_ptr, item_ptr, _ = split_index(index, contrib.shape[0], n_rows)
    ids = torch.arange(n_rows, device=contrib.device)
    rows = torch.repeat_interleave(ids, row_ptr[1:] - row_ptr[:-1])  # the sorted records' rows
    pos = torch.arange(len(order), device=contrib.device) - row_ptr[rows]  # place in its row
    items = contrib.new_zeros((int(item_ptr[-1]), contrib.shape[1]))
    items.index_add_(0, item_ptr[rows] + pos // SEG, contrib[order])
    item_rows = torch.repeat_interleave(ids, item_ptr[1:] - item_ptr[:-1])
    return contrib.new_zeros((n_rows, contrib.shape[1])).index_add_(0, item_rows, items)


def backward_plain(weights, flags, denom, planes, vecs, index, grad, n_rows: int) -> torch.Tensor:
    """The kernel's backward in torch: every record's contribution
    (``plane_contributions``) summed in the index's items
    (``sum_in_items``)."""
    return sum_in_items(plane_contributions(weights, flags, denom, planes, vecs, grad), index,
                        n_rows)


def _lib():
    lib = _build.load("margin_l1")
    fns = (lib.margin_l1_forward, lib.margin_l1_backward, lib.margin_l1_gather,
           lib.margin_l1_index_rows, lib.margin_l1_index_items)
    if fns[0].argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        types = ([p, p, p, p, p, ctypes.c_float, i, i, i, p, p, p, p, p, p, p],
                 [p, p, p, p, p, p, p, i, i, i, i, i, p, p, p], [p, p, p, i, i, i, p, p],
                 [p, p, i, i, i, p, p, p], [p, i, i, i, p, p])
        for fn, args in zip(fns, types):
            fn.argtypes, fn.restype = args, ctypes.c_int
    return fns


def _raise(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"margin_l1 {what} launch failed with CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _forward_cuda(emb, pairs, neg_l, neg_r, gamma: float, weights):
    global launches
    (s, k), d = neg_r.shape, emb.shape[1]
    dev = emb.device
    flags = torch.empty((s, k), dtype=torch.uint8, device=dev)
    row_sum = torch.empty(s, dtype=torch.float32, device=dev)
    planes = torch.empty((2 * s * k, 32 * plane_bytes(d)), dtype=torch.uint8, device=dev)
    vecs = torch.empty((2 * s, d), dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    denom = torch.empty(1, dtype=torch.float32, device=dev)
    _raise(_lib()[0](emb.data_ptr(), pairs.data_ptr(), neg_l.data_ptr(), neg_r.data_ptr(),
                     None if weights is None else weights.data_ptr(), float(gamma), s, k, d,
                     flags.data_ptr(), row_sum.data_ptr(), planes.data_ptr(), vecs.data_ptr(),
                     loss.data_ptr(), denom.data_ptr(), _stream(emb)), "forward")
    launches += 1
    return loss, flags, denom, planes, vecs


def _backward_cuda(weights, flags, denom, planes, vecs, index, grad, n_rows: int) -> torch.Tensor:
    global launches
    (s, k), d = flags.shape, vecs.shape[1]
    n_items = _n_items(2 * s * (k + 1), n_rows)
    grad = grad.to(torch.float32).reshape(1).contiguous()
    partial = torch.empty((n_items, d), dtype=torch.float32, device=vecs.device)
    out = torch.empty((n_rows, d), dtype=torch.float32, device=vecs.device)
    _raise(_lib()[1](None if weights is None else weights.data_ptr(), flags.data_ptr(),
                     planes.data_ptr(), vecs.data_ptr(), denom.data_ptr(), grad.data_ptr(),
                     index.data_ptr(), n_items, n_rows, s, k, d, partial.data_ptr(),
                     out.data_ptr(), _stream(vecs)), "backward")
    launches += 1
    return out


class MarginL1(torch.autograd.Function):
    """The loss of ``margin_l1_loss``: the kernel on a CUDA table, its
    arithmetic in torch on a CPU one."""

    @staticmethod
    def forward(ctx, emb, pairs, neg_l, neg_r, weights, index, gamma):
        fwd = _forward_cuda if emb.is_cuda else forward_plain
        loss, flags, denom, planes, vecs = fwd(emb, pairs, neg_l, neg_r, gamma, weights)
        ctx.save_for_backward(pairs, neg_l, neg_r, weights, index, flags, denom, planes, vecs)
        ctx.n_rows = emb.shape[0]
        return loss

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None, None, None
        pairs, neg_l, neg_r, weights, index, flags, denom, planes, vecs = ctx.saved_tensors
        if index is None:  # the caller's batch carries none: built for this call
            index = build_index(pairs, neg_l, neg_r, ctx.n_rows)
        bwd = _backward_cuda if grad.is_cuda else backward_plain
        return (bwd(weights, flags, denom, planes, vecs, index, grad, ctx.n_rows), None, None,
                None, None, None, None)


def _check(emb, pairs, neg_l, neg_r, weights, index) -> None:
    if emb.dim() != 2 or emb.dtype != torch.float32:
        raise ValueError(f"margin_l1 takes a float32 table (N, d), got {emb.dtype} "
                         f"{tuple(emb.shape)}")
    if emb.shape[1] < 1:
        raise ValueError(f"margin_l1 takes widths d ≥ 1, got d={emb.shape[1]}")
    s = neg_r.shape[0]
    if (pairs.shape != (s, 2) or neg_l.shape != neg_r.shape or neg_r.dim() != 2 or s == 0
            or neg_r.shape[1] == 0):
        raise ValueError(f"shapes: pairs {tuple(pairs.shape)}, neg_l {tuple(neg_l.shape)}, "
                         f"neg_r {tuple(neg_r.shape)}")
    if weights is not None and (weights.shape != (s,) or weights.requires_grad):
        raise ValueError(f"weights must be ({s},) and take no gradient")
    if index is not None:
        want = index_size(s, neg_r.shape[1], emb.shape[0])
        if index.dtype != torch.int32 or index.shape != (want,):
            raise ValueError(
                f"the index is {index.dtype} {tuple(index.shape)}; {s} pairs with "
                f"{neg_r.shape[1]} negatives a side over {emb.shape[0]} table rows need "
                f"int32 ({want},) (build_index of these pairs and negatives over this table)")
    for name, t in (("pairs", pairs), ("neg_l", neg_l), ("neg_r", neg_r), ("weights", weights),
                    ("index", index)):
        if t is not None and t.device != emb.device:
            raise ValueError(f"{name} on {t.device}, the table on {emb.device}")


def margin_l1_loss(emb: torch.Tensor, pairs: torch.Tensor, neg_l: torch.Tensor,
                   neg_r: torch.Tensor, gamma: float = 10.0,
                   weights: torch.Tensor | None = None,
                   index: torch.Tensor | None = None) -> torch.Tensor:
    """The margin loss of the table ``emb`` (N, d) float32 over ``pairs``
    (S, 2) and the negatives (S, k); ids are taken as int64, ``weights``
    as float32; ``index``, where the caller's batch carries it,
    ``build_index`` of these pairs and negatives over N rows (else it is
    built in the backward).  On a CUDA table the kernel (any d ≥ 1: an
    instance up to ``SLAB``, the slab kernels above), on a CPU one its
    arithmetic in torch; any other device raises."""
    _check(emb, pairs, neg_l, neg_r, weights, index)
    if emb.device.type not in ("cuda", "cpu"):
        raise ValueError(f"margin_l1_loss runs on cuda or cpu, not {emb.device}")
    emb = emb.contiguous()
    if emb.is_cuda and emb.data_ptr() % 16:
        raise ValueError("the table must be 16-byte aligned (the kernel reads float4)")
    ids = [t.to(torch.int64).contiguous() for t in (pairs, neg_l, neg_r)]
    w = None if weights is None else weights.to(torch.float32).contiguous()
    index = None if index is None else index.contiguous()
    return MarginL1.apply(emb, *ids, w, index, float(gamma))


def gather_rows_sum_plain(emb: torch.Tensor, neg_l: torch.Tensor,
                          neg_r: torch.Tensor) -> torch.Tensor:
    """The plain version of ``gather_rows_sum``: (S,) the sum of each pair
    row's 2·k negative rows."""
    return emb[neg_r].sum((1, 2)) + emb[neg_l].sum((1, 2))


def gather_rows_sum(emb: torch.Tensor, neg_l: torch.Tensor, neg_r: torch.Tensor) -> torch.Tensor:
    """The forward's gather alone, a yardstick of its time: the 2·S·k
    negative rows read in the forward's order and summed, (S,) float32.
    On a CUDA table the kernel's gather-only entry, on a CPU one
    ``gather_rows_sum_plain``."""
    global gather_launches
    if not emb.is_cuda:
        return gather_rows_sum_plain(emb, neg_l, neg_r)
    emb = emb.contiguous()
    if emb.dtype != torch.float32 or emb.shape[1] < 1 or emb.data_ptr() % 16:
        raise ValueError(f"margin_l1_gather takes a 16-byte aligned float32 table of width "
                         f"d ≥ 1, got {emb.dtype} {tuple(emb.shape)}")
    neg_l, neg_r = (t.to(torch.int64).contiguous() for t in (neg_l, neg_r))
    s, k = neg_r.shape
    out = torch.empty(s, dtype=torch.float32, device=emb.device)
    _raise(_lib()[2](emb.data_ptr(), neg_l.data_ptr(), neg_r.data_ptr(), s, k, emb.shape[1],
                     out.data_ptr(), _stream(emb)), "gather")
    gather_launches += 1
    return out
