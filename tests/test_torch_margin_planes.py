"""What the L1 margin kernel's forward keeps for its backward
(``tpugraph_torch/kernels/margin_l1.py``), on the host: the sign planes
packed in the kernel's register layout at every width (equal coordinates
give sign 0); the pair vectors, exact integers equal to the pair records'
contributions before their coefficient; the backward from planes and
vectors bit for bit the replay of the contributions formed from the table,
and within rel 1e-6 of autograd of the composite; the index the interval
batch carries (uniform and mined, with and without proposals) equal to the
one built from its pairs and negatives, and a loss given it equal bit for
bit to one that builds its own; a batch reloaded in place (as the captured
step's buffers are) giving the fresh batch's gradient; the wrapper's
refusal of an index of other rows or records; the gather-only yardstick's
plain version; the sorted SpMM's plain version on the host bit for bit its
fp32 edge-order sum."""

import numpy as np
import pytest
import torch

from tpugraph_torch.configs.configs import get_config
from tpugraph_torch.data.synthetic import synthetic_align_task
from tpugraph_torch.kernels import margin_l1
from tpugraph_torch.kernels.spmm import segment_spmm
from tpugraph_torch.sparse.build import build_adjacency
from tpugraph_torch.train.loop import IntervalBatch
from tpugraph_torch.train.losses import MARGIN_INDEX
from tpugraph_torch.train.negatives import sample_hard_negatives

GAMMA = 3.0


def _case(seed: int, k: int, weighted: bool, n: int = 90, s: int = 20, d: int = 16):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    pairs = np.stack([rng.integers(0, n // 2, s), rng.integers(n // 2, n, s)], 1)
    neg_l = rng.integers(0, n // 2, (s, k))
    neg_r = rng.integers(n // 2, n, (s, k))
    w = rng.uniform(0, 2, s).astype(np.float32) if weighted else None
    return emb, pairs, neg_l, neg_r, w


def _tensors(emb, pairs, neg_l, neg_r, w):
    t = [torch.from_numpy(np.asarray(a)).long() for a in (pairs, neg_l, neg_r)]
    return torch.from_numpy(emb), t, None if w is None else torch.from_numpy(w)


def _row_layout(d: int) -> list[list[int]]:
    """The element each (register slot, lane) of ``Row<d>`` holds, as
    ``csrc/margin_l1.cu`` loads it (-1: none)."""
    per = max(d // 32, 1)
    out = [[-1] * 32 for _ in range(per)]
    for lane in range(32):
        if d % 128 == 0:
            for c in range(per // 4):
                for u in range(4):
                    out[4 * c + u][lane] = (c * 32 + lane) * 4 + u
        else:
            for t in range(per):
                if t * 32 + lane < d:
                    out[t][lane] = t * 32 + lane
    return out


@pytest.mark.parametrize("d", margin_l1.WIDTHS)
def test_planes_hold_the_signs_in_the_kernel_layout(d):
    """Every active record's planes, bit by bit as each lane of the
    kernel's register layout holds them, are torch.sign of e_pair − n (0
    where the coordinates are equal), and unpack to it; an inactive
    record's are 0 in the plain version."""
    emb, pairs, neg_l, neg_r, w = _case(d, 6, True, d=d)
    emb[pairs[0, 0], ::3] = emb[neg_r[0, 0], ::3]  # equal coordinates: sign 0
    emb[pairs[2, 1], : d // 2] = emb[neg_l[2, 1], : d // 2]
    x, t, tw = _tensors(emb, pairs, neg_l, neg_r, w)
    _, flags, _, planes, _ = margin_l1.forward_plain(x, *t, 1e5, tw)  # every hinge active
    s, k = neg_r.shape
    size = margin_l1.plane_bytes(d)
    assert planes.dtype == torch.uint8 and planes.shape == (2 * s * k, 32 * size)
    act = torch.cat([(flags & 1).reshape(-1), (flags & 2).reshape(-1)]).bool()
    e_l, e_r = x[t[0][:, 0]], x[t[0][:, 1]]
    want = torch.cat([torch.sign(e_l[:, None] - x[t[2]]).reshape(-1, d),
                      torch.sign(e_r[:, None] - x[t[1]]).reshape(-1, d)])
    # γ 1e5: every hinge is active; a negative drawn as its pair's partner is not
    partner = torch.cat([(t[2] == t[0][:, 1:]).reshape(-1), (t[1] == t[0][:, :1]).reshape(-1)])
    assert torch.equal(act, ~partner) and int((want[act] == 0).sum()) >= d // 3
    want = want * act[:, None]
    torch.testing.assert_close(margin_l1.unpack_planes(planes, d), want, rtol=0, atol=0)
    # lane t's value, little-endian in bytes [t·size, (t + 1)·size): bit s
    # "> 0" at its element of slot s, bit per + s "< 0"
    lane_values = planes.numpy().reshape(-1, 32, size).astype(np.int64)
    lane_values = (lane_values << (8 * np.arange(size))).sum(-1)
    layout = _row_layout(d)
    per = len(layout)
    for rec in (0, 7, s * k + 2 * k + 1, 2 * s * k - 1):
        for slot in range(per):
            for lane in range(32):
                e, v = layout[slot][lane], int(lane_values[rec, lane])
                gt, lt = (v >> slot) & 1, (v >> (per + slot)) & 1
                assert (gt - lt) == (0 if e < 0 else int(want[rec, e]))
    assert torch.equal(margin_l1.pack_planes(want), planes)
    inactive = margin_l1.forward_plain(x, *t, -1e5, tw)[3]  # no hinge active
    assert not inactive.any()


@pytest.mark.parametrize("weighted", [False, True])
def test_pair_vectors_are_the_pair_records_before_their_coefficient(weighted):
    emb, pairs, neg_l, neg_r, w = _case(3, 7, weighted)
    neg_r[0, 0] = pairs[0, 1]  # a pool-of-one tie: no gradient
    x, t, tw = _tensors(emb, pairs, neg_l, neg_r, w)
    _, flags, denom, _, vecs = margin_l1.forward_plain(x, *t, GAMMA, tw)
    assert torch.equal(vecs, vecs.round()) and vecs.abs().max() <= 3 * neg_r.shape[1]
    # ḡ = 2·D makes c_i = 1 without weights: the contributions are the vectors
    contrib = margin_l1.record_contributions(x, *t, None, flags, denom, 2 * denom[0])
    assert torch.equal(contrib[: 2 * len(pairs)], vecs)


def _replay_case(name: str):
    emb, pairs, neg_l, neg_r, w = _case(6, 7, True, n=120, s=30)
    if name == "hub":
        neg_l[:, 2:5] = 7  # 90 records: three of the backward's items
        neg_r[0, 0] = pairs[0, 1]
    elif name == "negative_is_a_pair_row":
        neg_r[0, 1], neg_l[1, 2], neg_r[2, 0] = pairs[0, 0], pairs[5, 0], pairs[7, 1]
    elif name == "one_negative_twice":
        neg_l[3, 1:3] = neg_l[3, 0]
        neg_r[4, 3:5] = neg_r[4, 0]
    elif name == "entity_in_two_pairs":
        pairs[1] = pairs[0]
        pairs[6, 0] = pairs[2, 0]
    else:  # the pool-of-one fill on some rows
        neg_l[:4], neg_r[:4] = pairs[:4, :1], pairs[:4, 1:]
    return emb, pairs, neg_l, neg_r, w


@pytest.mark.parametrize("name", ["hub", "negative_is_a_pair_row", "one_negative_twice",
                                  "entity_in_two_pairs", "pool_of_one"])
def test_backward_from_planes_replays_the_table_contributions(name):
    """The backward from planes and vectors equals, bit for bit, the
    contributions formed from the table's rows summed in the index's
    items; and autograd of the composite within rel 1e-6."""
    emb, pairs, neg_l, neg_r, w = _replay_case(name)
    x, t, tw = _tensors(emb, pairs, neg_l, neg_r, w)
    n = emb.shape[0]
    _, flags, denom, planes, vecs = margin_l1.forward_plain(x, *t, GAMMA, tw)
    grad = torch.tensor(0.75)
    index = margin_l1.build_index(*t, n)
    got = margin_l1.backward_plain(tw, flags, denom, planes, vecs, index, grad, n)
    from_table = margin_l1.record_contributions(x, *t, tw, flags, denom, grad)
    assert torch.equal(margin_l1.plane_contributions(tw, flags, denom, planes, vecs, grad),
                       from_table)
    assert torch.equal(got, margin_l1.sum_in_items(from_table, index, n))
    e = x.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(0.75 * margin_l1.margin_loss_plain(e, *t, GAMMA, tw), e)
    assert float((got - want).norm() / want.norm()) < 1e-6


def _task_cfg(**over):
    task = synthetic_align_task(seed=4, n_ent=300, n_rel=6, n_triples=1200)
    cfg = get_config("base", syn_n_ent=300, dim=16, k_neg=6, neg_every=2, **over)
    return task, cfg


@pytest.mark.parametrize("mined", [False, True])
@pytest.mark.parametrize("boot", [False, True])
def test_the_interval_batch_carries_its_index(mined, boot):
    """``IntervalBatch`` at a uniform boundary and at a mined one, with and
    without proposals: the batch's index is the one built from its margin
    pairs and negatives over the table's rows, and a loss given it equals
    one that builds its own, bit for bit, on the Function's host path."""
    task, cfg = _task_cfg(neg_mode="hard" if mined else "uniform",
                          **(dict(boot_cap=10, boot_start=0) if boot else {}))
    n, dev = task.n_ent, torch.device("cpu")
    make = IntervalBatch(cfg, task, dev, table_rows=n)
    table = torch.from_numpy(np.random.default_rng(1).standard_normal((n, 16)).astype(np.float32))

    def mine(emb, pairs_t):
        return sample_hard_negatives(emb, pairs_t, task.kg1.n_ent, n, cfg.k_neg)

    before = margin_l1.index_builds
    batch, _ = make.at_boundary(2 if mined or boot else 0, lambda: table, mine, None,
                                lambda key, count, fn: fn())
    assert margin_l1.index_builds == before + 1
    pairs = batch.get("pairs_aug", batch["pairs"])
    assert ("pairs_aug" in batch) == boot and len(pairs) == len(task.train_pairs) + 10 * boot
    index = batch[MARGIN_INDEX]
    n_rec = 2 * len(pairs) * (cfg.k_neg + 1)
    assert index.dtype == torch.int32 and index.shape == (margin_l1.index_size(len(pairs),
                                                                              cfg.k_neg, n),)
    order, row_ptr, item_ptr, items = margin_l1.split_index(index, n_rec, n)
    _, want_order, want_ptr = margin_l1.contribution_index(pairs, batch["neg_l"],
                                                           batch["neg_r"], n)
    assert torch.equal(order, want_order) and torch.equal(row_ptr, want_ptr)
    want_items, bound = margin_l1.record_items(want_ptr, n_rec)
    assert torch.equal(item_ptr, want_items) and items.shape == (bound, 4)
    # each item: its row (then n past the last item), its records in order
    # (up to SEG of them), whether its row spans several items
    per_row = want_items[1:] - want_items[:-1]
    rows = torch.repeat_interleave(torch.arange(n), per_row)
    assert torch.equal(items[:len(rows), 0], rows) and (items[len(rows):, 0] == n).all()
    for it, (r, first, count, several) in enumerate(items[:len(rows)].tolist()):
        j = it - int(want_items[r])
        lo, hi = int(want_ptr[r]) + j * margin_l1.SEG, int(want_ptr[r + 1])
        assert (first, count) == (lo, min(hi - lo, margin_l1.SEG))
        assert several == int(per_row[r] > 1)
    grads = []
    for idx in (index, None):
        e = table.clone().requires_grad_(True)
        loss = margin_l1.margin_l1_loss(e, pairs, batch["neg_l"], batch["neg_r"], cfg.gamma,
                                        batch.get("w"), index=idx)
        grads.append((loss.detach(), torch.autograd.grad(loss, e)[0]))
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])


def test_a_batch_reloaded_in_place_gives_the_fresh_gradient():
    """The second interval's batch copied into the first's tensors, as
    ``CapturedStep.load`` fills its static buffers: the loss and gradient
    from those tensors equal the second batch's own, bit for bit."""
    task, cfg = _task_cfg(neg_mode="uniform")
    n = task.n_ent
    make = IntervalBatch(cfg, task, torch.device("cpu"), table_rows=n)
    table = torch.from_numpy(np.random.default_rng(2).standard_normal((n, 16)).astype(np.float32))

    def batch_of(epoch0):
        batch = make(None)
        make.uniform(batch, epoch0)
        return batch

    static, fresh = batch_of(0), batch_of(2)
    assert not torch.equal(static["neg_r"], fresh["neg_r"])
    assert not torch.equal(static[MARGIN_INDEX], fresh[MARGIN_INDEX])
    for key, buf in static.items():
        buf.copy_(fresh[key])

    def loss_and_grad(batch):
        e = table.clone().requires_grad_(True)
        loss = margin_l1.margin_l1_loss(e, batch["pairs"], batch["neg_l"], batch["neg_r"],
                                        cfg.gamma, index=batch[MARGIN_INDEX])
        return loss.detach(), torch.autograd.grad(loss, e)[0]

    got, want = loss_and_grad(static), loss_and_grad(fresh)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("bad", ["other_rows", "other_records", "int64"])
def test_the_wrapper_refuses_an_index_of_another_batch(bad):
    emb, pairs, neg_l, neg_r, _ = _case(7, 3, False)
    x, t, _ = _tensors(emb, pairs, neg_l, neg_r, None)
    n = emb.shape[0]
    if bad == "other_rows":
        index = margin_l1.build_index(*t, n + 1)
    elif bad == "other_records":
        index = margin_l1.build_index(t[0], t[1][:, :2], t[2][:, :2], n)
    else:
        index = margin_l1.build_index(*t, n).long()
    with pytest.raises(ValueError, match="index"):
        margin_l1.margin_l1_loss(x, *t, index=index)


def test_the_gather_yardstick_sums_the_forward_rows():
    emb, pairs, neg_l, neg_r, _ = _case(8, 5, False)
    x, t, _ = _tensors(emb, pairs, neg_l, neg_r, None)
    got = margin_l1.gather_rows_sum(x, t[1], t[2])
    want = emb[neg_r].sum((1, 2), dtype=np.float64) + emb[neg_l].sum((1, 2), dtype=np.float64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_sorted_spmm_plain_on_the_host_is_the_fp32_edge_order_sum():
    """On the host the plain sorted SpMM still sums in fp32 in edge order
    (``index_add_``): bit for bit that sum."""
    task = synthetic_align_task(seed=2, n_ent=400, n_rel=5, n_triples=2000)
    op = build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel, fmt="sorted")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((task.n_ent, 64))
                         .astype(np.float32))
    e = op.fwd
    want = torch.zeros((e.n_rows + 1, 64)).index_add_(0, e.dst, x[e.src] * e.w[:, None])
    assert torch.equal(segment_spmm(e, x), want[:e.n_rows])
