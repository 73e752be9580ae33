"""The L1 margin loss's hand kernel (``tpugraph_torch/kernels/margin_l1.py``)
on the host: its autograd Function's CPU path (the kernel's arithmetic in
torch) against ``jax.value_and_grad`` of the JAX package's
``margin_align_loss`` at ``tests/test_torch_train.py``'s bounds (rtol 1e-5,
atol 1e-6), weighted and unweighted, k 1 and 5; rows that repeat (a
negative that is a pair row, one negative twice in a row, an entity in two
pairs); the pool-of-one tie, whose entries have no gradient; the fixed-order
backward replayed from its contribution index against autograd of the
plain composite (rel 1e-6), each contribution counted once; the wrapper's
refusal of a float64 table and its taking of a width above the widest
instance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugraph.train.losses import margin_align_loss as jax_margin_loss
from tpugraph_torch.kernels import margin_l1

GAMMA = 3.0


def _case(seed: int, k: int, weighted: bool, n: int = 90, s: int = 20, d: int = 16):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    pairs = np.stack([rng.integers(0, n // 2, s), rng.integers(n // 2, n, s)], 1)
    neg_l = rng.integers(0, n // 2, (s, k))
    neg_r = rng.integers(n // 2, n, (s, k))
    w = rng.uniform(0, 2, s).astype(np.float32) if weighted else None
    return emb, pairs, neg_l, neg_r, w


def _jax(emb, pairs, neg_l, neg_r, w):
    jw = None if w is None else jnp.asarray(w)
    ids = [jnp.asarray(a, dtype=jnp.int32) for a in (pairs, neg_l, neg_r)]
    val, grad = jax.value_and_grad(lambda e: jax_margin_loss(e, *ids, GAMMA, jw))(
        jnp.asarray(emb))
    return float(val), np.asarray(grad)


def _port(emb, pairs, neg_l, neg_r, w, fn=margin_l1.margin_l1_loss):
    e = torch.from_numpy(emb).requires_grad_(True)
    loss = fn(e, *(torch.from_numpy(np.asarray(a)).long() for a in (pairs, neg_l, neg_r)),
              GAMMA, None if w is None else torch.from_numpy(w))
    loss.backward()
    return loss.item(), e.grad.numpy()


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("weighted", [False, True])
def test_function_cpu_path_matches_jax(weighted, k):
    args = _case(2, k, weighted)
    got, g_got = _port(*args)
    want, g_want = _jax(*args)
    assert got == pytest.approx(want, rel=1e-5)
    np.testing.assert_allclose(g_got, g_want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("repeat", ["negative_is_a_pair_row", "one_negative_twice",
                                    "entity_in_two_pairs"])
def test_repeated_rows_match_jax(repeat):
    emb, pairs, neg_l, neg_r, w = _case(4, 5, True)
    if repeat == "negative_is_a_pair_row":  # the pair's own left row, and another pair's
        neg_r[0, 1], neg_l[1, 2], neg_r[2, 0] = pairs[0, 0], pairs[5, 0], pairs[7, 1]
    elif repeat == "one_negative_twice":
        neg_l[3, 1:3] = neg_l[3, 0]
        neg_r[4, 3:5] = neg_r[4, 0]
    else:
        pairs[1] = pairs[0]
        pairs[6, 0] = pairs[2, 0]
    got, g_got = _port(emb, pairs, neg_l, neg_r, w)
    want, g_want = _jax(emb, pairs, neg_l, neg_r, w)
    assert got == pytest.approx(want, rel=1e-5)
    np.testing.assert_allclose(g_got, g_want, rtol=1e-5, atol=1e-6)


def test_the_pool_of_one_tie_gives_no_gradient():
    """Every negative is the pair's own partner (the pool-of-one fill): each
    hinge is γ whatever the rows, so the value is γ and the gradient 0 —
    exactly in the port (the entries are cleared), within rounding in JAX."""
    emb, pairs, _, _, _ = _case(5, 4, False, s=6)
    pairs[:, 1] = np.arange(45, 51)  # distinct rows: no pair reaches another's rows
    pairs[:, 0] = np.arange(6)
    neg_l, neg_r = np.repeat(pairs[:, :1], 4, 1), np.repeat(pairs[:, 1:], 4, 1)
    got, g_got = _port(emb, pairs, neg_l, neg_r, None)
    want, g_want = _jax(emb, pairs, neg_l, neg_r, None)
    assert got == pytest.approx(GAMMA, rel=1e-5) and want == pytest.approx(GAMMA, rel=1e-5)
    assert not g_got.any()
    np.testing.assert_allclose(g_want, 0.0, atol=1e-6)
    flags = margin_l1.forward_plain(torch.from_numpy(emb), torch.from_numpy(pairs),
                                    torch.from_numpy(neg_l), torch.from_numpy(neg_r), GAMMA,
                                    None)[1]
    assert not flags.any()


@pytest.mark.parametrize("weighted", [False, True])
def test_fixed_order_backward_replays_autograd(weighted):
    """The kernel's backward replayed in torch: each record's contribution
    summed into its row in the index's order equals autograd of the plain
    composite within rel 1e-6; the index lists every record once, each
    row's records in record order."""
    emb, pairs, neg_l, neg_r, w = _case(6, 7, weighted, n=120, s=30)
    neg_r[0, 0] = pairs[0, 1]  # a tie among the records
    neg_l[1, 0] = pairs[2, 0]  # a negative that is a pair row
    neg_l[:, 2:5] = 7  # a hub row: 90 records, three of the backward's items
    t = [torch.from_numpy(np.asarray(a)).long() for a in (pairs, neg_l, neg_r)]
    tw = None if w is None else torch.from_numpy(w)
    e = torch.from_numpy(emb).requires_grad_(True)
    (want,) = torch.autograd.grad(margin_l1.margin_loss_plain(e, *t, GAMMA, tw), e)
    x = torch.from_numpy(emb)
    loss, flags, denom, planes, vecs = margin_l1.forward_plain(x, *t, GAMMA, tw)
    grad = torch.ones(())
    index = margin_l1.build_index(*t, emb.shape[0])
    got = margin_l1.backward_plain(tw, flags, denom, planes, vecs, index, grad, emb.shape[0])
    rel = float((got - want).norm() / want.norm())
    assert rel < 1e-6
    keys, order, row_ptr = margin_l1.contribution_index(*t, emb.shape[0])
    n_rec = 2 * len(pairs) + 2 * neg_r.size
    assert keys.shape == (n_rec,) and int(row_ptr[-1]) == n_rec and int(row_ptr[0]) == 0
    assert torch.equal(torch.sort(order).values, torch.arange(n_rec))  # each record once
    for r in range(emb.shape[0]):
        recs = order[row_ptr[r]:row_ptr[r + 1]]
        assert (keys[recs] == r).all() and (recs[1:] > recs[:-1]).all()
    # the backward's items: each row's records in order, at most SEG an item
    item_ptr, bound = margin_l1.record_items(row_ptr, n_rec)
    per_row = ((row_ptr[1:] - row_ptr[:-1] + margin_l1.SEG - 1) // margin_l1.SEG).clamp_min(1)
    assert torch.equal(item_ptr[1:] - item_ptr[:-1], per_row) and int(item_ptr[-1]) <= bound
    assert int(per_row[7]) == 3
    # each record's contribution, summed by row in any order, is the gradient too
    contrib = margin_l1.record_contributions(x, *t, tw, flags, denom, grad)
    assert contrib.shape == (n_rec, emb.shape[1])
    by_row = torch.zeros_like(x).index_add_(0, keys, contrib)
    assert float((by_row - want).norm() / want.norm()) < 1e-6


@pytest.mark.parametrize("bad", ["float64_table", "width_without_instance"])
def test_the_wrapper_refuses(bad):
    """A float64 table is refused.  A width above the widest instance (d
    520 > ``SLAB``) is not: it runs in two column slabs, the second 8 wide,
    and its loss and gradient equal ``jax.value_and_grad`` of the JAX margin
    at this file's bounds."""
    emb, pairs, neg_l, neg_r, _ = _case(7, 3, False, d=16 if bad == "float64_table" else 520)
    if bad == "width_without_instance":
        assert margin_l1.lane_width(520) == 1024 and margin_l1.plane_bytes(520) == 8
        got, g_got = _port(emb, pairs, neg_l, neg_r, None)
        want, g_want = _jax(emb, pairs, neg_l, neg_r, None)
        assert got == pytest.approx(want, rel=1e-5)
        np.testing.assert_allclose(g_got, g_want, rtol=1e-5, atol=1e-6)
        return
    t = [torch.from_numpy(np.asarray(a)).long() for a in (pairs, neg_l, neg_r)]
    with pytest.raises(ValueError, match="float32"):
        margin_l1.margin_l1_loss(torch.from_numpy(emb).double(), *t)
