"""Port parity for the select-and-rerank entry that the approximate search
paths share (``tpugraph_torch/kernels/shortlist_dist.py``): its plain
version against the JAX package's composite of XLA ops and
``lax.approx_min_k`` (exact on the CPU, ordered like ``lax.top_k``) for
each caller's options, the (score, column) order under ties, and what the
kernel's wrapper refuses or routes elsewhere (CPU, plain versions)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugraph.train.losses import pairwise_l1 as jax_pairwise_l1
from tpugraph_torch.kernels import shortlist_dist as sd


def _rows(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _top_k_least(sel, k):
    """``lax.top_k``'s k least: ties to the lower index, in order."""
    vals, idx = jax.lax.top_k(-sel, k)
    return -vals, idx


def _jax_composite(q, c, k, a=1.0, bias=None, col_mask=None, exclude=None, bf16=False,
                   rerank=None, select=jax.lax.approx_min_k):
    """The JAX package's selection and rerank, as its callers write them
    (tpugraph/train/negatives.py:178 and :260-262, train/bootstrap.py:125-137,
    train/eval.py:112-159, serve.py:85-88)."""
    q32, c32 = jnp.asarray(q), jnp.asarray(c)
    c2 = jnp.sum(c32 ** 2, axis=1)
    if bf16:
        dot = jnp.dot(q32.astype(jnp.bfloat16), c32.astype(jnp.bfloat16).T,
                      preferred_element_type=jnp.float32)
    else:
        dot = jnp.dot(q32, c32.T, preferred_element_type=jnp.float32)
    sel = jnp.sum(q32 ** 2, axis=1)[:, None] + c2[None, :] - 2.0 * dot
    if bias is not None:
        sel = a * sel - jnp.asarray(bias)[None, :]
    if col_mask is not None:
        sel = jnp.where(jnp.asarray(col_mask)[None, :], sel, jnp.inf)
    if exclude is not None:
        cidx = jax.lax.broadcasted_iota(jnp.int32, sel.shape, 1)
        sel = jnp.where(cidx == jnp.asarray(exclude, jnp.int32)[:, None], jnp.inf, sel)
    vals, idx = select(sel, k)
    dist = None
    if rerank is not None:
        g = jnp.take(c32, idx, axis=0)
        if rerank == "cityblock":
            dist = jax_pairwise_l1(q32[:, None, :], g).astype(jnp.float32)
        else:
            diff = q32[:, None, :] - g
            dist = jnp.sum(diff * diff, axis=-1)
    return (np.asarray(idx), np.asarray(vals), None if dist is None else np.asarray(dist))


def _by_id(idx, *vals):
    order = np.argsort(idx, axis=1)
    return [np.take_along_axis(v, order, 1) for v in (idx, *vals)]


# the options each caller passes:
# mining: exclude + L1 rerank; sqeuclidean (CSLS) mining: selection only;
# the eval's shortlist: CSLS + L1 rerank; the hubness: L1 rerank over the
# query pool; proposals: bf16 operands, the seed mask, CSLS, rerank by the
# metric; serving: CSLS + L1 rerank
CALLERS = {
    "mining": dict(k=24, exclude=True, rerank="cityblock"),
    "mining_sq_csls": dict(k=12, exclude=True, csls=True),
    "eval_csls": dict(k=32, csls=True, rerank="cityblock"),
    "hubness": dict(k=10, rerank="cityblock"),
    "proposals": dict(k=16, bf16=True, mask=True, rerank="cityblock"),
    "proposals_sq_csls": dict(k=16, bf16=True, mask=True, csls=True, rerank="sqeuclidean"),
    "serving_csls": dict(k=40, csls=True, rerank="cityblock"),
}


@pytest.mark.parametrize("caller", list(CALLERS))
def test_select_matches_jax_composite(caller):
    """The same index sets as the JAX composite in every row, ordered by
    column: the rerank within rtol 1e-5 and atol 1e-5, the selection score
    within rtol 1e-5 and atol 1e-5 of the expanded form's scale
    a·(max ‖q‖² + max ‖c‖²) (the score cancels terms of that size, so two
    summation orders differ by that much where it crosses 0); ascending by
    (score, column), and no kernel launched."""
    opts = dict(CALLERS[caller])
    k = opts.pop("k")
    q, c = _rows(len(caller), (70, 24), (230, 24))
    rng = np.random.default_rng(3)
    kw, jkw = {}, {}
    if opts.get("exclude"):
        ex = rng.integers(-1, 230, 70)
        kw["exclude"], jkw["exclude"] = torch.from_numpy(ex), ex
    if opts.get("mask"):
        m = rng.random(230) >= 0.25
        kw["col_mask"], jkw["col_mask"] = torch.from_numpy(m), m
    if opts.get("csls"):
        r = (40.0 + 4.0 * rng.standard_normal(230)).astype(np.float32)
        kw.update(a=2.0, bias=torch.from_numpy(r))
        jkw.update(a=2.0, bias=r)
    for key in ("bf16", "rerank"):
        if key in opts:
            kw[key] = jkw[key] = opts[key]
    before = (sd.launches, sd.select_launches)
    sidx, sval, dist = sd.select_rerank(torch.from_numpy(q), torch.from_numpy(c), k, **kw)
    assert (sd.launches, sd.select_launches) == before
    w_idx, w_val, w_dist = _jax_composite(q, c, k, **jkw)
    sidx, sval = sidx.numpy(), sval.numpy()
    assert sidx.shape == sval.shape == (70, k)
    got, want = _by_id(sidx, sval), _by_id(w_idx, w_val)
    np.testing.assert_array_equal(got[0], want[0])
    scale = kw.get("a", 1.0) * float((q * q).sum(1).max() + (c * c).sum(1).max())
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5 * scale)
    if opts.get("rerank"):
        np.testing.assert_allclose(_by_id(sidx, dist.numpy())[1], _by_id(w_idx, w_dist)[1],
                                   rtol=1e-5, atol=1e-5)
    else:
        assert dist is None
    later = (sval[:, 1:] > sval[:, :-1]) | ((sval[:, 1:] == sval[:, :-1])
                                           & (sidx[:, 1:] > sidx[:, :-1]))
    assert later.all()


def test_ties_take_the_lower_column_in_order():
    """Equal scores order by column, and at the k-th value the lower
    columns are taken, as ``lax.top_k`` does (``approx_min_k`` on the CPU
    breaks such ties in another order): ten copies of one row (and every
    masked column at +inf) tie."""
    rng = np.random.default_rng(8)
    c = rng.standard_normal((40, 8)).astype(np.float32) + 5.0
    twin = rng.standard_normal(8).astype(np.float32)
    cols = np.array([31, 3, 17, 8, 25, 12, 36, 0, 21, 6])
    c[cols] = twin
    q = np.stack([twin, twin + 0.01, -twin])
    mask = np.ones(40, bool)
    mask[[2, 9, 11]] = False
    sidx, sval, dist = sd.shortlist_select(torch.from_numpy(q), torch.from_numpy(c), 4,
                                           rerank="cityblock")
    np.testing.assert_array_equal(sidx[:2].numpy(), np.tile(np.sort(cols)[:4], (2, 1)))
    assert (sval[:2, 1:] == sval[:2, :1]).all() and (dist[0] == 0).all()
    w_idx, _, _ = _jax_composite(q, c, 4, select=_top_k_least)
    np.testing.assert_array_equal(sidx.numpy(), w_idx)
    # only 37 eligible columns: the +inf (masked) ones fill the shortlist
    # in column order
    sidx, sval, _ = sd.shortlist_select(torch.from_numpy(q), torch.from_numpy(c), 40,
                                        col_mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(sidx[:, -3:].numpy(), np.tile([2, 9, 11], (3, 1)))
    assert torch.isinf(sval[:, -3:]).all() and torch.isfinite(sval[:, :-3]).all()


class _OnCard:
    """Stands in for a CUDA tensor where only the route is under test."""

    device = torch.device("cuda")


def test_route_above_the_queue_is_unfused(monkeypatch):
    """On the card a k above ``QUEUE_MAX`` takes the product + topk +
    gather route, decided on the shape before any launch; up to it, the
    select kernel.  On the CPU the plain version."""
    calls = []
    monkeypatch.setattr(sd, "_select_blocked",
                        lambda q, c, k, dist_fn, **kw: calls.append(("unfused", k, dist_fn)))
    monkeypatch.setattr(sd, "shortlist_select",
                        lambda q, c, k, **kw: calls.append(("kernel", k, None)))
    sd.select_rerank(_OnCard(), _OnCard(), sd.QUEUE_MAX + 1, rerank="cityblock")
    sd.select_rerank(_OnCard(), _OnCard(), sd.QUEUE_MAX)
    assert calls == [("unfused", sd.QUEUE_MAX + 1, sd.shortlist_dist),
                     ("kernel", sd.QUEUE_MAX, None)]
    with pytest.raises(ValueError, match="unknown metric"):
        sd.select_rerank(_OnCard(), _OnCard(), sd.QUEUE_MAX + 1, rerank="cosine")
    monkeypatch.undo()
    q, c = _rows(4, (30, 12), (400, 12))
    got = sd.select_rerank(torch.from_numpy(q), torch.from_numpy(c), 300, rerank="cityblock")
    want = sd.shortlist_select_plain(torch.from_numpy(q), torch.from_numpy(c), 300,
                                     rerank="cityblock")
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", ["width_not_4", "width_above", "dtype", "k_above_queue",
                                  "k_above_pool", "mask_dtype", "not_cuda"])
def test_kernel_wrapper_refuses(case):
    """What the kernel lacks raises before any launch: an operand that is
    not float32, a k above the queue or the pool, a mask that is not bool; a
    tensor that passes every check but lies on neither the card nor the
    host, as do rows of a width not a multiple of 4 (padded with zero
    columns) and rows above ``SELECT_RESIDENT_D`` (the strip streams), which
    are then refused for their device alone.  On the host that wide a call
    is the plain version."""
    d, k, c, dtype, kw = 16, 8, 50, torch.float32, {}
    if case == "width_not_4":
        d = 6
    elif case == "width_above":
        d = sd.SELECT_RESIDENT_D + 4
        assert sd.select_streams(d) and not sd.select_streams(d - 4)
        rows, cols = (torch.from_numpy(a) for a in _rows(8, (30, d), (400, d)))
        got = sd.shortlist_select(rows, cols, 16, rerank="cityblock")
        want = sd.shortlist_select_plain(rows, cols, 16, rerank="cityblock")
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    elif case == "dtype":
        dtype = torch.float16
    elif case == "k_above_queue":
        k, c = sd.QUEUE_MAX + 1, 400
    elif case == "k_above_pool":
        k = c + 1
    elif case == "mask_dtype":
        kw["col_mask"] = torch.ones(c, dtype=torch.uint8, device="meta")
    q = torch.empty(10, d, dtype=dtype, device="meta")
    cands = torch.empty(c, d, dtype=dtype, device="meta")
    error = TypeError if case in ("dtype", "mask_dtype") else ValueError
    match = "cuda or cpu" if case in ("not_cuda", "width_above") else None
    with pytest.raises(error, match=match):
        sd.shortlist_select(q, cands, k, **kw)


@pytest.mark.parametrize("k", [1, 33])
def test_least_k_matches_a_stable_sort(k):
    """The plain selection's k least equal the first k of a stable sort of
    each row, ties (a few repeated values and +inf) included."""
    rng = np.random.default_rng(k)
    sel = rng.integers(0, 12, (20, 90)).astype(np.float32)
    sel[rng.random((20, 90)) < 0.2] = np.inf
    cols, vals = sd._least_k(torch.from_numpy(sel), k)
    order = np.argsort(sel, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(cols.numpy(), order)
    np.testing.assert_array_equal(vals.numpy(), np.take_along_axis(sel, order, 1))
