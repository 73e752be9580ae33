"""The sorted SpMM kernel's work table (tpugraph_torch.kernels.spmm.
segment_plan), replayed in torch: what the CUDA kernel computes, item by
item, from the same tables — packed runs of short rows that write their
rows with no edge as 0, and the cut hub rows' partials summed in segment
order — against the plain version and the JAX package's ``spmm`` and
``spmm_xla``.  fp32 sums in another order: 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugraph.kernels.spmm import spmm as jax_spmm
from tpugraph.kernels.spmm import spmm_xla as jax_spmm_xla
from tpugraph.models.attr_channel import build_attr_operator as jax_attr_operator
from tpugraph.sparse.build import build_spmm_operator as jax_build_spmm_operator
from tpugraph.sparse.graph import SpMMOperator as JaxSpMMOperator
from tpugraph_torch.kernels.spmm import PACK_SLOTS, SEG_EDGES, segment_plan, segment_spmm
from tpugraph_torch.models.attr_channel import build_attr_operator
from tpugraph_torch.sparse.build import build_spmm_operator
from tpugraph_torch.sparse.graph import PaddedEdges


def _replay(edges, x, plan):
    """The kernel's arithmetic: each item walks its edge range in order,
    keyed by dst; a packed item writes every row of [r0, r1), a row with no
    edge as 0; a segment of a cut row writes a partial, and the row's
    partials are summed in segment order.  Checks that every real edge is
    used exactly once and no pad edge at all, that every row is written
    exactly once, and that a cut row's segments are its edges in order."""
    src, dst, w = edges.src.tolist(), edges.dst.tolist(), edges.w
    d = x.shape[1]
    out = torch.full((edges.n_rows, d), float("nan"))
    partial = torch.full((plan.n_partials, d), float("nan"))
    written = np.zeros(edges.n_rows, int)
    edge_use = np.zeros(edges.e_pad, int)
    segments = {}  # cut-row index -> [(partial, row, e0, e1)]

    def put(row, v):
        out[row] = v
        written[row] += 1

    for r0, r1, e0, e1, part, split, _, _ in plan.items.tolist():
        assert 0 <= r0 < r1 <= edges.n_rows and 0 <= e0 <= e1 <= edges.nnz
        acc, cur, nxt = torch.zeros(d), None, r0
        for e in range(e0, e1):
            edge_use[e] += 1
            assert r0 <= dst[e] < r1
            if dst[e] != cur:
                if cur is not None:
                    for row in range(nxt, cur):
                        put(row, torch.zeros(d))
                    put(cur, acc)
                    nxt = cur + 1
                acc, cur = torch.zeros(d), dst[e]
            acc = acc + w[e] * x[src[e]]
        if part < 0:
            if cur is not None:
                for row in range(nxt, cur):
                    put(row, torch.zeros(d))
                put(cur, acc)
                nxt = cur + 1
            for row in range(nxt, r1):
                put(row, torch.zeros(d))
        else:
            assert r1 == r0 + 1 and e1 > e0
            partial[part] = acc
            segments.setdefault(split, []).append((part, r0, e0, e1))
    p0 = plan.split_p0.tolist()
    assert sorted(segments) == list(range(len(p0) - 1))
    for split, segs in segments.items():
        segs.sort()
        row = segs[0][1]
        assert [s[0] for s in segs] == list(range(p0[split], p0[split + 1]))
        assert {s[1] for s in segs} == {row}
        # segment order is edge order: the segments tile the row's edges
        assert [s[2] for s in segs[1:]] == [s[3] for s in segs[:-1]]
        assert dst.index(row) == segs[0][2] and segs[-1][3] == len(dst) - dst[::-1].index(row)
        acc = torch.zeros(d)
        for p in range(p0[split], p0[split + 1]):
            acc = acc + partial[p]
        put(row, acc)
    np.testing.assert_array_equal(edge_use[:edges.nnz], 1)
    np.testing.assert_array_equal(edge_use[edges.nnz:], 0)
    np.testing.assert_array_equal(written, 1)
    return out


def _check_plan(edges, plan):
    """The table's shape: a packed run within PACK_SLOTS slots, a row of
    its own within SEG_EDGES edges, exactly the rows above SEG_EDGES cut
    into balanced segments of at most SEG_EDGES, heaviest first."""
    t = plan.items.numpy()
    rows, n_e = t[:, 1] - t[:, 0], t[:, 3] - t[:, 2]
    assert np.all(n_e[rows > 1] + rows[rows > 1] <= PACK_SLOTS)
    assert n_e.max(initial=0) <= SEG_EDGES
    deg = np.bincount(edges.dst[:edges.nnz].numpy(), minlength=edges.n_rows)
    cut = t[:, 4] >= 0
    assert set(t[cut, 0].tolist()) == set(np.flatnonzero(deg > SEG_EDGES).tolist())
    for r in np.flatnonzero(deg > SEG_EDGES):
        seg = n_e[cut & (t[:, 0] == r)]
        assert len(seg) == -(-deg[r] // SEG_EDGES) and seg.max() - seg.min() <= 1
    assert plan.n_partials == int(cut.sum()) == plan.split_p0[-1]
    assert np.all(np.diff(n_e + rows) <= 0)


def _jax_product(jedges_fwd, jedges_bwd, x):
    """A·x over ``jedges_fwd`` by the JAX package's spmm and spmm_xla."""
    jop = JaxSpMMOperator(fwd=jedges_fwd, bwd=jedges_bwd)
    jx = jnp.asarray(x)
    return np.asarray(jax_spmm(jop, jx)), np.asarray(jax_spmm_xla(jop, jx))


def _check_against_all(edges, jedges, jedges_other, x):
    plan = segment_plan(edges)
    _check_plan(edges, plan)
    got = _replay(edges, torch.from_numpy(x), plan)
    torch.testing.assert_close(got, segment_spmm(edges, torch.from_numpy(x)),
                               rtol=1e-5, atol=1e-5)
    for want in _jax_product(jedges, jedges_other, x):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    return plan


def _skewed(rng, n, hubs, empty=()):
    """Random edges into rows 30.. (none into the rows of ``empty``), and
    the rows of ``hubs`` (all below 30) with exactly the in-degree it
    gives them; rows below 30 that are not hubs have no edge."""
    dst = rng.integers(30, n, 6 * n)
    dst = dst[~np.isin(dst, list(empty))]
    src = rng.integers(0, n, len(dst))
    for row, deg in hubs.items():
        src = np.concatenate([src, rng.integers(0, n, deg)])
        dst = np.concatenate([dst, np.full(deg, row)])
    w = rng.standard_normal(len(src)).astype(np.float32)
    return src, dst, w


# in-degrees of rows 2, 5, 9, 13 and 17, and rows with no edge beyond the
# rows below 30 that are not hubs
CASES = {
    # one row under the cap, at it, one over (2 segments), and far above (20)
    "hubs_around_cap": ({2: SEG_EDGES - 1, 5: SEG_EDGES, 9: SEG_EDGES + 1, 13: 2500}, ()),
    # rows whose slots just fit one packed item and just do not
    "rows_around_pack": ({2: PACK_SLOTS - 1, 5: PACK_SLOTS, 9: 3 * SEG_EDGES}, ()),
    # empty rows inside packed runs, and a tail of empty rows before the dump row
    "empty_rows": ({5: 300, 17: 7}, tuple(range(40, 400, 3)) + tuple(range(540, 600))),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_segment_replay_matches_plain_and_jax(case, direction):
    hubs, empty = CASES[case]
    rng = np.random.default_rng(len(case) + len(direction))
    n = 600
    src, dst, w = _skewed(rng, n, hubs, empty)
    op = build_spmm_operator(src, dst, w, n, bucket=1024)
    jop = jax_build_spmm_operator(src, dst, w, n, bucket=1024)
    other = "bwd" if direction == "fwd" else "fwd"
    edges = getattr(op, direction)
    x = rng.standard_normal((edges.n_cols, 8)).astype(np.float32)
    plan = _check_against_all(edges, getattr(jop, direction), getattr(jop, other), x)
    deg = np.bincount(edges.dst[:edges.nnz].numpy(), minlength=n)
    if direction == "fwd":
        assert all(deg[r] == k for r, k in hubs.items())
        assert plan.split_p0.shape[0] - 1 == sum(k > SEG_EDGES for k in hubs.values())
        assert (deg == 0).sum() >= 30 - len(hubs) + len(empty)


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_attr_incidence_replay_matches_plain_and_jax(direction):
    """The entity × attribute incidence as ``fmt="sorted"`` builds it, some
    entities with no attribute (rows with no edge), and its transpose,
    whose attribute rows run into the hundreds of edges, so most are cut."""
    rng = np.random.default_rng(7)
    n_ent, n_attr = 900, 20
    ent = rng.integers(0, n_ent - 100, 3000)
    attr = np.stack([ent, rng.integers(0, n_attr, 3000)], 1)
    op = build_attr_operator(attr, n_ent, n_attr, fmt="sorted", bucket=1024)
    jop = jax_attr_operator(attr, n_ent, n_attr, fmt="sorted", bucket=1024)
    other = "bwd" if direction == "fwd" else "fwd"
    edges = getattr(op, direction)
    x = rng.standard_normal((edges.n_cols, 8)).astype(np.float32)
    plan = _check_against_all(edges, getattr(jop, direction), getattr(jop, other), x)
    if direction == "bwd":
        assert plan.split_p0.shape[0] - 1 >= n_attr // 2
    else:
        assert plan.n_partials == 0 and plan.items.shape[0] < n_ent // 4


def test_segment_plan_is_built_once_and_cached():
    """Built once per edge list, on its cache; a moved copy starts empty
    and builds its own on its device."""
    rng = np.random.default_rng(3)
    op = build_spmm_operator(*_skewed(rng, 200, {4: 500}), 200, bucket=512)
    plan = segment_plan(op.fwd)
    assert segment_plan(op.fwd) is plan and op.fwd.cache["segments"] is plan
    assert plan.scratch == {} and plan.items.dtype == torch.int32
    moved = op.fwd.to("cpu")
    assert moved.cache == {} and segment_plan(moved) is not plan
    assert torch.equal(segment_plan(moved).items, plan.items)


def test_segment_plan_refuses_a_broken_contract():
    """dst not sorted, padding off the dump row, a source out of range."""
    src = torch.tensor([0, 1, 2, 0], dtype=torch.int32)
    w = torch.ones(4)

    def edges(dst, src=src):
        return PaddedEdges(src=src, dst=torch.tensor(dst, dtype=torch.int32), w=w, n_rows=3,
                           nnz=3, n_cols=3)

    segment_plan(edges([0, 1, 1, 3]))
    for dst in ([1, 0, 2, 3], [0, 1, 2, 2]):
        with pytest.raises(ValueError, match="sorted"):
            segment_plan(edges(dst))
    with pytest.raises(ValueError, match="out of range"):
        segment_plan(edges([0, 1, 2, 3], torch.tensor([0, 1, 3, 0], dtype=torch.int32)))
