"""The ELL SpMM kernel's segment plan (tpugraph_torch.kernels.spmm_ell.
segment_plan), replayed in torch: what the CUDA kernel computes, item by
item, from the same tables — including the partial rows of the cut hub
rows and their fixed-order sum — against the plain version and the JAX
package's ``spmm_ell``.  Also: the fused GCN layer's tile table is the one
it always was."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugraph.kernels.spmm_ell import spmm_ell
from tpugraph.sparse.ell import build_ell_operator as jax_ell_operator
from tpugraph_torch.kernels.spmm_ell import (PACK_VSLOTS, SEG_SLOTS, TILE_ROWS, TILE_SLOTS,
                                             apply_with_diag, fused_plan, segment_plan)
from tpugraph_torch.sparse.ell import build_ell_operator


def _replay(m, diag, x, plan):
    """The kernel's arithmetic: each item walks its virtual slots (K ELL
    slots per row, then the diagonal) in order; a cut row's segments write
    partials that are summed in segment order.  Checks that every ELL slot
    and every diagonal slot is used exactly once and every row is written
    exactly once."""
    rows, idx, w = plan.base.rows, plan.base.idx, plan.base.w
    out = torch.full((m.n_rows, x.shape[1]), float("nan"))
    partial = torch.full((plan.n_partials, x.shape[1]), float("nan"))
    written = np.zeros(m.n_rows, int)
    slot_use = np.zeros(idx.shape[0], int)
    diag_use = np.zeros(m.n_rows, int)
    cut_row = {}
    for pos0, _, k, slot0, v0, v1, part, split in plan.items.tolist():
        acc, cur = None, None
        for v in range(v0, v1):
            r, kk = divmod(v, k + 1)
            nat = int(rows[pos0 + r])
            if nat != cur:
                if cur is not None:
                    out[cur] = acc
                    written[cur] += 1
                acc, cur = torch.zeros(x.shape[1]), nat
            if kk < k:
                s = slot0 + r * k + kk
                slot_use[s] += 1
                acc = acc + w[s] * x[idx[s]]
            else:
                diag_use[nat] += 1
                if diag is not None:
                    acc = acc + diag[nat] * x[nat]
        if part < 0:
            out[cur] = acc
            written[cur] += 1
        else:
            partial[part] = acc
            cut_row[split] = cur
    p0 = plan.split_p0.tolist()
    for split, row in cut_row.items():
        acc = torch.zeros(x.shape[1])
        for p in range(p0[split], p0[split + 1]):  # segment order
            acc = acc + partial[p]
        out[row] = acc
        written[row] += 1
    np.testing.assert_array_equal(slot_use, 1)
    np.testing.assert_array_equal(diag_use, 1)
    np.testing.assert_array_equal(written, 1)
    return out


def _graph(rng, n, hubs, split_diag, bare=0):
    """Random edges into rows 20.. (none of them a self-loop), the rows of
    ``hubs`` (all below 20) with exactly the ELL degree it gives them, and
    ``bare`` rows whose only edge is the self-loop."""
    n_e = 4 * n
    dst = rng.integers(20, n - bare, n_e)
    src = (dst + rng.integers(1, n, n_e)) % n
    for row, deg in hubs.items():
        k = deg - (0 if split_diag else 1)  # the self-loop stays in the ELL without a split
        src = np.concatenate([src, (row + rng.integers(1, n, k)) % n])
        dst = np.concatenate([dst, np.full(k, row)])
    loops = np.arange(n)
    src, dst = np.concatenate([src, loops]), np.concatenate([dst, loops])
    w = rng.standard_normal(len(src)).astype(np.float32)
    return src.astype(np.int32), dst.astype(np.int32), w


# (ELL degrees of rows 3, 5 and 9, bare rows, bucket Ks that must exist): a
# forced row's bucket K is its degree's power of two, or the maximum degree
CASES = {
    # K = 2,500: 20 segments; K = 512: 4
    "hub_far_above_cap": ({3: 2500, 5: 300}, 0, {2500, 512}),
    # 3, 2 and 1 segments of exactly SEG_SLOTS slots
    "k_multiple_of_cap": ({3: 3 * SEG_SLOTS, 5: 2 * SEG_SLOTS, 9: SEG_SLOTS}, 0,
                          {3 * SEG_SLOTS, 2 * SEG_SLOTS, SEG_SLOTS}),
    # the largest K one over the cap: 2 segments
    "k_cap_plus_one": ({3: SEG_SLOTS + 1, 5: 9}, 0, {SEG_SLOTS + 1}),
    # 30 rows with only a self-loop
    "rows_in_no_bucket": ({3: 400}, 30, {400}),
}


@pytest.mark.parametrize("split_diag", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_segment_replay_matches_plain(case, split_diag):
    hubs, bare, want_ks = CASES[case]
    rng = np.random.default_rng(len(case) + split_diag)
    n = 120
    op = build_ell_operator(*_graph(rng, n, hubs, split_diag, bare), n, split_diag=split_diag)
    m = op.fwd
    assert want_ks <= {b.k for b in m.buckets}
    if case == "rows_in_no_bucket" and split_diag:
        assert fused_plan(m).n_zero_rows >= bare
    plan = segment_plan(m)
    items = plan.items.numpy()
    ell_slots = np.where(items[:, 6] < 0, items[:, 1] * items[:, 2],
                         items[:, 5] - items[:, 4] - (items[:, 5] == items[:, 2] + 1))
    assert ell_slots.max() <= SEG_SLOTS and plan.max_item_slots <= SEG_SLOTS  # none above the cap
    n_cut = sum(int(b.rows.shape[0]) for b in m.buckets if b.k > SEG_SLOTS)
    assert plan.split_p0.shape[0] - 1 == n_cut  # exactly the rows with K above the cap are cut
    assert plan.n_partials > 0  # some row was cut
    weight = items[:, 5] - items[:, 4]
    assert np.all(np.diff(weight) <= 0)  # heaviest first
    x = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32))
    got = _replay(m, op.diag, x, plan)
    torch.testing.assert_close(got, apply_with_diag(m, op.diag, x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("split_diag", [False, True])
def test_default_segments_match_jax_spmm_ell(split_diag):
    """The default cap on a hub row with K far above it (both directions of
    the operator), against the JAX package's spmm_ell."""
    rng = np.random.default_rng(11 + split_diag)
    n = 200
    src, dst, w = _graph(rng, n, {3: 3 * SEG_SLOTS + 40, 7: SEG_SLOTS + 1}, split_diag)
    top = build_ell_operator(src, dst, w, n, split_diag=split_diag)
    jop = jax_ell_operator(src, dst, w, n, split_diag=split_diag)
    x = rng.standard_normal((n, 16)).astype(np.float32)
    want = np.asarray(spmm_ell(jop, jnp.asarray(x)))
    plan = segment_plan(top.fwd)
    assert plan.max_item_slots <= SEG_SLOTS and plan.split_p0.shape[0] - 1 == 2
    got = _replay(top.fwd, top.diag, torch.from_numpy(x), plan)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _expected_tiles(m):
    """The tile table the fused GCN layer walks, derived independently:
    tiles of max(1, min(TILE_ROWS, TILE_SLOTS // K)) rows per bucket, then
    TILE_ROWS-row tiles of the rows in no bucket, heaviest first."""
    tiles, row_base, slot_base = [], 0, 0
    for b in m.buckets:
        n_rows, per = int(b.rows.shape[0]), max(1, min(TILE_ROWS, TILE_SLOTS // b.k))
        tiles += [(row_base + r0, min(per, n_rows - r0), b.k, slot_base + r0 * b.k)
                  for r0 in range(0, n_rows, per)]
        row_base += n_rows
        slot_base += n_rows * b.k
    n_zero = m.n_rows - row_base
    tiles += [(row_base + r0, min(TILE_ROWS, n_zero - r0), 0, slot_base)
              for r0 in range(0, n_zero, TILE_ROWS)]
    t = np.asarray(tiles, np.int64)
    return t[np.argsort(-(t[:, 1] * (t[:, 2] + 1)), kind="stable")]


@pytest.mark.parametrize("split_diag", [False, True])
def test_fused_plan_tiles_unchanged_by_segments(split_diag):
    rng = np.random.default_rng(21)
    n = 150
    op = build_ell_operator(*_graph(rng, n, {3: 2000, 5: 300}, split_diag, 20), n,
                            split_diag=split_diag)
    m = op.bwd
    tiles = fused_plan(m)
    seg = segment_plan(m)
    assert m.cache["tiles"] is tiles and seg.base is tiles  # shared arrays, same table
    np.testing.assert_array_equal(tiles.tiles.numpy(), _expected_tiles(m))


def test_segment_plan_is_cached_beside_the_tiles():
    """Built once per matrix, on the matrix's cache beside ``fused_plan``'s
    tiles; the items of short rows hold at most PACK_VSLOTS virtual slots."""
    rng = np.random.default_rng(31)
    op = build_ell_operator(*_graph(rng, 60, {3: 3 * SEG_SLOTS}, True), 60, split_diag=True)
    m = op.fwd
    plan = segment_plan(m)
    assert segment_plan(m) is plan and m.cache["segments"] is plan
    assert m.cache["tiles"] is plan.base
    items = plan.items.numpy()
    packed = items[items[:, 6] < 0]
    assert (packed[:, 5] - packed[:, 4]).max() <= max(PACK_VSLOTS, SEG_SLOTS + 1)
    assert (packed[packed[:, 1] > 1, 5] - packed[packed[:, 1] > 1, 4]).max() <= PACK_VSLOTS
