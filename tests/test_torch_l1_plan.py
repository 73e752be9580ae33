"""The exact L1 search's work split (``tpugraph_torch/kernels/l1_search.py``:
``plan``, ``segments``, ``smem_bytes``, ``ring_stages``) and the rule that
makes any split give one answer, on the CPU.

* The planner: every (row, column) falls in exactly one unit's piece, for
  ragged S and C, one query, C below a tile and units forced past the
  tiles; the units differ by at most one tile; each piece's partials slot
  is its own and within the scratch the wrapper allocates; at the callers'
  shapes (``chip_smoke.py``'s ``L1_SHAPES``) one wave of an H100's 132 SMs
  holds the units with fill ≥ 0.95; a block's shared memory stays within
  the card's 232,448 bytes at every width and queue.
* The merge rule, with the plain versions: the plain top-k of each piece
  of a strip, merged by (score, column), equals the one-pass plain top-k
  bit for bit (ties across a piece's edge, masked columns, NaN rows, an
  exclusion at a piece's edge, a piece with fewer than k columns, CSLS);
  the pieces' plain counts sum to the one-pass count.

Equality is exact: the plain version's distance of a pair does not depend
on which columns share its block, and keys (score, column) are unique.
"""

import numpy as np
import pytest
import torch

from tpugraph_torch.kernels import l1_search
from tpugraph_torch.kernels.l1_search import (BLOCK_SMEM_MAX, BLOCK_SMEM_RESERVED, SM_SMEM_BYTES,
                                              STRIP, TILE, plan, ring_stages, segments,
                                              smem_bytes, unit_of)

H100_SMS = 132

# chip_smoke.py's L1_SHAPES below the queue: (entry, queries, candidates, d, k)
L1_SHAPES = {
    "mining": ("topk", 7000, 19000, 256, 100),
    "proposals": ("topk", 19000, 19000, 256, 1),
    "hubness": ("topk", 10500, 10500, 256, 10),
    "serving_csls": ("topk", 10500, 19000, 256, 10),
    "ranks": ("count", 10500, 10500, 256, 0),
    "ranks_csls": ("count", 10500, 10500, 256, 0),
    "dist_mining_block": ("topk", 17500, 12500, 256, 100),
    "dist_ranks_csls_block": ("count", 35000, 4375, 256, 0),
    "hubness_d512": ("topk", 10500, 10500, 512, 10),
}


def _blocks_per_sm(entry, k):
    kq = l1_search.queue_len(k) if entry == "topk" else 32
    n = smem_bytes(entry, kq, ring_stages(entry, kq)) + BLOCK_SMEM_RESERVED
    return SM_SMEM_BYTES // n


@pytest.mark.parametrize("s,c,units", [(1, 1, None), (1, 5000, None), (1, 5000, 3),
                                       (31, 383, 2), (33, 385, 4), (1000, 5, 40),
                                       (1003, 2503, 5), (7000, 19000, None)])
def test_plan_puts_every_pair_in_one_unit(s, c, units):
    """Strips cover the rows once; each strip's pieces cover its columns
    once, in order, from consecutive units (``unit_of``'s first to last,
    as the kernel finds a strip's units); the units' tiles differ by at
    most one; each piece's partials slot is its own and inside the
    scratch of (strips + units) slots."""
    p = plan(s, c, 128, 10, "topk", H100_SMS, 2, units)
    assert p.strips * STRIP >= s > (p.strips - 1) * STRIP
    assert p.units == min(p.tiles, units if units is not None else H100_SMS * 2)
    per_unit = [0] * p.units
    by_strip = {}
    slots = set()
    for b, strip, c0, c1, slot in segments(p, s, c):
        assert 0 <= c0 < c1 <= c and c0 % TILE == 0
        per_unit[b] += -(-(c1 - c0) // TILE)
        by_strip.setdefault(strip, []).append((c0, c1, b))
        assert slot not in slots and 0 <= slot < p.strips + p.units
        slots.add(slot)
    assert max(per_unit) - min(per_unit) <= 1 and min(per_unit) >= 1
    assert sorted(by_strip) == list(range(p.strips))
    n = p.tiles_per_strip
    for strip, pieces in by_strip.items():
        assert pieces[0][0] == 0 and pieces[-1][1] == c
        assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
        units_here = [b for _, _, b in pieces]
        assert units_here == list(range(unit_of(strip * n, p.tiles, p.units),
                                        unit_of(strip * n + n - 1, p.tiles, p.units) + 1))
    assert p.splits() == max(len(v) for v in by_strip.values())


@pytest.mark.parametrize("name", sorted(L1_SHAPES))
def test_plan_fills_whole_waves_at_the_callers_shapes(name):
    """At every ``L1_SHAPES`` shape one wave of an H100 (132 SMs, the
    blocks an SM that the shared-memory model allows) holds the units, and
    the longest unit is within 5 % of the mean: fill ≥ 0.95."""
    entry, s, c, d, k = L1_SHAPES[name]
    p = plan(s, c, d, k, entry, H100_SMS, _blocks_per_sm(entry, k))
    assert p.waves == 1 and p.units == p.slots
    assert p.fill >= 0.95


@pytest.mark.parametrize("entry,kq", [("topk", 32), ("topk", 64), ("topk", 128),
                                      ("topk", 256), ("count", 32), ("tile", 32)])
def test_block_shared_memory_fits_the_card(entry, kq):
    """The ring's depth is 3–6 stages and a block's shared memory stays
    within 232,448 bytes at every width from 4 to 512 (the block streams d,
    so its memory does not grow with it); two blocks share an SM wherever
    the queue is at most 128."""
    for d in range(4, 513, 4):
        stages = ring_stages(entry, kq)
        assert l1_search.MIN_STAGES <= stages <= l1_search.MAX_STAGES
        assert smem_bytes(entry, kq, stages) <= BLOCK_SMEM_MAX
        p = plan(100, 1000, d, min(kq, 1000), entry, H100_SMS, 1)
        assert p.strip == STRIP
    if kq <= 128:
        assert 2 * (smem_bytes(entry, kq, ring_stages(entry, kq)) + BLOCK_SMEM_RESERVED) \
            <= SM_SMEM_BYTES


def _case(name):
    """Rows, candidates and options of a merge-rule case: 70 queries (3
    strips), 1,000 candidates (4 tiles) at d 16, cut into 5 units."""
    rng = np.random.default_rng(sum(map(ord, name)))
    q = torch.from_numpy(rng.standard_normal((70, 16)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((1000, 16)).astype(np.float32))
    kw, k = {}, 20
    if name == "ties_across_split":
        c[TILE:2 * TILE] = c[:TILE]  # each column of tile 1 ties one of tile 0
        c[2 * TILE:] = c[TILE:1000 - TILE].clone()
    elif name == "masked":
        kw["col_mask"] = torch.from_numpy(rng.random(1000) >= 0.9)  # fewer eligible than k
    elif name == "nan_rows":
        q[[3, 40]] = float("nan")
    elif name == "exclusion_at_split_edge":
        kw["exclude"] = torch.from_numpy(rng.choice([TILE - 1, TILE, 2 * TILE - 1, 2 * TILE, -1],
                                                    70))
    elif name == "split_below_k":
        k = 240  # the last tile's 232 columns hold fewer than k
    elif name == "csls":
        kw["a"] = 2.0
        kw["bias"] = torch.from_numpy((16 + 2 * rng.standard_normal(1000)).astype(np.float32))
    return q, c, k, kw


def _piece_opts(kw, c0, c1):
    out = {}
    for key, v in kw.items():
        if key in ("col_mask", "bias"):
            out[key] = v[c0:c1]
        elif key in ("exclude", "self_col"):
            out[key] = torch.where((v >= c0) & (v < c1), v - c0, torch.full_like(v, -1))
        else:
            out[key] = v
    return out


@pytest.mark.parametrize("name", ["ties_across_split", "masked", "nan_rows",
                                  "exclusion_at_split_edge", "split_below_k", "csls"])
def test_pieces_merged_by_key_equal_the_one_pass_topk(name):
    """Each piece of each strip (``segments`` at 5 units) searched alone by
    the plain top-k (k, or the piece's columns if fewer), its columns
    shifted back, then every strip's pieces merged by (score, column): the
    one-pass plain top-k bit for bit, values and ids."""
    q, c, k, kw = _case(name)
    p = plan(q.shape[0], c.shape[0], 16, k, "topk", H100_SMS, 2, units=5)
    assert p.splits() >= 2
    want_v, want_i = l1_search.l1_topk_plain(q, c, k, **kw)
    got_v, got_i = torch.empty_like(want_v), torch.empty_like(want_i)
    pieces = {}
    for _, strip, c0, c1, _ in segments(p, q.shape[0], c.shape[0]):
        r0, r1 = strip * STRIP, min(q.shape[0], (strip + 1) * STRIP)
        opts = _piece_opts(kw, c0, c1)
        if "exclude" in opts:
            opts["exclude"] = opts["exclude"][r0:r1]
        v, i = l1_search.l1_topk_plain(q[r0:r1], c[c0:c1], min(k, c1 - c0), **opts)
        pieces.setdefault(strip, []).append((v, i + c0))
    for strip, parts in pieces.items():
        r0, r1 = strip * STRIP, min(q.shape[0], (strip + 1) * STRIP)
        v = torch.cat([a for a, _ in parts], 1).numpy()
        i = torch.cat([b for _, b in parts], 1).numpy()
        for r in range(r1 - r0):
            order = np.lexsort((i[r], v[r]))[:k]  # by score, then column
            got_v[r0 + r] = torch.from_numpy(v[r][order])
            got_i[r0 + r] = torch.from_numpy(i[r][order])
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_v, want_v)


@pytest.mark.parametrize("csls", [False, True])
def test_pieces_counts_sum_to_the_one_pass_count(csls):
    """The plain count of each piece of each strip (the self column
    shifted into it, or none), summed over a strip's pieces: the one-pass
    plain count, row for row."""
    q, c, _, kw = _case("csls" if csls else "plain")
    rng = np.random.default_rng(5)
    self_col = torch.from_numpy(rng.choice([0, TILE - 1, TILE, 2 * TILE, 999, -1], 70))
    other = torch.from_numpy(rng.integers(0, 1000, 70))
    d_true = (q - c[other]).abs().sum(1)
    thresh = 2.0 * d_true - kw["bias"][other] if csls else d_true
    opts = {key: v for key, v in kw.items() if key in ("a", "bias")}
    want = l1_search.l1_count_plain(q, c, thresh, self_col=self_col, **opts)
    p = plan(70, 1000, 16, 0, "count", H100_SMS, 2, units=5)
    got = torch.zeros(70, dtype=torch.int64)
    for _, strip, c0, c1, _ in segments(p, 70, 1000):
        r0, r1 = strip * STRIP, min(70, (strip + 1) * STRIP)
        po = _piece_opts({**opts, "self_col": self_col[r0:r1]}, c0, c1)
        got[r0:r1] += l1_search.l1_count_plain(q[r0:r1], c[c0:c1], thresh[r0:r1], **po)
    assert int(want.sum()) > 0
    assert torch.equal(got, want)
