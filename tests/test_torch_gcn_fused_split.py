"""The fused GCN layer kernel's work split and product (tpugraph_torch.
kernels.gcn_fused, csrc/gcn_fused.cu), replayed in torch on the CPU: the
rows of K > SEG_SLOTS as segments whose partials the row's last segment
sums in order before its fp32 product; then tile by tile, each warp's run
of rows walked as virtual slots (K ELL slots, then the diagonal; some
warps idle in a tile of fewer than 8 rows), and the 3× TF32 product —
against the plain version and the JAX package's Pallas layer in interpret
mode.  Also the segments' cover of the cut rows
and the error budget of the 3× TF32 product against float64."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugraph.kernels.gcn_fused_pallas import fused_gcn_layer as jax_fused_layer
from tpugraph.sparse.ell import build_ell_operator as jax_ell_operator
from tpugraph_torch.kernels.gcn_fused import layer_plan, reference_layer
from tpugraph_torch.kernels.spmm_ell import SEG_SLOTS, TILE_ROWS
from tpugraph_torch.sparse.ell import build_ell_operator

WARPS = 8  # kWarps in csrc/gcn_fused.cu


def _tf32(x):
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _split(x):
    big = _tf32(x)
    return big, _tf32(x - big)


def _product_3xtf32(a, wmat):
    """The kernel's product: a_big·W_big + a_big·W_small + a_small·W_big,
    each TF32 product exact in fp32, summed in fp32."""
    (ab, as_), (wb, ws) = _split(a), _split(wmat)
    return (ab @ ws + as_ @ wb) + ab @ wb


def _warp_runs(nrows):
    """Rows [r0, r1) of a tile that each warp walks."""
    return [(w * nrows // WARPS, (w + 1) * nrows // WARPS) for w in range(WARPS)]


def _replay(m, diag, x, wmat, bias):
    """What the CUDA kernel computes, segment by segment and tile by tile,
    from the same tables.  Checks that every ELL slot and every diagonal
    slot is used once, every row is written once, and the warps' runs of a
    tile cover its rows in order."""
    plan = layer_plan(m)
    rows, idx, w = plan.tiles.rows.long(), plan.tiles.idx.long(), plan.tiles.w
    d_in = x.shape[1]
    out = torch.full((m.n_rows, wmat.shape[1]), float("nan"))
    written = np.zeros(m.n_rows, int)
    slot_use = np.zeros(idx.shape[0], int)
    diag_use = np.zeros(m.n_rows, int)

    def slot(r, kk, row0, slot0, k):  # virtual slot kk of tile row r
        if kk < k:
            s = slot0 + r * k + kk
            slot_use[s] += 1
            return w[s] * x[idx[s]]
        nat = int(rows[row0 + r])
        diag_use[nat] += 1
        return diag[nat] * x[nat] if diag is not None else torch.zeros(d_in)

    partial, cut_row = {}, {}
    for pos0, _, k, slot0, v0, v1, part, split in plan.segs.tolist():
        acc = torch.zeros(d_in)
        for v in range(v0, v1):
            r, kk = divmod(v, k + 1)
            assert r == 0  # a segment covers one row
            acc = acc + slot(r, kk, pos0, slot0, k)
        partial[part] = acc
        cut_row[split] = int(rows[pos0])
    p0 = plan.split_p0.tolist()
    for split, nat in cut_row.items():  # the last segment: partials in order, fp32 product
        acc = torch.zeros(d_in)
        for p in range(p0[split], p0[split + 1]):
            acc = acc + partial[p]
        out[nat] = acc @ wmat + bias
        written[nat] += 1
    for row0, nrows, k, slot0 in plan.tiles.tiles.tolist():
        assert 1 <= nrows <= TILE_ROWS
        if k > SEG_SLOTS:  # rows the segments cover
            continue
        a = torch.full((TILE_ROWS, d_in), float("nan"))  # the aggregate in shared memory
        runs = _warp_runs(nrows)
        assert [r for r0, r1 in runs for r in range(r0, r1)] == list(range(nrows))
        for r0, r1 in runs:  # empty for some warps of a tile of fewer than WARPS rows
            acc, cur = None, None
            for v in range(r0 * (k + 1), r1 * (k + 1)):  # virtual-slot order
                r, kk = divmod(v, k + 1)
                if r != cur:
                    if cur is not None:
                        a[cur] = acc
                    acc, cur = torch.zeros(d_in), r
                acc = acc + slot(r, kk, row0, slot0, k)
            if cur is not None:
                a[cur] = acc
        prod = torch.from_numpy(_product_3xtf32(a[:nrows].numpy(), wmat.numpy()))
        for r in range(nrows):
            nat = int(rows[row0 + r])
            out[nat] = prod[r] + bias
            written[nat] += 1
    np.testing.assert_array_equal(slot_use, 1)
    np.testing.assert_array_equal(diag_use, 1)
    np.testing.assert_array_equal(written, 1)
    return out


# ELL degree -> rows of that degree: buckets K = 1, 7, 8, 32 and one above
# 1,024; tiles of 32 rows, tail tiles of 13, 4 and 3 rows (the last two
# leave warps idle), and the hub rows' one-row tiles, which segments cover
DEGREES = {1: 45, 7: 36, 8: 20, 30: 35, 1100: 2}
BARE = 40  # rows with no off-diagonal edge: K = 0 tiles of 32 and 8 rows


def _graph(rng, split_diag, degrees=DEGREES):
    """Rows of exactly the ELL degrees of ``degrees``, then BARE rows that
    lie in no bucket (only a self-loop with the diagonal split, else no
    edge)."""
    n = sum(degrees.values()) + BARE
    src, dst, row = [], [], 0
    for deg, count in degrees.items():
        for _ in range(count):
            k = deg - (0 if split_diag else 1)  # the self-loop stays in the ELL without a split
            src.append((row + rng.integers(1, n, k)) % n)
            dst.append(np.full(k, row))
            row += 1
    loops = np.arange(row + (BARE if split_diag else 0))
    src = np.concatenate(src + [loops]).astype(np.int32)
    dst = np.concatenate(dst + [loops]).astype(np.int32)
    w = rng.standard_normal(len(src)).astype(np.float32)
    return src, dst, w, n


@pytest.mark.parametrize("split_diag", [False, True])
@pytest.mark.parametrize("d_in,d_out", [(128, 128), (128, 256), (256, 128)])
def test_warp_split_replay_matches_plain_and_jax(split_diag, d_in, d_out):
    rng = np.random.default_rng(d_in + d_out + split_diag)
    src, dst, w, n = _graph(rng, split_diag)
    top = build_ell_operator(src, dst, w, n, split_diag=split_diag)
    jop = jax_ell_operator(src, dst, w, n, split_diag=split_diag)
    assert {b.k for b in top.fwd.buckets} == {1, 7, 8, 32, 1100}
    plan = layer_plan(top.fwd).tiles
    assert plan.n_zero_rows == BARE
    sizes = set(plan.tiles[:, 1].tolist())
    assert {32, 13, 8, 4, 3, 1} <= sizes
    x = rng.standard_normal((n, d_in)).astype(np.float32)
    wm = (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(np.float32)
    b = rng.standard_normal(d_out).astype(np.float32)
    got = _replay(top.fwd, top.diag, torch.from_numpy(x), torch.from_numpy(wm),
                  torch.from_numpy(b))
    want = reference_layer(top.fwd, top.diag, torch.from_numpy(x), torch.from_numpy(wm),
                           torch.from_numpy(b))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    jax_want = np.asarray(jax_fused_layer(jop.fwd, jop.diag, jnp.asarray(x), jnp.asarray(wm),
                                          jnp.asarray(b), interpret=True))
    np.testing.assert_allclose(got.numpy(), jax_want, rtol=1e-4, atol=1e-4)


# hub rows just above the segment cap, at twice it, and far above it
HUBS = {"cap_plus_one": {SEG_SLOTS + 1: 1}, "two_caps_and_5000": {2 * SEG_SLOTS: 2, 5000: 1}}


@pytest.mark.parametrize("split_diag", [False, True])
@pytest.mark.parametrize("hubs", list(HUBS))
def test_hub_segments_cover_each_cut_row_once(hubs, split_diag):
    """The rows of K > SEG_SLOTS are walked only as segments: each cut
    row's segments cover its K + 1 virtual slots exactly once, in order, in
    at most SEG_SLOTS ELL slots each, with the row's partials in segment
    order; the tiles the kernel skips (K > SEG_SLOTS) hold exactly the cut
    rows."""
    rng = np.random.default_rng(len(hubs) + split_diag)
    src, dst, w, n = _graph(rng, split_diag, {**DEGREES, **HUBS[hubs]})
    plan = layer_plan(build_ell_operator(src, dst, w, n, split_diag=split_diag).fwd)
    rows = plan.tiles.rows.numpy()
    by_row = {}
    for pos0, nr, k, _, v0, v1, part, split in plan.segs.tolist():
        assert nr == 1 and k > SEG_SLOTS
        assert v1 - v0 - (v1 == k + 1) <= SEG_SLOTS  # ELL slots; the last carries the diagonal
        by_row.setdefault(int(rows[pos0]), []).append((v0, v1, part, split, k))
    p0 = plan.split_p0.tolist()
    assert len(by_row) == len(p0) - 1
    for segs in by_row.values():
        segs.sort()
        split, k = segs[0][3], segs[0][4]
        assert [v for v0, v1, *_ in segs for v in range(v0, v1)] == list(range(k + 1))
        assert [s[2] for s in segs] == list(range(p0[split], p0[split + 1]))
        assert {s[3] for s in segs} == {split}
    tiles = plan.tiles.tiles.numpy()
    skipped = {int(rows[r0 + r]) for r0, nr, k, _ in tiles if k > SEG_SLOTS for r in range(nr)}
    assert skipped == set(by_row)


@pytest.mark.parametrize("d_in,d_out,w_dtype", [(128, 128, "float32"), (256, 128, "float32"),
                                                (128, 128, "bfloat16")])
def test_3xtf32_product_error_budget(d_in, d_out, w_dtype):
    """A 32-row aggregate times W against float64, as a share of the
    tolerance 1e-4 + 1e-4·|y|: the 3× TF32 product stays within 5 % of it
    and no worse than 1.5× a plain fp32 product; one TF32 product exceeds
    the tolerance and is at least 10× worse.  A bf16 W is exact in TF32:
    its small half is zero, so the kernel's two remaining products give the
    same result."""
    rng = np.random.default_rng(d_in + d_out)
    a = (3.0 * rng.standard_normal((TILE_ROWS, d_in))).astype(np.float32)
    wm = (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(np.float32)
    if w_dtype == "bfloat16":
        wm = torch.from_numpy(wm).to(torch.bfloat16).float().numpy()
        assert not _split(wm)[1].any()
    want = a.astype(np.float64) @ wm.astype(np.float64)

    def share(y):
        return float(np.max(np.abs(y - want) / (1e-4 + 1e-4 * np.abs(want))))

    got3 = _product_3xtf32(a, wm)
    got1 = _tf32(a) @ _tf32(wm)
    assert share(got3) <= 0.05 and share(got3) <= 1.5 * share(a @ wm)
    assert share(got1) > 1.0 and share(got1) >= 10 * share(got3)
    if w_dtype == "bfloat16":
        ab, as_ = _split(a)
        np.testing.assert_array_equal(got3, (as_ @ wm) + ab @ wm)
