"""The (256, 256) fused GCN layer kernel's work split and product
(tpugraph_torch.kernels.gcn_fused, csrc/gcn_fused.cu, gcn_fused_kernel_wide),
replayed in torch on the CPU: the work units in the order the counter hands
them out (the cut rows' segments, the cut rows 32 at a time, then the tiles
but those of the cut rows), each tile's rows split over the gather warps of
the CTA pair (fp32) or the CTA (bf16), each segment writing one partial and
each cut row summing its partials once all have counted; then each panel's
product (3× TF32 for fp32 tiles, fp32 for fp32 cut rows, the three bf16
terms in bf16) — against the plain version and the JAX package's Pallas layer in
interpret mode.  Each row and segment is gathered once and each (row,
column) of the output written once.  Also the error budget of the bf16
three-term product against float64, and the panels and scratch sizing per
dtype."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gcn_fused_split import DEGREES, HUBS, _graph, _product_3xtf32
from tpugraph.kernels.gcn_fused_pallas import fused_gcn_layer as jax_fused_layer
from tpugraph.sparse.ell import build_ell_operator as jax_ell_operator
from tpugraph_torch.kernels import gcn_fused
from tpugraph_torch.kernels.gcn_fused import PANELS, layer_plan, reference_layer, sub_plan
from tpugraph_torch.kernels.spmm_ell import SEG_SLOTS, TILE_ROWS
from tpugraph_torch.sparse.ell import build_ell_operator

D = 256
GATHER_WARPS = 8  # wide::kGatherWarps in csrc/gcn_fused.cu
HUB_ROWS = {torch.float32: 4, torch.bfloat16: TILE_ROWS}  # wide::kHubRows: cut rows a unit
BF16_TOL = dict(rtol=0.05, atol=0.5)  # tests/test_fused_gcn.py's bf16 layer


def _top16(a):
    """The top 16 bits of each fp32: its bf16 truncation, as a float32."""
    return (np.asarray(a, np.float32).view(np.uint32) & 0xFFFF0000).view(np.float32)


def _split3_bf16(a):
    """The kernel's a = hi + mid + lo: three bf16 values cut by truncation."""
    a = np.asarray(a, np.float32)
    hi = _top16(a)
    mid = _top16(a - hi)
    return hi, mid, (a - hi) - mid


def _product_3xbf16(a, wmat):
    """The bf16 kernel's product: lo·W + mid·W + hi·W, each exact in fp32
    (W is bf16), summed in fp32, lo first."""
    hi, mid, lo = _split3_bf16(a)
    return (lo @ wmat + mid @ wmat) + hi @ wmat


def _units(plan, pair, hub_rows):
    """The work units in the order the kernel's counter hands them out,
    each as (kind, payload): a group of the pair's segments, a run of up to
    ``hub_rows`` cut rows, a tile (those of K > SEG_SLOTS skipped)."""
    j = pair * GATHER_WARPS
    segs, tiles, hub = plan.segs.tolist(), plan.tiles.tiles.tolist(), plan.hub.tolist()
    out = [("segments", segs[u * j:(u + 1) * j]) for u in range(-(-len(segs) // j))]
    out += [("hub", hub[h:h + hub_rows]) for h in range(0, len(hub), hub_rows)]
    return out + [("tile", t) for t in tiles if t[2] <= SEG_SLOTS]


def _replay_wide(m, diag, x, wmat, bias, dtype):
    """What gcn_fused_kernel_wide computes, unit by unit, from the same
    tables; ``x`` and ``wmat`` hold the values of ``dtype`` as float32, and
    the result is the fp32 sum before the output's one rounding.  Checks
    that every ELL slot and diagonal slot is used once, every segment is
    gathered once, a cut row is summed only after all its segments counted
    (and its counter left at 0), every tile row is gathered by one warp of
    the pair, and every (row, column) of the output is written once."""
    plan = layer_plan(m)
    pair = PANELS[(D, D, dtype)]
    n_warps = pair * GATHER_WARPS
    rows, idx, w = plan.tiles.rows.long(), plan.tiles.idx.long(), plan.tiles.w
    p0 = plan.split_p0.tolist()
    out = torch.full((m.n_rows, D), float("nan"))
    written = np.zeros((m.n_rows, pair), int)  # per panel of columns
    slot_use = np.zeros(idx.shape[0], int)
    diag_use = np.zeros(m.n_rows, int)
    seg_use = np.zeros(plan.segs.shape[0], int)
    counters = np.zeros(len(p0) - 1, int)
    partial = {}

    def slot(pos0, r, kk, slot0, k):  # virtual slot kk of row r of a run at pos0
        if kk < k:
            s = slot0 + r * k + kk
            slot_use[s] += 1
            return w[s] * x[idx[s]]
        nat = int(rows[pos0 + r])
        diag_use[nat] += 1
        return diag[nat] * x[nat] if diag is not None else torch.zeros(D)

    def walk(pos0, k, slot0, v0, v1):  # {local row: its sum over [v0, v1)}
        acc = {}
        for v in range(v0, v1):
            r, kk = divmod(v, k + 1)
            acc[r] = acc.get(r, torch.zeros(D)) + slot(pos0, r, kk, slot0, k)
        return acc

    seg_rows = {tuple(s): i for i, s in enumerate(plan.segs.tolist())}
    for kind, payload in _units(plan, pair, HUB_ROWS[dtype]):
        if kind == "segments":  # one a warp: its partial, then its count
            assert len(payload) <= n_warps
            for pos0, nr, k, slot0, v0, v1, part, split in payload:
                assert nr == 1 and k > SEG_SLOTS
                (acc,) = walk(pos0, k, slot0, v0, v1).values()  # one row
                partial[part] = acc
                counters[split] += 1
                seg_use[seg_rows[(pos0, nr, k, slot0, v0, v1, part, split)]] += 1
            continue
        buf = torch.full((TILE_ROWS, D), float("nan"))  # both CTAs' copy after the barrier
        gathered = np.zeros(TILE_ROWS, int)
        if kind == "tile":
            row0, nrows, k, slot0 = payload
            natural = [int(rows[row0 + r]) for r in range(nrows)]
            for jw in range(n_warps):  # a run of rows a warp, across the pair
                r0, r1 = jw * nrows // n_warps, (jw + 1) * nrows // n_warps
                for r, acc in walk(row0, k, slot0, r0 * (k + 1), r1 * (k + 1)).items():
                    buf[r] = acc
                    gathered[r] += 1
        else:
            nrows = len(payload)
            natural = [nat for _, nat in payload]
            for jw in range(n_warps):
                for r in range(jw * nrows // n_warps, (jw + 1) * nrows // n_warps):
                    split = payload[r][0]
                    assert counters[split] == p0[split + 1] - p0[split]  # all have counted
                    counters[split] = 0
                    acc = torch.zeros(D)
                    for q in range(p0[split], p0[split + 1]):  # segment order
                        acc = acc + partial[q]
                    buf[r] = acc
                    gathered[r] += 1
        np.testing.assert_array_equal(gathered[:nrows], 1)
        a = buf[:nrows].numpy()
        for rank in range(pair):  # each CTA's panel of columns
            cols = slice(rank * D // pair, (rank + 1) * D // pair)
            wp = wmat[:, cols].numpy()
            if dtype == torch.bfloat16:
                y = _product_3xbf16(a, wp)
            elif kind == "tile":
                y = _product_3xtf32(a, wp)
            else:  # fp32 cut rows: the narrow instances' fp32 SIMT row product
                y = a @ wp
            for r, nat in enumerate(natural):
                out[nat, cols] = torch.from_numpy(y[r]) + bias[cols]
                written[nat, rank] += 1
    np.testing.assert_array_equal(slot_use, 1)
    np.testing.assert_array_equal(diag_use, 1)
    np.testing.assert_array_equal(seg_use, 1)
    np.testing.assert_array_equal(written, 1)
    np.testing.assert_array_equal(counters, 0)
    return out


def _inputs(rng, n, dtype):
    x = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32)).to(dtype)
    wm = torch.from_numpy((rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.standard_normal(D).astype(np.float32))
    return x, wm, b


@pytest.mark.parametrize("split_diag", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_replay_matches_plain_and_jax(dtype, split_diag):
    """The (256, 256) split on a graph with hub rows (K = 1,100 cut into
    segments), tiles of 32 to 3 rows and rows in no bucket: the replay's fp32
    sums against the plain version on the same (dtype-rounded) inputs at the
    fp32 tolerance, and the result in ``dtype`` against the plain version
    and the JAX Pallas layer at that type's tolerance."""
    rng = np.random.default_rng(7 + split_diag + 2 * (dtype == torch.bfloat16))
    src, dst, w, n = _graph(rng, split_diag)
    top = build_ell_operator(src, dst, w, n, split_diag=split_diag)
    jop = jax_ell_operator(src, dst, w, n, split_diag=split_diag)
    plan = layer_plan(top.fwd)
    assert plan.hub.shape[0] == 2 and plan.segs.shape[0] > 2 * GATHER_WARPS
    x, wm, b = _inputs(rng, n, dtype)
    got = _replay_wide(top.fwd, top.diag, x.float(), wm.float(), b, dtype)
    want = reference_layer(top.fwd, top.diag, x.float(), wm.float(), b)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else BF16_TOL
    got = got.to(dtype)  # the kernel's one rounding
    plain = reference_layer(top.fwd, top.diag, x, wm, b)
    torch.testing.assert_close(got.float(), plain.float(), **tol)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16 else
                                               jnp.float32)
    jw = jnp.asarray(wm.float().numpy()).astype(jx.dtype)
    jax_want = np.asarray(jax_fused_layer(jop.fwd, jop.diag, jx, jw, jnp.asarray(b.numpy()),
                                          interpret=True), np.float32)
    np.testing.assert_allclose(got.float().numpy(), jax_want, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hubs", list(HUBS))
def test_wide_hub_rows_summed_once(hubs, dtype):
    """Hub rows just above the segment cap, at twice it and far above it:
    each segment is gathered once, each cut row summed once after its last
    segment (the replay's asserts), and those rows match the plain version;
    the hub table lists every cut row once, in cut-row order, at its
    natural row."""
    rng = np.random.default_rng(len(hubs) + (dtype == torch.bfloat16))
    src, dst, w, n = _graph(rng, True, {1: 30, 8: 20, **HUBS[hubs]})
    top = build_ell_operator(src, dst, w, n, split_diag=True)
    plan = layer_plan(top.fwd)
    hub = plan.hub.numpy()
    np.testing.assert_array_equal(hub[:, 0], np.arange(plan.split_p0.shape[0] - 1))
    rows = plan.tiles.rows.numpy()
    for pos0, *_, split in plan.segs.tolist():
        assert hub[split, 1] == rows[pos0]
    x, wm, b = _inputs(rng, n, dtype)
    got = _replay_wide(top.fwd, top.diag, x.float(), wm.float(), b, dtype)
    want = reference_layer(top.fwd, top.diag, x.float(), wm.float(), b)
    cut = torch.from_numpy(hub[:, 1]).long()
    torch.testing.assert_close(got[cut], want[cut], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d_in,d_out", [(128, 128), (256, 256)])
def test_3xbf16_product_error_budget(d_in, d_out):
    """A 32-row aggregate times a bf16 W against float64, as a share of the
    tolerance 1e-4 + 1e-4·|y|: the three bf16 terms are exact (hi + mid + lo
    = a), and their product stays within 5 % of the tolerance and within
    1.5× a plain fp32 product; two terms (hi + mid) leave 2⁻¹⁶ of a, over
    5 % and several times the fp32 product's error."""
    rng = np.random.default_rng(d_in + d_out)
    a = (3.0 * rng.standard_normal((TILE_ROWS, d_in))).astype(np.float32)
    wm = torch.from_numpy((rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(
        np.float32)).to(torch.bfloat16).float().numpy()
    want = a.astype(np.float64) @ wm.astype(np.float64)

    def share(y):
        return float(np.max(np.abs(y - want) / (1e-4 + 1e-4 * np.abs(want))))

    hi, mid, lo = _split3_bf16(a)
    np.testing.assert_array_equal((hi + mid) + lo, a)
    for t in (hi, mid, lo):
        np.testing.assert_array_equal(_top16(t), t)  # each a bf16 value
    got3 = _product_3xbf16(a, wm)
    got2 = mid @ wm + hi @ wm
    assert share(got3) <= 0.05 and share(got3) <= 1.5 * share(a @ wm)
    assert share(got2) > 0.05 and share(got2) >= 3 * share(a @ wm)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_in,d_out", [(128, 128), (128, 256), (256, 128), (256, 256)])
def test_panels_and_scratch_sizing(d_in, d_out, dtype):
    """Two panels (a CTA pair) only for the fp32 (256, 256) instance; the
    scratch is the partials (one per segment, whatever the panels) then the
    work and done counters and one counter per cut row, for every
    instance; a sub-plan keeps only the cut rows whose segments it runs."""
    assert PANELS[(d_in, d_out, dtype)] == (2 if (d_in, d_out, dtype) == (256, 256, torch.float32)
                                           else 1)
    rng = np.random.default_rng(3)
    src, dst, w, n = _graph(rng, True, {**DEGREES, 2 * SEG_SLOTS: 2})
    m = build_ell_operator(src, dst, w, n, split_diag=True).fwd
    plan = layer_plan(m)
    n_split = plan.split_p0.shape[0] - 1
    scratch = gcn_fused._scratch(plan, d_in, d_out, torch.device("cpu"), 0)
    assert scratch.shape == (plan.n_partials * d_in + 2 + n_split,) and not scratch.any()
    assert gcn_fused.counters(plan, d_in, d_out, 0).shape == (2 + n_split,)
    assert gcn_fused._scratch(plan, d_in, d_out, torch.device("cpu"), 0) is scratch
    big = plan.segs[:, 2] >= 1024
    part = sub_plan(plan, plan.tiles.tiles, plan.segs[big])
    assert set(part.hub[:, 0].tolist()) == set(plan.segs[big][:, 7].tolist()) and \
        0 < part.hub.shape[0] < plan.hub.shape[0] and not part.scratch
