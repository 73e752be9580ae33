"""The fused GCN layer at every width (tpugraph_torch.kernels.gcn_fused:
``fused_gcn_layer`` outside the instances' {128, 256}², ``fused_bucket_apply``,
``kernel_plan``, ``FUSED_WIDTHS``) on the host, against the JAX package's
Pallas kernel in interpret mode (``tpugraph/kernels/gcn_fused_pallas.py``).

On the CPU the wrappers run their plain versions; the card's kernels
(``csrc/gcn_fused.cu``, ``gcn_fused_kernel_wgmma`` and ``gcn_fused_kernel_any``)
are held to them by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.  What is
checked here: the plain versions against the Pallas layer and its bucket
entry (fp32 at (64, 64), (50, 300), (300, 50), bf16 at (50, 300)), the
bucket entry's padded shape, the one-bucket matrix the card's launch walks,
the launch plan at every width on a grid up to 2,048 (shared memory, the
kernel each width takes, the W bytes a layer reads against the per-tile
kernel's), the
W prologue's layout, a replay of the wgmma kernel's work split and product
through that layout, the route table against ``gcn_layer_plain``, and the
encoder at a fused width without an instance and at a wgmma width against
the JAX encoder.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_gcn_fused_split import DEGREES
from test_torch_gcn_fused_split import _graph as _split_graph
from tpugraph.kernels.gcn_fused_pallas import _tile_sizes
from tpugraph.kernels.gcn_fused_pallas import fused_bucket_apply as jax_bucket_apply
from tpugraph.kernels.gcn_fused_pallas import fused_gcn_layer as jax_fused_layer
from tpugraph.models.encoder import AlignGCN as JaxAlignGCN
from tpugraph.sparse.build import build_adjacency as jax_build_adjacency
from tpugraph.sparse.ell import build_ell_operator as jax_ell_operator
from tpugraph_torch.convert import params_from_jax
from tpugraph_torch.kernels import gcn_fused
from tpugraph_torch.kernels.gcn_fused import (FUSED_WIDTHS, WIDTHS, bucket_matrix,
                                              bucket_tile_rows, fused_bucket_apply,
                                              fused_bucket_apply_plain, fused_gcn_layer,
                                              gcn_layer, gcn_layer_plain, kernel_plan,
                                              layer_plan, reference_layer)
from tpugraph_torch.kernels.spmm_ell import SEG_SLOTS, TILE_ROWS, apply_with_diag
from tpugraph_torch.models.encoder import AlignGCN
from tpugraph_torch.sparse.build import build_adjacency
from tpugraph_torch.sparse.ell import build_ell_operator

# tests/test_fused_gcn.py's bounds: fp32 and bf16
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4), torch.bfloat16: dict(rtol=0.05, atol=0.5)}
SMEM_BLOCK = 232_448  # shared memory a block may use on the H100
# the launch plan's grid: tails of every kind up to 1,030 columns
GRID = (1, 3, 4, 5, 31, 32, 33, 50, 63, 64, 65, 100, 127, 128, 129, 191, 192, 200, 255, 256,
        257, 300, 384, 500, 511, 512, 513, 514, 640, 768, 1000, 1024, 1030)


def _one_bucket_graph(rng, n=100, k=3):
    """Every row of K = 3 off-diagonal edges (one ELL bucket, so one Pallas
    call a layer) and a self-loop on each row (the split diagonal)."""
    dst = np.repeat(np.arange(n), k)
    src = (dst + np.tile(np.arange(1, k + 1), n)) % n
    loops = np.arange(n)
    src, dst = np.concatenate([src, loops]), np.concatenate([dst, loops])
    w = rng.standard_normal(len(src)).astype(np.float32)
    return src.astype(np.int32), dst.astype(np.int32), w, n


def _inputs(rng, n, d_in, d_out):
    x = rng.standard_normal((n, d_in)).astype(np.float32)
    wm = (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(np.float32)
    b = rng.standard_normal(d_out).astype(np.float32)
    return x, wm, b


def _to(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _jax(a, dtype):
    return jnp.asarray(a).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


CASES = [(64, 64, torch.float32), (50, 300, torch.float32), (300, 50, torch.float32),
         (50, 300, torch.bfloat16)]


@pytest.mark.parametrize("d_in,d_out,dtype", CASES)
def test_layer_matches_jax_interpret(d_in, d_out, dtype):
    """The layer outside the instances (the card's any-width kernels; their
    plain version here) against the Pallas layer in interpret mode, with the
    split diagonal and a bias, at tests/test_fused_gcn.py's tolerances."""
    rng = np.random.default_rng(d_in + d_out)
    src, dst, w, n = _one_bucket_graph(rng)
    top = build_ell_operator(src, dst, w, n, split_diag=True)
    jop = jax_ell_operator(src, dst, w, n, split_diag=True)
    assert len(jop.fwd.buckets) == 1
    x, wm, b = _inputs(rng, n, d_in, d_out)
    assert kernel_plan(d_in, d_out, dtype).kernel in ("gcn_fused_kernel_any",
                                                      "gcn_fused_kernel_wgmma")
    got = fused_gcn_layer(top.fwd, top.diag, _to(x, dtype), _to(wm, dtype), torch.from_numpy(b))
    want = jax_fused_layer(jop.fwd, jop.diag, _jax(x, dtype), _jax(wm, dtype), jnp.asarray(b),
                           interpret=True)
    assert got.dtype == dtype and got.shape == (n, d_out)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("d_in,d_out,dtype", CASES)
def test_bucket_apply_matches_jax_interpret(d_in, d_out, dtype):
    """``fused_bucket_apply`` (no diagonal, no bias) against the Pallas
    entry: the same padded shape, the same zero rows past R, the values at
    the tolerances above."""
    rng = np.random.default_rng(7 + d_in + d_out)
    n, r, k = 100, 37, 5
    idx = rng.integers(0, n, (r, k)).astype(np.int32)
    w = rng.standard_normal((r, k)).astype(np.float32)
    x, wm, _ = _inputs(rng, n, d_in, d_out)
    got = fused_bucket_apply(torch.from_numpy(idx), torch.from_numpy(w), _to(x, dtype),
                             _to(wm, dtype))
    want = np.asarray(jax_bucket_apply(jnp.asarray(idx), jnp.asarray(w), _jax(x, dtype),
                                       _jax(wm, dtype), interpret=True), np.float32)
    assert got.shape == want.shape and got.dtype == dtype
    assert not got[r:].any() and not want[r:].any()
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


def test_tile_rows_copy_the_jax_rule():
    """The port's copy of the Pallas wrapper's row tile (``_tile_sizes``)."""
    for k in range(1, 600):
        assert bucket_tile_rows(k) == _tile_sizes(k)[0], k


@pytest.mark.parametrize("k", [1, 4, 40, SEG_SLOTS + 1, 300])
def test_bucket_apply_pads_with_zero_rows(k):
    """R rows padded to the multiple of the tile at or above R, rows past R
    zero; the rows below R the weighted sums of x[idx] times W (float64).
    The one-bucket matrix the card's launch walks holds the same function:
    ``reference_layer`` over it (no diagonal, no bias) gives those rows, its
    rows past R are in no bucket, and a bucket of K > SEG_SLOTS is cut into
    segments (every row a cut row)."""
    rng = np.random.default_rng(k)
    n, r, d_in, d_out = 60, 45, 12, 7
    idx = torch.from_numpy(rng.integers(0, n, (r, k)).astype(np.int32))
    w = torch.from_numpy(rng.standard_normal((r, k)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((n, d_in)).astype(np.float32))
    wm = torch.from_numpy(rng.standard_normal((d_in, d_out)).astype(np.float32))
    got = fused_bucket_apply(idx, w, x, wm)
    r_pad = -(-r // _tile_sizes(k)[0]) * _tile_sizes(k)[0]
    assert got.shape == (r_pad, d_out) and not got[r:].any()
    agg = np.einsum("rk,rkd->rd", w.double().numpy(), x.double().numpy()[idx.numpy()])
    np.testing.assert_allclose(got[:r].numpy(), agg @ wm.double().numpy(), rtol=1e-5, atol=1e-4)
    m = bucket_matrix(idx, w, n)
    assert m.n_rows == r_pad and len(m.buckets) == 1 and m.n_cols == n
    torch.testing.assert_close(reference_layer(m, None, x, wm), got, rtol=1e-5, atol=1e-5)
    plan = layer_plan(m)
    assert plan.tiles.n_zero_rows == r_pad - r
    assert plan.hub.shape[0] == (r if k > SEG_SLOTS else 0)
    torch.testing.assert_close(fused_bucket_apply_plain(idx, w, x, wm), got, rtol=0, atol=0)


def _w_fits_half_an_sm(old, d_in: int) -> bool:
    """The per-tile kernel's residency rule on its plan ``old``, from its
    parts: a 32-row aggregate of its k-chunk and W whole (its padded panels
    × d_in rounded up to 32) within what lets two blocks share an SM; the
    plan's own ``w_resident`` must agree."""
    w_bytes = 4 * old.n_panels * old.panel * gcn_fused._up(d_in, 32)
    fits = 4 * 32 * old.k_chunk + w_bytes <= gcn_fused.SMEM_TWO_BLOCKS
    assert old.w_resident == fits, (d_in, old)
    return fits


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_plan_fits_at_every_width(dtype):
    """At every (d_in, d_out) of the grid (and far above it) the launch plan
    fits a block's shared memory and agrees with the kernel's own sum
    (csrc/gcn_fused.cu, any::smem_bytes or wg::smem_bytes); the per-tile kernel
    covers d_in in its chunks and d_out in its panels with less than one to
    spare and holds W whole where two blocks still fit an SM, the wgmma
    kernel covers d_out in panels of 64 and d_in in slabs of 128, with two
    aggregate buffers where they fit beside two W slots; the instances keep
    theirs."""
    up = gcn_fused._up
    for d_in, d_out in itertools.chain(itertools.product(GRID, GRID),
                                       [(2048, 2048), (5000, 700), (1, 4096)]):
        p = kernel_plan(d_in, d_out, dtype)
        assert p.smem_bytes <= SMEM_BLOCK, (d_in, d_out, p)
        if (d_in, d_out) in WIDTHS:
            assert p.kernel not in ("gcn_fused_kernel_any", "gcn_fused_kernel_wgmma")
            assert p.k_chunk == d_in and p.panel * p.n_panels == d_out
            assert p.cluster == gcn_fused.PANELS[d_in, d_out, dtype]
            continue
        assert p.partial_pitch == up(d_in, 128)
        resident = _w_fits_half_an_sm(gcn_fused.any_plan(d_in, d_out, dtype), d_in)
        if p.kernel == "gcn_fused_kernel_wgmma":
            assert not resident and d_in <= 768, (d_in, d_out)
            assert p.cluster == 2 and p.panel == 64 and p.unit_rows == 64
            assert (p.n_panels - 1) * 64 < d_out <= p.n_panels * 64
            assert p.k_chunk == up(d_in, 128) and p.n_k_chunks == 1
            assert p.w_chunk == 128 // (4 if dtype == torch.float32 else 2)
            assert p.agg_buffers in (1, 2) and 2 <= p.w_stages <= gcn_fused.WG_MAX_STAGES
            chunk = 8192 * (2 if dtype == torch.float32 else 1)  # fp32: W's two TF32 planes
            slabs = up(d_in, 128) // 128
            assert p.smem_bytes == 1024 + p.w_stages * chunk + p.agg_buffers * slabs * 32768
            two = 1024 + 2 * chunk + 2 * slabs * 32768
            assert (p.agg_buffers == 2) == (two <= gcn_fused.SMEM_DYNAMIC)
            continue
        assert p.kernel == "gcn_fused_kernel_any" and p.cluster == 1
        assert resident or gcn_fused.wgmma_layout(d_in, d_out, dtype) is None, (d_in, d_out)
        assert p.k_chunk % 128 == 0
        assert (p.n_k_chunks - 1) * p.k_chunk < p.partial_pitch <= p.n_k_chunks * p.k_chunk
        assert p.panel in (64, 128) and (p.n_panels - 1) * p.panel < d_out <= p.n_panels * p.panel
        assert up(d_out, p.panel) <= up(d_out, 192 - p.panel)  # the panel that pads less
        w_bytes = 4 * p.n_panels * p.panel * up(d_in, 32)
        assert p.w_resident == (4 * 32 * p.k_chunk + w_bytes <= gcn_fused.SMEM_TWO_BLOCKS)
        assert p.w_chunk == (up(d_in, 32) if p.w_resident else gcn_fused.W_CHUNK)
        assert p.smem_bytes == 4 * 32 * p.k_chunk + (
            w_bytes if p.w_resident else 4 * p.panel * gcn_fused.W_CHUNK)
        assert (p.n_k_chunks == 1) == (d_in <= 1536)
    assert kernel_plan(5000, 700, dtype).n_k_chunks == 4
    with pytest.raises(ValueError):
        kernel_plan(0, 5, dtype)


# chip_smoke.py's ANY_WIDTHS: the widths the card times the any-width layer at
ANY_WIDTHS = ((384, 384, torch.float32), (512, 512, torch.float32), (768, 768, torch.float32),
              (50, 300, torch.float32), (300, 50, torch.float32), (64, 64, torch.float32),
              (384, 384, torch.bfloat16), (768, 768, torch.bfloat16))
ROWS = 38_000  # the zh-en operator's rows, for the W bytes a layer moves


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wgmma_plan_moves_w_once_per_128_rows(dtype):
    """On a grid of widths up to 2,048: wherever the per-tile kernel
    (``gcn_fused_kernel_any``, its plan ``any_plan``) restages W
    for every 32-row tile and a layout of the redesign fits, the plan takes
    the wgmma kernel, whose cluster of two reads each W chunk once for 128
    rows (P = 2 ≤ 8), its panels cover [0, d_out) once, its units are whole
    plan tiles, and the W bytes a layer reads (both counted over the padded
    grid of W each walks) are at most a quarter of its in bf16 and half
    in fp32, whose chunks carry W's two TF32 planes (8 bytes an element, so
    no CTA splits W; four CTAs a cluster, a quarter, ran 12 % slower on the
    H100: PERF.md §6); it takes it at every ANY_WIDTHS width where the
    per-tile kernel streams W.  Where W stays resident (once per block) or
    no layout fits (d_in above 768), the per-tile kernel, and the plan says
    which."""
    grid = sorted(set(GRID) | {640, 700, 896, 1536, 2048})
    for d_in, d_out in itertools.product(grid, grid):
        if (d_in, d_out) in WIDTHS:
            continue
        p = kernel_plan(d_in, d_out, dtype)
        old = gcn_fused.any_plan(d_in, d_out, dtype)  # the per-tile kernel's plan
        resident = _w_fits_half_an_sm(old, d_in)
        if p.kernel != "gcn_fused_kernel_wgmma":
            assert resident == p.w_resident and (resident or d_in > 768), (d_in, d_out)
            continue
        assert not resident and d_in <= 768
        assert p.cluster <= 8 and p.w_pass_rows == p.cluster * p.unit_rows >= 128
        assert p.unit_rows % TILE_ROWS == 0
        cols = [c for pan in range(p.n_panels) for c in range(pan * 64, pan * 64 + 64)]
        assert sorted(c for c in cols if c < d_out) == list(range(d_out))
        assert p.w_pass_bytes == gcn_fused.wt_layout_bytes(d_in, d_out, dtype)
        share = 2 if dtype == torch.float32 else 4  # of its W bytes at most 1 / share
        assert share * p.w_bytes_per_layer(ROWS) <= old.w_bytes_per_layer(ROWS), (d_in, d_out)
    for d_in, d_out, dt in ANY_WIDTHS:
        if dt == dtype and not gcn_fused.any_plan(d_in, d_out, dt).w_resident:
            assert kernel_plan(d_in, d_out, dt).kernel == "gcn_fused_kernel_wgmma", (d_in, d_out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_in,d_out", [(3, 5), (40, 70), (300, 50), (384, 130)])
def test_wt_layout_is_the_swizzled_transpose(d_in, d_out, dtype):
    """The W prologue's plain version: each plane of chunk (panel, k-chunk)
    read back the way wgmma reads a K-major, 128-byte-swizzled tile (row
    n's 16-byte piece j at piece j ^ (n % 8)) is Wᵀ's 64 columns × the
    chunk's k's in k_of order, zero past W's edges; fp32's two planes are
    W's TF32 big part (the low 13 bits zero) and small part, which sum to W
    within TF32's rounding of the small part; k_of permutes each group of
    16."""
    rng = np.random.default_rng(d_in * 7 + d_out)
    wm = torch.from_numpy(rng.standard_normal((d_in, d_out)).astype(np.float32)).to(dtype)
    lay = gcn_fused.wt_layout_plain(wm)
    elem, ck = (4, 32) if dtype == torch.float32 else (2, 64)
    n_pan, n_kc = -(-d_out // 64), -(-d_in // ck)
    planes = 2 if dtype == torch.float32 else 1
    assert lay.shape == (n_pan, n_kc, planes, 8192 // elem)
    assert lay.numel() * elem == gcn_fused.wt_layout_bytes(d_in, d_out, dtype)
    pos = np.arange(ck)
    k = gcn_fused.k_of(pos, dtype)
    for g in range(0, ck, 16):
        assert sorted(k[g:g + 16]) == list(range(g, g + 16))
    n = np.arange(64)[:, None]
    byte = pos[None, :] * elem
    at = (n * 128 + ((byte // 16) ^ (n % 8)) * 16 + byte % 16) // elem  # (64, ck) element index
    wp = torch.zeros((n_kc * ck, n_pan * 64), dtype=dtype)
    wp[:d_in, :d_out] = wm
    for pan in range(n_pan):
        for c in range(n_kc):
            got = [lay[pan, c, pl][torch.from_numpy(at)] for pl in range(planes)]
            want = wp[c * ck + torch.from_numpy(k)][:, pan * 64:pan * 64 + 64].t()
            if dtype == torch.bfloat16:
                assert torch.equal(got[0], want), (pan, c)
                continue
            big, small = got
            assert not (big.view(torch.int32) & 0x1FFF).any()
            assert not (small.view(torch.int32) & 0x1FFF).any()
            torch.testing.assert_close(big.double() + small.double(), want.double(),
                                       rtol=2.0 ** -21, atol=0)
            want_big, want_small = gcn_fused.tf32_split(want)
            assert torch.equal(big, want_big) and torch.equal(small, want_small)


WG_GATHER_WARPS = 11  # wg::kGatherWarps in csrc/gcn_fused.cu
WG_HUB_ROWS = 16  # wg::kHubRows: cut rows a unit
WG_ROWS = 64  # wg::kRows: a unit's rows, two plan tiles


def _wg_units(plan):
    """The wgmma kernel's units in the order its counter hands them out:
    groups of WG_GATHER_WARPS segments, the cut rows WG_HUB_ROWS at a time,
    then pairs of tiles (a tile of K > SEG_SLOTS skipped, as None)."""
    g = WG_GATHER_WARPS
    segs, tiles, hub = plan.segs.tolist(), plan.tiles.tiles.tolist(), plan.hub.tolist()
    out = [("segments", segs[u * g:(u + 1) * g]) for u in range(-(-len(segs) // g))]
    out += [("hub", hub[h:h + WG_HUB_ROWS]) for h in range(0, len(hub), WG_HUB_ROWS)]
    ok = [t if t[2] <= SEG_SLOTS else None for t in tiles]
    return out + [("pair", (ok[j], ok[j + 1] if j + 1 < len(ok) else None))
                  for j in range(0, len(ok), 2)]


def _run_bounds(pair):
    """Each gather warp's first row of a tile pair's rows (tile 0's, then
    tile 1's), split by their slots (K + 1 a row), rounded to the nearest
    row: the kernel's `bound`."""
    (na, ka), (nb, kb) = [(t[1], t[2]) if t else (0, 0) for t in pair]
    va = na * (ka + 1)
    vt = va + nb * (kb + 1)

    def bound(w):
        t = w * vt // WG_GATHER_WARPS
        return (t + ka // 2) // (ka + 1) if t <= va else na + (t - va + kb // 2) // (kb + 1)
    return [bound(w) for w in range(WG_GATHER_WARPS + 1)]


def _product_replay(agg, lay, d_in, dtype):
    """A unit's (WG_ROWS, d_in) aggregate times W through the prologue's
    layout, as the warpgroup's wgmma reads both: A from each lane's 16-byte
    load of columns kk + 4t .. + 3 into its fragment registers (TF32: k t
    and t + 4 of two k-steps; bf16: k 2t, 2t + 1, 2t + 8, 2t + 9), B from the
    chunk's swizzled K-major rows (fp32: its big and small planes summed),
    group by group of 16 k's; in float64."""
    elem, ck = (4, 32) if dtype == torch.float32 else (2, 64)
    n_pan, n_kc, _, _ = lay.shape
    n = np.arange(64)[:, None]
    out = np.zeros((WG_ROWS, n_pan * 64))
    a = np.zeros((WG_ROWS, -(-d_in // 128) * 128 + ck))
    a[:, :agg.shape[1]] = agg
    kpad = -(-d_in // 16) * 16
    for pan in range(n_pan):
        for c in range(n_kc):
            for gi in range(ck // 16):
                kk = c * ck + gi * 16
                if kk >= kpad:
                    break
                steps = [(2 * gi + ks, ks) for ks in (0, 1)] if elem == 4 else [(gi, 0)]
                for step, ks in steps:
                    kdim = 8 if elem == 4 else 16
                    frag = np.zeros((WG_ROWS, kdim))
                    for t in range(4):
                        v = a[:, kk + 4 * t:kk + 4 * t + 4]
                        if elem == 4:
                            frag[:, t], frag[:, t + 4] = v[:, 2 * ks], v[:, 2 * ks + 1]
                        else:
                            frag[:, 2 * t:2 * t + 2] = v[:, :2]
                            frag[:, 2 * t + 8:2 * t + 10] = v[:, 2:]
                    byte = step * 32 + np.arange(kdim)[None, :] * elem
                    at = (n * 128 + ((byte // 16) ^ (n % 8)) * 16 + byte % 16) // elem
                    b = lay[pan, c].sum(0)[at]  # fp32: big + small, W to TF32's rounding
                    out[:, pan * 64:pan * 64 + 64] += frag @ b.T
    return out


def _replay_wgmma(m, diag, x, wmat, bias, dtype):
    """What gcn_fused_kernel_wgmma computes, cluster step by cluster step
    (two units a step, one a CTA), from the same tables: each segment
    walked once by one gather warp into its partial, each cut row summed in
    segment order once all its segments counted, each tile pair's rows split
    over the gather warps by ``_run_bounds``; every unit with rows multiplied
    through the prologue's layout (``_product_replay``) into the output's
    natural rows.  Checks that every ELL slot and diagonal slot is used once,
    every aggregate row gathered once, every output row written once by one
    CTA, and the counters left at 0.  Returns the float64 result before the
    output's rounding, and (rank, warp) of each tile row's gather."""
    plan = layer_plan(m)
    d_in = x.shape[1]
    lay = gcn_fused.wt_layout_plain(wmat).double().numpy()
    rows, idx, w = plan.tiles.rows.long(), plan.tiles.idx.long(), plan.tiles.w
    p0 = plan.split_p0.tolist()
    out = np.full((m.n_rows, wmat.shape[1]), np.nan)
    written = np.zeros(m.n_rows, int)
    slot_use, diag_use = np.zeros(idx.shape[0], int), np.zeros(m.n_rows, int)
    counters, partial, gathered_by = np.zeros(len(p0) - 1, int), {}, {}

    def walk(pos0, k, slot0, v0, v1):  # {local row: its fp32 sum over virtual slots [v0, v1)}
        acc = {}
        for v in range(v0, v1):
            r, kk = divmod(v, k + 1)
            if kk < k:
                s_ = slot0 + r * k + kk
                slot_use[s_] += 1
                term = w[s_] * x[idx[s_]]
            else:
                nat = int(rows[pos0 + r])
                diag_use[nat] += 1
                term = diag[nat] * x[nat] if diag is not None else torch.zeros(d_in)
            acc[r] = acc.get(r, torch.zeros(d_in)) + term
        return acc

    units = _wg_units(plan)
    for step in range(0, len(units), 2):
        for rank, (kind, payload) in enumerate(units[step:step + 2]):
            agg = np.full((WG_ROWS, d_in), np.nan)
            orow = [-1] * WG_ROWS
            if kind == "segments":  # one a warp: its partial, then its count
                assert len(payload) <= WG_GATHER_WARPS
                for pos0, nr, k, slot0, v0, v1, part, split in payload:
                    (partial[part],) = walk(pos0, k, slot0, v0, v1).values()
                    counters[split] += 1
                continue
            if kind == "hub":
                for r, (split, nat) in enumerate(payload):  # warp r % WG_GATHER_WARPS
                    assert counters[split] == p0[split + 1] - p0[split]  # all have counted
                    counters[split] = 0
                    acc = torch.zeros(d_in)
                    for q in range(p0[split], p0[split + 1]):  # segment order
                        acc = acc + partial[q]
                    agg[r], orow[r] = acc.numpy(), nat
            else:
                bounds = _run_bounds(payload)
                base = [0, payload[0][1] if payload[0] else 0]
                for warp in range(WG_GATHER_WARPS):
                    for h, t in enumerate(payload):
                        if t is None:
                            continue
                        row0, nrows, k, slot0 = t
                        r0 = max(bounds[warp] - base[h], 0)
                        r1 = min(bounds[warp + 1] - base[h], nrows)
                        for r, acc in walk(row0, k, slot0, r0 * (k + 1), r1 * (k + 1)).items():
                            assert np.isnan(agg[TILE_ROWS * h + r]).all()  # gathered once
                            agg[TILE_ROWS * h + r] = acc.numpy()
                            orow[TILE_ROWS * h + r] = int(rows[row0 + r])
                            gathered_by[int(rows[row0 + r])] = (rank, warp)
            y = _product_replay(np.nan_to_num(agg), lay, d_in, wmat.dtype)
            for r, nat in enumerate(orow):
                if nat >= 0:
                    out[nat] = y[r, :wmat.shape[1]] + bias.double().numpy()
                    written[nat] += 1
    np.testing.assert_array_equal(slot_use, 1)
    np.testing.assert_array_equal(diag_use, 1)
    np.testing.assert_array_equal(written, 1)
    np.testing.assert_array_equal(counters, 0)
    return torch.from_numpy(out), gathered_by


@pytest.mark.parametrize("d_in,d_out,dtype", [(300, 50, torch.float32), (130, 200, torch.bfloat16)])
@pytest.mark.parametrize("split_diag", [False, True])
def test_wgmma_replay_matches_plain(d_in, d_out, dtype, split_diag):
    """The wgmma kernel's work split on a graph with hub rows (K = 1,100 cut
    into segments), tiles of 32 to 3 rows and rows in no bucket, at two
    widths it takes (d_out no multiple of 16: the cluster's 2 × 8): the
    replay against ``reference_layer`` on the same inputs, both CTAs of a
    cluster and more than one gather warp having gathered tile rows."""
    assert kernel_plan(d_in, d_out, dtype).kernel == "gcn_fused_kernel_wgmma"
    rng = np.random.default_rng(d_in + d_out + split_diag)
    src, dst, w, n = _split_graph(rng, split_diag, DEGREES)
    op = build_ell_operator(src, dst, w, n, split_diag=split_diag)
    assert layer_plan(op.fwd).hub.shape[0] > 0
    x, wm, b = _inputs(rng, n, d_in, d_out)
    x, wm, b = _to(x, dtype), _to(wm, dtype), torch.from_numpy(b)
    got, by = _replay_wgmma(op.fwd, op.diag, x.float(), wm, b, dtype)
    want = reference_layer(op.fwd, op.diag, x.float(), wm.float(), b)
    torch.testing.assert_close(got.float(), want, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got.to(dtype).float(),
                               reference_layer(op.fwd, op.diag, x, wm, b).float(), **TOL[dtype])
    assert {r for r, _ in by.values()} == {0, 1} and len({wp for _, wp in by.values()}) > 1


@pytest.mark.parametrize("d_in,d_out", [(3, 5), (50, 300), (300, 50), (1030, 1030)])
def test_scratch_holds_the_plans_partials(d_in, d_out):
    """The wrapper's scratch at an any-width (d_in, d_out): one fp32 partial
    of the plan's pitch per segment, then the unit, done and cut-row
    counters, all zero; cached per (d_in, d_out, stream)."""
    rng = np.random.default_rng(3)
    n = 400
    src = rng.integers(0, n, 3000)
    dst = rng.integers(0, n, 3000)
    dst[:600] = 5  # a cut row (K > SEG_SLOTS)
    m = build_ell_operator(src, dst, np.ones(3000, np.float32), n).fwd
    plan = layer_plan(m)
    n_split = plan.split_p0.shape[0] - 1
    assert n_split == 1 and plan.n_partials > 1
    kp = kernel_plan(d_in, d_out, torch.float32)
    scratch = gcn_fused._scratch(plan, d_in, d_out, torch.device("cpu"), 0)
    assert scratch.shape == (plan.n_partials * kp.partial_pitch + 2 + n_split,)
    assert not scratch.any()
    assert gcn_fused.counters(plan, d_in, d_out, 0).shape == (2 + n_split,)
    assert gcn_fused._scratch(plan, d_in, d_out, torch.device("cpu"), 0) is scratch


@pytest.mark.parametrize("d_in,d_out", sorted(FUSED_WIDTHS | {(300, 50), (64, 128), (384, 384),
                                                                (768, 768), (3, 5)}))
def test_route_table_agrees_with_plain(d_in, d_out):
    """``fused_width`` is ``FUSED_WIDTHS`` (the instances' widths among
    them); ``gcn_layer_plain`` takes the route it names (the aggregate,
    then W; else x·W, then the aggregate) and ``gcn_layer`` gives its
    output bit for bit on the host."""
    assert set(WIDTHS) <= FUSED_WIDTHS
    fused = gcn_fused.fused_width(d_in, d_out)
    assert fused == ((d_in, d_out) in FUSED_WIDTHS)
    rng = np.random.default_rng(d_in * d_out)
    src, dst, w, n = _one_bucket_graph(rng, n=50)
    op = build_ell_operator(src, dst, w, n, split_diag=True)
    x, wm, b = (torch.from_numpy(a) for a in _inputs(rng, n, d_in, d_out))
    plain = gcn_layer_plain(op, x, wm, b)
    if fused:
        route = reference_layer(op.fwd, op.diag, x, wm, b)
    else:
        route = apply_with_diag(op.fwd, op.diag, torch.matmul(x, wm)) + b
    assert torch.equal(plain, route)
    assert torch.equal(gcn_layer(op, x, wm, b), plain)


@pytest.mark.parametrize("d_in,d_out", [(3, 5), (1030, 1030)])
def test_check_takes_every_width(d_in, d_out):
    """The wrapper's checks refuse a type, layout or shape the kernel does
    not take, and no width."""
    src, dst, w, n = _one_bucket_graph(np.random.default_rng(0), n=20)
    op = build_ell_operator(src, dst, w, n, split_diag=True)
    x, wm = torch.zeros(n, d_in), torch.zeros(d_in, d_out)
    gcn_fused._check(op.fwd, op.diag, x, wm, torch.zeros(d_out))
    with pytest.raises(ValueError):
        gcn_fused._check(op.fwd, op.diag, x, wm.to(torch.bfloat16), None)
    with pytest.raises(ValueError):
        gcn_fused._check(op.fwd, op.diag, x, wm[1:], None)
    with pytest.raises(TypeError):
        gcn_fused._check(op.fwd, op.diag, x.double(), wm.double(), None)
    with pytest.raises(ValueError):
        gcn_fused._check(op.fwd, op.diag, x, torch.zeros(d_in, 0), None)


def _encoder_against_jax(dim, hidden, seed):
    """``AlignGCN`` at (dim, hidden) against the JAX encoder, its parameters
    carried across by ``params_from_jax``: the layers' activations and
    every parameter's gradient against ``jax.grad``."""
    rng = np.random.default_rng(seed)
    n = 120
    tri = np.stack([rng.integers(0, n, 480), rng.integers(0, 5, 480),
                    rng.integers(0, n, 480)], 1).astype(np.int32)
    jop = jax_build_adjacency(n, tri, use_native=False, fmt="ell")
    op = build_adjacency(n, tri, use_native=False, fmt="ell")
    jm = JaxAlignGCN(n_ent=n, dim=dim, hidden=hidden, spmm_impl="ell")
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(2), jop)["params"])
    params["gc1"]["b"] = 0.1 * rng.standard_normal(hidden).astype(np.float32)
    params["gc2"]["b"] = 0.1 * rng.standard_normal(dim).astype(np.float32)
    cot = rng.standard_normal((n, dim)).astype(np.float32)
    want = jm.apply({"params": params}, jop, method="layer_activations")
    grads = params_from_jax(jax.tree_util.tree_map(np.asarray, jax.grad(
        lambda p: jnp.sum(jm.apply({"params": p}, jop) * cot))(params)))
    model = AlignGCN(n_ent=n, dim=dim, hidden=hidden, spmm_impl="ell")
    model.load_state_dict(params_from_jax(params))
    got = model.layer_activations(op)
    (got[-1] * torch.from_numpy(cot)).sum().backward()
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w_), rtol=1e-4, atol=1e-5)
    for k, v in model.named_parameters():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(grads[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_encoder_at_a_fused_width_matches_jax():
    """``AlignGCN`` at dim 50, hidden 300: its first layer on the fused route
    without an instance ((50, 300) in ``FUSED_WIDTHS``), its second x·W then
    the SpMM; the JAX encoder's parameters carried across by
    ``params_from_jax``, the layers' activations and every parameter's
    gradient against ``jax.grad``."""
    assert gcn_fused.fused_width(50, 300) and (50, 300) not in WIDTHS
    assert not gcn_fused.fused_width(300, 50)
    _encoder_against_jax(50, 300, 11)


def test_encoder_at_a_wgmma_width_matches_jax():
    """``AlignGCN`` at dim 384, both layers at (384, 384), where the plan
    takes the wgmma kernel and the layer's route (x·W, then the SpMM: the
    kernel did not beat it on the card) is what the card runs: against the
    JAX encoder as above."""
    assert kernel_plan(384, 384, torch.float32).kernel == "gcn_fused_kernel_wgmma"
    assert not gcn_fused.fused_width(384, 384)
    _encoder_against_jax(384, 384, 13)
