"""The port's CUDA kernels (fused GCN layer, ELL SpMM in fp32 and bf16,
sorted-segment SpMM, Sinkhorn potential update, shortlist select-and-rerank
and gathered distances, the exact L1 search's top-k, count and tile,
bit for bit at any number of work units)
against their plain versions, each exact cityblock search path on the card
against the host, and training on
the card: the attribute incidence's SpMM, a GCN layer on config highway's
operator, steps of recipes v6 and v7r, bf16 and sorted steps, captured
steps, ``debug_nans`` on a captured interval, and the approximate search
paths against the same calls on the host; the distributed trainer's
shard operators and steps (margin, recipe v7r's surface with the ring OT,
the attribute channel, bf16) and the exchange route beside them, a
replayed distributed interval, its ring stages (exact and shortlisted, at
``dwy100k_dist``'s block sizes), a bitwise resume, and one card holding
every feature block and slice (its step bit for bit the F = L = 1 step);
both SpMM kernels also at a tensor-parallel rank's width, d = 64; the
grouped layout's halo SpMM (``halo_grouped``) by both routes; the
single-device trainers on a sharded config, the fp32 (128, 128) fused
layer's error against float64, the wgmma any-width layer's (bit for bit
over two calls, its W prologue's layout), and ``sddmm_pairs``; the training step's
loss kernels (the L1 margin's forward and fixed-order backward, its sign
planes and pair vectors, the OT head's reverse update) against their plain
versions, bit for bit over two calls and through a captured replay (the
margin's also after a reload of negatives and index), and a margin step
that takes its index from the batch; every width up to 512: the SpMMs'
panels, the margin's masked instances and the streamed Sinkhorn strip
against their plain versions (two launches bit for bit, captured replays at
d 384), the GCN layer at widths without a fused instance (x·W, then the
ELL SpMM), the searches' zero columns, and pins of the outputs at the
widths that had instances before (``scripts/width_pins.py``).

Marked ``gpu``; each test skips without a CUDA device.  This file imports
neither JAX nor the JAX package, so on a machine with a card (and no JAX)
it runs without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import ctypes
import hashlib
import itertools
import math

import numpy as np
import pytest
import torch

import tpugraph_torch.models.align as align_mod
import tpugraph_torch.models.attr_channel as attr_channel_mod
import tpugraph_torch.nn.graphconv as graphconv_mod
from tpugraph_torch.configs.configs import get_config
from tpugraph_torch.configs.recipes import RECIPES
from tpugraph_torch.data.synthetic import synthetic_align_task
from tpugraph_torch.kernels import (_build, gcn_fused, l1_search, margin_l1, shortlist_dist,
                                   sinkhorn_fused, spmm_ell)
from tpugraph_torch.kernels import spmm as spmm_mod
from tpugraph_torch.kernels.spmm import PACK_SLOTS, SEG_EDGES, segment_spmm, sorted_spmm
from tpugraph_torch.kernels.gcn_fused import fused_gcn_layer, gcn_layer, reference_layer
from tpugraph_torch.kernels.sinkhorn_fused import sinkhorn_potential_update, sinkhorn_update_plain
from tpugraph_torch.kernels.sddmm import sddmm_pairs
from tpugraph_torch.kernels.spmm_ell import SEG_SLOTS, apply_with_diag, ell_spmm
from tpugraph_torch.models.align import AlignMTL, init_mtl_params
from tpugraph_torch.models.attr_channel import build_attr_operator
from tpugraph_torch.models.encoder import AlignGCN, init_params
from tpugraph_torch.serve import topk_alignments
from tpugraph_torch.sparse.build import build_adjacency, build_spmm_operator
from tpugraph_torch.sparse.ell import build_ell_operator
from tpugraph_torch.train.bootstrap import propose_mutual_nn_pairs
from tpugraph_torch.train.driver import run, step_parts
from tpugraph_torch.train.eval import _both_direction_ranks
from tpugraph_torch.train.fused import CapturedStep, train_step
from tpugraph_torch.train.loop import first_batch, fit, step_generator, step_seed
from tpugraph_torch.train.losses import margin_align_loss
from tpugraph_torch.train.mtl import fit_mtl
from tpugraph_torch.train.negatives import _hubness_both_approx, sample_hard_negatives
from tpugraph_torch.train.optim import make_optimizer
from tpugraph_torch.train.ot import sinkhorn_align_loss, sinkhorn_align_loss_plain
from tpugraph_torch.dist import mp_worker
from tpugraph_torch.dist.halo import exchange, halo_spmm, halo_spmm_ell
from tpugraph_torch.dist.mesh import make_mesh, shard_operator
from tpugraph_torch.dist.ring import ring_hits_at_k, ring_knn, ring_sinkhorn_align_loss
from tpugraph_torch.dist.trainer import dist_parts
from tpugraph_torch.sparse.build import coo_from_triples, coo_normalize
from tpugraph_torch.sparse.halo_ell import build_halo_ell, shard_edge_operators
from tpugraph_torch.sparse.partition import partition_edges
from tpugraph_torch.train.negatives import sample_uniform_negatives

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4), torch.bfloat16: dict(rtol=0.05, atol=0.5)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _graph(rng, n=1000, split_diag=True):
    """Hub rows with K in the hundreds and thousands, many short rows, and
    rows with no off-diagonal edge at all."""
    src = rng.integers(0, n, 6000)
    dst = rng.integers(0, n // 2, 6000)
    dst[:1500] = 3
    dst[1500:1900] = 11
    loops = np.arange(n)
    src, dst = np.concatenate([src, loops]), np.concatenate([dst, loops])
    w = rng.standard_normal(len(src)).astype(np.float32)
    return build_ell_operator(src, dst, w, n, split_diag=split_diag)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_in,d_out", [(128, 128), (128, 256), (256, 128), (256, 256),
                                        (3, 5), (50, 300), (300, 50), (64, 64), (384, 384),
                                        (768, 768), (1030, 1030), (2048, 64), (384, 100),
                                        (514, 130)])
@pytest.mark.parametrize("split_diag", [False, True])
def test_kernel_matches_plain(cuda, dtype, d_in, d_out, split_diag):
    """The instances at {128, 256}² and the any-width kernels elsewhere by
    the plan (the wgmma kernel at (300, 50), (384, *), (514, 130), (768,
    768); the per-tile kernel with W resident or past d_in 768; tails of 3, 5,
    50, 100, 130, 300 and 1,030 columns, d_out no multiple of the cluster's
    2 × 8 at 50, 100 and 130; (2048, 64) aggregates d_in in two chunks), on
    a graph with hub rows: one launch, against the plain version, with and
    without a bias."""
    rng = np.random.default_rng(d_in + d_out + split_diag)
    op = _graph(rng, split_diag=split_diag).to(cuda)
    x = torch.from_numpy(rng.standard_normal((op.n_rows, d_in)).astype(np.float32))
    wm = torch.from_numpy((rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(d_out).astype(np.float32))
    x, wm, b = x.to(cuda, dtype), wm.to(cuda, dtype), b.to(cuda)
    before = gcn_fused.launches
    got = fused_gcn_layer(op.fwd, op.diag, x, wm, b)
    torch.cuda.synchronize()
    assert gcn_fused.launches == before + 1
    assert got.dtype == dtype and got.shape == (op.n_rows, d_out)
    want = reference_layer(op.fwd, op.diag, x, wm, b)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    # no bias: the bias-free path
    torch.testing.assert_close(fused_gcn_layer(op.fwd, op.diag, x, wm).float(),
                               reference_layer(op.fwd, op.diag, x, wm).float(), **TOL[dtype])


def _rel_l2(a, ref):
    return float((a.double() - ref).norm() / ref.norm())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_in,d_out", [(300, 50), (384, 384), (384, 100), (512, 512),
                                        (768, 768)])
def test_wgmma_kernel_bitwise_and_float64(cuda, dtype, d_in, d_out):
    """The wgmma any-width kernel on a graph with hub rows (cut into
    segments, so the cut-row units run beside the tile pairs of both CTAs
    of each cluster): one launch of the layer and one of its W prologue a
    call on NaN-prefilled memory, two calls bit for bit, the prologue's
    layout of W equal to ``wt_layout_plain``; fp32 within 2× the plain fp32 layer's relative L2 error against a
    float64 layer, bf16 within PERF.md §2's bf16 limit of the plain
    version."""
    assert gcn_fused.kernel_plan(d_in, d_out, dtype).kernel == "gcn_fused_kernel_wgmma"
    rng = np.random.default_rng(d_in * 3 + d_out)
    op = _graph(rng).to(cuda)
    x = torch.from_numpy(rng.standard_normal((op.n_rows, d_in)).astype(np.float32))
    wm = torch.from_numpy((rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(d_out).astype(np.float32)).to(cuda)
    x, wm = x.to(cuda, dtype), wm.to(cuda, dtype)
    runs = []
    for _ in range(2):
        torch.full((op.n_rows, d_out), float("nan"), device=cuda, dtype=dtype)
        before = (gcn_fused.launches, gcn_fused.prologue_launches)
        runs.append(fused_gcn_layer(op.fwd, op.diag, x, wm, b))
        torch.cuda.synchronize()
        assert (gcn_fused.launches, gcn_fused.prologue_launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(runs[0], runs[1]) and not runs[0].isnan().any()
    stream = torch._C._cuda_getCurrentRawStream(cuda.index or 0)
    wt = gcn_fused.layer_plan(op.fwd).scratch[("wt", d_in, d_out, dtype, stream)]
    assert torch.equal(wt, gcn_fused.wt_layout_plain(wm).reshape(-1).view(torch.uint8))
    plain = reference_layer(op.fwd, op.diag, x, wm, b)
    if dtype == torch.float32:
        ref = _layer_float64(op, x, wm, b)
        assert _rel_l2(runs[0], ref) <= 2 * _rel_l2(plain, ref)
    torch.testing.assert_close(runs[0].float(), plain.float(), **TOL[dtype])


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    op = _graph(np.random.default_rng(0)).to(cuda)
    x = torch.randn(op.n_rows, 128, device=cuda)
    wm = torch.randn(128, 128, device=cuda)
    with pytest.raises(ValueError):
        fused_gcn_layer(op.fwd, op.diag, x, wm.to(torch.bfloat16))
    with pytest.raises(ValueError):
        fused_gcn_layer(op.fwd, op.diag, x.t().contiguous().t(), wm)
    # (64, 64) has no instance: the any-width kernel, not a refusal
    x64, w64 = x[:, :64].contiguous(), wm[:64, :64].contiguous()
    torch.testing.assert_close(fused_gcn_layer(op.fwd, op.diag, x64, w64),
                               reference_layer(op.fwd, op.diag, x64, w64), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        fused_gcn_layer(op.fwd, op.diag, x[1:], wm)
    with pytest.raises(ValueError):
        fused_gcn_layer(op.fwd, op.diag.cpu(), x, wm)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,d_in,d_out", [(4, 128, 128), (200, 64, 96), (8, 50, 300)])
def test_fused_bucket_apply_matches_plain(cuda, dtype, k, d_in, d_out):
    """One ELL bucket through the any-width kernel (K 200 cuts each row into
    segments): the JAX entry's padded shape, zero rows past R, one launch,
    the rest against the plain version; the bucket's matrix reused."""
    rng = np.random.default_rng(k + d_in)
    n, r = 2000, 300
    idx = torch.from_numpy(rng.integers(0, n, (r, k)).astype(np.int32)).to(cuda)
    w = torch.from_numpy(rng.standard_normal((r, k)).astype(np.float32)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((n, d_in)).astype(np.float32)).to(cuda, dtype)
    wm = torch.from_numpy((rng.standard_normal((d_in, d_out)) * 0.1).astype(np.float32))
    wm = wm.to(cuda, dtype)
    m = gcn_fused.bucket_matrix(idx, w, n)
    before = gcn_fused.launches
    got = gcn_fused.fused_bucket_apply(idx, w, x, wm, matrix=m)
    torch.cuda.synchronize()
    assert gcn_fused.launches == before + 1
    r_pad = -(-r // gcn_fused.bucket_tile_rows(k)) * gcn_fused.bucket_tile_rows(k)
    assert got.shape == (r_pad, d_out) and got.dtype == dtype and not got[r:].any()
    want = gcn_fused.fused_bucket_apply_plain(idx, w, x, wm)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.equal(got, gcn_fused.fused_bucket_apply(idx, w, x, wm, matrix=m))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [(torch.float32, 128), (torch.bfloat16, 128),
                                     (torch.bfloat16, 3)])
def test_row_copy_matches_plain(cuda, dtype, d):
    """The probe's stage 0: x[idx[0, 0]] copied bit for bit, one launch; a
    row of an odd number of bf16 values goes by bytes."""
    from tpugraph_torch.kernels import probe
    x = torch.randn(16, d, device=cuda).to(dtype)
    idx = torch.tensor([[3]], dtype=torch.int32, device=cuda)
    before = probe.launches
    got = probe.row_copy(x, idx)
    torch.cuda.synchronize()
    assert probe.launches == before + 1
    assert got.shape == (1, d) and torch.equal(got, probe.row_copy_plain(x, idx))


@pytest.mark.gpu
def test_encoder_on_card_matches_host(cuda):
    """Forward and gradients of the 2-layer encoder: kernels on the card
    (2 gcn_fused + 2 spmm_ell launches) against the plain path on the host."""
    rng = np.random.default_rng(1)
    n = 400
    tri = np.stack([rng.integers(0, n, 1600), rng.integers(0, 7, 1600),
                    rng.integers(0, n, 1600)], 1)
    op = build_adjacency(n, tri)
    params = init_params(n, 128, seed=3)
    host, card = AlignGCN(n_ent=n), AlignGCN(n_ent=n, device=cuda)
    host.load_state_dict(params)
    card.load_state_dict(params)
    cot = torch.from_numpy(rng.standard_normal((n, 128)).astype(np.float32))
    before = (gcn_fused.launches, spmm_ell.launches)
    got = card(op.to(cuda))
    (got * cot.to(cuda)).sum().backward()
    torch.cuda.synchronize()
    assert (gcn_fused.launches - before[0], spmm_ell.launches - before[1]) == (2, 2)
    want = host(op)
    (want * cot).sum().backward()
    torch.testing.assert_close(got.detach().cpu(), want.detach(), rtol=1e-4, atol=1e-4)
    for (name, p_card), p_host in zip(card.named_parameters(), host.parameters()):
        torch.testing.assert_close(p_card.grad.cpu(), p_host.grad, rtol=1e-4, atol=1e-4,
                                   msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("split_diag", [False, True])
def test_spmm_ell_kernel_matches_plain(cuda, d, split_diag):
    rng = np.random.default_rng(d + split_diag)
    op = _graph(rng, split_diag=split_diag).to(cuda)
    x = torch.from_numpy(rng.standard_normal((op.n_rows, d)).astype(np.float32)).to(cuda)
    for m in (op.fwd, op.bwd):
        before = spmm_ell.launches
        got = ell_spmm(m, op.diag, x)
        torch.cuda.synchronize()
        assert spmm_ell.launches == before + 1
        torch.testing.assert_close(got, apply_with_diag(m, op.diag, x), rtol=1e-4, atol=1e-4)
    with pytest.raises(TypeError):  # float32 and bfloat16 only
        ell_spmm(op.fwd, op.diag, x.to(torch.float16))
    # d = 32 has no instance: the panel path, against the plain version
    x32 = x[:, :32].contiguous()
    torch.testing.assert_close(ell_spmm(op.fwd, op.diag, x32),
                               apply_with_diag(op.fwd, op.diag, x32), rtol=1e-4, atol=1e-4)
    # above 512 the panels go on: 5 and 9 of them, the last masked
    for wide in (513, 1030):
        xw = torch.from_numpy(rng.standard_normal((op.n_rows, wide)).astype(np.float32))
        xw = xw.to(cuda)
        got = ell_spmm(op.fwd, op.diag, xw)
        assert torch.equal(got, ell_spmm(op.fwd, op.diag, xw))
        torch.testing.assert_close(got, apply_with_diag(op.fwd, op.diag, xw), rtol=1e-4,
                                   atol=1e-4)
    with pytest.raises(ValueError):  # misaligned rows
        ell_spmm(op.fwd, op.diag, torch.zeros(op.n_rows * d + 1, device=cuda)[1:].view(-1, d))


def _hub_graph(rng, degrees, n=8000, split_diag=True):
    """Random rows of low degree, plus rows 3, 11, ... of the exact ELL
    degree given (the random edges avoid them)."""
    src = rng.integers(0, n, 4 * n)
    dst = rng.integers(20, n, 4 * n)
    for row, deg in degrees.items():
        k = deg - (0 if split_diag else 1)  # the self-loop stays in the ELL without a split
        src = np.concatenate([src, rng.integers(20, n, k)])
        dst = np.concatenate([dst, np.full(k, row)])
    loops = np.arange(n)
    src, dst = np.concatenate([src, loops]), np.concatenate([dst, loops])
    w = rng.standard_normal(len(src)).astype(np.float32)
    return build_ell_operator(src, dst, w, n, split_diag=split_diag)


# bucket K of rows 3, 11, 17: a hub far above the segment cap with rows on
# its boundaries (K = 2·cap, K = cap), or a largest K of cap + 1
HUB_DEGREES = {"hub_5300": {3: 5300, 11: SEG_SLOTS + 100, 17: SEG_SLOTS - 20},
               "cap_plus_1": {3: SEG_SLOTS + 1, 17: SEG_SLOTS}}
HUB_KS = {"hub_5300": {5300, 2 * SEG_SLOTS, SEG_SLOTS},
          "cap_plus_1": {SEG_SLOTS + 1, SEG_SLOTS}}


@pytest.mark.gpu
@pytest.mark.parametrize("hub", list(HUB_DEGREES))
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("split_diag", [False, True])
def test_spmm_ell_hub_segments_match_plain(cuda, hub, d, split_diag):
    """Rows of K ≥ 5,000 and at the segment boundaries: the segments' fixed-
    order sum matches the plain version, and two launches agree bit for bit."""
    rng = np.random.default_rng(len(hub) + d + split_diag)
    op = _hub_graph(rng, HUB_DEGREES[hub], split_diag=split_diag).to(cuda)
    assert HUB_KS[hub] <= {b.k for b in op.fwd.buckets}
    x = torch.from_numpy(rng.standard_normal((op.n_rows, d)).astype(np.float32)).to(cuda)
    for m in (op.fwd, op.bwd):
        before = spmm_ell.launches
        got = ell_spmm(m, op.diag, x)
        again = ell_spmm(m, op.diag, x)
        torch.cuda.synchronize()
        assert spmm_ell.launches == before + 2
        torch.testing.assert_close(got, apply_with_diag(m, op.diag, x), rtol=1e-4, atol=1e-4)
        assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_in,d_out", [(128, 128), (128, 256), (256, 128), (256, 256)])
def test_gcn_fused_short_and_hub_rows(cuda, dtype, d_in, d_out):
    """Tiles of every K from 1 to 7 (packed virtual-slot walks, bucket tails
    of under 8 rows among them) and a hub row of K ≥ 5,000, against the
    plain version; two launches agree bit for bit, and the cached counters
    read 0 after each call."""
    rng = np.random.default_rng(d_in + d_out)
    op = _hub_graph(rng, {3: 5300, 11: 300}).to(cuda)
    ks = {b.k for b in op.fwd.buckets}
    assert set(range(1, 8)) <= ks and max(ks) >= 5000
    x = torch.from_numpy(rng.standard_normal((op.n_rows, d_in)).astype(np.float32))
    wm = torch.from_numpy((rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(d_out).astype(np.float32)).to(cuda)
    x, wm = x.to(cuda, dtype), wm.to(cuda, dtype)
    before = gcn_fused.launches
    got = fused_gcn_layer(op.fwd, op.diag, x, wm, b)
    again = fused_gcn_layer(op.fwd, op.diag, x, wm, b)
    torch.cuda.synchronize()
    assert gcn_fused.launches == before + 2
    assert torch.equal(got, again)
    plan = gcn_fused.layer_plan(op.fwd)
    counters = gcn_fused.counters(plan, d_in, d_out, torch.cuda.current_stream().cuda_stream)
    assert plan.segs.shape[0] > 0 and plan.hub.shape[0] > 0 and not counters.any()
    want = reference_layer(op.fwd, op.diag, x, wm, b)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("d,dtype", [(128, torch.float32), (256, torch.float32),
                                     (256, torch.bfloat16)])
def test_gcn_fused_call_is_one_kernel(cuda, d, dtype):
    """A warm call is one kernel on the device: no memset, no other work
    (at (256, 256) fp32 one cluster launch of CTA pairs)."""
    rng = np.random.default_rng(4)
    op = _graph(rng).to(cuda)
    x = torch.randn(op.n_rows, d, device=cuda, dtype=dtype)
    wm = torch.randn(d, d, device=cuda, dtype=dtype)
    fused_gcn_layer(op.fwd, op.diag, x, wm)  # builds the tile table and the counters
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fused_gcn_layer(op.fwd, op.diag, x, wm)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "gcn_fused_kernel" in names[0], names


# SHA-256 of each narrow instance's output on ``narrow_outputs``' inputs:
# what the kernel computed before (256, 256) had a kernel of its own (the
# parent commit's, which the redesign matches bit for bit on the H100:
# ``chip_smoke.py --parent-gcn``)
NARROW_SHA256 = {
    "(128, 128) float32": "d438e8fecaf97475eda75ccf08e17123f091e255ac596ab7bbce1e9e8afa9e21",
    "(128, 128) bfloat16": "4b5055e158ac0e2d1223b004eb33142a5f8e579ae983761563c1b952be4ee34a",
    "(128, 256) float32": "72b560baa66083af3ab0d7b77fdf2f491691b81faa5239125ca7d3e51ab80be5",
    "(128, 256) bfloat16": "f520e198800eda1e17fd564d56961beb0b5908a8b020a1c51ed4c280c24a680b",
    "(256, 128) float32": "fae238e009feefcef727acda9850c499bab48a95e37c365fc8b4df04daad2041",
    "(256, 128) bfloat16": "3bed24893fd463ad2c7619b13e9cfa9d2736e87a762c695c834ac64398a78781",
}


def narrow_outputs(cuda, layer=fused_gcn_layer) -> dict:
    """``layer`` at (128, 128), (128, 256) and (256, 128) in fp32 and bf16
    on a graph with a hub row of K = 5,300, seeded."""
    rng = np.random.default_rng(21)
    op = _hub_graph(rng, {3: 5300, 11: 300}).to(cuda)
    out = {}
    for (d_in, d_out), dtype in itertools.product(((128, 128), (128, 256), (256, 128)),
                                                  (torch.float32, torch.bfloat16)):
        x = torch.from_numpy(rng.standard_normal((op.n_rows, d_in)).astype(np.float32))
        wm = torch.from_numpy((rng.standard_normal((d_in, d_out)) / np.sqrt(d_in))
                              .astype(np.float32))
        b = torch.from_numpy(rng.standard_normal(d_out).astype(np.float32)).to(cuda)
        out[f"({d_in}, {d_out}) {str(dtype).split('.')[1]}"] = layer(
            op.fwd, op.diag, x.to(cuda, dtype), wm.to(cuda, dtype), b)
    return out


def sha256_of(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()).hexdigest()


@pytest.mark.gpu
def test_gcn_fused_narrow_widths_bits_unchanged(cuda):
    """The instances the (256, 256) redesign left alone give the bits they
    gave before it."""
    got = {name: sha256_of(y) for name, y in narrow_outputs(cuda).items()}
    assert got == NARROW_SHA256


@pytest.mark.gpu
@pytest.mark.parametrize("q,c,d", [(70, 4001, 4), (1000, 777, 20), (4500, 4500, 128),
                                   (130, 2050, 256), (9000, 4500, 192), (333, 2049, 64),
                                   (1000, 777, 300), (4500, 4500, 384), (333, 2049, 512),
                                   (1000, 777, 768), (333, 2049, 1028)])
def test_sinkhorn_splits_match_plain(cuda, q, c, d):
    """Ragged Q and C (no multiple of the 64 × 128 tile or of a block's
    share, odd Q too), d from 4 to 1,028 (above 256 the strip streams
    beside the candidates), τ = 0.05 and 0.3, and strips cut into one to 33
    candidate splits; widths that are no multiple of 4 are taken with zero
    columns, and widths above 512 too (514 and 1,030)."""
    rng = np.random.default_rng(q + c + d)

    def unit(n, dd=d):
        x = rng.standard_normal((n, dd)).astype(np.float32)
        return torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True)).to(cuda)

    l, r = unit(q), unit(c)
    g = torch.from_numpy((0.2 * rng.standard_normal(c)).astype(np.float32)).to(cuda)
    log_mu = torch.full((q,), -float(np.log(q)), device=cuda)
    for tau in (0.05, 0.3):
        got = sinkhorn_potential_update(l, r, g, log_mu, tau)
        torch.testing.assert_close(got, sinkhorn_update_plain(l, r, g, log_mu, tau),
                                   rtol=1e-4, atol=1e-4)
    # d + 2 (no multiple of 4: zero columns appended), 260 (the strip
    # streamed beside the candidates) and above 512 are taken too
    for other in (d + 2, 260, 514 if d <= 512 else 1030):
        lo, ro = unit(q, other), unit(c, other)
        torch.testing.assert_close(sinkhorn_potential_update(lo, ro, g, log_mu, 0.3),
                                   sinkhorn_update_plain(lo, ro, g, log_mu, 0.3),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_sinkhorn_masked_columns_and_rows(cuda):
    """Splits whose every column has g = -inf add nothing; with every column
    -inf each row ends at lse = log(1e-38), the TPU kernel's guard.  5 strips
    × 24 tiles on 120 blocks: one tile per split."""
    rng = np.random.default_rng(9)
    q, c, d = 300, 3000, 128
    l = torch.nn.functional.normalize(torch.from_numpy(rng.standard_normal((q, d))).float(), dim=1)
    r = torch.nn.functional.normalize(torch.from_numpy(rng.standard_normal((c, d))).float(), dim=1)
    l, r = l.to(cuda), r.to(cuda)
    g = torch.from_numpy((0.2 * rng.standard_normal(c)).astype(np.float32)).to(cuda)
    g[:1000] = -float("inf")
    log_mu = torch.full((q,), -float(np.log(q)), device=cuda)
    got = sinkhorn_potential_update(l, r, g, log_mu, 0.3)
    torch.testing.assert_close(got, sinkhorn_update_plain(l, r, g, log_mu, 0.3),
                               rtol=1e-4, atol=1e-4)
    g[:] = -float("inf")
    got = sinkhorn_potential_update(l, r, g, log_mu, 0.3)
    torch.testing.assert_close(got, 0.3 * (log_mu - float(np.log(1e-38))), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("q,c,d", [(70, 90, 16), (257, 300, 128), (33, 1000, 256),
                                   (4500, 130, 128), (70, 90, 52), (257, 300, 384),
                                   (33, 1000, 512)])
def test_sinkhorn_kernel_matches_plain(cuda, q, c, d):
    """Query and candidate counts that are not multiples of the 32 × 128
    tile; potentials of both signs.  fp32 dot products in another order:
    rtol/atol 1e-4."""
    rng = np.random.default_rng(q + c + d)

    def unit(n):
        x = rng.standard_normal((n, d)).astype(np.float32)
        return torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True)).to(cuda)

    l, r = unit(q), unit(c)
    g = torch.from_numpy((0.2 * rng.standard_normal(c)).astype(np.float32)).to(cuda)
    log_mu = torch.full((q,), -float(np.log(q)), device=cuda)
    for tau in (0.05, 0.3):
        before = sinkhorn_fused.launches
        got = sinkhorn_potential_update(l, r, g, log_mu, tau)
        torch.cuda.synchronize()
        assert sinkhorn_fused.launches == before + 1
        torch.testing.assert_close(got, sinkhorn_update_plain(l, r, g, log_mu, tau),
                                   rtol=1e-4, atol=1e-4)
    # d − 2 (no multiple of 4) is taken with zero columns appended
    lo, ro = l[:, :d - 2].contiguous(), r[:, :d - 2].contiguous()
    torch.testing.assert_close(sinkhorn_potential_update(lo, ro, g, log_mu, 0.3),
                               sinkhorn_update_plain(lo, ro, g, log_mu, 0.3), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):  # float64
        sinkhorn_potential_update(l.double(), r.double(), g, log_mu, 0.3)


@pytest.mark.gpu
def test_sinkhorn_loss_on_card_matches_plain(cuda):
    """2·n_iters + 1 kernel launches; value rel 1e-4 and gradient relative
    L2 1e-3 against autograd of the plain unrolled solver on the card."""
    rng = np.random.default_rng(7)
    emb = torch.from_numpy(rng.standard_normal((900, 128)).astype(np.float32)).to(cuda)
    pairs = torch.stack([torch.arange(0, 300), torch.arange(450, 750)], 1).to(cuda)
    e1, e2 = emb.clone().requires_grad_(True), emb.clone().requires_grad_(True)
    before = sinkhorn_fused.launches
    a = sinkhorn_align_loss(e1, pairs, tau=0.3, n_iters=20)
    a.backward()
    torch.cuda.synchronize()
    assert sinkhorn_fused.launches == before + 41
    b = sinkhorn_align_loss_plain(e2, pairs, tau=0.3, n_iters=20)
    b.backward()
    assert a.item() == pytest.approx(b.item(), rel=1e-4)
    assert float((e1.grad - e2.grad).norm() / e2.grad.norm()) < 1e-3


@pytest.mark.gpu
def test_training_on_card(cuda):
    cfg = get_config("sinkhorn", syn_n_ent=600, syn_n_triples=2400, epochs=4, neg_every=2,
                     eval_every=0, k_neg=10)
    before = (gcn_fused.launches, spmm_ell.launches, sinkhorn_fused.launches)
    res = run(cfg, device=cuda)
    after = (gcn_fused.launches, spmm_ell.launches, sinkhorn_fused.launches)
    # 4 steps × 2 layers, one mining forward, one final eval forward
    assert after[0] - before[0] == 4 * 2 + 2 + 2
    assert after[1] - before[1] == 4 * 2
    assert after[2] - before[2] == 4 * 41
    assert np.isfinite(res.metrics["final_loss"]) and res.losses[-1] < res.losses[0]


@pytest.mark.gpu
def test_v6_step_at_dim_256_matches_plain(cuda):
    """One step of recipe v6 (dim 256; seed pairs plus weighted proposals in
    the margin loss, the Sinkhorn head on the seed pairs) through the
    kernels (2 gcn_fused at (256, 256), 2 spmm_ell, 41 sinkhorn_fused)
    against the plain path on the card: loss rel 1e-4, each gradient
    relative L2 1e-3."""
    cfg = get_config("base", **RECIPES["v6"])
    rng = np.random.default_rng(11)
    n, n1, s, cap = 1200, 600, 200, 100
    tri = np.stack([rng.integers(0, n, 5000), rng.integers(0, 9, 5000),
                    rng.integers(0, n, 5000)], 1)
    op = build_adjacency(n, tri).to(cuda)
    model = AlignMTL(n, cfg, device=cuda)
    model.encoder.load_state_dict(init_params(n, cfg.dim, seed=4))
    pairs = np.stack([rng.permutation(n1)[:s], n1 + rng.permutation(n1)[:s]], 1)
    boot = np.stack([rng.integers(0, n1, cap), rng.integers(n1, n, cap)], 1)
    w = np.concatenate([np.ones(s), np.where(np.arange(cap) < 60, cfg.boot_weight, 0.0)])
    batch = {"pairs": torch.from_numpy(pairs).to(cuda),
             "pairs_aug": torch.from_numpy(np.concatenate([pairs, boot])).to(cuda),
             "w": torch.from_numpy(w.astype(np.float32)).to(cuda),
             "neg_l": torch.from_numpy(rng.integers(0, n1, (s + cap, cfg.k_neg))).to(cuda),
             "neg_r": torch.from_numpy(rng.integers(n1, n, (s + cap, cfg.k_neg))).to(cuda)}
    before = (gcn_fused.launches, spmm_ell.launches, sinkhorn_fused.launches)
    loss, _ = model(op, batch)
    loss.backward()
    torch.cuda.synchronize()
    after = (gcn_fused.launches, spmm_ell.launches, sinkhorn_fused.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (2, 2, 2 * cfg.sinkhorn_iters + 1)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in model.named_parameters()}
    h = torch.relu(reference_layer(op.fwd, op.diag, p["encoder.emb"], p["encoder.gc1.w"],
                                   p["encoder.gc1.b"]))
    emb = reference_layer(op.fwd, op.diag, h, p["encoder.gc2.w"], p["encoder.gc2.b"])
    plain = (margin_align_loss(emb, batch["pairs_aug"], batch["neg_l"], batch["neg_r"],
                               cfg.gamma, batch["w"])
             + cfg.sinkhorn_weight * sinkhorn_align_loss_plain(
                 emb, batch["pairs"], tau=cfg.sinkhorn_tau, n_iters=cfg.sinkhorn_iters))
    plain.backward()
    assert loss.item() == pytest.approx(plain.item(), rel=1e-4)
    for k, v in model.named_parameters():
        assert float((v.grad - p[k].grad).norm() / p[k].grad.norm()) < 1e-3, k


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 256])
def test_incidence_spmm_matches_plain(cuda, d):
    """The attribute channel's rectangular incidence (no diagonal): the
    forward over entities × attributes (K ≤ 4) and the transpose, whose
    rows (K ≈ 240) are all cut into segments, against the plain version;
    two launches agree bit for bit; the trainable form's gradient is the
    transpose's launch."""
    rng = np.random.default_rng(d)
    n_ent, n_attr = 6000, 100
    attr = np.stack([np.repeat(np.arange(n_ent), 4), rng.integers(0, n_attr, 4 * n_ent)], 1)
    op = build_attr_operator(attr, n_ent, n_attr).to(cuda)
    assert op.diag is None and min(b.k for b in op.bwd.buckets) > SEG_SLOTS
    for m in (op.fwd, op.bwd):
        x = torch.from_numpy(rng.standard_normal((m.n_cols, d)).astype(np.float32)).to(cuda)
        got, again = ell_spmm(m, None, x), ell_spmm(m, None, x)
        torch.testing.assert_close(got, apply_with_diag(m, None, x), rtol=1e-4, atol=1e-4)
        assert torch.equal(got, again)
    table = torch.from_numpy(rng.standard_normal((n_attr, d)).astype(np.float32)).to(cuda)
    cot = torch.from_numpy(rng.standard_normal((n_ent, d)).astype(np.float32)).to(cuda)
    t1, t2 = table.clone().requires_grad_(True), table.clone().requires_grad_(True)
    before = spmm_ell.launches
    (spmm_ell.spmm_ell(op, t1) * cot).sum().backward()
    torch.cuda.synchronize()
    assert spmm_ell.launches == before + 2
    (apply_with_diag(op.fwd, None, t2) * cot).sum().backward()
    torch.testing.assert_close(t1.grad, t2.grad, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_gcn_layer_on_the_highway_operator_matches_plain(cuda):
    """Config highway's funifun-weighted, rw-normalised operator is not
    symmetric, so the backward's op.bwd is another matrix than op.fwd: the
    layer's forward and its gradients against autograd of the plain layer."""
    rng = np.random.default_rng(3)
    n = 3000
    tri = np.stack([rng.integers(0, n, 12000), rng.integers(0, 30, 12000),
                    rng.integers(0, n, 12000)], 1)
    op = build_adjacency(n, tri, n_rel=30, weighting="funifun", norm="rw").to(cuda)
    x = torch.from_numpy(rng.standard_normal((n, 128)).astype(np.float32)).to(cuda)
    wm = torch.from_numpy((rng.standard_normal((128, 128)) / 11.3).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.standard_normal(128).astype(np.float32)).to(cuda)
    cot = torch.from_numpy(rng.standard_normal((n, 128)).astype(np.float32)).to(cuda)
    args = [t.clone().requires_grad_(True) for t in (x, wm, b)]
    plain = [t.clone().requires_grad_(True) for t in (x, wm, b)]
    before = (gcn_fused.launches, spmm_ell.launches)
    got = gcn_layer(op, *args)
    (got * cot).sum().backward()
    torch.cuda.synchronize()
    assert (gcn_fused.launches - before[0], spmm_ell.launches - before[1]) == (1, 1)
    want = reference_layer(op.fwd, op.diag, *plain)
    (want * cot).sum().backward()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    for a, p in zip(args, plain):
        assert float((a.grad - p.grad).norm() / p.grad.norm()) < 1e-4


@pytest.mark.gpu
def test_v7r_step_at_dim_256_matches_plain(cuda, monkeypatch):
    """One step of recipe v7r (v6 + the attribute head) at dim 256 through
    the kernels (2 gcn_fused, 2 spmm_ell, 41 sinkhorn_fused) against the
    same model with every kernel swapped for its plain version: loss rel
    1e-4, each gradient (the attribute head's too) relative L2 1e-3."""
    cfg = get_config("base", **RECIPES["v7r"])
    rng = np.random.default_rng(12)
    n, n1, s, n_attr = 1200, 600, 200, 40
    tri = np.stack([rng.integers(0, n, 5000), rng.integers(0, 9, 5000),
                    rng.integers(0, n, 5000)], 1)
    op = build_adjacency(n, tri).to(cuda)
    model = AlignMTL(n, cfg, device=cuda, n_attr=n_attr)
    model.load_state_dict(init_mtl_params(cfg, n, n_attr=n_attr, seed=4))
    pairs = np.stack([rng.permutation(n1)[:s], n1 + rng.permutation(n1)[:s]], 1)
    batch = {"pairs": torch.from_numpy(pairs).to(cuda),
             "neg_l": torch.from_numpy(rng.integers(0, n1, (s, cfg.k_neg))).to(cuda),
             "neg_r": torch.from_numpy(rng.integers(n1, n, (s, cfg.k_neg))).to(cuda),
             "attr_triples": torch.from_numpy(np.stack([rng.integers(0, n, 3000),
                                                        rng.integers(0, n_attr, 3000)], 1)
                                              ).to(cuda)}
    before = (gcn_fused.launches, spmm_ell.launches, sinkhorn_fused.launches)
    loss, aux = model(op, batch, train=True)
    loss.backward()
    torch.cuda.synchronize()
    after = (gcn_fused.launches, spmm_ell.launches, sinkhorn_fused.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (2, 2, 2 * cfg.sinkhorn_iters + 1)
    assert "attr" in aux
    grads = {k: v.grad for k, v in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    monkeypatch.setattr(graphconv_mod, "gcn_layer",
                        lambda op_, x, w, b=None: reference_layer(op_.fwd, op_.diag, x, w, b))
    monkeypatch.setattr(attr_channel_mod, "spmm_ell",
                        lambda op_, x: apply_with_diag(op_.fwd, op_.diag, x))
    monkeypatch.setattr(align_mod, "sinkhorn_align_loss", sinkhorn_align_loss_plain)
    plain, _ = model(op, batch, train=True)
    plain.backward()
    assert (gcn_fused.launches, spmm_ell.launches, sinkhorn_fused.launches) == after
    assert loss.item() == pytest.approx(plain.item(), rel=1e-4)
    for k, v in model.named_parameters():
        assert float((grads[k] - v.grad).norm() / v.grad.norm()) < 1e-3, k


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["cityblock", "sqeuclidean"])
@pytest.mark.parametrize("d,k", [(d, k) for d in (32, 128, 256, 512) for k in (10, 16, 128, 200)]
                         + [(37, 10), (6, 33)])
def test_shortlist_dist_matches_plain(cuda, metric, d, k):
    """The kernel against its plain version within 1e-5 + 1e-5·|x| (the d
    terms summed in another order), one launch a call, and two launches
    bit-identical; d = 37 and 6 take the kernel's scalar loads, K = 10, 33
    and 200 leave a partial chunk of 32 entries."""
    rng = np.random.default_rng(d * 1000 + k)
    s, c = 1500, 2500
    q = torch.from_numpy(rng.standard_normal((s, d)).astype(np.float32)).to(cuda)
    table = torch.from_numpy(rng.standard_normal((c, d)).astype(np.float32)).to(cuda)
    idx = torch.from_numpy(rng.integers(0, c, (s, k))).to(cuda)
    before = shortlist_dist.launches
    got = shortlist_dist.shortlist_dist(q, table, idx, metric)
    torch.cuda.synchronize()
    assert shortlist_dist.launches == before + 1 and got.shape == (s, k)
    want = shortlist_dist.shortlist_dist_plain(q, table, idx, metric)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, shortlist_dist.shortlist_dist(q, table, idx, metric))


@pytest.mark.gpu
def test_shortlist_dist_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(8, 16, device=cuda)
    idx = torch.zeros(8, 4, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        shortlist_dist.shortlist_dist(q, q, idx.int())
    with pytest.raises(ValueError):
        shortlist_dist.shortlist_dist(q, q[:, :8].contiguous(), idx)
    with pytest.raises(ValueError):
        shortlist_dist.shortlist_dist(q.t(), q, idx)
    assert shortlist_dist.shortlist_dist(q, q, idx[:, :0]).shape == (8, 0)


def _select_case(rng, s, c, d, masked, csls):
    q = torch.from_numpy(rng.standard_normal((s, d)).astype(np.float32))
    cands = torch.from_numpy(rng.standard_normal((c, d)).astype(np.float32))
    kw = {}
    if masked:
        kw["exclude"] = torch.from_numpy(rng.integers(-1, c, s))
        kw["col_mask"] = torch.from_numpy(rng.random(c) >= 0.25)
    if csls:
        kw["a"] = 2.0
        kw["bias"] = torch.from_numpy((1.6 * d + 0.1 * d * rng.standard_normal(c))
                                      .astype(np.float32))
    return q, cands, kw


def _by_id(idx, *vals):
    order = idx.argsort(dim=1)
    return [v.gather(1, order) for v in vals]


@pytest.mark.gpu
@pytest.mark.parametrize("k", [10, 16, 128, 200, 256])
@pytest.mark.parametrize("d", [128, 256, 512, 768, 1030])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_shortlist_select_matches_plain(cuda, k, d, bf16, masked):
    """The select-and-rerank kernel against its plain version at every
    shortlist length the callers use (10, 16, 128, 200; 256 the queue's
    largest) and every width the configs use, fp32 (3× TF32) and bf16
    operands, with and without the mask, the exclusions and the CSLS bias:
    the same index sets on ≥ 99 % of rows; where they agree the rerank
    within 1e-5 + 1e-5·|x| and the score within 1e-5 of the expanded form's
    scale a·(max ‖q‖² + max ‖c‖²); ascending by (score, column); one launch
    a call, and two launches bit-identical."""
    rng = np.random.default_rng(k * 7 + d + 2 * bf16 + masked)
    q, cands, kw = _select_case(rng, 1500, 2500, d, masked, csls=masked)
    rerank = ("cityblock", "sqeuclidean", None)[(k + d // 128 + bf16) % 3]
    want = shortlist_dist.shortlist_select_plain(q, cands, k, bf16=bf16, rerank=rerank, **kw)
    q, cands = q.to(cuda), cands.to(cuda)
    kw = {key: v.to(cuda) if torch.is_tensor(v) else v for key, v in kw.items()}
    before = shortlist_dist.select_launches
    got = shortlist_dist.shortlist_select(q, cands, k, bf16=bf16, rerank=rerank, **kw)
    torch.cuda.synchronize()
    assert shortlist_dist.select_launches == before + 1
    again = shortlist_dist.shortlist_select(q, cands, k, bf16=bf16, rerank=rerank, **kw)
    for g, a in zip(got, again):
        assert (g is None and a is None) or torch.equal(g, a)
    sidx, sval = got[0].cpu(), got[1].cpu()
    assert sidx.shape == (1500, k) and (got[2] is None) == (rerank is None)
    later = (sval[:, 1:] > sval[:, :-1]) | ((sval[:, 1:] == sval[:, :-1])
                                           & (sidx[:, 1:] > sidx[:, :-1]))
    assert later.all()
    rows = (sidx.sort(dim=1).values == want[0].sort(dim=1).values).all(dim=1)
    assert float(rows.double().mean()) >= 0.99
    scale = kw.get("a", 1.0) * float(shortlist_dist.sq_norms(cands).max()
                                     + shortlist_dist.sq_norms(q).max())
    torch.testing.assert_close(_by_id(sidx[rows], sval[rows])[0],
                               _by_id(want[0][rows], want[1][rows])[0], rtol=1e-5,
                               atol=1e-5 * scale)
    if rerank is not None:
        torch.testing.assert_close(_by_id(sidx[rows], got[2].cpu()[rows])[0],
                                   _by_id(want[0][rows], want[2][rows])[0], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.gpu
def test_select_rerank_is_unfused_above_the_queue(cuda):
    """A shortlist above the kernel's queue takes the selection tile,
    ``torch.topk`` and the gather kernel: no select launch, one gather
    launch, and the plain version's sets and distances."""
    rng = np.random.default_rng(31)
    q, cands, kw = _select_case(rng, 700, 1800, 256, masked=True, csls=True)
    k = shortlist_dist.QUEUE_MAX + 44
    want = shortlist_dist.shortlist_select_plain(q, cands, k, rerank="cityblock", **kw)
    kw = {key: v.to(cuda) if torch.is_tensor(v) else v for key, v in kw.items()}
    before = (shortlist_dist.select_launches, shortlist_dist.launches)
    got = shortlist_dist.select_rerank(q.to(cuda), cands.to(cuda), k, rerank="cityblock", **kw)
    torch.cuda.synchronize()
    assert (shortlist_dist.select_launches, shortlist_dist.launches) == (before[0],
                                                                        before[1] + 1)
    rows = (got[0].cpu().sort(dim=1).values == want[0].sort(dim=1).values).all(dim=1)
    assert float(rows.double().mean()) >= 0.99
    torch.testing.assert_close(_by_id(got[0].cpu()[rows], got[2].cpu()[rows])[0],
                               _by_id(want[0][rows], want[2][rows])[0], rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_shortlist_select_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(8, 16, device=cuda)
    # width 6 is taken with zero columns up to 8: the plain version's answer
    q6, c6 = torch.randn(8, 6, device=cuda), torch.randn(40, 6, device=cuda)
    for bf16 in (False, True):  # zero columns up to 8 and to 8
        got = shortlist_dist.shortlist_select(q6, c6, 4, bf16=bf16, rerank="cityblock")
        want = shortlist_dist.shortlist_select_plain(q6, c6, 4, bf16=bf16, rerank="cityblock")
        assert torch.equal(got[0], want[0])
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-5)
    # above 512 too (the strip streamed): 516, and 1,030 with zero columns up to 1,032
    for wide in (516, 1030):
        qw, cw = torch.randn(8, wide, device=cuda), torch.randn(40, wide, device=cuda)
        got = shortlist_dist.shortlist_select(qw, cw, 4, rerank="cityblock")
        want = shortlist_dist.shortlist_select_plain(qw, cw, 4, rerank="cityblock")
        assert torch.equal(got[0], want[0])
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-5)
    with pytest.raises(TypeError):
        shortlist_dist.shortlist_select(q.half(), q.half(), 4)
    with pytest.raises(ValueError):
        shortlist_dist.shortlist_select(q, torch.zeros(400, 16, device=cuda),
                                        shortlist_dist.QUEUE_MAX + 1)
    with pytest.raises(ValueError):
        shortlist_dist.shortlist_select(q.t(), q, 4)
    with pytest.raises(TypeError):
        shortlist_dist.shortlist_select(q, q, 4, exclude=torch.zeros(8, device=cuda))


def _l1_case(rng, s, c, d, masked, csls):
    """Queries and candidates on the host, and the search's options: with
    ``masked`` a quarter of the columns masked and an exclusion per row
    (some -1); with ``csls`` a = 2 and a bias near the rows' hubness."""
    q = torch.from_numpy(rng.standard_normal((s, d)).astype(np.float32))
    cands = torch.from_numpy(rng.standard_normal((c, d)).astype(np.float32))
    kw = {}
    if masked:
        kw["exclude"] = torch.from_numpy(rng.integers(-1, c, s))
        kw["col_mask"] = torch.from_numpy(rng.random(c) >= 0.25)
    if csls:
        kw["a"] = 2.0
        kw["bias"] = torch.from_numpy((1.6 * d + 0.1 * d * rng.standard_normal(c))
                                      .astype(np.float32))
    return q, cands, kw


def _on(dev, kw):
    return {key: v.to(dev) if torch.is_tensor(v) else v for key, v in kw.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 10, 25, 100, 256, 300])
@pytest.mark.parametrize("d", [128, 256, 512, 768, 1028])
def test_l1_topk_matches_plain(cuda, k, d):
    """``l1_topk`` on ragged Q and C (1,003 × 2,503) against its plain version
    at every table width and at k from 1 to the queue's 256 and above it
    (300: the tile entry and ``torch.topk``), raw or CSLS, with or without
    the mask and exclusions: ascending by (score, column); the same index
    sets on ≥ 99 % of rows and, where they agree, the values within rtol
    1e-5 (atol 1e-5, with CSLS 1e-5 of the distance scale a·max d); one
    launch a call; two calls bit for bit."""
    rng = np.random.default_rng(k * 11 + d)
    masked, csls = (k + d // 128) % 2 == 0, (k // 10 + d // 128) % 2 == 1
    q, cands, kw = _l1_case(rng, 1003, 2503, d, masked, csls)
    want = l1_search.l1_topk_plain(q, cands, k, **kw)
    q, cands, kw = q.to(cuda), cands.to(cuda), _on(cuda, kw)
    before = (l1_search.topk_launches, l1_search.tile_launches)
    got = l1_search.l1_topk(q, cands, k, **kw)
    torch.cuda.synchronize()
    assert (l1_search.topk_launches, l1_search.tile_launches) == (
        (before[0] + 1, before[1]) if k <= l1_search.QUEUE_MAX else (before[0], before[1] + 1))
    again = l1_search.l1_topk(q, cands, k, **kw)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    vals, idx = got[0].cpu(), got[1].cpu()
    later = (vals[:, 1:] > vals[:, :-1]) | ((vals[:, 1:] == vals[:, :-1])
                                           & (idx[:, 1:] > idx[:, :-1]))
    assert later.all() and idx.shape == (1003, k)
    rows = (idx.sort(dim=1).values == want[1].sort(dim=1).values).all(dim=1)
    assert float(rows.double().mean()) >= 0.99
    finite = torch.isfinite(want[0])
    scale = 1.0
    if csls:
        scale = float((want[0] + kw["bias"].cpu()[want[1]])[finite].max())
    torch.testing.assert_close(_by_id(idx[rows], vals[rows])[0],
                               _by_id(want[1][rows], want[0][rows])[0], rtol=1e-5,
                               atol=1e-5 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 256, 512, 1028])
@pytest.mark.parametrize("csls", [False, True])
def test_l1_count_matches_plain(cuda, d, csls):
    """``l1_count`` against its plain version: position-aligned pools (the
    true match, column i of row i, excluded by index) and ragged ones with
    random self columns (some -1), each row's threshold another
    candidate's score, so the counts spread over the pool; each count equal
    but for candidates whose score lies within 1e-5 of the threshold's
    scale; one launch a call; two calls bit for bit."""
    rng = np.random.default_rng(d + csls)
    for s, c, aligned in ((1500, 1500, True), (1003, 2503, False)):
        q, cands, kw = _l1_case(rng, s, c, d, False, csls)
        self_col = torch.arange(s) if aligned else torch.from_numpy(rng.integers(-1, c, s))
        other = torch.from_numpy(rng.integers(0, c, s))
        d_true = (q - cands[other]).abs().sum(1)
        thresh = d_true if not csls else 2.0 * d_true - kw["bias"][other]
        want = l1_search.l1_count_plain(q, cands, thresh, self_col=self_col, **kw)
        scores = l1_search.l1_tile_plain(q, cands, **kw)
        near = ((scores - thresh[:, None]).abs() <= 1e-5 * thresh.abs()[:, None]).sum(1)
        before = l1_search.count_launches
        got = l1_search.l1_count(q.to(cuda), cands.to(cuda), thresh.to(cuda),
                                 self_col=self_col.to(cuda), **_on(cuda, kw))
        torch.cuda.synchronize()
        assert l1_search.count_launches == before + 1
        again = l1_search.l1_count(q.to(cuda), cands.to(cuda), thresh.to(cuda),
                                   self_col=self_col.to(cuda), **_on(cuda, kw))
        assert torch.equal(got, again) and got.dtype == torch.int64
        assert ((got.cpu() - want).abs() <= near).all() and int(want.sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 512])
def test_l1_tile_matches_plain(cuda, d):
    """The tile entry (the route above the queue, ``dist_tile``'s cityblock
    branch) against its plain version within rtol 1e-5 of each score's
    distance scale, +inf where masked, and two launches bit for bit."""
    rng = np.random.default_rng(d + 5)
    q, cands, kw = _l1_case(rng, 333, 1031, d, True, True)
    want = l1_search.l1_tile_plain(q, cands, **kw)
    got = l1_search.l1_tile(q.to(cuda), cands.to(cuda), **_on(cuda, kw))
    assert torch.equal(got, l1_search.l1_tile(q.to(cuda), cands.to(cuda), **_on(cuda, kw)))
    got = got.cpu()
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    scale = float((want + kw["bias"][None, :])[fin].max())
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.gpu
def test_l1_topk_all_masked_rows_and_exhausted_pools(cuda):
    """A row with no eligible column returns the k lowest columns at +inf
    (``_nn1``'s (inf, 0) at k = 1), and so does a row of NaN scores; k = C
    returns every column."""
    rng = np.random.default_rng(41)
    q, cands, _ = _l1_case(rng, 70, 300, 128, False, False)
    none = torch.zeros(300, dtype=torch.bool)
    for k in (1, 17, 256):
        vals, idx = l1_search.l1_topk(q.to(cuda), cands.to(cuda), k, col_mask=none.to(cuda))
        assert torch.isinf(vals).all()
        assert torch.equal(idx.cpu(), torch.arange(k).expand(70, k))
    few = torch.zeros(300, dtype=torch.bool)
    few[[5, 250]] = True
    vals, idx = l1_search.l1_topk(q.to(cuda), cands.to(cuda), 4, col_mask=few.to(cuda))
    want = l1_search.l1_topk_plain(q, cands, 4, col_mask=few)
    assert torch.equal(idx.cpu(), want[1]) and torch.isinf(vals[:, 2:]).all()
    vals, idx = l1_search.l1_topk(q.to(cuda), cands[:200].to(cuda), 200)
    assert torch.equal(idx.cpu().sort(dim=1).values, torch.arange(200).expand(70, 200))
    q[3, 7] = float("nan")  # a diverged row scores +inf everywhere, as masked
    vals, idx = l1_search.l1_topk(q.to(cuda), cands.to(cuda), 5)
    assert torch.isinf(vals[3]).all() and torch.equal(idx[3].cpu(), torch.arange(5))


@pytest.mark.gpu
def test_l1_search_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(8, 16, device=cuda)
    c = torch.zeros(40, 16, device=cuda)
    th = torch.zeros(8, device=cuda)
    with pytest.raises(TypeError):
        l1_search.l1_topk(q.double(), c.double(), 4)
    with pytest.raises(TypeError):
        l1_search.l1_count(q, c, th.double())
    # width 6 is taken with zero columns up to 8: the plain version's answer
    q6 = torch.randn(8, 6, device=cuda)
    c6 = torch.randn(40, 6, device=cuda)
    vals, idx = l1_search.l1_topk(q6, c6, 4)
    want = l1_search.l1_topk_plain(q6.cpu(), c6.cpu(), 4)
    assert torch.equal(idx.cpu(), want[1])
    torch.testing.assert_close(vals.cpu(), want[0], rtol=1e-5, atol=1e-5)
    # above 512 too: 1,030 taken with zero columns up to 1,032
    q_w = torch.randn(8, 1030, device=cuda)
    c_w = torch.randn(40, 1030, device=cuda)
    vals, idx = l1_search.l1_topk(q_w, c_w, 4)
    want = l1_search.l1_topk_plain(q_w.cpu(), c_w.cpu(), 4)
    assert torch.equal(idx.cpu(), want[1])
    torch.testing.assert_close(vals.cpu(), want[0], rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        l1_search.l1_topk(q, c.cpu(), 4)
    with pytest.raises(ValueError):
        l1_search.l1_count(q, c, th.cpu())
    with pytest.raises(ValueError):
        l1_search.l1_topk(q.cpu(), c, 4)
    with pytest.raises(ValueError):
        l1_search.l1_topk(q, c, 41)
    with pytest.raises(ValueError):
        l1_search.l1_topk(q, c, 0)
    with pytest.raises(ValueError):
        l1_search.l1_topk(q, torch.zeros(16, 40, device=cuda).t(), 4)
    with pytest.raises(TypeError):
        l1_search.l1_topk(q, c, 4, col_mask=torch.ones(40, dtype=torch.uint8, device=cuda))
    with pytest.raises(TypeError):
        l1_search.l1_count(q, c, th, self_col=torch.zeros(8, dtype=torch.int32, device=cuda))


def _l1_agrees(got, want, kw, csls):
    """The top-k check of ``test_l1_topk_matches_plain``: ascending by
    (score, column); the same index sets on ≥ 99 % of rows and there the
    values within rtol 1e-5 (atol 1e-5 of the distance scale)."""
    vals, idx = got[0].cpu(), got[1].cpu()
    later = (vals[:, 1:] > vals[:, :-1]) | ((vals[:, 1:] == vals[:, :-1])
                                           & (idx[:, 1:] > idx[:, :-1]))
    assert later.all()
    rows = (idx.sort(dim=1).values == want[1].sort(dim=1).values).all(dim=1)
    assert float(rows.double().mean()) >= 0.99
    finite = torch.isfinite(want[0])
    scale = 1.0
    if csls and bool(finite.any()):
        scale = float((want[0] + kw["bias"].cpu()[want[1]])[finite].max())
    torch.testing.assert_close(_by_id(idx[rows], vals[rows])[0],
                               _by_id(want[1][rows], want[0][rows])[0], rtol=1e-5,
                               atol=1e-5 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 256, 512])
@pytest.mark.parametrize("entry", ["topk", "count"])
def test_l1_units_give_one_answer_bit_for_bit(cuda, entry, d):
    """The top-k (k 100, a mask, exclusions, CSLS) and the count (CSLS,
    ragged self columns) at 1, 2, 3 and 5 units and at the planned count
    (one a tile here: 32 strips × 10 tiles) are bit for bit equal: a strip's
    pieces merged by (score, column) or summed give one answer, whatever
    unit arrives last."""
    rng = np.random.default_rng(d + 7)
    q, cands, kw = _l1_case(rng, 1003, 2503, d, entry == "topk", True)
    q, cands, kw = q.to(cuda), cands.to(cuda), _on(cuda, kw)
    if entry == "topk":
        def run(units):
            return l1_search.l1_topk(q, cands, 100, units=units, **kw)
    else:
        self_col = torch.from_numpy(rng.integers(-1, 2503, 1003)).to(cuda)
        other = torch.from_numpy(rng.integers(0, 2503, 1003)).to(cuda)
        thresh = 2.0 * (q - cands[other]).abs().sum(1) - kw["bias"][other]

        def run(units):
            return (l1_search.l1_count(q, cands, thresh, a=2.0, bias=kw["bias"],
                                       self_col=self_col, units=units),)
    want = run(None)
    torch.cuda.synchronize()
    if entry == "count":
        assert int(want[0].sum()) > 0
    for units in (1, 2, 3, 5):
        got = run(units)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), units


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ties_across_units", "exclusions_at_unit_edges", "q1",
                                  "q_below_strip", "c_one_past_tile", "k256_d512"])
def test_l1_edge_shapes_match_plain(cuda, case):
    """Shapes at the work split's edges against the plain version, each at
    the planned units and at 1 and 3 bit for bit: duplicate candidates tied
    across tile and unit edges (the lower column first), exclusions at the
    tiles' edges, one query, fewer queries than a strip (top-k and count),
    one column past a tile, and k 256 at d 512."""
    rng = np.random.default_rng(sum(map(ord, case)))
    tile = l1_search.TILE
    s, c, d, k = {"ties_across_units": (300, 1200, 128, 20),
                  "exclusions_at_unit_edges": (300, 1200, 128, 10), "q1": (1, 5000, 256, 10),
                  "q_below_strip": (17, 3000, 256, 25),
                  "c_one_past_tile": (100, tile + 1, 128, 50),
                  "k256_d512": (200, 3000, 512, 256)}[case]
    q, cands, kw = _l1_case(rng, s, c, d, False, case == "q1")
    if case == "ties_across_units":
        cands[tile:2 * tile] = cands[:tile]  # candidate tile + i ties candidate i exactly
        cands[2 * tile:3 * tile] = cands[:tile]
    if case == "exclusions_at_unit_edges":
        edges = [0, tile - 1, tile, 2 * tile - 1, 2 * tile, 3 * tile - 1, 3 * tile, c - 1]
        kw["exclude"] = torch.from_numpy(rng.choice(edges, s))
    want = l1_search.l1_topk_plain(q, cands, k, **kw)
    qc, cc, kc = q.to(cuda), cands.to(cuda), _on(cuda, kw)
    runs = [l1_search.l1_topk(qc, cc, k, units=u, **kc) for u in (None, 1, 3)]
    for got in runs[1:]:
        assert all(torch.equal(g, w) for g, w in zip(got, runs[0]))
    _l1_agrees(runs[0], want, kw, case == "q1")
    idx = runs[0][1].cpu()
    if case == "ties_across_units":
        for row in idx.tolist():
            pos = {j: n for n, j in enumerate(row)}
            for j, n in pos.items():
                if tile <= j < 3 * tile and j - tile in pos:
                    assert pos[j - tile] < n  # the tie goes to the lower column
    if case == "exclusions_at_unit_edges":
        assert not (idx == kw["exclude"][:, None]).any()
    if case == "q_below_strip":
        other = torch.from_numpy(rng.integers(0, c, s))
        thresh = (q - cands[other]).abs().sum(1)
        scores = l1_search.l1_tile_plain(q, cands)
        near = ((scores - thresh[:, None]).abs() <= 1e-5 * thresh.abs()[:, None]).sum(1)
        want_n = l1_search.l1_count_plain(q, cands, thresh, self_col=other)
        for u in (None, 1, 3):
            got_n = l1_search.l1_count(qc, cc, thresh.to(cuda), self_col=other.to(cuda),
                                       units=u).cpu()
            assert ((got_n - want_n).abs() <= near).all()


@pytest.mark.gpu
def test_l1_smem_model_and_occupancy_match_the_kernel(cuda):
    """The planner's shared-memory model (``smem_bytes``) equals the
    kernel's own for every entry, queue and ring depth, and the ring's
    depth (``ring_stages``) puts two blocks on an SM where its model says
    so: the count, the tile and the top-k at queues of up to 128."""
    lib = _build.load("l1_search")
    lib.l1_smem_bytes.restype = ctypes.c_longlong
    lib.l1_smem_bytes.argtypes = [ctypes.c_int] * 3
    for mode, entry in enumerate(("topk", "count", "tile")):
        for kq in (32, 64, 128, 256):
            for stages in range(3, 7):
                assert lib.l1_smem_bytes(mode, kq, stages) == l1_search.smem_bytes(
                    entry, kq, stages), (entry, kq, stages)
            stages = l1_search.ring_stages(entry, kq)
            two = 2 * (l1_search.smem_bytes(entry, kq, stages)
                       + l1_search.BLOCK_SMEM_RESERVED) <= l1_search.SM_SMEM_BYTES
            assert l1_search._blocks_per_sm(cuda, entry, kq, stages) == (2 if two else 1)


def _aligned_pair(rng, n1=1500, n2=1700, d=64, noise=0.3):
    base = rng.standard_normal((n1, d)).astype(np.float32)
    right = (np.pad(base, ((0, n2 - n1), (0, 0)))
             + noise * rng.standard_normal((n2, d)).astype(np.float32))
    right[: n2 // 20] *= 0.05
    return np.concatenate([base, right])


def _same_rows(a, b):
    a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
    return float((a.sort(dim=1).values == b.sort(dim=1).values).all(dim=1).float().mean())


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["mining", "mining_sq_csls", "proposals", "proposals_csls",
                                  "proposals_sq", "ranks", "ranks_csls", "topk", "topk_csls",
                                  "hubness"])
def test_approx_paths_on_the_card_match_the_host(cuda, path):
    """Each approximate search path on the card (the shortlist kernel, fp32
    products) against the same call on the host (plain versions): the same
    sets on at least 99 % of rows (pairs, ranks), and the kernel launched."""
    rng = np.random.default_rng(21)
    n1, n2 = 1500, 1700
    emb = _aligned_pair(rng, n1, n2)
    n = n1 + n2
    pairs = np.stack([rng.permutation(n1)[:600], n1 + rng.permutation(n1)[:600]], 1)
    mask1, mask2 = np.ones(n1, bool), np.ones(n2, bool)
    mask1[pairs[:, 0]] = False
    mask2[pairs[:, 1] - n1] = False
    test = np.stack([np.arange(n1), n1 + np.arange(n1)], 1)

    def call(dev):
        e = torch.from_numpy(emb).to(dev)
        p = torch.from_numpy(pairs).to(dev)
        m1, m2 = torch.from_numpy(mask1).to(dev), torch.from_numpy(mask2).to(dev)
        if path.startswith("mining"):
            kw = dict(metric="sqeuclidean", csls_k=10) if path == "mining_sq_csls" else {}
            return torch.cat(sample_hard_negatives(e, p, n1, n, 50, approx=True, **kw), 1)
        if path.startswith("proposals"):
            kw = dict(csls_k=10 if path == "proposals_csls" else 0,
                      metric="sqeuclidean" if path == "proposals_sq" else "cityblock")
            bp, bw = propose_mutual_nn_pairs(e, m1, m2, n1, n, 800, approx=True, **kw)
            return {tuple(r) for r in bp[bw > 0].tolist()}
        if path.startswith("ranks"):
            t = torch.from_numpy(test).to(dev)
            return torch.stack(_both_direction_ranks(
                e, t, csls_k=10 if path == "ranks_csls" else 0, approx_k=64))
        if path.startswith("topk"):
            return topk_alignments(e, np.arange(n1), n1 + np.arange(n2), k=10,
                                   csls_k=10 if path == "topk_csls" else 0, approx_k=64)[1]
        return torch.stack(_hubness_both_approx(e[:n1], e[n1:], 10))

    before = shortlist_dist.select_launches
    got = call(cuda)
    torch.cuda.synchronize()
    assert shortlist_dist.select_launches > before
    want = call(torch.device("cpu"))
    if path.startswith("proposals"):
        assert len(got & want) >= 0.99 * len(want) and len(want) > 100
    elif path.startswith("ranks"):
        assert float((got.cpu() == want).double().mean()) >= 0.99
    elif path == "hubness":
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    else:
        assert _same_rows(got, want) >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["mining", "mining_csls", "mining_approx_csls", "proposals",
                                  "proposals_csls", "ranks", "ranks_csls", "topk", "topk_csls",
                                  "ring_knn", "ring_knn_csls", "ring_hits_csls"])
def test_exact_l1_paths_on_the_card_launch_l1_search(cuda, path):
    """Each exact cityblock search path on the card goes through the L1
    search kernel (its launches counted, no plain fallback) and gives the
    same call's answer on the host: the same sets on ≥ 99 % of rows (pairs,
    ranks, top-k ids); the ring at 8 shards on one rank."""
    rng = np.random.default_rng(22)
    n1, n2 = 1500, 1700
    emb = _aligned_pair(rng, n1, n2, d=128)
    n = n1 + n2
    pairs = np.stack([rng.permutation(n1)[:600], n1 + rng.permutation(n1)[:600]], 1)
    mask1, mask2 = np.ones(n1, bool), np.ones(n2, bool)
    mask1[pairs[:, 0]] = False
    mask2[pairs[:, 1] - n1] = False
    test = np.stack([np.arange(n1), n1 + np.arange(n1)], 1)
    csls = 10 if path.endswith("csls") else 0

    def call(dev):
        e = torch.from_numpy(emb).to(dev)
        p = torch.from_numpy(pairs).to(dev)
        if path.startswith("mining"):
            return torch.cat(sample_hard_negatives(e, p, n1, n, 50, csls_k=csls,
                                                   approx=path == "mining_approx_csls"), 1)
        if path.startswith("proposals"):
            m1, m2 = torch.from_numpy(mask1).to(dev), torch.from_numpy(mask2).to(dev)
            bp, bw = propose_mutual_nn_pairs(e, m1, m2, n1, n, 800, csls_k=csls)
            return {tuple(r) for r in bp[bw > 0].tolist()}
        if path.startswith("ranks"):
            return torch.stack(_both_direction_ranks(e, torch.from_numpy(test).to(dev),
                                                     csls_k=csls))
        if path.startswith("topk"):
            return topk_alignments(e, np.arange(n1), n1 + np.arange(n2), k=10, csls_k=csls)[1]
        with make_mesh(8, dev) as mesh:
            if path == "ring_hits_csls":
                return ring_hits_at_k(e, test, mesh, csls_k=csls)
            return ring_knn(e[p[:, 0]], e[n1:], p[:, 1] - n1, 50, mesh, csls_k=csls)

    before = (l1_search.topk_launches, l1_search.count_launches, l1_search.tile_launches)
    got = call(cuda)
    torch.cuda.synchronize()
    after = (l1_search.topk_launches, l1_search.count_launches, l1_search.tile_launches)
    counted = path.startswith("ranks") or path == "ring_hits_csls"
    assert after[1] > before[1] if counted else after[0] > before[0]
    assert after[2] == before[2]
    want = call(torch.device("cpu"))
    if path.startswith("proposals"):
        assert len(got & want) >= 0.99 * len(want) and len(want) > 100
    elif path.startswith("ranks"):
        assert float((got.cpu() == want).double().mean()) >= 0.99
    elif path == "ring_hits_csls":
        assert all(abs(got[k] - want[k]) <= 2e-3 for k in want)
    else:
        assert _same_rows(got, want) >= 0.99


# ---- the fused interval: a captured training step, replayed ----

CAPTURE_CASES = {
    "base": ("base", dict(dim=128)),
    "base_bf16": ("base", dict(dim=128, param_dtype="bfloat16")),
    "base_sorted": ("base", dict(dim=128, spmm_impl="sorted")),
    "v6_bf16": ("base", dict(RECIPES["v6"], boot_cap=64, k_neg=10, param_dtype="bfloat16")),
    "sinkhorn": ("sinkhorn", dict(sinkhorn_iters=5)),
    "v6": ("base", dict(RECIPES["v6"], boot_cap=64, k_neg=10)),  # (256, 256) and the OT head
    "highway_dropout": ("highway", dict(dropout=0.3)),
    "mtl_channel": ("mtl", dict(use_attr_channel=True, sinkhorn_iters=5, rel_k_neg=3)),
}


def _captured_case(cfg, dev):
    """The trainers' own model and loss for ``cfg`` (``driver.step_parts``)
    on a small task, and epoch 0's batch as the loop builds it
    (``loop.first_batch``; with bootstrapping, proposals of weight
    ``boot_weight`` in place of the placeholder)."""
    task = synthetic_align_task(seed=3, n_ent=1500, n_rel=20, n_triples=6000, n_attr=40)
    parts = step_parts(cfg, task, dev)
    boot = None
    if cfg.boot_cap:
        pairs = torch.as_tensor(task.train_pairs, dtype=torch.int64, device=dev)
        boot = (pairs[:cfg.boot_cap], torch.ones(cfg.boot_cap, device=dev))
    return parts, first_batch(cfg, task, parts, dev, boot)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CAPTURE_CASES))
def test_captured_step_replays_as_eager(cuda, case):
    """Three replays of the captured step against the same three steps
    eager with the same (capturable) Adam, from the same parameters and
    batch, the dropout masks from the same seeds: each loss rel 1e-6, the
    parameters relative L2 1e-6; a replay goes through no wrapper."""
    config, over = CAPTURE_CASES[case]
    cfg = get_config(config, **{"k_neg": 10, **over})
    parts, batch = _captured_case(cfg, cuda)
    model = parts.model
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt, sched = make_optimizer(cfg, model.parameters(), capturable=True)
    want = []
    for e in range(3):
        gen = step_generator(cfg, e, cuda) if cfg.dropout else None
        want.append(train_step(opt, parts.loss_fn, batch, gen)[0].item())
        sched.step()
    want_p = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model.load_state_dict(init)
    opt, sched = make_optimizer(cfg, model.parameters(), capturable=True)
    cap = CapturedStep(opt, parts.loss_fn, batch, cuda, cfg.dropout > 0)
    before = (gcn_fused.launches, spmm_ell.launches, sinkhorn_fused.launches)
    got = []
    for e in range(3):
        got.append(cap.replay(step_seed(cfg, e)))
        sched.step()
    torch.cuda.synchronize()
    assert (gcn_fused.launches, spmm_ell.launches, sinkhorn_fused.launches) == before
    for g, w in zip(got, want):
        assert g.item() == pytest.approx(w, rel=1e-6)
    for k, v in want_p.items():
        assert float((model.state_dict()[k] - v).norm() / v.norm().clamp_min(1e-30)) < 1e-6, k


@pytest.mark.gpu
@pytest.mark.parametrize("kernel, d", [("gcn_fused", (128, 128)), ("gcn_fused", (256, 256)),
                                       ("gcn_fused", (128, 256)), ("gcn_fused", (256, 128)),
                                       ("gcn_fused_bf16", (256, 256)),
                                       ("gcn_fused_bf16", (128, 128)),
                                       ("spmm_ell", 128), ("spmm_ell", 256),
                                       ("spmm_sorted", 128), ("spmm_sorted", 256),
                                       ("sinkhorn_fused", 128), ("sinkhorn_fused", 256)])
def test_kernel_warm_up_then_capture(cuda, kernel, d):
    """Each wrapper, called once on a side stream (its library loaded, its
    scratch for that stream allocated), then captured there and replayed
    twice: both replays equal the eager call bit for bit."""
    rng = np.random.default_rng(5)
    op = _graph(rng, n=2000).to(cuda)
    if kernel.startswith("gcn_fused"):
        dtype = torch.bfloat16 if kernel.endswith("bf16") else torch.float32
        x = torch.from_numpy(rng.standard_normal((2000, d[0])).astype(np.float32)).to(cuda, dtype)
        w = torch.from_numpy(rng.standard_normal(d).astype(np.float32) / 16).to(cuda, dtype)
        b = torch.from_numpy(rng.standard_normal(d[1]).astype(np.float32)).to(cuda)

        def call():
            return fused_gcn_layer(op.fwd, op.diag, x, w, b)
    elif kernel == "spmm_ell":
        x = torch.from_numpy(rng.standard_normal((2000, d)).astype(np.float32)).to(cuda)

        def call():
            return ell_spmm(op.bwd, op.diag, x)
    elif kernel == "spmm_sorted":
        x = torch.from_numpy(rng.standard_normal((2000, d)).astype(np.float32)).to(cuda)
        edges = _sorted_graph(rng, n=2000).bwd.to(cuda)

        def call():
            return sorted_spmm(edges, x)
    else:
        lr = [torch.nn.functional.normalize(torch.from_numpy(
            rng.standard_normal((700, d)).astype(np.float32)), dim=1).to(cuda) for _ in "lr"]
        g = torch.from_numpy(rng.standard_normal(700).astype(np.float32) * 0.1).to(cuda)
        log_mu = torch.full((700,), -math.log(700), device=cuda)

        def call():
            return sinkhorn_potential_update(lr[0], lr[1], g, log_mu, 0.3)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        want = call()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = call()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.gpu
def test_fused_run_on_card_tracks_the_unfused_run(cuda):
    """Config sinkhorn, 8 epochs in intervals of 4, fused (replays of a
    captured step, capturable Adam) against unfused: every loss rel 1e-4,
    the final metrics within 0.01; the wrappers count the eager forwards,
    the warm-up step and the capture, not the replays."""
    cfg = get_config("sinkhorn", syn_n_ent=600, syn_n_triples=2400, epochs=8, neg_every=4,
                     eval_every=0, k_neg=10)
    plain = run(cfg, device=cuda)
    before = gcn_fused.launches
    fused = run(cfg.replace(steps_per_call=4), device=cuda)
    # one mining forward, the final eval's, the warm-up step and the capture
    assert gcn_fused.launches - before == 2 + 2 + 2 + 2
    assert fused.timings["steps"] == 8 and fused.timings["capture_s"] > 0
    assert fused.losses == pytest.approx(plain.losses, rel=1e-4)
    for k in ("hits@1", "hits@10"):
        assert abs(fused.metrics[k] - plain.metrics[k]) <= 0.01


@pytest.mark.gpu
@pytest.mark.parametrize("first, then", [(4, 1), (1, 4)])
def test_checkpoint_crosses_modes_on_card(cuda, tmp_path, first, then):
    """A run of 4 epochs in one mode (fused: a capturable Adam; unfused: a
    plain one) saves at epoch 3; a run in the other mode resumes it at the
    boundary 4 and ends as an uninterrupted 8-epoch run: each loss rel
    1e-4."""
    cfg = get_config("sinkhorn", syn_n_ent=600, syn_n_triples=2400, epochs=8, neg_every=4,
                     eval_every=0, k_neg=10, checkpoint_every=100)
    whole = run(cfg.replace(steps_per_call=first), device=cuda)
    ck = cfg.replace(checkpoint_dir=str(tmp_path / "ck"))
    head = run(ck.replace(epochs=4, steps_per_call=first), device=cuda)
    tail = run(ck.replace(steps_per_call=then), device=cuda)
    assert tail.timings["start_epoch"] == 4
    assert head.losses + tail.losses == pytest.approx(whole.losses, rel=1e-4)


# ---- bf16 training and the sorted SpMM ----

def _sorted_graph(rng, n=8000, hubs=(5300, 700)):
    """A sorted operator with hub rows of the given in-degrees (rows 3,
    11, ...), many short rows, self-loops as edges and a padded tail."""
    src = rng.integers(0, n, 4 * n)
    dst = rng.integers(20, n, 4 * n)
    for row, deg in zip((3, 11, 17), hubs):
        src = np.concatenate([src, rng.integers(20, n, deg)])
        dst = np.concatenate([dst, np.full(deg, row)])
    loops = np.arange(n)
    src, dst = np.concatenate([src, loops]), np.concatenate([dst, loops])
    w = rng.standard_normal(len(src)).astype(np.float32)
    return build_spmm_operator(src, dst, w, n, bucket=4096)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("hub", ["hub_5300", "cap_plus_1"])
def test_spmm_ell_bf16_matches_plain(cuda, d, hub):
    """The bf16 instance over A and Aᵀ of a hub graph and over the attribute
    incidence and its transpose: against the fp32 plain version of the same
    bf16 input within half a bf16 ulp (fp32 sums, one rounding: rel 2^-8,
    atol 1e-3 for the fp32 sums' order) and against the bf16 plain version
    (which rounds the bucket sum and the diagonal term apart) at the bf16
    tolerance; two launches agree bit for bit."""
    rng = np.random.default_rng(d + len(hub))
    op = _hub_graph(rng, HUB_DEGREES[hub]).to(cuda)
    attr = np.stack([np.repeat(np.arange(6000), 4), rng.integers(0, 100, 24000)], 1)
    inc = build_attr_operator(attr, 6000, 100).to(cuda)
    for m, diag in ((op.fwd, op.diag), (op.bwd, op.diag), (inc.fwd, None), (inc.bwd, None)):
        x = torch.from_numpy(rng.standard_normal((m.n_cols, d)).astype(np.float32))
        x = x.to(cuda, torch.bfloat16)
        before = spmm_ell.launches
        got, again = ell_spmm(m, diag, x), ell_spmm(m, diag, x)
        torch.cuda.synchronize()
        assert spmm_ell.launches == before + 2 and got.dtype == torch.bfloat16
        assert torch.equal(got, again)
        torch.testing.assert_close(got.float(), apply_with_diag(m, diag, x.float()),
                                   rtol=2 ** -8, atol=1e-3)
        torch.testing.assert_close(got.float(), apply_with_diag(m, diag, x).float(),
                                   **TOL[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_spmm_sorted_matches_plain(cuda, dtype, d):
    """The sorted-segment kernel over A and Aᵀ of a graph with 5,300- and
    700-edge rows, and over the attribute incidence and its transpose:
    against its plain version (fp32 1e-4; bf16: one rounding of fp32 sums
    on both sides, so 1 ulp, rel 2^-7, atol 1e-3); two launches agree bit
    for bit; the trainable form's gradient is the transpose's launch,
    held to the plain version over op.bwd."""
    rng = np.random.default_rng(d + (dtype == torch.bfloat16))
    op = _sorted_graph(rng).to(cuda)
    attr = np.stack([np.repeat(np.arange(6000), 4), rng.integers(0, 100, 24000)], 1)
    inc = build_attr_operator(attr, 6000, 100, fmt="sorted", bucket=4096).to(cuda)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=2 ** -7, atol=1e-3)
    for edges in (op.fwd, op.bwd, inc.fwd, inc.bwd):
        x = torch.from_numpy(rng.standard_normal((edges.n_cols, d)).astype(np.float32))
        x = x.to(cuda, dtype)
        before = spmm_mod.launches
        got, again = sorted_spmm(edges, x), sorted_spmm(edges, x)
        torch.cuda.synchronize()
        assert spmm_mod.launches == before + 2 and got.dtype == dtype
        assert torch.equal(got, again)
        torch.testing.assert_close(got.float(), segment_spmm(edges, x).float(), **tol)
    table = torch.from_numpy(rng.standard_normal((100, d)).astype(np.float32)).to(cuda, dtype)
    cot = torch.from_numpy(rng.standard_normal((6000, d)).astype(np.float32)).to(cuda, dtype)
    t1 = table.clone().requires_grad_(True)
    before = spmm_mod.launches
    spmm_mod.spmm(inc, t1).backward(cot)
    torch.cuda.synchronize()
    assert spmm_mod.launches == before + 2
    torch.testing.assert_close(t1.grad.float(), segment_spmm(inc.bwd, cot).float(), **tol)
    with pytest.raises(TypeError):
        sorted_spmm(op.fwd, x.to(torch.float16))
    # d = 32 has no instance: the panel path, against the plain version
    x32 = torch.from_numpy(rng.standard_normal((op.fwd.n_cols, 32)).astype(np.float32))
    x32 = x32.to(cuda, dtype)
    torch.testing.assert_close(sorted_spmm(op.fwd, x32).float(),
                               segment_spmm(op.fwd, x32).float(), **tol)
    # above 512 the panels go on: 5 and 9 of them, the last masked
    for wide in (513, 1030):
        xw = torch.from_numpy(rng.standard_normal((op.fwd.n_cols, wide)).astype(np.float32))
        xw = xw.to(cuda, dtype)
        got = sorted_spmm(op.fwd, xw)
        assert torch.equal(got, sorted_spmm(op.fwd, xw))
        torch.testing.assert_close(got.float(), segment_spmm(op.fwd, xw).float(), **tol)
    with pytest.raises(ValueError):  # non-contiguous
        sorted_spmm(op.fwd, torch.zeros(64, op.fwd.n_cols, device=cuda).t())


def _gapped_sorted_graph(rng, n=6000):
    """A sorted operator with rows of exactly SEG_EDGES and SEG_EDGES + 1
    edges (the second cut in two), rows of PACK_SLOTS ± 1 slots, a 2,000-edge
    hub, and rows with no edge: all rows below 40 but those, every fifth
    row of [100, 2000) and the last 300 rows before the dump row."""
    dst = rng.integers(40, n - 300, 4 * n)
    dst = dst[(dst >= 2000) | (dst < 100) | (dst % 5 != 0)]
    src = rng.integers(0, n, len(dst))
    for row, deg in ((3, SEG_EDGES), (7, SEG_EDGES + 1), (11, PACK_SLOTS - 1),
                     (13, PACK_SLOTS), (17, 2000)):
        src = np.concatenate([src, rng.integers(0, n, deg)])
        dst = np.concatenate([dst, np.full(deg, row)])
    w = rng.standard_normal(len(src)).astype(np.float32)
    return build_spmm_operator(src, dst, w, n, bucket=4096)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_spmm_sorted_cut_and_empty_rows(cuda, dtype, d):
    """Rows at the segment cap and one over it, and rows with no edge
    inside packed runs and before the dump row, over A and Aᵀ: against the
    plain version (the tolerances of test_spmm_sorted_matches_plain), the
    empty rows exactly 0 although the output's memory held NaN just before
    (every row is written), two launches bit for bit."""
    rng = np.random.default_rng(d + 2 * (dtype == torch.bfloat16))
    op = _gapped_sorted_graph(rng).to(cuda)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=2 ** -7, atol=1e-3)
    for edges in (op.fwd, op.bwd):
        deg = torch.bincount(edges.dst[:edges.nnz].long(), minlength=edges.n_rows)
        if edges is op.fwd:
            assert int(deg[3]) == SEG_EDGES and int(deg[7]) == SEG_EDGES + 1
            assert int((deg == 0).sum()) >= 300 + 380
        x = torch.from_numpy(rng.standard_normal((edges.n_cols, d)).astype(np.float32))
        x = x.to(cuda, dtype)
        torch.full((edges.n_rows, d), float("nan"), dtype=dtype, device=cuda)  # freed to the cache
        got = sorted_spmm(edges, x)
        again = sorted_spmm(edges, x)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert torch.equal(got[deg == 0], torch.zeros_like(got[deg == 0]))
        torch.testing.assert_close(got.float(), segment_spmm(edges, x).float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 256])
def test_spmm_sorted_twice_in_one_graph(cuda, d):
    """Two launches over cut hub rows inside one captured CUDA graph (on
    two inputs), replayed twice: each output equals its eager call bit for
    bit, so every cut row's counter is back at 0 after each launch."""
    rng = np.random.default_rng(d)
    edges = _sorted_graph(rng, n=4000, hubs=(3000, 400)).fwd.to(cuda)
    xs = [torch.from_numpy(rng.standard_normal((4000, d)).astype(np.float32)).to(cuda)
          for _ in range(2)]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        want = [sorted_spmm(edges, x) for x in xs]
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        outs = [sorted_spmm(edges, x) for x in xs]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for o, w in zip(outs, want):
            assert torch.equal(o, w)


# bf16 against the plain path on the card: the two round at other points
# (the kernel rounds each layer's fp32 sum once; the plain path rounds the
# aggregate, the product and the bias apart), so a value differs by a few
# roundings of 2^-9 between them.  A unit whose pre-activation lies that
# close to 0 takes the other side of the layer-1 ReLU in the other path,
# and its whole gradient moves with it: on these graphs a fraction
# f ≈ 3e-3 of the pre-activations lies within 2^-8 of their RMS of 0, and
# flipped units make a relative L2 of up to ≈ sqrt(f) ≈ 5.5e-2 upstream of
# the ReLU, held at 2·sqrt(f) ≈ 1e-1.  The loss, a mean of many L1 hinge
# terms, moves within a bf16 ulp, 2^-7.  The layer-2 bias's gradient is 0
# by construction (the margin reads differences of rows); in bf16 it is
# the sum over the n rows of each row's rounding of its cotangent (≤ 2^-9
# of it), held under sqrt(n)·2^-8 of the largest gradient entry.
BF16_STEP_TOL = dict(loss_rel=2 ** -7, grad_rel_l2=1e-1)


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [128, 256])
def test_bf16_step_matches_plain(cuda, dim):
    """One bf16 training step of AlignGCN at (dim, dim) through the kernels
    (2 gcn_fused bf16 forward, 2 spmm_ell bf16 backward) against the same
    step with the layer swapped for its plain version (autograd through it)
    on the card, at BF16_STEP_TOL; the parameters' gradients are fp32."""
    rng = np.random.default_rng(dim)
    n, n1, s, k = 2000, 1000, 300, 20
    tri = np.stack([rng.integers(0, n, 8000), rng.integers(0, 9, 8000),
                    rng.integers(0, n, 8000)], 1)
    op = build_adjacency(n, tri).to(cuda)
    model = AlignGCN(n_ent=n, dim=dim, compute_dtype="bfloat16", device=cuda)
    model.load_state_dict(init_params(n, dim, seed=4))
    pairs = torch.from_numpy(np.stack([rng.permutation(n1)[:s],
                                       n1 + rng.permutation(n1)[:s]], 1)).to(cuda)
    neg_l = torch.from_numpy(rng.integers(0, n1, (s, k))).to(cuda)
    neg_r = torch.from_numpy(rng.integers(n1, n, (s, k))).to(cuda)

    def step():
        model.zero_grad(set_to_none=True)
        loss = margin_align_loss(model(op), pairs, neg_l, neg_r, 3.0)
        loss.backward()
        return loss.item(), {k: v.grad.clone() for k, v in model.named_parameters()}

    before = (gcn_fused.launches, spmm_ell.launches)
    loss, grads = step()
    torch.cuda.synchronize()
    assert (gcn_fused.launches - before[0], spmm_ell.launches - before[1]) == (2, 2)
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads.values())
    real = graphconv_mod.gcn_layer
    graphconv_mod.gcn_layer = lambda op, x, w, b=None: reference_layer(op.fwd, op.diag, x, w, b)
    try:
        plain_loss, plain = step()
    finally:
        graphconv_mod.gcn_layer = real
    assert loss == pytest.approx(plain_loss, rel=BF16_STEP_TOL["loss_rel"])
    scale = max(float(v.abs().max()) for v in plain.values())
    for k, v in plain.items():
        if k == "gc2.b":  # 0 by construction: both are rounding noise
            assert max(float(grads[k].abs().max()), float(v.abs().max())) < (
                math.sqrt(n) * 2 ** -8 * scale)
        else:
            assert float((grads[k] - v).norm() / v.norm()) < BF16_STEP_TOL["grad_rel_l2"], k


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sorted_encoder_on_card_matches_host(cuda, dtype):
    """The sorted encoder (2 spmm_sorted forward, 2 backward, no ELL kernel)
    on the card against the plain path on the host: fp32 1e-4; bf16 at the
    gradient tolerance BF16_STEP_TOL (cuBLAS and the host round the bf16
    products apart)."""
    rng = np.random.default_rng(2)
    n = 1500
    tri = np.stack([rng.integers(0, n, 6000), rng.integers(0, 7, 6000),
                    rng.integers(0, n, 6000)], 1)
    op = build_adjacency(n, tri, fmt="sorted", bucket=2048)
    params = init_params(n, 128, seed=3)
    kw = dict(n_ent=n, spmm_impl="sorted", compute_dtype=dtype)
    host, card = AlignGCN(**kw), AlignGCN(**kw, device=cuda)
    host.load_state_dict(params)
    card.load_state_dict(params)
    cot = torch.from_numpy(rng.standard_normal((n, 128)).astype(np.float32))
    before = (gcn_fused.launches, spmm_ell.launches, spmm_mod.launches)
    got = card(op.to(cuda))
    (got * cot.to(cuda)).sum().backward()
    torch.cuda.synchronize()
    assert (gcn_fused.launches - before[0], spmm_ell.launches - before[1],
            spmm_mod.launches - before[2]) == (0, 0, 4)
    want = host(op)
    (want * cot).sum().backward()
    tol = 1e-4 if dtype == "float32" else BF16_STEP_TOL["grad_rel_l2"]
    assert float((got.cpu() - want.detach()).norm() / want.norm()) < tol
    for (k, a), (_, b) in zip(card.named_parameters(), host.named_parameters()):
        assert float((a.grad.cpu() - b.grad).norm() / b.grad.norm()) < tol, k


@pytest.mark.gpu
def test_debug_nans_on_a_captured_interval(cuda):
    """A fused run whose huge learning rate overflows the second step: the
    captured step's finite flag, read at the interval's synchronise,
    raises FloatingPointError naming the interval; unfused, anomaly mode
    and the step check name the epoch."""
    cfg = get_config("base", syn_n_ent=600, syn_n_triples=2400, epochs=8, neg_every=4,
                     eval_every=0, k_neg=10, lr=1e30)
    with pytest.raises(FloatingPointError, match="interval of epochs 0-3"):
        run(cfg.replace(steps_per_call=4), device=cuda, debug_nans=True)
    with pytest.raises(FloatingPointError, match="epoch 1"):
        run(cfg, device=cuda, debug_nans=True)


def _shard_graph(n_shards=4, seed=6):
    """A power-law graph of 2,000 entities partitioned into ``n_shards``:
    hub rows in shard 0, boundary groups over every pair of shards."""
    task = synthetic_align_task(seed=seed, n_ent=1000, n_rel=10, n_triples=6000)
    src, dst, w = coo_from_triples(task.n_ent, task.merged_triples, n_rel=task.n_rel)
    w = coo_normalize(src, dst, w, task.n_ent)
    return task, partition_edges(src, dst, w, task.n_ent, n_shards)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128, 256])
def test_spmm_kernels_on_a_shard_boundary_and_its_transpose(cuda, d):
    """Both SpMM kernels on each shard's boundary operator (n_loc × S·B)
    and its transpose (S·B rows, most of them pad slots with no edge), and
    on the local operator: against their plain versions, on output memory
    prefilled with NaN, the empty rows exactly 0."""
    _, hg = _shard_graph()
    he = build_halo_ell(hg)
    rng = np.random.default_rng(d)
    for s in range(hg.n_shards):
        loc, bnd = he.loc.shard(s).to(cuda), he.bnd.shard(s).to(cuda)
        s_loc, s_bnd = (op.to(cuda) for op in shard_edge_operators(hg, s))
        cases = [(lambda x, m=m, dg=dg: ell_spmm(m, dg, x),
                  lambda x, m=m, dg=dg: apply_with_diag(m, dg, x), m.n_rows, m.n_cols)
                 for m, dg in ((loc.fwd, loc.diag), (bnd.fwd, None), (bnd.bwd, None))]
        cases += [(lambda x, e=e: sorted_spmm(e, x), lambda x, e=e: segment_spmm(e, x),
                   e.n_rows, e.n_cols) for e in (s_loc.fwd, s_bnd.fwd, s_bnd.bwd)]
        for kernel, plain, rows, cols in cases:
            x = torch.from_numpy(rng.standard_normal((cols, d)).astype(np.float32)).to(cuda)
            torch.full((rows, d), float("nan"), device=cuda)  # freed to the cache
            got = kernel(x)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, plain(x), rtol=1e-4, atol=1e-4)
        assert bnd.bwd.n_rows == hg.n_shards * hg.halo_b
        empty = torch.ones(bnd.bwd.n_rows, dtype=torch.bool, device=cuda)
        for b in bnd.bwd.buckets:
            empty[b.rows.long()] = False
        assert int(empty.sum()) > bnd.bwd.n_rows // 2  # mostly pad slots
        got = ell_spmm(bnd.bwd, None, torch.ones(hg.n_loc, d, device=cuda))
        assert torch.equal(got[empty], torch.zeros_like(got[empty]))


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["ell", "sorted"])
def test_distributed_step_on_the_card_matches_the_host(cuda, impl):
    """One distributed step (4 shards, an NCCL group of one rank, the
    kernels doing the rank's stacked local and boundary aggregation both
    ways) against the same step on the host (gloo, plain versions): loss
    rel 1e-4, each gradient relative L2 1e-4 (gc2.b, 0 by construction, as
    noise)."""
    task, _ = _shard_graph()
    cfg = get_config("base", n_shards=4, dim=128, k_neg=10, spmm_impl=impl)
    pairs = torch.as_tensor(task.train_pairs, dtype=torch.int64)
    neg_l, neg_r = sample_uniform_negatives(torch.Generator().manual_seed(0), pairs,
                                            task.kg1.n_ent, task.n_ent, cfg.k_neg)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        batch = {"pairs": pairs.to(dev), "neg_l": neg_l.to(dev), "neg_r": neg_r.to(dev)}
        with make_mesh(4, dev) as mesh:
            parts = dist_parts(cfg, task, mesh)
            before = (spmm_ell.launches, spmm_mod.launches)
            loss = parts.grads(batch)
            launched = (spmm_ell.launches - before[0], spmm_mod.launches - before[1])
            out[dev.type] = (loss.item(), {k: p.grad.cpu() for k, p in
                                           parts.model.named_parameters()}, launched)
    assert out["cuda"][2] == ((8, 0) if impl == "ell" else (0, 8))
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-4)
    scale = max(float(g.abs().max()) for g in out["cpu"][1].values())
    for k, g in out["cpu"][1].items():
        got = out["cuda"][1][k]
        if k == "gc2.b":
            assert float(got.abs().max()) < 1e-5 * scale
        else:
            assert float((got - g).norm() / g.norm()) < 1e-4, k


@pytest.mark.gpu
@pytest.mark.parametrize("s, d", [(4096, 256), (4096, 128), (1000, 256), (9, 256)])
def test_ring_ot_on_card_matches_plain(cuda, s, d):
    """The ring OT (one NCCL rank holding 8 shards: one ``sinkhorn_fused``
    launch per update on the chunk's real rows, 41 per loss) against its
    plain version on the card, at the configs' widths (128:
    ``dwy100k_dist``, 256: recipes v6–v7r), v7r's τ 0.3; 9 pairs leave shards
    without a real row.  Loss rel 1e-4, gradient relative L2 1e-3 (PERF.md
    §2's step limits)."""
    rng = np.random.default_rng(s + d)
    table = torch.from_numpy(rng.standard_normal((2 * s, d)).astype(np.float32)).to(cuda)
    pairs = torch.stack([torch.arange(s), s + torch.randperm(s)], 1).to(cuda)
    x = table.clone().requires_grad_()
    with make_mesh(8, cuda) as mesh:
        before = sinkhorn_fused.launches
        loss = ring_sinkhorn_align_loss(x, pairs, mesh, tau=0.3, n_iters=20)
        assert sinkhorn_fused.launches == before + 41
        loss.backward()
    y = table.clone().requires_grad_()
    want = sinkhorn_align_loss_plain(y, pairs, tau=0.3, n_iters=20)
    want.backward()
    assert torch.isfinite(x.grad).all()
    assert loss.item() == pytest.approx(want.item(), rel=1e-4)
    assert float((x.grad - y.grad).norm() / y.grad.norm()) < 1e-3


@pytest.mark.gpu
def test_ring_csls_stages_on_card_match_the_host(cuda):
    """CSLS ring mining and eval on the card (one rank, 8 shards) against
    the same calls on the host: the same id sets on ≥ 99 % of rows, Hits@k
    and MRR within 2e-3 (the L1 sums run in another order on the card, and a
    near tie may flip one of the 900 ranks: PERF.md §2)."""
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.standard_normal((700, 64)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((2000, 64)).astype(np.float32))
    ex = torch.from_numpy(rng.integers(0, 2000, 700))
    emb = torch.from_numpy(rng.standard_normal((3000, 64)).astype(np.float32))
    pairs = np.stack([rng.choice(1500, 900, replace=False),
                      1500 + rng.choice(1500, 900, replace=False)], 1)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        with make_mesh(8, dev) as mesh:
            out[dev.type] = (ring_knn(q.to(dev), c.to(dev), ex.to(dev), 10, mesh, csls_k=10).cpu(),
                             ring_hits_at_k(emb.to(dev), pairs, mesh, csls_k=10))
    same = (out["cuda"][0].sort(1).values == out["cpu"][0].sort(1).values).all(1)
    assert float(same.float().mean()) >= 0.99  # a near-tie may flip (PERF.md §2)
    for k, v in out["cpu"][1].items():
        assert out["cuda"][1][k] == pytest.approx(v, abs=2e-3), k


@pytest.mark.gpu
def test_distributed_v7r_step_on_the_card_matches_the_host(cuda):
    """One step of recipe v7r's surface (the margin with proposals at their
    weights, the ring OT on a subsample through ``sinkhorn_fused``, the
    relation and attribute heads) on 4 shards, on the card against the
    host: loss rel 1e-4, each gradient relative L2 1e-4."""
    task, _ = _shard_graph()
    cfg = get_config("dwy100k_dist", **RECIPES["v7r"]).replace(
        n_shards=4, dim=128, k_neg=10, boot_cap=200, sinkhorn_pairs=512, use_rel_head=True)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        batch = mp_worker.surface_batch(cfg, task, device=dev)
        with make_mesh(4, dev) as mesh:
            parts = dist_parts(cfg, task, mesh)
            before = (spmm_ell.launches, sinkhorn_fused.launches)
            loss = parts.grads(batch)
            launched = (spmm_ell.launches - before[0], sinkhorn_fused.launches - before[1])
            out[dev.type] = (loss.item(), {k: p.grad.cpu() for k, p in
                                           parts.model.named_parameters()}, launched)
    assert out["cuda"][2] == (8, 41)
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-4)
    for k, g in out["cpu"][1].items():
        assert float((out["cuda"][1][k] - g).norm() / g.norm()) < 1e-4, k


@pytest.mark.gpu
@pytest.mark.parametrize("recipe", ["margin", "v7r"])
def test_one_card_holds_every_feature_block_and_slice(cuda, recipe):
    """``feature_shards = slice_shards = 2`` on one NCCL rank: the rank
    holds every feature block and slice (the grid (1, 1, 1), no subgroup),
    and its step equals the F = L = 1 step bit for bit, the loss and every
    gradient, with the same launches (the margin step on injected
    negatives, and recipe v7r's surface with the ring OT)."""
    task, _ = _shard_graph()
    if recipe == "v7r":
        cfg = get_config("dwy100k_dist", **RECIPES["v7r"]).replace(
            n_shards=4, dim=128, k_neg=10, boot_cap=200, sinkhorn_pairs=512, use_rel_head=True)
        batch = mp_worker.surface_batch(cfg, task, device=cuda)
    else:
        cfg = get_config("base", n_shards=4, dim=128, k_neg=10)
        pairs = torch.as_tensor(task.train_pairs, dtype=torch.int64)
        neg_l, neg_r = sample_uniform_negatives(torch.Generator().manual_seed(0), pairs,
                                                task.kg1.n_ent, task.n_ent, cfg.k_neg)
        batch = {"pairs": pairs.to(cuda), "neg_l": neg_l.to(cuda), "neg_r": neg_r.to(cuda)}
    out = []
    for n_feature, n_slice in ((1, 1), (2, 2)):
        with make_mesh(4, cuda, n_feature, n_slice) as mesh:
            assert mesh.grid == (1, 1, 1) and not mesh.groups
            parts = dist_parts(cfg.replace(feature_shards=n_feature, slice_shards=n_slice), task,
                               mesh)
            before = (spmm_ell.launches, sinkhorn_fused.launches)
            loss = parts.grads(batch)
            torch.cuda.synchronize()
            out.append((loss, {k: p.grad.clone() for k, p in parts.model.named_parameters()},
                        (spmm_ell.launches - before[0], sinkhorn_fused.launches - before[1])))
    (flat_loss, flat_grads, flat_n), (loss, grads, n) = out
    assert n == flat_n == ((8, 41) if recipe == "v7r" else (8, 0))
    assert torch.equal(loss, flat_loss)
    assert set(grads) == set(flat_grads)
    for k, g in grads.items():
        assert torch.equal(g, flat_grads[k]), k


def _stage_sets_agree(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.sort(1).values == want.sort(1).values).all(1).float().mean())


@pytest.mark.gpu
@pytest.mark.parametrize("k", [100, 150])
def test_ring_approx_mining_on_card_matches_the_host(cuda, k):
    """Shortlisted ring mining at ``dwy100k_dist``'s block size (100,000
    candidates over 8 shards: blocks of 12,500), d 256, on one NCCL rank
    against the host: k 100 gives shortlists of 200 (one select-and-rerank
    launch per block), k 150 of 300 (above the kernel's queue: the
    selection tile, ``torch.topk`` and one gather launch per block).  The
    same sets on ≥ 99 % of rows (a near tie may flip: PERF.md §2)."""
    rng = np.random.default_rng(k)
    q = torch.from_numpy(rng.standard_normal((2000, 256)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((100_000, 256)).astype(np.float32))
    ex = torch.from_numpy(rng.integers(0, 100_000, 2000))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        with make_mesh(8, dev) as mesh:
            before = (shortlist_dist.select_launches, shortlist_dist.launches)
            out[dev.type] = ring_knn(q.to(dev), c.to(dev), ex.to(dev), k, mesh,
                                     approx=True).cpu()
            launched = (shortlist_dist.select_launches - before[0],
                        shortlist_dist.launches - before[1])
        if dev.type == "cuda":
            assert launched == ((8, 0) if 2 * k <= shortlist_dist.QUEUE_MAX else (0, 8))
    assert not (out["cuda"] == ex[:, None]).any()
    assert _stage_sets_agree(out["cuda"], out["cpu"]) >= 0.99


@pytest.mark.gpu
def test_ring_approx_eval_on_card_matches_the_host(cuda, approx_k=128, csls_k=10):
    """The shortlisted CSLS ring eval at ``dwy100k_dist``'s block size
    (35,000 test pairs over 8 shards: blocks of 4,375), d 128, shortlists of
    128 (the hubness pair and the ranks: one launch per direction and block
    each), on the card against the host: Hits@k and MRR within 2e-3.  (The
    route above the queue runs in the mining test; the host's plain
    selection at this size takes about a minute.)"""
    rng = np.random.default_rng(approx_k)
    base = rng.standard_normal((35_000, 128)).astype(np.float32)
    emb = torch.from_numpy(np.concatenate(
        [base, base + 0.8 * rng.standard_normal((35_000, 128)).astype(np.float32)]))
    pairs = np.stack([np.arange(35_000), 35_000 + np.arange(35_000)], 1)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        with make_mesh(8, dev) as mesh:
            before = (shortlist_dist.select_launches, shortlist_dist.launches)
            out[dev.type] = ring_hits_at_k(emb.to(dev), pairs, mesh, csls_k=csls_k,
                                           approx_k=approx_k)
            launched = (shortlist_dist.select_launches - before[0],
                        shortlist_dist.launches - before[1])
        if dev.type == "cuda":
            assert launched == ((32, 0) if csls_k else (0, 16))
    for key, v in out["cpu"].items():
        assert out["cuda"][key] == pytest.approx(v, abs=2e-3), key


@pytest.mark.gpu
@pytest.mark.parametrize("option", ["channel", "bf16"])
def test_distributed_option_step_on_the_card_matches_the_host(cuda, option):
    """One distributed step (4 shards, one NCCL rank) with the attribute
    channel (fp32: loss rel 1e-4, each gradient relative L2 1e-4) or in
    bf16 (PERF.md §2's bf16 step limits; gc2.b, 0 by construction, as noise
    under sqrt(n)·2^-8 of the largest entry) against the same step on the
    host."""
    task, _ = _shard_graph()
    over = dict(use_attr_channel=True) if option == "channel" else dict(param_dtype="bfloat16")
    cfg = get_config("base", n_shards=4, dim=128, k_neg=10, **over)
    pairs = torch.as_tensor(task.train_pairs, dtype=torch.int64)
    neg_l, neg_r = sample_uniform_negatives(torch.Generator().manual_seed(0), pairs,
                                            task.kg1.n_ent, task.n_ent, cfg.k_neg)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        batch = {"pairs": pairs.to(dev), "neg_l": neg_l.to(dev), "neg_r": neg_r.to(dev)}
        with make_mesh(4, dev) as mesh:
            parts = dist_parts(cfg, task, mesh)
            before = spmm_ell.launches
            loss = parts.grads(batch)
            out[dev.type] = (loss.item(), {k: p.grad.cpu() for k, p in
                                           parts.model.named_parameters()},
                             spmm_ell.launches - before)
    # the encoder's and the channel's halo layers 8 each, the incidence one
    # launch per shard each way
    assert out["cuda"][2] == (8 + 8 + 8 if option == "channel" else 8)
    host = out["cpu"][1]
    scale = max(float(g.abs().max()) for g in host.values())
    if option == "bf16":
        assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=2 ** -7)
        for k, g in host.items():
            got = out["cuda"][1][k]
            if k == "gc2.b":
                noise = max(float(got.abs().max()), float(g.abs().max()))
                assert noise <= math.sqrt(task.n_ent) * 2 ** -8 * scale
            else:
                assert float((got - g).norm() / g.norm()) < 1e-1, k
        return
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-4)
    for k, g in host.items():
        got = out["cuda"][1][k]
        if k in ("gc2.b", "ae_encoder.gc2.b"):
            assert float(got.abs().max()) < 1e-5 * scale, k
        else:
            assert float((got - g).norm() / g.norm()) < 1e-4, k


@pytest.mark.gpu
def test_distributed_resume_on_the_card(cuda, tmp_path):
    """A ``dwy100k_dist``-shaped run on the card (8 shards, one NCCL rank,
    shortlisted mining) stopped by SIGTERM in the middle of an interval and
    resumed: each loss and the final loss equal the uninterrupted run's bit
    for bit (every sum of the step runs in a fixed order)."""
    task, _ = _shard_graph()
    cfg = get_config("dwy100k_dist", dim=128, k_neg=10, epochs=8, neg_every=3, eval_every=0,
                     neg_approx=True, checkpoint_every=2)
    full = run(cfg, task=task, device=cuda)
    cut = cfg.replace(checkpoint_dir=str(tmp_path / "ck"))
    undo = mp_worker.sigterm_at_call(5)  # epoch 4, the middle of the interval 3-5
    try:
        first = run(cut, task=task, device=cuda)
    finally:
        undo()
    resumed = run(cut, task=task, device=cuda)
    assert first.timings["steps"] == 5 and resumed.timings["start_epoch"] == 5
    assert first.losses + resumed.losses == full.losses
    assert resumed.metrics["final_loss"] == full.metrics["final_loss"]


@pytest.mark.gpu
def test_two_backward_calls_of_the_exchange_are_equal_bit_for_bit(cuda):
    """The exchange at R = 1 (the NCCL self-copy) on 8 shards: its backward
    sums each row's returned slots through the send map's transpose
    (``spmm_ell``, one launch), so two calls are equal bit for bit, and
    equal the host's ``index_add_`` of the same rows within rounding."""
    _, hg = _shard_graph(n_shards=8)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((hg.n_loc * 8, 128)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((8, 8 * hg.halo_b, 128)).astype(np.float32))
    with make_mesh(8, cuda) as mesh:
        op = shard_operator(hg, mesh, "ell", exchange=True)
        grads = []
        for _ in range(2):
            xt = x.to(cuda).requires_grad_()
            before = spmm_ell.launches
            exchange(xt, op).backward(g.to(cuda))
            assert spmm_ell.launches == before + 1
            grads.append(xt.grad.cpu())
        live, rows = op.live.cpu(), op.live_rows.cpu()
    assert torch.equal(grads[0], grads[1])
    back = g.reshape(8, 8, hg.halo_b, 128).transpose(0, 1).reshape(-1, 128)
    want = torch.zeros_like(x).index_add_(0, rows, back.index_select(0, live))
    torch.testing.assert_close(grads[0], want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["ell", "sorted"])
def test_the_one_rank_step_equals_the_exchange_route(cuda, impl):
    """One distributed step at R = 1 (8 shards, the boundary over the
    table's own rows: 8 launches, no exchange) against the same step
    through the exchange (its NCCL self-copy and fixed-order backward: 2
    more ``spmm_ell`` launches) at PERF.md §2's step limits: loss rel 1e-4,
    each gradient relative L2 1e-3 (gc2.b as noise)."""
    task, _ = _shard_graph()
    cfg = get_config("base", n_shards=8, dim=128, k_neg=10, spmm_impl=impl)
    pairs = torch.as_tensor(task.train_pairs, dtype=torch.int64, device=cuda)
    neg_l, neg_r = sample_uniform_negatives(torch.Generator().manual_seed(0), pairs,
                                            task.kg1.n_ent, task.n_ent, cfg.k_neg)
    batch = {"pairs": pairs, "neg_l": neg_l, "neg_r": neg_r}
    out = {}
    with make_mesh(8, cuda) as mesh:
        for route in (False, True):
            parts = dist_parts(cfg, task, mesh, exchange=route)
            assert parts.op.direct == (not route)
            before = (spmm_ell.launches, spmm_mod.launches)
            loss = parts.grads(batch)
            launched = (spmm_ell.launches - before[0], spmm_mod.launches - before[1])
            out[route] = (loss.item(), {k: p.grad.clone() for k, p in
                                        parts.model.named_parameters()}, launched)
    assert out[False][2] == ((8, 0) if impl == "ell" else (0, 8))
    assert out[True][2] == ((10, 0) if impl == "ell" else (2, 8))
    assert out[True][0] == pytest.approx(out[False][0], rel=1e-4)
    scale = max(float(g.abs().max()) for g in out[False][1].values())
    for k, g in out[False][1].items():
        got = out[True][1][k]
        if k == "gc2.b":
            assert float(got.abs().max()) < 1e-5 * scale
        else:
            assert float((got - g).norm() / g.norm()) < 1e-3, k


@pytest.mark.gpu
def test_a_replayed_distributed_interval_equals_its_eager_steps(cuda):
    """One interval of recipe v7r's surface with dropout on 8 shards (one
    NCCL rank): the distributed step captured (``CapturedStep`` with
    ``DistParts.loss_fn`` and ``sum_grads``, a capturable Adam, the mask's
    generator reseeded with ``step_seed``) and replayed against the same
    steps eager with the same Adam, at PERF.md §2's replay limits: each
    loss rel 1e-6, the parameters relative L2 1e-6."""
    task, _ = _shard_graph()
    cfg = get_config("dwy100k_dist", **RECIPES["v7r"]).replace(
        n_shards=8, dim=128, k_neg=10, boot_cap=200, sinkhorn_pairs=512, dropout=0.3)
    batch = mp_worker.surface_batch(cfg, task, device=cuda)
    steps = cfg.neg_every
    with make_mesh(8, cuda) as mesh:
        parts = dist_parts(cfg, task, mesh)
        init = {k: v.detach().clone() for k, v in parts.model.state_dict().items()}
        opt, sched = make_optimizer(cfg, parts.model.parameters(), capturable=True)
        want = []
        for e in range(steps):
            want.append(train_step(opt, parts.loss_fn, batch, step_generator(cfg, e, cuda),
                                   parts.sum_grads)[0].item())
            sched.step()
        want_p = {k: v.detach().clone() for k, v in parts.model.state_dict().items()}
        parts.model.load_state_dict(init)
        opt, sched = make_optimizer(cfg, parts.model.parameters(), capturable=True)
        cap = CapturedStep(opt, parts.loss_fn, batch, cuda, True, after_backward=parts.sum_grads)
        got = []
        for e in range(steps):
            got.append(cap.replay(step_seed(cfg, e)).item())
            sched.step()
        for k, v in want_p.items():
            assert float((parts.model.state_dict()[k] - v).norm() / v.norm()) < 1e-6, k
    for g, w in zip(got, want):
        assert g == pytest.approx(w, rel=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["ell", "sorted"])
def test_the_grouped_halo_spmm_by_both_routes(cuda, impl):
    """The grouped layout (``halo_grouped``) at a remap that moves KG2 (999
    entities a KG, 8 shards in two groups: r0 = 1,000) on the card: the halo
    SpMM over the rank's grouped operators, its boundary read from x's rows
    and through the exchange (the NCCL self-copy of the grouped send
    lists), equals the host's plain result of the same route (rtol 1e-5,
    atol 1e-5; the gradient 1e-4), the two routes' forwards equal bit for
    bit, the padding rows' gradient 0."""
    task = synthetic_align_task(seed=6, n_ent=999, n_rel=10, n_triples=6000)
    src, dst, w = coo_from_triples(task.n_ent, task.merged_triples, n_rel=task.n_rel)
    w = coo_normalize(src, dst, w, task.n_ent)
    n1, r0 = task.kg1.n_ent, 1000
    src, dst = (np.where(a < n1, a, a - n1 + r0) for a in (src, dst))
    hg = partition_edges(src, dst, w, 2 * r0, 8, n_groups=2)
    rng = np.random.default_rng(12)
    x = np.zeros((hg.n_loc * 8, 64), np.float32)
    x[:n1] = rng.standard_normal((n1, 64))
    x[r0:r0 + n1] = rng.standard_normal((n1, 64))
    g = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    fn = halo_spmm_ell if impl == "ell" else halo_spmm
    out = {}
    for dev in (torch.device("cpu"), cuda):
        with make_mesh(8, dev, halo_grouped=True) as mesh:
            for route in (False, True):
                op = shard_operator(hg, mesh, impl, exchange=route)
                xt = torch.from_numpy(x).to(dev).requires_grad_()
                y = fn(xt, op)
                y.backward(g.to(dev))
                out[dev.type, route] = (y.detach().cpu(), xt.grad.cpu())
    for route in (False, True):
        (got, got_g), (want, want_g) = out["cuda", route], out["cpu", route]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got_g, want_g, rtol=1e-4, atol=1e-4)
        assert not got_g[n1:r0].any() and not got_g[r0 + n1:].any()
    assert torch.equal(out["cuda", False][0], out["cuda", True][0])


@pytest.mark.gpu
@pytest.mark.parametrize("trainer", ["fit", "fit_mtl"])
def test_single_device_trainer_on_a_sharded_config(cuda, trainer):
    """``fit`` (d 128, the (128, 128) fused layer) and ``fit_mtl`` (recipe
    v7r at d 256, the OT head on 128 pairs) on config ``dwy100k_dist`` at
    2,000 entities, called directly: one device over the whole graph, two
    ``gcn_fused`` launches per forward and two ``spmm_ell`` per step, the
    loss finite and falling in each interval, the final loss within rel
    1e-4 of the same run unsharded (PERF.md §2: single-device runs on the
    card)."""
    task = synthetic_align_task(seed=2, n_ent=2000, n_rel=20, n_triples=8000, n_attr=40,
                                attrs_per_ent=3)
    if trainer == "fit":
        fn, cfg = fit, get_config("dwy100k_dist", k_neg=10, epochs=6, neg_every=3,
                                  eval_every=0)
    else:
        fn = fit_mtl
        cfg = get_config("dwy100k_dist", **RECIPES["v7r"]).replace(
            k_neg=10, epochs=4, boot_start=2, boot_cap=100, eval_every=0, sinkhorn_pairs=128)
    before = (gcn_fused.launches, spmm_ell.launches)
    res = fn(cfg, task=task, device=cuda)
    t = res.timings
    assert (gcn_fused.launches - before[0], spmm_ell.launches - before[1]) == (
        2 * (t["steps"] + t["forwards"] + t["evals"]), 2 * t["steps"])
    assert res.op.fwd.device.type == cuda.type
    assert getattr(res.model, "encoder", res.model).gc1.w.shape[0] == cfg.dim
    losses, nb = res.losses, cfg.neg_every
    assert np.isfinite(losses).all() and all(
        losses[i + nb - 1] < losses[i] for i in range(0, cfg.epochs, nb))
    plain = fn(cfg.replace(n_shards=1), task=task, device=cuda)
    assert res.metrics["final_loss"] == pytest.approx(plain.metrics["final_loss"], rel=1e-4)


def _layer_float64(op, x, wm, b):
    """(A·x)·W + b in float64 on x's device, from the ELL buckets."""
    y = op.diag.double()[:, None] * x.double()
    for bk in op.fwd.buckets:
        y.index_add_(0, bk.rows.long(),
                     (bk.w.double()[..., None] * x.double()[bk.idx.long()]).sum(1))
    return y @ wm.double() + b.double()


@pytest.mark.gpu
def test_gcn_fused_128_fp32_error_against_float64(cuda):
    """The fp32 (128, 128) instance on an operator with a hub row of K
    5,300: its relative L2 error against the float64 layer is at most the
    (256, 128) instance's on the same rows and the same layer (x widened by
    128 random columns that W's 128 zero rows drop), as both sum each group
    of 16 k's outside the tensor cores' accumulator."""
    rng = np.random.default_rng(21)
    op = _hub_graph(rng, HUB_DEGREES["hub_5300"]).to(cuda)
    x = torch.from_numpy(rng.standard_normal((op.n_rows, 256)).astype(np.float32)).to(cuda)
    wm = torch.from_numpy((rng.standard_normal((128, 128)) / np.sqrt(128))
                          .astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.standard_normal(128).astype(np.float32)).to(cuda)
    x128 = x[:, :128].contiguous()
    want = _layer_float64(op, x128, wm, b)
    err = {}
    for d_in, xi, wi in ((128, x128, wm), (256, x, torch.cat([wm, torch.zeros_like(wm)]))):
        got = fused_gcn_layer(op.fwd, op.diag, xi, wi, b)
        err[d_in] = float((got.double() - want).norm() / want.norm())
    assert err[128] <= err[256] < 1e-6, err


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["cityblock", "sqeuclidean"])
def test_sddmm_pairs_on_the_card(cuda, metric):
    rng = np.random.default_rng(4)
    emb = torch.from_numpy(rng.standard_normal((5000, 128)).astype(np.float32))
    rows, cols = (torch.from_numpy(rng.integers(0, 5000, 20000)) for _ in range(2))
    want = sddmm_pairs(emb, rows, cols, metric)
    got = sddmm_pairs(emb.to(cuda), rows.to(cuda), cols.to(cuda), metric)
    assert got.device.type == cuda.type
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=0)


# ---- the training step's loss kernels: the L1 margin and the OT reverse update

def _margin_case(rng, n: int, s: int, k: int, d: int, weighted: bool, dev, gamma: float = 3.0,
                 margin_of_flip: float = 1e-4):
    """A table (N, d), pairs from the two halves and k negatives a side,
    with some rows repeated (a negative that is a pair row, an entity in
    two pairs) and a few pool-of-one ties; a negative whose hinge lies
    within ``margin_of_flip`` of its threshold (float64) is moved to the
    pair's partner, so the sums' order flips no hinge."""
    emb = (rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)
    half = n // 2
    pairs = np.stack([rng.integers(0, half, s), rng.integers(half, n, s)], 1)
    pairs[1] = pairs[0]
    neg_l, neg_r = rng.integers(0, half, (s, k)), rng.integers(half, n, (s, k))
    neg_r[: s // 50, 0] = pairs[: s // 50, 1]
    neg_l[2, :] = pairs[3, 0]
    neg_r[:, 1] = half  # a hub row that every pair's right side reaches
    e64 = emb.astype(np.float64)
    d_pos = np.abs(e64[pairs[:, 0]] - e64[pairs[:, 1]]).sum(1)[:, None]
    for neg, own, part in ((neg_r, 0, 1), (neg_l, 1, 0)):
        for j0 in range(0, k, 16):  # blocks of negatives keep the float64 temporaries small
            nb = neg[:, j0:j0 + 16]
            h = d_pos + gamma - np.abs(e64[pairs[:, own]][:, None] - e64[nb]).sum(2)
            near = np.abs(h) < margin_of_flip
            nb[near] = np.broadcast_to(pairs[:, part:part + 1], nb.shape)[near]
    w = rng.uniform(0.0, 2.0, s).astype(np.float32) if weighted else None
    t = [torch.from_numpy(a).to(dev) for a in (emb, pairs, neg_l, neg_r)]
    return (*t, None if w is None else torch.from_numpy(w).to(dev))


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-300))


@pytest.mark.gpu
@pytest.mark.parametrize("n, s, k, d, weighted", [
    (300, 64, 5, 128, False), (300, 64, 5, 256, True), (200, 40, 7, 16, True),
    (200, 40, 3, 64, False), (200, 40, 9, 512, True), (38_000, 7_000, 100, 256, True),
    (200, 40, 7, 1, True), (300, 64, 5, 50, False), (300, 64, 5, 300, True),
    (300, 64, 5, 384, False), (200, 40, 9, 500, True), (38_000, 7_000, 100, 384, True),
    (300, 64, 5, 520, True), (200, 40, 37, 1030, False), (38_000, 7_000, 100, 768, True)])
def test_margin_l1_kernel_matches_plain(cuda, n, s, k, d, weighted):
    """The loss at rel 1e-5 and the table's gradient at relative L2 1e-5
    against the plain composite, every row written (the output's memory
    prefilled with NaN), two calls bit for bit; the last case is recipe
    v6's zh-en step (7,000 pairs with proposals, k 100, d 256)."""
    emb, pairs, neg_l, neg_r, w = _margin_case(np.random.default_rng(d + k), n, s, k, d,
                                               weighted, cuda)
    e = emb.clone().requires_grad_(True)
    want = margin_l1.margin_loss_plain(e, pairs, neg_l, neg_r, 3.0, w)
    (g_want,) = torch.autograd.grad(want, e)
    got, grads = [], []
    for _ in range(2):
        torch.full((n, d), float("nan"), device=cuda)  # the next (n, d) output lands on NaNs
        before = margin_l1.launches
        loss = margin_l1.margin_l1_loss(e, pairs, neg_l, neg_r, 3.0, w)
        (g,) = torch.autograd.grad(loss, e)
        torch.cuda.synchronize()
        assert margin_l1.launches == before + 2
        got.append(loss)
        grads.append(g)
    assert torch.isfinite(grads[0]).all()
    assert float(got[0]) == pytest.approx(float(want), rel=1e-5)
    assert _rel_l2(grads[0], g_want) < 1e-5
    assert torch.equal(got[0], got[1]) and torch.equal(grads[0], grads[1])


@pytest.mark.gpu
def test_margin_l1_captured_replay_equals_eager(cuda):
    emb, pairs, neg_l, neg_r, w = _margin_case(np.random.default_rng(5), 500, 120, 10, 128,
                                               True, cuda)
    e = emb.clone().requires_grad_(True)

    def call():
        loss = margin_l1.margin_l1_loss(e, pairs, neg_l, neg_r, 3.0, w)
        return loss.detach(), torch.autograd.grad(loss, e)[0]

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        want = call()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = call()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])


@pytest.mark.gpu
def test_margin_l1_refuses_what_it_has_no_instance_for(cuda):
    emb, pairs, neg_l, neg_r, _ = _margin_case(np.random.default_rng(6), 100, 20, 3, 128,
                                               False, cuda)
    with pytest.raises(ValueError, match="float32"):
        margin_l1.margin_l1_loss(emb.double(), pairs, neg_l, neg_r)
    # d = 100 runs on the masked instance of 128: against the plain version
    e = emb[:, :100].contiguous().requires_grad_(True)
    got = margin_l1.margin_l1_loss(e, pairs, neg_l, neg_r)
    want = margin_l1.margin_loss_plain(e, pairs, neg_l, neg_r)
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    assert _rel_l2(torch.autograd.grad(got, e)[0], torch.autograd.grad(want, e)[0]) < 1e-5
    # above 512 the slab kernels: 520 (two slabs, the second 8 wide) against the plain version
    e = emb.repeat(1, 5)[:, :520].contiguous().requires_grad_(True)
    got = margin_l1.margin_l1_loss(e, pairs, neg_l, neg_r)
    want = margin_l1.margin_loss_plain(e, pairs, neg_l, neg_r)
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    assert _rel_l2(torch.autograd.grad(got, e)[0], torch.autograd.grad(want, e)[0]) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("n, s, k, d, weighted", [
    (300, 64, 5, 128, False), (38_000, 7_000, 100, 256, True), (300, 64, 5, 50, True),
    (300, 64, 5, 300, False), (300, 64, 5, 384, True), (300, 64, 5, 600, True),
    (200, 40, 37, 1030, False)])
def test_margin_l1_planes_and_backward_match_their_plain_versions(cuda, n, s, k, d, weighted):
    """The forward's flags, pair vectors and the active records' sign
    planes equal ``forward_plain``'s bit for bit; the index its kernel
    entries build equals ``build_index_plain``'s; the backward from them,
    with the batch's index, within relative L2 1e-6 of ``backward_plain``
    on the same planes, run on the card (its sums by atomics in another
    order; the gradient's memory prefilled with NaN), two
    launches bit for bit; the gather-only entry within rel 1e-5 of its
    plain version; the last case is recipe v6's zh-en shape."""
    emb, pairs, neg_l, neg_r, w = _margin_case(np.random.default_rng(d + k + 1), n, s, k, d,
                                               weighted, cuda)
    loss, flags, denom, planes, vecs = margin_l1._forward_cuda(emb, pairs, neg_l, neg_r, 3.0, w)
    p_loss, p_flags, _, p_planes, p_vecs = margin_l1.forward_plain(emb, pairs, neg_l, neg_r,
                                                                   3.0, w)
    assert torch.equal(flags, p_flags) and torch.equal(vecs, p_vecs)
    act = torch.cat([(p_flags & 1).reshape(-1), (p_flags & 2).reshape(-1)]).bool()
    assert torch.equal(planes[act], p_planes[act])
    assert float(loss) == pytest.approx(float(p_loss), rel=1e-5)
    index = margin_l1.build_index(pairs, neg_l, neg_r, n)  # the kernel's index entries
    assert torch.equal(index, margin_l1.build_index_plain(pairs, neg_l, neg_r, n))
    grad = torch.tensor(0.75, device=cuda)
    outs = []
    for _ in range(2):
        torch.full((n, d), float("nan"), device=cuda)  # the gradient lands on NaNs
        before = margin_l1.launches
        outs.append(margin_l1._backward_cuda(w, flags, denom, planes, vecs, index, grad, n))
        torch.cuda.synchronize()
        assert margin_l1.launches == before + 1
    want = margin_l1.backward_plain(w, flags, denom, planes, vecs, index, grad, n)
    assert torch.isfinite(outs[0]).all() and torch.equal(outs[0], outs[1])
    assert _rel_l2(outs[0], want) < 1e-6
    got = margin_l1.gather_rows_sum(emb, neg_l, neg_r)
    torch.testing.assert_close(got, margin_l1.gather_rows_sum_plain(emb, neg_l, neg_r),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.gpu
def test_margin_l1_captured_replay_after_a_reload(cuda):
    """A captured loss and gradient over static negatives and index buffers
    equal eager, and after the buffers are reloaded with a second batch's
    negatives and index (as ``CapturedStep.load`` does) equal that batch's
    eager call: nothing of the first batch is kept by address."""
    emb, pairs, neg_l, neg_r, w = _margin_case(np.random.default_rng(8), 600, 150, 12, 256,
                                               True, cuda)
    _, _, neg_l2, neg_r2, _ = _margin_case(np.random.default_rng(9), 600, 150, 12, 256, True,
                                           cuda)
    e = emb.clone().requires_grad_(True)
    static = [neg_l.clone(), neg_r.clone(), margin_l1.build_index(pairs, neg_l, neg_r, 600)]

    def call(nl, nr, index):
        loss = margin_l1.margin_l1_loss(e, pairs, nl, nr, 3.0, w, index=index)
        return loss.detach(), torch.autograd.grad(loss, e)[0]

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        want = call(*static)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = call(*static)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
    second = (neg_l2, neg_r2, margin_l1.build_index(pairs, neg_l2, neg_r2, 600))
    want2 = call(*second)
    assert not torch.equal(want2[1], want[1])
    for buf, src in zip(static, second):
        buf.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[0], want2[0]) and torch.equal(out[1], want2[1])


@pytest.mark.gpu
def test_margin_step_takes_its_index_from_the_batch(cuda):
    """One training step of config base on ``loop.first_batch`` (which
    carries the margin's index): the margin launches twice and builds no
    index; the batch without its index builds one, with the same loss and
    gradients bit for bit."""
    cfg = get_config("base", syn_n_ent=600, dim=128, k_neg=10)
    task = synthetic_align_task(seed=3, n_ent=1200, n_rel=20, n_triples=5000)
    parts = step_parts(cfg, task, cuda)
    batch = first_batch(cfg, task, parts, cuda)
    assert batch["margin_index"].dtype == torch.int32

    def step(b):
        parts.model.zero_grad(set_to_none=True)
        loss, _ = parts.loss_fn(b, None)
        loss.backward()
        torch.cuda.synchronize()
        return loss.detach(), [p.grad.clone() for p in parts.model.parameters()]

    launches, builds = margin_l1.launches, margin_l1.index_builds
    got = step(batch)
    assert margin_l1.launches == launches + 2 and margin_l1.index_builds == builds
    want = step({k: v for k, v in batch.items() if k != "margin_index"})
    assert margin_l1.index_builds == builds + 1
    assert torch.equal(got[0], want[0]) and all(map(torch.equal, got[1], want[1]))


def _reverse_case(rng, q: int, c: int, rows: bool, dev, offset: int = 0, extra: int = 0,
                  tau: float = 0.05):
    """A (q, c) column block at column ``offset`` of (q, c + extra) cost and
    C̄ matrices, b, the saved LSE and ō of a potential update on unit rows."""
    width = c + extra
    l = rng.standard_normal((q, 64))
    r = rng.standard_normal((width, 64))
    l /= np.linalg.norm(l, axis=1, keepdims=True)
    r /= np.linalg.norm(r, axis=1, keepdims=True)
    cost = np.maximum(2.0 - 2.0 * l @ r.T, 0.0)  # the sqeuclidean cost of unit rows
    cbar = rng.standard_normal((q, width)) * 1e-3
    n_b, n_o = (c, q) if rows else (q, c)
    b = rng.standard_normal(n_b) * 0.1
    blk = cost[:, offset:offset + c]
    z = (b[None, :] - blk) / tau if rows else (b[:, None] - blk) / tau
    lse = np.log(np.exp(z - z.max(1 if rows else 0, keepdims=True)).sum(1 if rows else 0)) + (
        z.max(1 if rows else 0))
    ob = rng.standard_normal(n_o) / n_o
    t = [torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dev)
         for a in (cost, cbar, b, lse, ob)]
    return t[0][:, offset:offset + c], t[1][:, offset:offset + c], t[1], *t[2:]


@pytest.mark.gpu
@pytest.mark.parametrize("q, c, offset, extra", [(70, 300, 0, 0), (70, 300, 37, 80),
                                                 (4500, 4500, 0, 0), (4096, 4096, 0, 0)])
@pytest.mark.parametrize("rows", [True, False])
def test_sinkhorn_reverse_kernel_matches_plain(cuda, q, c, offset, extra, rows):
    """C̄ and b̄ at relative L2 1e-5 against the plain version, on whole
    blocks and a strided column block (the rest of C̄ untouched), b̄'s
    memory prefilled with NaN; two calls from the same C̄ bit for bit."""
    cost, cbar, whole, b, lse, ob = _reverse_case(np.random.default_rng(q + offset), q, c,
                                                  rows, cuda, offset, extra)
    before = whole.clone()
    want_c = whole.clone()
    want_b = sinkhorn_fused.sinkhorn_reverse_plain(want_c[:, offset:offset + c], cost, b, lse,
                                                   ob, 0.05, rows)
    outs = []
    for _ in range(2):
        whole.copy_(before)
        torch.full((q if not rows else c,), float("nan"), device=cuda)
        n0 = sinkhorn_fused.reverse_launches
        got_b = sinkhorn_fused.sinkhorn_reverse(cbar, cost, b, lse, ob, 0.05, rows)
        torch.cuda.synchronize()
        assert sinkhorn_fused.reverse_launches == n0 + 1
        outs.append((got_b, whole.clone()))
    got_b, got_c = outs[0]
    assert torch.isfinite(got_b).all()
    assert _rel_l2(got_c, want_c) < 1e-5 and _rel_l2(got_b, want_b) < 1e-5
    outside = torch.ones_like(before, dtype=torch.bool)
    outside[:, offset:offset + c] = False
    assert torch.equal(got_c[outside], before[outside])
    assert torch.equal(outs[1][0], got_b) and torch.equal(outs[1][1], got_c)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [True, False])
def test_sinkhorn_reverse_captured_replay_equals_eager(cuda, rows):
    cost, cbar, whole, b, lse, ob = _reverse_case(np.random.default_rng(9), 300, 260, rows,
                                                  cuda)
    start = whole.clone()

    def call():
        whole.copy_(start)
        return sinkhorn_fused.sinkhorn_reverse(cbar, cost, b, lse, ob, 0.05, rows)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        want_b = call()
        want_c = whole.clone()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = call()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want_b) and torch.equal(whole, want_c)


@pytest.mark.gpu
@pytest.mark.parametrize("s, d", [(4500, 256), (4500, 128)])
def test_ot_loss_gradient_on_the_reverse_kernel_matches_plain(cuda, s, d):
    """The OT head's loss and gradient, the reverse sweep on the kernel
    (41 launches), against the plain version differentiated by autograd:
    loss rel 1e-4, gradient relative L2 1e-3 (PERF.md §2's step limits)."""
    rng = np.random.default_rng(s + d)
    emb = torch.from_numpy(rng.standard_normal((2 * s, d)).astype(np.float32)).to(cuda)
    pairs = torch.stack([torch.arange(s), torch.arange(s, 2 * s)], 1).to(cuda)
    e = emb.clone().requires_grad_(True)
    n0 = sinkhorn_fused.reverse_launches
    loss = sinkhorn_align_loss(e, pairs, tau=0.05, n_iters=20)
    (g,) = torch.autograd.grad(loss, e)
    torch.cuda.synchronize()
    assert sinkhorn_fused.reverse_launches == n0 + 41
    e2 = emb.clone().requires_grad_(True)
    want = sinkhorn_align_loss_plain(e2, pairs, tau=0.05, n_iters=20)
    (g_want,) = torch.autograd.grad(want, e2)
    assert float(loss) == pytest.approx(float(want), rel=1e-4)
    assert _rel_l2(g, g_want) < 1e-3


# Every width the JAX package takes, up to 512: the kernels' panel and
# masked paths, the GCN layer's route at widths without a fused instance,
# and the pins of the widths that had instances before.

# (d, dtype) of the SpMM kernels' panel path: d % 4 ≠ 0 in fp32 (1, 50:
# scalar loads), the sweeps' 384 and 512, and bf16 at 50, 300 (300 % 8 = 4)
# and 384
PANEL_CASES = [(1, torch.float32), (50, torch.float32), (300, torch.float32),
               (384, torch.float32), (512, torch.float32), (50, torch.bfloat16),
               (300, torch.bfloat16), (384, torch.bfloat16)]
SPMM_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
            torch.bfloat16: dict(rtol=2 ** -7, atol=1e-3)}


def _spmm_route(kind: str, rng, cuda):
    """(operator matrices, the wrapper, its plain version, its module) of
    the ELL or sorted SpMM on a graph with rows of 5,300 and 300 edges."""
    if kind == "ell":
        op = _hub_graph(rng, HUB_DEGREES["hub_5300"]).to(cuda)
        return ((op.fwd, op.bwd), lambda m, x: ell_spmm(m, op.diag, x),
                lambda m, x: apply_with_diag(m, op.diag, x), spmm_ell)
    op = _sorted_graph(rng, hubs=(5300, 300)).to(cuda)
    return (op.fwd, op.bwd), sorted_spmm, segment_spmm, spmm_mod


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["ell", "sorted"])
@pytest.mark.parametrize("d,dtype", PANEL_CASES)
def test_spmm_kernels_at_every_width_match_plain(cuda, kind, d, dtype):
    """The panel path (128-column panels over the grid, the last masked at
    d; rows cut into segments whose partials are summed per panel) over A
    and Aᵀ: against the plain version (fp32 1e-4; bf16, one rounding of
    fp32 sums on both sides: rel 2^-7, atol 1e-3), every row written (the
    output's memory prefilled with NaN), two launches bit for bit.  The
    ELL kernel in bf16 is held, as its instances are, within half a bf16
    ulp of the fp32 plain sums of the same input (rel 2^-8, atol 1e-3)."""
    rng = np.random.default_rng(d + 1000 * (dtype == torch.bfloat16))
    mats, call, plain, mod = _spmm_route(kind, rng, cuda)
    if kind == "ell" and dtype == torch.bfloat16:  # its bf16 plain version rounds twice
        tol, ref = dict(rtol=2 ** -8, atol=1e-3), torch.float32
    else:
        tol, ref = SPMM_TOL[dtype], dtype
    for m in mats:
        x = torch.from_numpy(rng.standard_normal((m.n_cols, d)).astype(np.float32))
        x = x.to(cuda, dtype)
        outs = []
        for _ in range(2):
            torch.full((m.n_rows, d), float("nan"), dtype=dtype, device=cuda)  # lands on NaNs
            before = mod.launches
            outs.append(call(m, x))
            torch.cuda.synchronize()
            assert mod.launches == before + 1
        assert outs[0].dtype == dtype and outs[0].shape == (m.n_rows, d)
        assert torch.isfinite(outs[0]).all() and torch.equal(outs[0], outs[1])
        torch.testing.assert_close(outs[0].float(), plain(m, x.to(ref)).float(), **tol)


def _replays_as_eager(call) -> None:
    """``call()`` (a tuple of tensors) captured in a CUDA graph: two
    replays equal the eager call bit for bit."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        want = call()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = call()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, want):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_kernels_at_d384_replay_as_eager(cuda):
    """The ELL and sorted SpMMs (fp32 and bf16), the margin's forward and
    backward and the Sinkhorn update (strip streamed) at d = 384, each
    captured in a CUDA graph: its replays equal eager bit for bit."""
    rng = np.random.default_rng(384)
    for kind in ("ell", "sorted"):
        mats, call, _, _ = _spmm_route(kind, rng, cuda)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.standard_normal((mats[0].n_cols, 384)).astype(np.float32))
            x = x.to(cuda, dtype)
            _replays_as_eager(lambda: (call(mats[0], x), call(mats[1], x)))
    emb, pairs, neg_l, neg_r, w = _margin_case(rng, 3000, 600, 20, 384, True, cuda)
    e = emb.clone().requires_grad_(True)

    def margin():
        loss = margin_l1.margin_l1_loss(e, pairs, neg_l, neg_r, 3.0, w)
        return loss.detach(), torch.autograd.grad(loss, e)[0]

    _replays_as_eager(margin)
    l = torch.nn.functional.normalize(torch.randn(1000, 384, device=cuda), dim=1)
    r = torch.nn.functional.normalize(torch.randn(1200, 384, device=cuda), dim=1)
    g = 0.2 * torch.randn(1200, device=cuda)
    log_mu = torch.full((1000,), -math.log(1000), device=cuda)
    _replays_as_eager(lambda: (sinkhorn_potential_update(l, r, g, log_mu, 0.05),))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_in,d_out", [(300, 50), (64, 128), (384, 384), (512, 128)])
def test_gcn_layer_at_widths_without_a_fused_instance(cuda, dtype, d_in, d_out):
    """x·W then the ELL SpMM kernel (one launch forward, one backward over
    the transpose, no fused launch), against ``gcn_layer_plain``
    differentiated by autograd: the output at ``TOL`` and each gradient at
    relative L2 1e-4 (fp32) or 2e-2 (bf16: the plain version rounds the
    bucket sums and the diagonal term apart)."""
    assert not gcn_fused.fused_width(d_in, d_out)
    rng = np.random.default_rng(d_in + d_out)
    op = _graph(rng).to(cuda)
    x = torch.from_numpy(rng.standard_normal((op.n_rows, d_in)).astype(np.float32))
    wm = torch.from_numpy((rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(d_out).astype(np.float32)).to(cuda)
    cot = torch.from_numpy(rng.standard_normal((op.n_rows, d_out)).astype(np.float32))
    cot = cot.to(cuda, dtype)
    grads = []
    for layer in (gcn_layer, gcn_fused.gcn_layer_plain):
        xt = x.to(cuda, dtype).requires_grad_(True)
        wt = wm.to(cuda, dtype).requires_grad_(True)
        bt = b.clone().requires_grad_(True)
        before = (gcn_fused.launches, spmm_ell.launches)
        out = layer(op, xt, wt, bt)
        (out * cot).sum().backward()
        torch.cuda.synchronize()
        launched = (gcn_fused.launches - before[0], spmm_ell.launches - before[1])
        assert launched == ((0, 2) if layer is gcn_layer else (0, 0))
        grads.append((out.detach(), xt.grad, wt.grad, bt.grad))
    got, want = grads
    assert got[0].dtype == dtype and got[0].shape == (op.n_rows, d_out)
    torch.testing.assert_close(got[0].float(), want[0].float(), **TOL[dtype])
    for a, b_ in zip(got[1:], want[1:]):
        assert _rel_l2(a.float(), b_.float()) < (1e-4 if dtype == torch.float32 else 2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [3, 50])
def test_search_kernels_at_widths_of_no_multiple_of_4(cuda, d):
    """The L1 search's top-k and count and the select-and-rerank kernel
    (fp32 and bf16 products) at d % 4 ≠ 0: the wrappers give the kernels
    rows with zero columns (to 4 or 8), and the answers are the plain
    versions' on the unpadded rows: the top-k as ``_l1_agrees`` holds it,
    each count exact at a threshold halfway between the plain version's
    fourth and fifth distances, the select's shortlists on ≥ 99 % of the
    entries and the reranked distances within 1e-5."""
    rng = np.random.default_rng(d)
    q, cands, kw = _l1_case(rng, 300, 2000, d, True, True)
    got = l1_search.l1_topk(q.to(cuda), cands.to(cuda), 10, **_on(cuda, kw))
    _l1_agrees(got, l1_search.l1_topk_plain(q, cands, 10, **kw), kw, True)
    raw = l1_search.l1_topk_plain(q, cands, 5)[0]
    thresh = (0.5 * (raw[:, 3] + raw[:, 4])).contiguous()
    count = l1_search.l1_count(q.to(cuda), cands.to(cuda), thresh.to(cuda))
    assert torch.equal(count.cpu(), torch.full((300,), 4))
    for bf16 in (False, True):
        got = shortlist_dist.shortlist_select(q.to(cuda), cands.to(cuda), 16, bf16=bf16,
                                              rerank="cityblock")
        want = shortlist_dist.shortlist_select_plain(q, cands, 16, bf16=bf16,
                                                     rerank="cityblock")
        assert float((got[0].cpu() == want[0]).float().mean()) > 0.99
        torch.testing.assert_close(got[2].cpu().sort(1).values, want[2].sort(1).values,
                                   rtol=1e-5, atol=1e-5)


# SHA-256 of each kernel's output on ``scripts/width_pins.py``'s inputs at
# the widths that had instances before every width up to 512 did, as the
# commit d43e3b5, the last before them, computed it on an NVIDIA H100 80GB
# HBM3 (``scripts/width_pins.py --root``)
WIDTH_PINS = {
    "margin_l1 grad d128": "6e0c359d050ba079b4f98f4a7c91ae78d437cbcc6936cfbef586b33fdf7b7220",
    "margin_l1 grad d16": "20f1fe471ad63d08c186ecccb7a6b726a0b5f47b6ebcb74d63c8f070e6e1ca15",
    "margin_l1 grad d256": "0595f5451d7f2cab6d8f415fd587bdbb4a10812236c6eca02a88bc7dbd53ef8e",
    "margin_l1 grad d32": "3e5a71009dbe2ed07327d431a742caf83b2b70d576fb2ddfe43abed79dc78fed",
    "margin_l1 grad d512": "3117c118b10362cb012fbd7a8dc20a43651aab16f2a2e2d50e9265840e7b4523",
    "margin_l1 grad d64": "e721ff56cfc9f52e8b3991443e31767de9bc5c2d632c78d15b8f4e8fb4cb05e2",
    "margin_l1 loss d128": "c2ce27993758ef4ca979e370a3ec1ff5812bf67a122380afcb5ad6c4fa54f52a",
    "margin_l1 loss d16": "be771050e7a2f223fc1a21188c664d20545ea4c1f403bd6fa77843eb6a0d15ba",
    "margin_l1 loss d256": "bfe9da13aa8d11df72ba38343ed94dadc8ef55d021ef0542919661c0d1aa92c9",
    "margin_l1 loss d32": "45ebe3e204bbc208da7ba2d4b225b16c87e21151f416b8655a4e839936b39581",
    "margin_l1 loss d512": "942426c6cb7c6f88d6f992a289aa1268f652f96f21849f5d002ac9a19d814bc5",
    "margin_l1 loss d64": "72d73fbe9907cfc139dcd4653507db815598a3a6df1e21b780e0b7ab5eb994b8",
    "sinkhorn_fused d128 tau0.05":
        "a617742ce7fb8121647210602d645a07e63d63bab8b69cf4beceea69b6375625",
    "sinkhorn_fused d128 tau0.3":
        "158de00fc0833bbfdf02c270dfc702314a89a9db44109915fb1076737596b3c6",
    "sinkhorn_fused d16 tau0.05":
        "c9fe19b50c0f461a6da1dff52665cc17695ee29f01a5703261b8b5fcd56feeff",
    "sinkhorn_fused d16 tau0.3": "212a2b3f281fa6f4d40401f9cee43b0ee7231e412e7397e5a1de215f23d2fca3",
    "sinkhorn_fused d192 tau0.05":
        "20aef3e142e3e1c9da5645e9b9a36c367be1e268dce68fe920f593acffc30bfe",
    "sinkhorn_fused d192 tau0.3":
        "a7f25a9dc4f931822a3ca57b788dd94796053e10ff4df722aac85e7b6cf57143",
    "sinkhorn_fused d256 tau0.05":
        "ec670dafdfb47f6df1791758ecaedaa672e4635c2c6e39e09cb4c9b19aefb939",
    "sinkhorn_fused d256 tau0.3":
        "3e05d716faa1277ebe69b00e5e0146e9549dc24cba5cd491ac53e2dbbbe30d99",
    "sinkhorn_fused d4 tau0.05": "42927ec2250d1497d28291068b0a49e75db79a046a14dfe644f1d3d3cd5208ce",
    "sinkhorn_fused d4 tau0.3": "96bba16d80eefa6ad5a91dd42ceda109e2c652a6ce070886a439535ff652fa4e",
    "spmm_ell bwd d128 bfloat16":
        "c54a6f425864bc02d2fa2922fc61a7df1d79808fe4a902fc7ca399dafc16c4dc",
    "spmm_ell bwd d128 float32": "4c6dfb43c15c95adbbcd9c3761c1c2455f604bd17219c17c7df77f0b5d19422c",
    "spmm_ell bwd d256 bfloat16":
        "79106ca3ba26fdf86b4c8fe55ecd7ea2d9d36d7431948383c106bdc61b7d7208",
    "spmm_ell bwd d256 float32": "71750586f0930d8f6ec0079492108a5b2c9ef9d4f11f88e4f330176908f1c2b9",
    "spmm_ell bwd d64 bfloat16": "b8cf5ceaf40822b338f0965ec122f75276457599f0cafe4b35bdb27104e9165f",
    "spmm_ell bwd d64 float32": "c87c06305c1ebbed47f9f5571dad8078a2e8ed993da7ef61d33bf08b81f63546",
    "spmm_ell fwd d128 bfloat16":
        "0b1d1f18f8709ea469b9c8d82dd72e970e693c94dea9c1615e271b4c559e0c61",
    "spmm_ell fwd d128 float32": "23b99936ed5c483565cab00ec2300288294cb622f99468994ee2326cfe3c40bd",
    "spmm_ell fwd d256 bfloat16":
        "c5fbe09be5d79f4351e29ea2e356dd8a942315b2983749550f13e185b5259d73",
    "spmm_ell fwd d256 float32": "570398247c35273a62205441018d8d4dd3fcc000c63aa85f62a7654510167aad",
    "spmm_ell fwd d64 bfloat16": "ba610ffa7e097c9aeed496a130c5de08439eb130a5c8528868bed8bdd6864525",
    "spmm_ell fwd d64 float32": "bb46b89d0e75f6cf5c89ab14a4873a3af3480dc9d716b5e93b0a35fec9cb62f3",
    "spmm_sorted fwd d128 bfloat16":
        "fd815059629978309fe63b434c031311941b157a4fbb0e0de27101b7ecdadd00",
    "spmm_sorted fwd d128 float32":
        "d8f8b6356a237e9d69b4261a6a2d2a70989964b92c3a53ac0214657c08f413a1",
    "spmm_sorted fwd d256 bfloat16":
        "263d712c6296f83574be3e351fa46c50d4ef21dac1354b3de4b61786cca36908",
    "spmm_sorted fwd d256 float32":
        "761c7e5e4b4a8cf8af32bf339427abe02fc651d9e26bbf6762bffdfc8e284e12",
    "spmm_sorted fwd d64 bfloat16":
        "e21c4c479eec150f991780e8e6c109739416a76f2728523a12259baa58a8dafe",
    "spmm_sorted fwd d64 float32":
        "d30876817fa0f1c9c74a30196556cd250d91bec3663a9538a55f05aea4d9e7eb",
}


@pytest.mark.gpu
def test_existing_widths_bits_unchanged(cuda):
    """The SpMMs at d 64, 128 and 256, the margin at its six instance
    widths and the Sinkhorn update up to 256 give the bits they gave before
    the panel, masked and streamed paths were added."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "width_pins.py"
    spec = importlib.util.spec_from_file_location("width_pins", path)
    pins = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pins)
    got = {k: pins.sha256_of(v) for k, v in pins.pinned_outputs(cuda).items()}
    assert got == WIDTH_PINS
