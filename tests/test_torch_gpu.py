"""The port's CUDA kernels (fused GCN layer, ELL SpMM, Sinkhorn potential
update) against their plain versions, and training on the card.

Marked ``gpu``; each test skips without a CUDA device.  This file imports
neither JAX nor the JAX package, so on a machine with a card (and no JAX)
it runs without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from tpugraph_torch.configs.configs import get_config
from tpugraph_torch.kernels import gcn_fused, sinkhorn_fused, spmm_ell
from tpugraph_torch.kernels.gcn_fused import fused_gcn_layer, reference_layer
from tpugraph_torch.kernels.sinkhorn_fused import sinkhorn_potential_update, sinkhorn_update_plain
from tpugraph_torch.kernels.spmm_ell import SEG_SLOTS, apply_with_diag, ell_spmm
from tpugraph_torch.models.encoder import AlignGCN, init_params
from tpugraph_torch.sparse.build import build_adjacency
from tpugraph_torch.sparse.ell import build_ell_operator
from tpugraph_torch.train.driver import run
from tpugraph_torch.train.ot import sinkhorn_align_loss, sinkhorn_align_loss_plain

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
@pytest.mark.parametrize("d_in,d_out", [(128, 128), (128, 256), (256, 128)])
@pytest.mark.parametrize("split_diag", [False, True])
def test_kernel_matches_plain(cuda, dtype, d_in, d_out, split_diag):
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


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    op = _graph(np.random.default_rng(0)).to(cuda)
    x = torch.randn(op.n_rows, 128, device=cuda)
    wm = torch.randn(128, 128, device=cuda)
    with pytest.raises(ValueError):
        fused_gcn_layer(op.fwd, op.diag, x, wm.to(torch.bfloat16))
    with pytest.raises(ValueError):
        fused_gcn_layer(op.fwd, op.diag, x.t().contiguous().t(), wm)
    with pytest.raises(ValueError):
        fused_gcn_layer(op.fwd, op.diag, x[:, :64].contiguous(), wm[:64, :64].contiguous())
    with pytest.raises(ValueError):
        fused_gcn_layer(op.fwd, op.diag, x[1:], wm)
    with pytest.raises(ValueError):
        fused_gcn_layer(op.fwd, op.diag.cpu(), x, wm)


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
@pytest.mark.parametrize("d", [128, 256])
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
    with pytest.raises(TypeError):
        ell_spmm(op.fwd, op.diag, x.to(torch.bfloat16))
    with pytest.raises(ValueError):
        ell_spmm(op.fwd, op.diag, x[:, :64].contiguous())


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
@pytest.mark.parametrize("d", [128, 256])
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
@pytest.mark.parametrize("q,c,d", [(70, 4001, 4), (1000, 777, 20), (4500, 4500, 128),
                                   (130, 2050, 256), (9000, 4500, 192), (333, 2049, 64)])
def test_sinkhorn_splits_match_plain(cuda, q, c, d):
    """Ragged Q and C (no multiple of the 64 × 128 tile or of a block's
    share, odd Q too), every d the kernel takes from 4 to 256, τ = 0.05 and
    0.3, and strips cut into one to 33 candidate splits; the wrapper refuses
    other d."""
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
    for bad in (d + 2, 260):
        with pytest.raises(ValueError):
            sinkhorn_potential_update(unit(q, bad), unit(c, bad), g, log_mu, 0.3)


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
                                   (4500, 130, 128)])
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
    with pytest.raises(ValueError):
        sinkhorn_potential_update(l[:, :d - 2].contiguous(), r[:, :d - 2].contiguous(), g,
                                  log_mu, 0.3)


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
