"""The fused GCN-layer CUDA kernel against its plain version, on the card.

Marked ``gpu``; each test skips without a CUDA device.  This file imports
neither JAX nor the JAX package, so on a machine with a card (and no JAX)
it runs without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from tpugraph_torch.kernels import gcn_fused
from tpugraph_torch.kernels.gcn_fused import fused_gcn_layer, reference_layer
from tpugraph_torch.models.encoder import AlignGCN, init_params
from tpugraph_torch.sparse.build import build_adjacency
from tpugraph_torch.sparse.ell import build_ell_operator

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
    rng = np.random.default_rng(1)
    n = 400
    tri = np.stack([rng.integers(0, n, 1600), rng.integers(0, 7, 1600),
                    rng.integers(0, n, 1600)], 1)
    op = build_adjacency(n, tri)
    params = init_params(n, 128, seed=3)
    host, card = AlignGCN(n_ent=n), AlignGCN(n_ent=n, device=cuda)
    host.load_state_dict(params)
    card.load_state_dict(params)
    with pytest.raises(NotImplementedError, match="training is not ported"):
        card(op.to(cuda))
    with torch.no_grad():
        want = host(op)
        got = card(op.to(cuda))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
