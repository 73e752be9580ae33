"""Port parity: AlignGCN, Hits@k and top-k serving (tpugraph_torch) against
the JAX package on identical weights and embeddings."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugraph.models.encoder import AlignGCN as JaxAlignGCN
from tpugraph.serve import topk_alignments as jax_topk
from tpugraph.sparse.build import build_adjacency as jax_build_adjacency
from tpugraph.train.eval import _both_direction_ranks as jax_ranks
from tpugraph.train.eval import hits_at_k as jax_hits
from tpugraph_torch.convert import params_from_jax
from tpugraph_torch.models.encoder import AlignGCN, init_params
from tpugraph_torch.serve import export_alignments, load_embeddings, main, save_embeddings
from tpugraph_torch.serve import topk_alignments
from tpugraph_torch.sparse.build import build_adjacency
from tpugraph_torch.train.eval import _both_direction_ranks, hits_at_k


@pytest.mark.parametrize("l2_normalize", [False, True])
def test_align_gcn_layer_activations_match_flax(l2_normalize):
    rng = np.random.default_rng(0)
    n, dim = 120, 32
    tri = np.stack([rng.integers(0, n, 500), rng.integers(0, 5, 500),
                    rng.integers(0, n, 500)], 1).astype(np.int32)
    jop = jax_build_adjacency(n, tri, use_native=False, fmt="ell")
    jmodel = JaxAlignGCN(n_ent=n, dim=dim, spmm_impl="ell", l2_normalize=l2_normalize)
    params = jmodel.init(jax.random.PRNGKey(1), jop)["params"]
    # non-zero biases so the bias path is compared too
    params = jax.tree_util.tree_map(np.asarray, params)
    params["gc1"]["b"] = rng.standard_normal(dim).astype(np.float32)
    params["gc2"]["b"] = rng.standard_normal(dim).astype(np.float32)
    want = jmodel.apply({"params": params}, jop, method="layer_activations")

    model = AlignGCN(n_ent=n, dim=dim, l2_normalize=l2_normalize)
    model.load_state_dict(params_from_jax(params))
    got = model.layer_activations(build_adjacency(n, tri))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-4)


def test_align_gcn_bf16_and_unported_options():
    params = init_params(40, 16, seed=2)
    assert params["emb"].std().item() == pytest.approx(16 ** -0.5, rel=0.1)
    rng = np.random.default_rng(2)
    tri = np.stack([rng.integers(0, 40, 90), np.zeros(90, int), rng.integers(0, 40, 90)], 1)
    model = AlignGCN(n_ent=40, dim=16, compute_dtype="bfloat16")
    model.load_state_dict(params)
    out = model(build_adjacency(40, tri))
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="hidden == dim"):
        AlignGCN(n_ent=4, dim=8, hidden=16, highway=True)
    with pytest.raises(ValueError, match="compute_dtype"):
        AlignGCN(n_ent=4, compute_dtype="float16")


def _emb(seed, n=160, d=24):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


@pytest.mark.parametrize("block_c", [7, 1024])
def test_hits_at_k_ranks_and_metrics_match(block_c):
    emb = _emb(0)
    # near-duplicates make close calls; the true match is excluded by index
    emb[100:130] = emb[0:30] + 1e-3 * emb[30:60]
    pairs = np.stack([np.arange(0, 60), np.arange(100, 160)], 1).astype(np.int32)
    jl, jr = jax_ranks(jnp.asarray(emb), jnp.asarray(pairs), block_c=block_c)
    tl, tr = _both_direction_ranks(torch.from_numpy(emb), torch.from_numpy(pairs).long(),
                                   block_c=block_c)
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
    want = jax_hits(jnp.asarray(emb), pairs, block_c=block_c)
    got = hits_at_k(torch.from_numpy(emb), pairs, block_c=block_c)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


@pytest.mark.parametrize("n_cands,k,block_c", [(90, 5, 16), (6, 10, 2048), (40, 40, 32)])
def test_topk_alignments_match(n_cands, k, block_c):
    emb = _emb(1)
    q_ids = np.arange(0, 30)
    c_ids = np.arange(60, 60 + n_cands)
    jv, ji = jax_topk(jnp.asarray(emb), q_ids, c_ids, k=k, block_c=block_c)
    tv, ti = topk_alignments(torch.from_numpy(emb), q_ids, c_ids, k=k, block_c=block_c)
    np.testing.assert_array_equal(ji, ti)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    if n_cands < k:
        assert np.all(np.isinf(tv[:, n_cands:]))


def test_export_embeddings_and_cli_roundtrip(tmp_path):
    emb = torch.from_numpy(_emb(2, n=50, d=8))
    path = str(tmp_path / "emb" / "table.pt")
    save_embeddings(path, emb)
    torch.testing.assert_close(load_embeddings(path), emb)
    rows = export_alignments(str(tmp_path / "a.tsv"), emb, np.arange(5), np.arange(20, 50), k=3)
    assert rows == 5
    assert main(["--emb", path, "--out", str(tmp_path / "b.tsv"), "--n-left", "20",
                 "--k", "3", "--device", "cpu"]) == 0
    lines = (tmp_path / "b.tsv").read_text().splitlines()
    assert len(lines) == 20
    first = (tmp_path / "a.tsv").read_text().splitlines()[0]
    assert lines[0] == first
    _, ids = topk_alignments(emb, [0], np.arange(20, 50), k=3)
    assert [int(c.split(":")[0]) for c in first.split("\t")[1:]] == ids[0].tolist()
