"""The exact L1 search (``tpugraph_torch/kernels/l1_search.py``): its plain
versions, through each caller that the port routes through it, against the
JAX package's functions on the CPU (``blockwise_knn_l1``, ``_nn1``,
``_ranks_l1``, ``_knn_mean_l1``, ``serve._topk_blockwise``), raw and CSLS,
with exclusions, column masks, k = 1, pools smaller than k and exhausted,
and the route above the queue (k = 300); ties go to the lower column; the
ring's exact stages at 1 and 8 shards equal the single-device search; the
checks the card's wrapper makes before a launch.

Tolerances: index sets and counts equal (the plain version and XLA sum each
distance of a few dozen terms in fp32; the inputs are random normals, so no
two distances of a row lie within the rounding of each other); values
within rtol 1e-5, atol 1e-5 (PERF.md §2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugraph.serve import _topk_blockwise as jax_topk_blockwise
from tpugraph.train.bootstrap import _nn1 as jax_nn1
from tpugraph.train.eval import _knn_mean_l1 as jax_knn_mean_l1
from tpugraph.train.eval import _ranks_l1 as jax_ranks_l1
from tpugraph.train.negatives import blockwise_knn_l1 as jax_knn
from tpugraph_torch.dist import ring
from tpugraph_torch.dist.mesh import make_mesh
from tpugraph_torch.kernels import l1_search
from tpugraph_torch.serve import _topk_blockwise
from tpugraph_torch.train.bootstrap import _nn1
from tpugraph_torch.train.eval import _knn_mean_l1, _ranks_l1, hits_at_k
from tpugraph_torch.train.negatives import _cand_hubness, blockwise_knn_l1

TOL = dict(rtol=1e-5, atol=1e-5)


def _rows(seed, n, d):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _sorted(a):
    return np.sort(np.asarray(a), axis=1)


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("csls_k", [0, 5])
def test_mining_matches_jax(d, csls_k):
    """``blockwise_knn_l1`` (cityblock, exact) through ``l1_topk``: the JAX
    package's sets, the partner masked."""
    q, c = _rows(1, 40, d), _rows(2, 90, d)
    ex = np.random.default_rng(3).integers(-1, 90, 40)
    got = blockwise_knn_l1(torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(ex), 7,
                           csls_k=csls_k).numpy()
    want = jax_knn(jnp.asarray(q), jnp.asarray(c), jnp.asarray(ex, jnp.int32), 7, block_c=32,
                   csls_k=csls_k)
    np.testing.assert_array_equal(_sorted(got), _sorted(want))
    assert not (got == ex[:, None]).any()


@pytest.mark.parametrize("n_cands,k", [(4, 7), (7, 7)])
def test_mining_fills_tiny_and_exhausted_pools(n_cands, k):
    """A pool smaller than k, and one that k exhausts (the masked partner
    among the k): the row's best valid column fills, as in the JAX
    package."""
    q, c = _rows(4, 12, 16), _rows(5, n_cands, 16)
    ex = np.arange(12) % n_cands
    got = blockwise_knn_l1(torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(ex),
                           k).numpy()
    want = jax_knn(jnp.asarray(q), jnp.asarray(c), jnp.asarray(ex, jnp.int32), k)
    np.testing.assert_array_equal(_sorted(got), _sorted(want))
    assert not (got == ex[:, None]).any()


@pytest.mark.parametrize("csls_k", [0, 4])
@pytest.mark.parametrize("masked", ["some", "all"])
def test_proposals_nn1_matches_jax(csls_k, masked):
    """``_nn1`` (cityblock, exact): k = 1 under the eligibility mask, the
    score and index of the JAX package; with no eligible candidate
    (inf, 0)."""
    q, c = _rows(6, 30, 32), _rows(7, 50, 32)
    mask = np.random.default_rng(8).random(50) < 0.6 if masked == "some" else np.zeros(50, bool)
    v, i = _nn1(torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(mask),
                csls_k=csls_k)
    jv, ji = jax_nn1(jnp.asarray(q), jnp.asarray(c), jnp.asarray(mask), block_c=16,
                     csls_k=csls_k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
    if masked == "all":
        assert np.isinf(v.numpy()).all() and (i.numpy() == 0).all()


@pytest.mark.parametrize("csls", [False, True])
def test_rank_count_matches_jax(csls):
    """``_ranks_l1`` through ``l1_count``: the JAX package's counts, raw and
    CSLS, the true match excluded by index."""
    left = _rows(9, 60, 48)
    right = left + 0.5 * _rows(10, 60, 48)
    tl, tr = torch.from_numpy(left), torch.from_numpy(right)
    d_true = (tl - tr).abs().sum(1)
    kw, jkw = {}, {}
    if csls:
        corr = _knn_mean_l1(tr, tl, 5)
        kw = dict(cand_corr=corr, true_corr=corr)
        jc = jnp.asarray(corr.numpy())
        jkw = dict(cand_corr=jc, true_corr=jc)
    got = _ranks_l1(tl, tr, d_true, **kw).numpy()
    want = np.asarray(jax_ranks_l1(jnp.asarray(left), jnp.asarray(right),
                                   jnp.asarray(d_true.numpy()), block_c=16, **jkw))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [5, 300, 1000])
def test_hubness_mean_matches_jax(k):
    """``_knn_mean_l1`` (the CSLS hubness term) through ``l1_topk``'s values:
    at k = 5, above the queue (k = 300) and clamped to the pool (k > C)."""
    q, c = _rows(11, 20, 16), _rows(12, 320, 16)
    got = _knn_mean_l1(torch.from_numpy(q), torch.from_numpy(c), k).numpy()
    want = np.asarray(jax_knn_mean_l1(jnp.asarray(q), jnp.asarray(c), min(k, 320), block_c=64))
    np.testing.assert_allclose(got, want, **TOL)
    hub = _cand_hubness(torch.from_numpy(c), torch.from_numpy(q), min(k, 320)).numpy()
    np.testing.assert_allclose(hub, got, **TOL)


@pytest.mark.parametrize("csls_k,n_cands", [(0, 80), (6, 80), (0, 6)])
def test_serving_topk_matches_jax(csls_k, n_cands):
    """``serve._topk_blockwise`` at k = 10 through ``l1_topk``, raw and CSLS,
    and a pool smaller than k (inf entries at position 0)."""
    q, c = _rows(13, 25, 32), _rows(14, n_cands, 32)
    v, i = _topk_blockwise(torch.from_numpy(q), torch.from_numpy(c), 10, csls_k=csls_k)
    jv, ji = jax_topk_blockwise(jnp.asarray(q), jnp.asarray(c), 10, block_c=32, csls_k=csls_k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)


@pytest.mark.parametrize("k", [1, 5, 300])
def test_ties_go_to_the_lower_column(k):
    """Duplicate candidates tie exactly: each row is the k least by (score,
    column), masked and excluded columns last at +inf in column order, at
    k = 1, 5 and above the queue."""
    q, c = _rows(15, 9, 16), _rows(16, 400, 16)
    c[200:] = c[:200]  # candidate 200 + i duplicates candidate i
    mask = np.random.default_rng(17).random(400) < 0.9
    ex = np.random.default_rng(18).integers(0, 400, 9)
    tq, tc = torch.from_numpy(q), torch.from_numpy(c)
    vals, idx = l1_search.l1_topk(tq, tc, k, col_mask=torch.from_numpy(mask),
                                  exclude=torch.from_numpy(ex))
    d = np.abs(q[:, None, :] - c[None, :, :]).sum(-1)
    d[:, 200:] = d[:, :200]  # the duplicates' distances, tied exactly
    d[:, ~mask] = np.inf
    d[np.arange(9), ex] = np.inf
    cols = np.arange(400)
    want = np.stack([cols[np.lexsort((cols, row))][:k] for row in d])
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_allclose(vals.numpy(), np.take_along_axis(d, want, 1), **TOL)


@pytest.mark.parametrize("stage", ["knn", "knn_csls", "ranks", "ranks_csls"])
def test_ring_exact_stages_at_1_and_8_shards(stage):
    """The ring's exact stages fold one search per held block: at 1 and 8
    shards the same answer bit for bit, and the single-device search's."""
    q, c = _rows(19, 37, 16), _rows(20, 101, 16)
    ex = torch.from_numpy(np.random.default_rng(21).integers(0, 101, 37))
    tq, tc = torch.from_numpy(q), torch.from_numpy(c)
    emb = torch.from_numpy(_rows(22, 90, 16))
    pairs = np.stack([np.arange(45), 45 + np.random.default_rng(23).permutation(45)], 1)
    csls_k = (7 if stage == "knn_csls" else 10) if stage.endswith("csls") else 0
    got = []
    for s in (1, 8):
        with make_mesh(s, torch.device("cpu")) as mesh:
            if stage.startswith("knn"):
                got.append(ring.ring_knn(tq, tc, ex, 5, mesh, csls_k=csls_k).numpy())
            else:
                got.append(ring.ring_hits_at_k(emb, pairs, mesh, csls_k=csls_k))
    if stage.startswith("knn"):
        np.testing.assert_array_equal(got[0], got[1])
        want = blockwise_knn_l1(tq, tc, ex, 5, csls_k=csls_k).numpy()
        np.testing.assert_array_equal(_sorted(got[0]), _sorted(want))
    else:
        assert got[0] == got[1]
        assert got[0] == hits_at_k(emb, pairs, csls_k=csls_k)


@pytest.mark.parametrize("case", ["float64", "width_6", "width_516", "strided", "mask_dtype",
                                  "meta_device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    """The checks the card's wrapper makes before any launch (``_check``), and
    a device that is neither the CPU nor the card: each raises, none falls
    back to the plain version.  A width the kernel does not take (6: it
    reads d % 4 == 0) never reaches it: ``_check`` hands it the rows with
    zero columns up to 8.  No width is refused: 516 (d % 4 == 0) passes as
    it is, 514 with zero columns up to 516."""
    q, c = torch.from_numpy(_rows(24, 8, 16)), torch.from_numpy(_rows(25, 20, 16))
    if case == "meta_device":
        with pytest.raises(ValueError):
            l1_search.l1_topk(q.to("meta"), c.to("meta"), 3)
        return
    rows = {}
    if case == "float64":
        q = q.double()
    elif case == "width_6":
        q, c = q[:, :6].contiguous(), c[:, :6].contiguous()
        q8, c8 = l1_search._check(q, c)
        assert q8.shape == (8, 8) and c8.shape == (20, 8)
        assert torch.equal(q8[:, :6], q) and torch.equal(c8[:, :6], c)
        assert not q8[:, 6:].any() and not c8[:, 6:].any()
        return
    elif case == "width_516":
        q, c = q.repeat(1, 33)[:, :516].contiguous(), c.repeat(1, 33)[:, :516].contiguous()
        q516, c516 = l1_search._check(q, c)
        assert q516 is q and c516 is c
        q514, c514 = l1_search._check(q[:, :514].contiguous(), c[:, :514].contiguous())
        assert q514.shape == (8, 516) and torch.equal(q514[:, :514], q[:, :514])
        assert not q514[:, 514:].any() and not c514[:, 514:].any()
        return
    elif case == "strided":
        c = c.t().contiguous().t()
    else:
        rows["col_mask"] = torch.ones(20, dtype=torch.uint8)
    with pytest.raises((TypeError, ValueError)):
        l1_search._check(q, c, **rows)
