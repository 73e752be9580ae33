"""The port at every width the JAX package takes, up to 512 (on the CPU,
where every kernel runs its plain version), against the JAX package:

* ``AlignGCN`` through ``AlignMTL``'s margin step at (dim, hidden) = (50,
  300), (64, 64), (384, 384), (512, 128) — widths with no fused GCN-layer
  instance, so the ``ell`` layer takes the JAX layer's order, x·W then the
  ELL SpMM — and (128, 256), a fused width, with the ``ell`` and
  ``sorted`` impls: the converted weights, the forward, the loss and each
  gradient, at fp32 rtol 1e-4 / atol 1e-5 (the same sums in another order);
* the OT loss and its gradient at d 384 and 512, and the Sinkhorn update
  against the Pallas update in interpret mode;
* the margin's sign planes (in the masked instances' register layout),
  pair vectors and backward from planes at d 50, 300 and 384 against
  ``jax.value_and_grad`` of the JAX margin;
* the ELL and sorted SpMMs' plain versions at d 50, 300, 384 (and bf16 at
  300) against the JAX ``spmm_ell`` and ``spmm``;
* the search kernels' zero-column padding at d 50;
* the kernels' new arithmetic replayed in torch: the SpMMs' 128-column
  panels with the masked tail (each panel the instances' item walk), and
  the Sinkhorn update's 3× TF32 dot products summed over 64-wide chunks of
  d at 384 and 512 (and above 512: 516, 768, 1,032), within the error
  budget of the 256-wide kernel.

Torch runs on one thread here: the OT loss's exp(−C/τ) amplifies the
threaded reductions' order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_sorted_segments import _replay as _sorted_replay
from test_torch_sorted_segments import _skewed
from test_torch_spmm_segments import _graph as _ell_graph
from test_torch_spmm_segments import _replay as _ell_replay
from tpugraph.configs.configs import get_config as jax_get_config
from tpugraph.kernels.sinkhorn_pallas import sinkhorn_potential_update as jax_pallas_update
from tpugraph.kernels.spmm import spmm as jax_spmm
from tpugraph.kernels.spmm_ell import spmm_ell as jax_spmm_ell
from tpugraph.models.align import AlignMTL as JaxAlignMTL
from tpugraph.sparse.build import build_adjacency as jax_build_adjacency
from tpugraph.train.losses import margin_align_loss as jax_margin_loss
from tpugraph.train.ot import sinkhorn_align_loss as jax_sinkhorn_loss
from tpugraph_torch.configs.configs import get_config
from tpugraph_torch.convert import params_from_jax
from tpugraph_torch.data.synthetic import synthetic_align_task
from tpugraph_torch.kernels import gcn_fused, l1_search, margin_l1, shortlist_dist, spmm_ell
from tpugraph_torch.kernels.pad import pad_columns
from tpugraph_torch.kernels.sinkhorn_fused import (TILE_C, sinkhorn_potential_update,
                                                   sinkhorn_update_plain, sq_norms)
from tpugraph_torch.kernels.spmm import segment_plan as sorted_plan
from tpugraph_torch.kernels.spmm import segment_spmm
from tpugraph_torch.models.align import AlignMTL
from tpugraph_torch.sparse.build import build_adjacency, build_spmm_operator
from tpugraph_torch.sparse.ell import build_ell_operator
from tpugraph_torch.train.ot import sinkhorn_align_loss

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return np.asarray(t.detach() if isinstance(t, torch.Tensor) else t, np.float32)


@pytest.mark.parametrize("impl", ["ell", "sorted"])
@pytest.mark.parametrize("dim,hidden", [(50, 300), (64, 64), (384, 384), (512, 128),
                                        (128, 256)])
def test_margin_step_at_width_matches_jax(dim, hidden, impl):
    """The JAX model's weights carried across by ``params_from_jax`` (every
    name and shape of the port's model), the encoder's forward, the loss
    and each parameter's gradient; the layer's route is the width's."""
    task = synthetic_align_task(seed=4, n_ent=120, n_rel=5, n_triples=480)
    over = dict(dim=dim, hidden=hidden, k_neg=4, spmm_impl=impl)
    jcfg, cfg = jax_get_config("base", **over), get_config("base", **over)
    fmt = "ell" if impl == "ell" else "sorted"
    jop = jax_build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel,
                              use_native=False, fmt=fmt)
    op = build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel, use_native=False,
                         fmt=fmt)
    rng = np.random.default_rng(dim + hidden)
    s, n1 = len(task.train_pairs), task.kg1.n_ent
    negs = (rng.integers(0, n1, (s, 4)), rng.integers(n1, task.n_ent, (s, 4)))
    jbatch = {"pairs": jnp.asarray(task.train_pairs), "neg_l": jnp.asarray(negs[0], jnp.int32),
              "neg_r": jnp.asarray(negs[1], jnp.int32)}
    batch = {"pairs": torch.from_numpy(task.train_pairs).long(),
             "neg_l": torch.from_numpy(negs[0]), "neg_r": torch.from_numpy(negs[1])}
    jmodel = JaxAlignMTL(n_ent=task.n_ent, n_rel=task.n_rel, n_attr=1, cfg=jcfg)

    def layer(d_in, d_out):  # xavier-uniform W; nonzero b, so the bias add is exercised
        lim = np.sqrt(6.0 / (d_in + d_out))
        return {"w": rng.uniform(-lim, lim, (d_in, d_out)).astype(np.float32),
                "b": (0.1 * rng.standard_normal(d_out)).astype(np.float32)}

    params = {"encoder": {
        "emb": (rng.standard_normal((task.n_ent, dim)) / np.sqrt(dim)).astype(np.float32),
        "gc1": layer(dim, hidden), "gc2": layer(hidden, dim)}}

    @jax.jit
    def jax_step(p):
        loss_grads = jax.value_and_grad(lambda q: jmodel.apply({"params": q}, jop, jbatch)[0])(p)
        return loss_grads, jmodel.apply({"params": p}, jop, method="embed")

    (want, jgrads), want_emb = jax_step(params)
    model = AlignMTL(task.n_ent, cfg)
    weights = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    assert {k: v.shape for k, v in weights.items()} == {
        k: v.shape for k, v in model.state_dict().items()}
    model.load_state_dict(weights)
    assert gcn_fused.fused_width(dim, hidden) == ((dim, hidden) in {(128, 256), (50, 300), (64, 64)})
    np.testing.assert_allclose(_np(model.embed(op)), _np(want_emb), **TOL)
    loss, _ = model(op, batch)
    loss.backward()
    assert loss.item() == pytest.approx(float(want), rel=1e-4)
    grads = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for k, v in model.named_parameters():
        np.testing.assert_allclose(_np(v.grad), _np(grads[k]), **TOL, err_msg=k)


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("d", [384, 512])
def test_ot_loss_and_update_at_width_match_jax(d):
    """The OT loss and its gradient (τ 0.1, 10 iterations) against
    ``jax.value_and_grad`` of the JAX loss (value rel 1e-4, gradient
    relative L2 1e-4); one update, the wrapper on a CPU tensor and the plain
    version, against the Pallas update in interpret mode (1e-5)."""
    rng = np.random.default_rng(d)
    n, s = 120, 40
    emb = rng.standard_normal((n, d)).astype(np.float32)
    pairs = np.stack([rng.permutation(n // 2)[:s], n // 2 + rng.permutation(n // 2)[:s]], 1)
    pairs = pairs.astype(np.int32)
    jfn = lambda e: jax_sinkhorn_loss(e, jnp.asarray(pairs), tau=0.1, n_iters=10, block_q=16)
    want, g_want = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(emb))
    e = torch.from_numpy(emb).requires_grad_(True)
    got = sinkhorn_align_loss(e, torch.from_numpy(pairs).long(), tau=0.1, n_iters=10)
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-4)
    g_want = np.asarray(g_want)
    assert np.linalg.norm(e.grad.numpy() - g_want) / np.linalg.norm(g_want) < 1e-4

    l, r = _unit_rows(rng, 70, d), _unit_rows(rng, 150, d)
    g = (0.2 * rng.standard_normal(150)).astype(np.float32)
    log_mu = np.full(70, -np.log(70), np.float32)
    want = np.asarray(jax_pallas_update(jnp.asarray(l), jnp.asarray(r), jnp.asarray(g),
                                        jnp.asarray(log_mu), 0.05, block_q=32, block_c=TILE_C,
                                        interpret=True))
    args = [torch.from_numpy(a) for a in (l, r, g, log_mu)]
    for fn in (sinkhorn_potential_update, sinkhorn_update_plain):
        np.testing.assert_allclose(fn(*args, 0.05).numpy(), want, rtol=1e-5, atol=1e-5)


def _tf32(x):
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("d", [384, 512, 516, 768, 1032])
def test_update_chunked_3xtf32_error_budget(d):
    """The kernel above d = 256: each 64-wide chunk of the strip split
    into (big, small) in registers, as the candidates' are, and its three
    TF32 products added to the tile's fp32 sums chunk by chunk, all before
    the exp and LSE fold.  The update keeps within 1 % of the tolerance
    1e-4 + 1e-4·|f| against a float64 reference at τ 0.05 and 0.3 (the
    256-wide kernel's budget, tests/test_torch_sinkhorn_split.py), also
    above 512 (516 and 1,032: 514 and 1,030 padded to a multiple of 4),
    where the split's error grows with d as a fp32 dot product's does."""
    rng = np.random.default_rng(d + 1)
    l, r = _unit_rows(rng, 512, d), _unit_rows(rng, 512, d)
    g = (0.2 * rng.standard_normal(512)).astype(np.float32)
    log_mu = np.full(512, -np.log(512), np.float32)
    dot = np.zeros((512, 512), np.float32)
    for k0 in range(0, d, 64):
        lc, rc = l[:, k0:k0 + 64], r[:, k0:k0 + 64]
        lb, rb = _tf32(lc), _tf32(rc)
        ls, rs = _tf32(lc - lb), _tf32(rc - rb)
        dot += (lb @ rs.T + ls @ rb.T) + lb @ rb.T
    l64, r64 = l.astype(np.float64), r.astype(np.float64)
    c64 = np.maximum((l64 * l64).sum(1)[:, None] + (r64 * r64).sum(1)[None, :]
                     - 2.0 * l64 @ r64.T, 0.0)
    l_sq, r_sq = sq_norms(torch.from_numpy(l)).numpy(), sq_norms(torch.from_numpy(r)).numpy()
    cost = np.maximum(l_sq[:, None] + r_sq[None, :] - 2.0 * dot, 0.0)
    for tau in (0.05, 0.3):
        z64 = (g.astype(np.float64)[None, :] - c64) / tau
        zmax = z64.max(1)
        want = tau * (log_mu - (zmax + np.log(np.exp(z64 - zmax[:, None]).sum(1))))
        z = torch.from_numpy(((g[None, :] - cost) / tau).astype(np.float32))
        got = tau * (log_mu - torch.logsumexp(z, dim=1).numpy())
        assert np.max(np.abs(got - want) / (1e-4 + 1e-4 * np.abs(want))) <= 0.01


def _margin_case(rng, d, n=90, s=20, k=5):
    emb = rng.standard_normal((n, d)).astype(np.float32)
    pairs = np.stack([rng.integers(0, n // 2, s), rng.integers(n // 2, n, s)], 1)
    neg_l = rng.integers(0, n // 2, (s, k))
    neg_r = rng.integers(n // 2, n, (s, k))
    neg_r[0, 0] = pairs[0, 1]  # a pool-of-one tie: no gradient
    return emb, pairs, neg_l, neg_r, rng.uniform(0, 2, s).astype(np.float32)


@pytest.mark.parametrize("d", [50, 300, 384])
def test_margin_planes_and_backward_at_width_match_jax(d):
    """The masked instances' layout (d 50 and 300: 2 and 5 slots of
    ``lane_width`` 64 and 320, element 32·slot + lane, none past d) and
    the float4 instance at 384: the planes unpack to the active records'
    signs and pack back bit for bit, the pair vectors are exact integers,
    and the loss and the backward from planes and vectors equal
    ``jax.value_and_grad`` of the JAX margin."""
    rng = np.random.default_rng(d)
    emb, pairs, neg_l, neg_r, w = _margin_case(rng, d)
    width = margin_l1.lane_width(d)
    assert width == {50: 64, 300: 320, 384: 384}[d]
    lanes = margin_l1._lane_elems(d)
    assert lanes.shape == (width // 32, 32)
    held = lanes[lanes < d]
    assert torch.equal(held.sort().values, torch.arange(d))  # each element on one lane
    if d != 384:
        t = torch.arange(width // 32)[:, None] * 32 + torch.arange(32)[None, :]
        assert torch.equal(lanes, torch.where(t < d, t, d))
    assert margin_l1.plane_bytes(d) == (1 if d == 50 else 4)
    x = torch.from_numpy(emb)
    t = [torch.from_numpy(a).long() for a in (pairs, neg_l, neg_r)]
    tw = torch.from_numpy(w)
    loss, flags, denom, planes, vecs = margin_l1.forward_plain(x, *t, 3.0, tw)
    s, k = neg_r.shape
    assert planes.shape == (2 * s * k, 32 * margin_l1.plane_bytes(d))
    act = torch.cat([(flags & 1).reshape(-1), (flags & 2).reshape(-1)]).bool()
    e_l, e_r = x[t[0][:, 0]], x[t[0][:, 1]]
    signs = torch.cat([torch.sign(e_l[:, None] - x[t[2]]).reshape(-1, d),
                       torch.sign(e_r[:, None] - x[t[1]]).reshape(-1, d)]) * act[:, None]
    assert torch.equal(margin_l1.unpack_planes(planes, d), signs)
    assert torch.equal(margin_l1.pack_planes(signs), planes)
    assert torch.equal(vecs, vecs.round()) and int((signs == 0).sum()) > 0
    index = margin_l1.build_index_plain(*t, x.shape[0])
    grad = margin_l1.backward_plain(tw, flags, denom, planes, vecs, index, torch.ones(()),
                                    x.shape[0])
    want, g_want = jax.jit(jax.value_and_grad(lambda e: jax_margin_loss(
        e, jnp.asarray(pairs), jnp.asarray(neg_l), jnp.asarray(neg_r), 3.0, jnp.asarray(w))))(
        jnp.asarray(emb))
    assert loss.item() == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(g_want), rtol=1e-5, atol=1e-6)


SPMM_CASES = [(50, "float32"), (300, "float32"), (384, "float32"), (300, "bfloat16")]


def _tri(rng, n, t):
    return np.stack([rng.integers(0, n, t), rng.integers(0, 5, t),
                     np.where(rng.random(t) < 0.2, 7, rng.integers(0, n, t))], 1).astype(np.int32)


@pytest.mark.parametrize("impl", ["ell", "sorted"])
@pytest.mark.parametrize("d,dtype", SPMM_CASES)
def test_spmm_plain_at_width_matches_jax(d, dtype, impl):
    """A·x and its VJP over an adjacency with a hub row (row 7) against the
    JAX ``spmm_ell`` / ``spmm``: fp32 at 1e-5 (the same sums in another
    order); bf16, where both packages sum in fp32 and round once, at one
    bf16 ulp (rel 2^-7)."""
    rng = np.random.default_rng(d)
    n = 200
    tri = _tri(rng, n, 900)
    fmt = "ell" if impl == "ell" else "sorted"
    jop = jax_build_adjacency(n, tri, use_native=False, fmt=fmt, bucket=512)
    op = build_adjacency(n, tri, use_native=False, fmt=fmt, bucket=512)
    x = rng.standard_normal((n, d)).astype(np.float32)
    cot = rng.standard_normal((n, d)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                       torch.bfloat16)
    jfn = jax_spmm_ell if impl == "ell" else jax_spmm

    @jax.jit
    def jax_product(x_, cot_):
        y_, vjp = jax.vjp(lambda z: jfn(jop, z), x_)
        return y_, vjp(cot_)[0]

    y, gx = jax_product(jnp.asarray(x, jdt), jnp.asarray(cot, jdt))
    if impl == "ell":
        got = spmm_ell.ell_spmm(op.fwd, op.diag, torch.from_numpy(x).to(tdt))
        back = spmm_ell.ell_spmm(op.bwd, op.diag, torch.from_numpy(cot).to(tdt))
    else:
        got = segment_spmm(op.fwd, torch.from_numpy(x).to(tdt))
        back = segment_spmm(op.bwd, torch.from_numpy(cot).to(tdt))
    assert got.dtype == tdt and got.shape == (n, d)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2**-7, atol=2**-7)
    np.testing.assert_allclose(_np(got.float()), np.asarray(y, np.float32), **tol)
    np.testing.assert_allclose(_np(back.float()), np.asarray(gx, np.float32), **tol)


@pytest.mark.parametrize("kind", ["ell", "sorted"])
def test_panel_replay_matches_plain(kind):
    """The SpMM kernels at d = 300 (no instance): 3 panels of 128 columns
    over the grid, the last masked at 300 (its 84 columns past d read as 0
    and never written), each panel the instances' item walk over the same
    work table, a cut row's partials rows of 384 floats, one counter per cut
    row and panel in the scratch.  The replay equals the instances' walk
    over the whole 300-wide rows bit for bit (each element's sum is the same
    fp32 operations in the same slot order), and the plain version within
    rtol 1e-4 (a hub row sums 2,500 terms, in another order there)."""
    d = 300
    assert spmm_ell.panel_layout(d) == (384, 3)
    assert [spmm_ell.panel_layout(w) for w in (64, 128, 256, 1, 512)] == [
        (64, 1), (128, 1), (256, 1), (128, 1), (512, 4)]
    rng = np.random.default_rng(31)
    n = 600 if kind == "sorted" else 120
    if kind == "ell":
        op = build_ell_operator(*_ell_graph(rng, n, {3: 2500, 5: 300}, True), n,
                                split_diag=True)
        m, plan = op.fwd, spmm_ell.segment_plan(op.fwd)
        replay = lambda xp: _ell_replay(m, op.diag, xp, plan)
        want = lambda xx: spmm_ell.apply_with_diag(m, op.diag, xx)
    else:
        op = build_spmm_operator(*_skewed(rng, n, {2: 95, 13: 2500}), n, bucket=1024)
        m, plan = op.fwd, sorted_plan(op.fwd)
        replay = lambda xp: _sorted_replay(m, xp, plan)
        want = lambda xx: segment_spmm(m, xx)
    x = torch.from_numpy(rng.standard_normal((m.n_cols, d)).astype(np.float32))
    xp = F.pad(x, (0, 384 - d))
    got = torch.cat([replay(xp[:, 128 * p:128 * (p + 1)].contiguous()) for p in range(3)], 1)
    assert torch.equal(got[:, d:], torch.zeros(m.n_rows, 384 - d))  # the masked tail adds 0
    assert torch.equal(got[:, :d], replay(x))
    torch.testing.assert_close(got[:, :d], want(x), rtol=1e-4, atol=1e-4)
    n_split = plan.split_p0.shape[0] - 1
    assert plan.n_partials > 0 and n_split > 0
    spmm_ell.segment_scratch(plan, d, torch.device("cpu"), 0)
    assert plan.scratch[(d, 0)].numel() == plan.n_partials * 384 + n_split * 3


def test_search_rows_padded_with_zero_columns_give_the_unpadded_search():
    """At d = 50 the search wrappers give the kernels rows of 52 (56 for the
    bf16 select): the plain searches on the padded rows return the same ids
    and counts as on the 50-wide rows, and the same values within rtol 1e-6
    (the kernels sum c = 0 … d − 1 in order, so the zeros add nothing there;
    torch's vectorised sum takes another order at another row length)."""
    rng = np.random.default_rng(50)
    q = torch.from_numpy(rng.standard_normal((70, 50)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((300, 50)).astype(np.float32))
    q4, c4 = pad_columns(q, 4), pad_columns(c, 4)
    assert q4.shape == (70, 52) and torch.equal(q4[:, :50], q) and not q4[:, 50:].any()
    assert pad_columns(q4, 4) is q4 and pad_columns(q, 8).shape == (70, 56)
    vals, idx = l1_search.l1_topk_plain(q, c, 10)
    vals4, idx4 = l1_search.l1_topk_plain(q4, c4, 10)
    assert torch.equal(idx, idx4)
    torch.testing.assert_close(vals4, vals, rtol=1e-6, atol=0)
    thresh = vals[:, 4].contiguous()
    assert torch.equal(l1_search.l1_count_plain(q, c, thresh),
                       l1_search.l1_count_plain(q4, c4, thresh))
    for bf16, mult in ((False, 4), (True, 8)):
        want = shortlist_dist.shortlist_select_plain(q, c, 10, bf16=bf16, rerank="cityblock")
        got = shortlist_dist.shortlist_select_plain(pad_columns(q, mult), pad_columns(c, mult),
                                                    10, bf16=bf16, rerank="cityblock")
        assert torch.equal(want[0], got[0])
        for a, b in zip(want[1:], got[1:]):
            torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6)
