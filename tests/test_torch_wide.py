"""The port above 512 columns (on the CPU, where every kernel runs its plain
version), against the JAX package, and the wide kernels' new arithmetic
replayed in torch:

* ``AlignGCN``'s margin step at (dim, hidden) = (600, 600) and (96, 640),
  ``ell`` and ``sorted``: the converted weights, the forward, the loss and
  each gradient at fp32 rtol 1e-4 / atol 1e-5 (``test_torch_widths.py``'s
  bounds: the same sums in another order);
* config ``mtl`` with the attribute channel at dim 300, so the table the
  searches read is 600 wide: the combined table (rtol 1e-4 / atol 1e-6),
  then on that table the exact eval's ranks and the mining ids of the
  port's ``l1_search`` plain version equal the JAX ``_ranks_l1`` and
  ``blockwise_knn_l1``;
* the Sinkhorn update at d 768 against the Pallas update in interpret mode
  (1e-5);
* the margin's sign planes in the slab layout, the pair vectors and the
  backward from planes at d 600 and 1,030 against ``jax.value_and_grad``
  of the JAX margin (rtol 1e-5 / atol 1e-6);
* the ELL and sorted SpMMs' plain versions at d 768 (and bf16 at 600)
  against the JAX ``spmm_ell`` and ``spmm`` (fp32 1e-5, bf16 one ulp);
* replays: the shortlist select's streamed strip (the ring slot's
  swizzled chunks, the 3× TF32 scores summed chunk by chunk) and its
  rerank's order of terms at 768; the margin kernel's slab walk at 1,030
  (each lane's sum in column order, then the butterfly);
* the host planners up to 2,048: ``l1_search.smem_bytes`` and ``plan``,
  the select kernel's shared memory, ``margin_l1.plane_bytes``, each
  within one H100 block's 227 KB.

Torch runs on one thread here, as in ``test_torch_widths.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mtl import _mtl_models, _tree
from test_torch_widths import _margin_case, _tf32, _unit_rows
from test_torch_widths import test_margin_step_at_width_matches_jax as _margin_step
from test_torch_widths import test_spmm_plain_at_width_matches_jax as _spmm_plain
from tpugraph.kernels.sinkhorn_pallas import sinkhorn_potential_update as jax_pallas_update
from tpugraph.train.eval import _ranks_l1 as jax_ranks_l1
from tpugraph.train.losses import margin_align_loss as jax_margin_loss
from tpugraph.train.negatives import blockwise_knn_l1 as jax_knn_l1
from tpugraph_torch.convert import params_from_jax
from tpugraph_torch.data.synthetic import synthetic_align_task
from tpugraph_torch.kernels import l1_search, margin_l1, shortlist_dist
from tpugraph_torch.kernels.sinkhorn_fused import (TILE_C, sinkhorn_potential_update,
                                                   sinkhorn_update_plain)
from tpugraph_torch.train.eval import _ranks_l1
from tpugraph_torch.train.negatives import blockwise_knn_l1

H100_BLOCK_SMEM = 232448  # the most shared memory one H100 block may take (227 KB)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("impl", ["ell", "sorted"])
@pytest.mark.parametrize("dim,hidden", [(600, 600), (96, 640)])
def test_margin_step_above_512_matches_jax(dim, hidden, impl):
    """Both widths have no fused instance: each layer runs x·W, then the
    SpMM (on the card its panels, 5 of them at 600 and 640)."""
    _margin_step(dim, hidden, impl)


def test_mtl_channel_table_600_wide_and_its_searches_match_jax():
    """Config ``mtl`` with the attribute channel at dim 300: the JAX
    model's weights in the port's model, the β-weighted SE‖AE table (600
    wide); on the JAX table both packages' exact eval ranks (both
    directions) and k-10 mining ids with the partner excluded."""
    task = synthetic_align_task(seed=4, n_ent=110, n_rel=5, n_triples=420, n_attr=24)
    over = dict(dim=300, k_neg=4, rel_k_neg=3, sinkhorn_iters=6, use_attr_channel=True)
    jmodel, jop, jattr_op, model, op, attr_op, cfg = _mtl_models(task, over)
    params = jax.jit(lambda key: jmodel.init(key, jop, attr_op=jattr_op,
                                             method=jmodel.embed))(jax.random.PRNGKey(0))
    params = params["params"]
    model.load_state_dict(params_from_jax(_tree(params)), strict=False)
    jemb = np.asarray(jmodel.apply({"params": params}, jop, attr_op=jattr_op,
                                   method=jmodel.embed))
    with torch.no_grad():
        emb = model.embed(op, attr_op)
    assert emb.shape == jemb.shape == (task.n_ent, 600)
    np.testing.assert_allclose(emb.numpy(), jemb, rtol=1e-4, atol=1e-6)

    test = task.test_pairs
    table = torch.from_numpy(jemb.copy())
    for a, b in ((0, 1), (1, 0)):
        q, c = jemb[test[:, a]], jemb[test[:, b]]
        d_true = np.abs(q - c).sum(1).astype(np.float32)
        want = np.asarray(jax_ranks_l1(jnp.asarray(q), jnp.asarray(c), jnp.asarray(d_true)))
        got = _ranks_l1(torch.from_numpy(q), torch.from_numpy(c), torch.from_numpy(d_true))
        np.testing.assert_array_equal(got.numpy(), want)
    pairs, n1 = task.train_pairs, task.kg1.n_ent
    q, cands = table[pairs[:, 0]], table[n1:]
    exclude = torch.from_numpy(pairs[:, 1] - n1)
    want = np.asarray(jax_knn_l1(jnp.asarray(q.numpy()), jnp.asarray(cands.numpy()),
                                 jnp.asarray(exclude.numpy()), 10))
    got = blockwise_knn_l1(q, cands, exclude, 10)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sinkhorn_update_at_768_matches_pallas():
    """One update at d 768 (the kernel's strip streamed through the ring),
    the wrapper on a CPU tensor and the plain version, against the Pallas
    update in interpret mode."""
    rng = np.random.default_rng(768)
    l, r = _unit_rows(rng, 70, 768), _unit_rows(rng, 150, 768)
    g = (0.2 * rng.standard_normal(150)).astype(np.float32)
    log_mu = np.full(70, -np.log(70), np.float32)
    want = np.asarray(jax_pallas_update(jnp.asarray(l), jnp.asarray(r), jnp.asarray(g),
                                        jnp.asarray(log_mu), 0.05, block_q=32, block_c=TILE_C,
                                        interpret=True))
    args = [torch.from_numpy(a) for a in (l, r, g, log_mu)]
    for fn in (sinkhorn_potential_update, sinkhorn_update_plain):
        np.testing.assert_allclose(fn(*args, 0.05).numpy(), want, rtol=1e-5, atol=1e-5)


def _records(x, t, flags):
    """Every negative record's rows (its pair row, its negative row) in the
    kernel's record order, and whether its side's hinge is active."""
    (pairs, neg_l, neg_r), (s, k) = t, t[2].shape
    e_l, e_r = x[pairs[:, 0]], x[pairs[:, 1]]
    p = torch.cat([e_l[:, None].expand(s, k, -1).reshape(s * k, -1),
                   e_r[:, None].expand(s, k, -1).reshape(s * k, -1)])
    n = torch.cat([x[neg_r].reshape(s * k, -1), x[neg_l].reshape(s * k, -1)])
    act = torch.cat([(flags & 1).reshape(-1), (flags & 2).reshape(-1)]).bool()
    return p, n, act


@pytest.mark.parametrize("d", [600, 1030])
def test_margin_slab_planes_and_backward_match_jax(d):
    """Above 512 a row is 2 or 3 slabs of 512 columns in the masked 512
    instance's layout (element 512·b + 32·u + t at slot 16·b + u of lane t,
    none past d); a record's planes are its slabs' 128 bytes, slab after
    slab.  Every record's signs pack and unpack bit for bit, the pair
    vectors are exact integers, and the loss and the backward from planes
    and vectors equal ``jax.value_and_grad`` of the JAX margin."""
    rng = np.random.default_rng(d)
    emb, pairs, neg_l, neg_r, w = _margin_case(rng, d)
    n_slabs = -(-d // 512)
    assert margin_l1.lane_width(d) == 512 * n_slabs and margin_l1.slabs(d) == n_slabs
    assert margin_l1.plane_bytes(d) == 4 * n_slabs
    lanes = margin_l1._lane_elems(d)
    t = torch.arange(16 * n_slabs)[:, None] * 32 + torch.arange(32)[None, :]
    assert torch.equal(lanes, torch.where(t < d, t, d))
    x = torch.from_numpy(emb)
    ids = [torch.from_numpy(a).long() for a in (pairs, neg_l, neg_r)]
    tw = torch.from_numpy(w)
    loss, flags, denom, planes, vecs = margin_l1.forward_plain(x, *ids, 3.0, tw)
    p, n, act = _records(x, ids, flags)
    signs = torch.sign(p - n)
    every = margin_l1.pack_planes(signs)  # the kernel writes every record's planes above 512
    assert every.shape == planes.shape == (len(signs), 32 * 4 * n_slabs)
    assert torch.equal(margin_l1.unpack_planes(every, d), signs)
    assert torch.equal(every[act], planes[act]) and not planes[~act].any()
    # slab b's 128 bytes: lane t's little-endian word has bit u where element
    # 512·b + 32·u + t is > 0 and bit 16 + u where it is < 0
    words = every.reshape(len(signs), n_slabs, 32, 4).long()
    words = words[..., 0] | words[..., 1] << 8 | words[..., 2] << 16 | words[..., 3] << 24
    for b in range(n_slabs):
        for u in (0, 7, 15):
            col = 512 * b + 32 * u + torch.arange(32)
            ok = col < d
            gt, lt = (words[:, b] >> u) & 1, (words[:, b] >> (16 + u)) & 1
            held = signs[:, col.clamp_max(d - 1)] * ok
            assert torch.equal((gt - lt).float(), held)
    assert torch.equal(vecs, vecs.round())
    index = margin_l1.build_index_plain(*ids, x.shape[0])
    grad = margin_l1.backward_plain(tw, flags, denom, every, vecs, index, torch.ones(()),
                                    x.shape[0])
    want, g_want = jax.jit(jax.value_and_grad(lambda e: jax_margin_loss(
        e, jnp.asarray(pairs), jnp.asarray(neg_l), jnp.asarray(neg_r), 3.0, jnp.asarray(w))))(
        jnp.asarray(emb))
    assert loss.item() == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(g_want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", ["ell", "sorted"])
@pytest.mark.parametrize("d,dtype", [(768, "float32"), (600, "bfloat16")])
def test_spmm_plain_above_512_matches_jax(d, dtype, impl):
    _spmm_plain(d, dtype, impl)


def _butterfly(v: torch.Tensor) -> torch.Tensor:
    """warp_sum's order on (R, 32) lanes: v[t] += v[t ^ o] for o = 16 … 1;
    every lane ends with the same value, lane 0's returned."""
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, lane ^ o]
    return v[:, 0]


def test_margin_slab_walk_replay_at_1030():
    """The slab forward's arithmetic at d 1,030 (3 slabs, the last 6 wide):
    each lane adds |a − b| over its slots in column order (slab by slab,
    slot by slot), then the butterfly.  The replayed distances are within
    rtol 1e-6 of the plain version's, a negative that is the pair's partner
    gets d⁺ bit for bit (the pool-of-one tie), the hinges' signs give
    ``forward_plain``'s flags, and the pair vectors summed from every
    record's planes under those flags (the kernel's second walk) are
    ``forward_plain``'s bit for bit."""
    d = 1030
    rng = np.random.default_rng(3)
    emb, pairs, neg_l, neg_r, w = _margin_case(rng, d, s=12, k=37)
    x = torch.from_numpy(emb)
    ids = [torch.from_numpy(a).long() for a in (pairs, neg_l, neg_r)]
    lanes = margin_l1._lane_elems(d)  # (48, 32): slot 16·b + u, element 512·b + 32·u + t
    xp = torch.cat([x, x.new_zeros((x.shape[0], 1))], 1)  # column d: the masked 0

    def walk(a_rows, b_rows):
        a, b = xp[a_rows][:, lanes], xp[b_rows][:, lanes]  # (R, 48, 32)
        acc = torch.zeros(a.shape[0], 32)
        for slot in range(lanes.shape[0]):  # column order: slab by slab, slot by slot
            acc = acc + (a[:, slot] - b[:, slot]).abs()
        return _butterfly(acc)

    s, k = neg_r.shape
    pos = walk(ids[0][:, 0], ids[0][:, 1])
    d_r = walk(ids[0][:, 0].repeat_interleave(k), ids[2].reshape(-1)).reshape(s, k)
    d_l = walk(ids[1].reshape(-1), ids[0][:, 1].repeat_interleave(k)).reshape(s, k)
    plain_r = (x[ids[0][:, 0]][:, None] - x[ids[2]]).abs().sum(-1)
    torch.testing.assert_close(d_r, plain_r, rtol=1e-6, atol=0)
    assert bool(neg_r[0, 0] == pairs[0, 1]) and d_r[0, 0] == pos[0]
    thr = pos[:, None] + 3.0
    act_r = (thr - d_r >= 0) & (ids[2] != ids[0][:, 1:])
    act_l = (thr - d_l >= 0) & (ids[1] != ids[0][:, :1])
    loss, flags, denom, planes, vecs = margin_l1.forward_plain(x, *ids, 3.0, torch.from_numpy(w))
    assert torch.equal(act_r.to(torch.uint8) | (act_l.to(torch.uint8) << 1), flags)
    p, n, act = _records(x, ids, flags)
    signs = margin_l1.unpack_planes(margin_l1.pack_planes(torch.sign(p - n)), d) * act[:, None]
    cnt = (act_r.sum(1) + act_l.sum(1)).float()[:, None]
    e_l, e_r = x[ids[0][:, 0]], x[ids[0][:, 1]]
    walked = torch.cat([cnt * torch.sign(e_l - e_r) - signs[:s * k].reshape(s, k, d).sum(1),
                        cnt * torch.sign(e_r - e_l) - signs[s * k:].reshape(s, k, d).sum(1)])
    assert torch.equal(walked, vecs)


def _ring_at(row: int, granule: int) -> int:
    """``ring_at`` in csrc/shortlist_dist.cu: granule g of ring row ``row``
    at g ^ 4·(row & 1), 32 floats a row."""
    return row * 32 + ((granule ^ ((row & 1) << 2)) << 2)


def test_select_streamed_strip_and_rerank_replay_at_768():
    """Above ``SELECT_RESIDENT_D`` each ring slot holds the candidate chunk
    (128 rows × 32 of d) and then the strip's chunk (32 rows × 32), in one
    swizzled layout: every (row, float) of a slot has one place, and the
    fragment loads of a quarter-warp (rows r, r + 1, granules g … g + 3)
    cover the 32 banks once.  The scores summed chunk by chunk of 32 in 3×
    TF32 (big·small + small·big + big·big, each chunk's terms added to the
    tile's fp32 sums) select the plain version's sets on every row, within
    1e-5 of the expanded form's scale; the rerank's order of terms (a lane
    strides the float4s of the row by 32, sums each float4 as ((t0 + t1) +
    t2) + t3, then the butterfly) is within 1e-5 of the plain distances."""
    d, s, c, k = 768, 40, 300, 16
    assert shortlist_dist.select_streams(d)
    slot = sorted(_ring_at(row, g) + e for row in range(128 + 32) for g in range(8)
                  for e in range(4))
    assert slot == list(range((128 + 32) * 32))
    for row in (0, 8, 30):
        banks = {(_ring_at(r, g) + e) % 32 for r in (row, row + 1) for g in range(4)
                 for e in range(4)}
        assert len(banks) == 32
    rng = np.random.default_rng(5)
    q = rng.standard_normal((s, d)).astype(np.float32)
    cands = rng.standard_normal((c, d)).astype(np.float32)
    dot = np.zeros((s, c), np.float32)
    for k0 in range(0, d, 32):
        qc, cc = q[:, k0:k0 + 32], cands[:, k0:k0 + 32]
        qb, cb = _tf32(qc), _tf32(cc)
        qs, cs = _tf32(qc - qb), _tf32(cc - cb)
        dot += (qb @ cs.T + qs @ cb.T) + qb @ cb.T
    tq, tc = torch.from_numpy(q), torch.from_numpy(cands)
    q2, c2 = shortlist_dist.sq_norms(tq), shortlist_dist.sq_norms(tc)
    sel = q2[:, None] + c2[None, :] - 2.0 * torch.from_numpy(dot)
    sidx, sval = shortlist_dist._least_k(sel, k)
    want = shortlist_dist.shortlist_select_plain(tq, tc, k, rerank="cityblock")
    assert torch.equal(sidx.sort(1).values, want[0].sort(1).values)
    scale = float(q2.max() + c2.max())
    torch.testing.assert_close(sval, want[1], rtol=0, atol=1e-5 * scale)
    gathered = tc[want[0]]  # (s, k, d)
    diff = (tq[:, None, :] - gathered).abs().reshape(s, k, d // 4, 4)
    f4 = ((diff[..., 0] + diff[..., 1]) + diff[..., 2]) + diff[..., 3]  # (s, k, 192)
    lane_sums = torch.zeros(s * k, 32)
    f4 = f4.reshape(s * k, d // 4)
    for c0 in range(0, d // 4, 32):
        lane_sums = lane_sums + f4[:, c0:c0 + 32]
    torch.testing.assert_close(_butterfly(lane_sums).reshape(s, k), want[2], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("d", [4, 300, 512, 516, 768, 1030, 1536, 2048])
def test_planners_fit_an_h100_block_at_every_width(d):
    """Nothing a block keeps in shared memory grows with d above 512: the L1
    search's ring (8 of d a stage) and its plan are the same at every
    width; the select kernel fits at least one score-tile slot at every width
    and queue, its strip resident up to 512, and above it streamed: all 4
    slots, the same bytes at 516 and 2,048; the margin's planes are 4 bytes
    a lane and slab."""
    for entry in l1_search.ENTRIES:
        for kq in (32, 64, 128, 256):
            if entry != "topk" and kq != 32:
                continue
            stages = l1_search.ring_stages(entry, kq)
            assert l1_search.smem_bytes(entry, kq, stages) <= H100_BLOCK_SMEM
    plans = {l1_search.plan(7000, 19000, w, 100, "topk", 132, 2) for w in (4, d)}
    assert len(plans) == 1 and plans.pop().fill >= 0.95
    for kq in (32, 64, 128, 256):
        slots = next((n for n in range(shortlist_dist.SELECT_SLOTS, 0, -1)  # as the kernel
                      if shortlist_dist.select_smem(d, kq, n) <= shortlist_dist.SELECT_ROOM), 0)
        assert slots >= 1 and shortlist_dist.select_smem(d, kq, slots) <= shortlist_dist.SELECT_ROOM
        if d > shortlist_dist.SELECT_RESIDENT_D:
            assert slots == 4
            assert shortlist_dist.select_smem(d, kq, 4) == shortlist_dist.select_smem(2048, kq, 4)
    if d > margin_l1.SLAB:
        n_slabs = -(-d // margin_l1.SLAB)
        assert margin_l1.slabs(d) == n_slabs and margin_l1.plane_bytes(d) == 4 * n_slabs
        assert margin_l1.lane_width(d) == 32 * 16 * n_slabs  # 16 slots a lane a slab
    else:
        assert margin_l1.slabs(d) == 1 and margin_l1.plane_bytes(d) <= 4
