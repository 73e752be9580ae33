"""The single-device trainers on a sharded config: the port's ``fit`` and
``fit_mtl`` train it on one device over the whole graph, as the JAX
trainers do (neither reads ``n_shards``, ``feature_shards`` or
``slice_shards``), so a sharded run equals its one-shard twin bit for bit
in both packages; a step of ``fit_mtl``'s parts under a sharded config
against the JAX model; the OT guard's message under ``fit_mtl``; and
``sddmm_pairs`` against the JAX function (CPU, plain versions)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpugraph.configs.configs import get_config as jax_get_config
from tpugraph.kernels.sddmm import sddmm_pairs as jax_sddmm_pairs
from tpugraph.models.align import AlignMTL as JaxAlignMTL
from tpugraph.sparse.build import build_adjacency as jax_build_adjacency
from tpugraph.sparse.graph import KG as JaxKG
from tpugraph.sparse.graph import AlignTask as JaxAlignTask
from tpugraph.train.loop import fit as jax_fit
from tpugraph.train.mtl import fit_mtl as jax_fit_mtl
from tpugraph_torch.configs.configs import get_config
from tpugraph_torch.convert import params_from_jax
from tpugraph_torch.data.synthetic import synthetic_align_task
from tpugraph_torch.kernels.sddmm import sddmm_pairs
from tpugraph_torch.sparse.graph import KG, AlignTask
from tpugraph_torch.train.driver import step_parts
from tpugraph_torch.train.loop import fit
from tpugraph_torch.train.mtl import fit_mtl
from tpugraph_torch.train.optim import make_optimizer

# fit trains config base; fit_mtl config sinkhorn (margin + the OT head)
TRAINERS = {"fit": (fit, jax_fit, "base"), "fit_mtl": (fit_mtl, jax_fit_mtl, "sinkhorn")}
SHARDS = {"n_shards": 2, "feature_shards": 2, "slice_shards": 2}
TINY = dict(syn_n_ent=100, syn_n_rel=5, syn_n_triples=400, dim=16, k_neg=4, epochs=4,
            neg_every=2, eval_every=0, sinkhorn_iters=5)


@pytest.fixture
def one_thread():
    """A run's parameters equal bit for bit only on one host thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_UNSHARDED = {}


def _port_run(trainer: str, **over):
    fn, _, name = TRAINERS[trainer]
    return fn(get_config(name, **TINY, **over), device="cpu")


@pytest.mark.parametrize("field", list(SHARDS))
@pytest.mark.parametrize("trainer", list(TRAINERS))
def test_port_trainer_runs_a_sharded_config_as_its_one_shard_twin(trainer, field, one_thread):
    """Uniform negatives, then one hard-mining interval: the losses, the
    final metrics and the parameters equal the unsharded run's bit for bit."""
    res = _port_run(trainer, **{field: SHARDS[field]})
    if trainer not in _UNSHARDED:
        _UNSHARDED[trainer] = _port_run(trainer)
    ref = _UNSHARDED[trainer]
    assert res.timings["steps"] == 4 and res.timings["minings"] == 1
    losses = res.losses  # the mined interval starts higher: its negatives are harder
    assert np.isfinite(losses).all() and losses[1] < losses[0] and losses[3] < losses[2]
    assert res.losses == ref.losses and res.metrics == ref.metrics
    assert res.params.keys() == ref.params.keys()
    assert all(torch.equal(res.params[k], ref.params[k]) for k in ref.params)


@pytest.mark.parametrize("trainer", list(TRAINERS))
def test_jax_trainer_runs_a_sharded_config_as_its_one_shard_twin(trainer):
    """The reference behaviour the port follows: the JAX ``fit`` and
    ``fit_mtl`` never read the shard fields."""
    _, jfn, name = TRAINERS[trainer]
    got, want = (jfn(jax_get_config(name, **TINY, n_shards=s)) for s in (8, 1))
    assert got.metrics == want.metrics and np.isfinite(got.metrics["final_loss"])
    leaves = zip(jax.tree_util.tree_leaves(got.params), jax.tree_util.tree_leaves(want.params))
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in leaves)


def test_three_adam_steps_of_fit_mtl_under_a_sharded_config_match_jax(one_thread):
    """``fit_mtl``'s own model and loss (``driver.step_parts``) on config
    sinkhorn with 8 shards and 2 feature shards, from the JAX weights, with
    the same negatives, three Adam steps: params allclose at rtol 1e-4,
    atol 1e-5 (``test_torch_train.py``'s unsharded case)."""
    task = synthetic_align_task(seed=3, n_ent=120, n_rel=6, n_triples=500)
    over = dict(dim=32, k_neg=5, n_shards=8, feature_shards=2)
    jcfg, cfg = jax_get_config("sinkhorn", **over), get_config("sinkhorn", **over)
    jop = jax_build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel,
                              use_native=False, fmt="ell")
    rng = np.random.default_rng(6)
    s, n1 = len(task.train_pairs), task.kg1.n_ent
    negs = (rng.integers(0, n1, (s, 5)), rng.integers(n1, task.n_ent, (s, 5)))
    jbatch = {"pairs": jnp.asarray(task.train_pairs), "neg_l": jnp.asarray(negs[0], jnp.int32),
              "neg_r": jnp.asarray(negs[1], jnp.int32)}
    batch = {"pairs": torch.from_numpy(task.train_pairs).long(),
             "neg_l": torch.from_numpy(negs[0]), "neg_r": torch.from_numpy(negs[1])}
    jmodel = JaxAlignMTL(n_ent=task.n_ent, n_rel=task.n_rel, n_attr=1, cfg=jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), jop, jbatch)["params"]
    parts = step_parts(cfg, task, torch.device("cpu"))
    parts.model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))

    tx = optax.adam(jcfg.lr)
    state = tx.init(params)

    @jax.jit
    def step(params, state):
        grads = jax.grad(lambda p: jmodel.apply({"params": p}, jop, jbatch)[0])(params)
        upd, state = tx.update(grads, state, params)
        return optax.apply_updates(params, upd), state

    opt, sched = make_optimizer(cfg, parts.model.parameters())
    for _ in range(3):
        params, state = step(params, state)
        opt.zero_grad()
        loss, aux = parts.loss_fn(batch, None)
        loss.backward()
        opt.step()
        sched.step()
    assert set(aux) == {"margin", "sinkhorn", "total"}
    got = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    for k, v in parts.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), got[k].numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


def test_the_ot_guard_under_fit_mtl_raises_the_jax_fit_mtl_message():
    """8 shards and 10,000 seed pairs over an OT head without a cap: both
    ``fit_mtl``s refuse with the single-device message, word for word."""
    n, pairs = 10_000, np.stack([np.arange(10_000), 10_000 + np.arange(10_000)], 1)
    tri = np.array([[0, 0, 1], [1, 0, 2]], np.int32)
    pairs = pairs.astype(np.int32)
    jtask = JaxAlignTask(kg1=JaxKG(n, 1, tri), kg2=JaxKG(n, 1, tri), train_pairs=pairs,
                         test_pairs=pairs[:10])
    task = AlignTask(kg1=KG(n, 1, tri), kg2=KG(n, 1, tri), train_pairs=pairs,
                     test_pairs=pairs[:10])
    with pytest.raises(ValueError) as want:
        jax_fit_mtl(jax_get_config("sinkhorn", n_shards=8), task=jtask)
    with pytest.raises(ValueError) as got:
        fit_mtl(get_config("sinkhorn", n_shards=8), task=task, device="cpu")
    assert str(got.value) == str(want.value)
    assert "does not compile at this scale —" in str(got.value)


@pytest.mark.parametrize("metric", ["cityblock", "sqeuclidean"])
def test_sddmm_pairs_matches_jax(metric):
    """rtol 1e-5, the bound of the JAX package's own test
    (``tests/test_sddmm_sinkhorn.py``)."""
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((50, 8)).astype(np.float32)
    rows, cols = rng.integers(0, 50, 40), rng.integers(0, 50, 40)
    want = jax_sddmm_pairs(jnp.asarray(emb), jnp.asarray(rows, jnp.int32),
                           jnp.asarray(cols, jnp.int32), metric=metric)
    got = sddmm_pairs(torch.from_numpy(emb), torch.from_numpy(rows), torch.from_numpy(cols),
                      metric=metric)
    assert got.shape == (40,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_sddmm_pairs_refuses_another_metric():
    emb, idx = torch.zeros(4, 3), torch.arange(4)
    with pytest.raises(ValueError, match="unknown metric 'cosine'"):
        sddmm_pairs(emb, idx, idx, metric="cosine")
    with pytest.raises(ValueError, match="unknown metric 'cosine'"):
        jax_sddmm_pairs(jnp.zeros((4, 3)), jnp.arange(4), jnp.arange(4), metric="cosine")
