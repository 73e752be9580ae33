"""Port parity for config ``highway`` (BASELINE config 1): the highway gate,
the highway encoder over the ``funifun``-weighted, ``rw``-normalised
adjacency (its activations and gradients), dropout's mask rule, and the
config through the CLI with and without dropout, against the JAX package
on the same weights (CPU, plain versions)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugraph.models.encoder import AlignGCN as JaxAlignGCN
from tpugraph.nn.highway import Highway as JaxHighway
from tpugraph.sparse.build import build_adjacency as jax_build_adjacency
from tpugraph_torch.cli.main import main as cli_main
from tpugraph_torch.configs.configs import get_config
from tpugraph_torch.convert import params_from_jax
from tpugraph_torch.data.synthetic import synthetic_align_task
from tpugraph_torch.models.encoder import AlignGCN, dropout, init_params
from tpugraph_torch.nn.highway import Highway
from tpugraph_torch.sparse.build import build_adjacency
from tpugraph_torch.train.driver import run


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def test_highway_gate_matches_jax():
    rng = np.random.default_rng(0)
    x, h = (rng.standard_normal((50, 12)).astype(np.float32) for _ in range(2))
    cot = rng.standard_normal((50, 12)).astype(np.float32)
    jgate = JaxHighway()
    params = jgate.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(h))["params"]
    want, vjp = jax.vjp(lambda p, a, b: jgate.apply({"params": p}, a, b), params,
                        jnp.asarray(x), jnp.asarray(h))
    g_p, g_x, g_h = vjp(jnp.asarray(cot))
    gate = Highway(12)
    gate.load_state_dict({k: torch.tensor(v) for k, v in _tree(params).items()})
    xt, ht = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(h).requires_grad_(True)
    got = gate(xt, ht)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    for t, w in ((xt.grad, g_x), (ht.grad, g_h), (gate.w.grad, g_p["w"]),
                 (gate.b.grad, g_p["b"])):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("train,rate", [(False, 0.3), (True, 0.0)])
def test_highway_encoder_matches_jax(train, rate):
    """Activations of the highway encoder over the funifun + rw operator
    (rtol 1e-5), in an eval forward with dropout configured and in a training
    forward without it; and the gradients of every parameter (rel 1e-5),
    which run the layers' backward over the non-symmetric rw transpose."""
    task = synthetic_align_task(seed=3, n_ent=140, n_rel=6, n_triples=560)
    args = (task.n_ent, task.merged_triples)
    kw = dict(n_rel=task.n_rel, weighting="funifun", norm="rw")
    jop = jax_build_adjacency(*args, **kw, use_native=False, fmt="ell")
    op = build_adjacency(*args, **kw)
    jenc = JaxAlignGCN(n_ent=task.n_ent, dim=16, highway=True, dropout=rate, spmm_impl="ell")
    params = jenc.init(jax.random.PRNGKey(4), jop)["params"]
    enc = AlignGCN(n_ent=task.n_ent, dim=16, highway=True, dropout=rate)
    enc.load_state_dict(params_from_jax(_tree(params)))
    assert {"hw1.w", "hw2.b"} <= set(enc.state_dict())
    want = jenc.apply({"params": params}, jop, train=train, method=jenc.layer_activations)
    got = enc.layer_activations(op, train=train)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    cot = np.random.default_rng(5).standard_normal((task.n_ent, 16)).astype(np.float32)
    grads = jax.jit(jax.grad(
        lambda p: jnp.sum(jenc.apply({"params": p}, jop, train=train) * cot)))(params)
    (got[-1] * torch.from_numpy(cot)).sum().backward()
    want_g = params_from_jax(_tree(grads))
    for name, p in enc.named_parameters():
        assert float((p.grad - want_g[name]).norm() / want_g[name].norm()) < 1e-5, name


def test_dropout_mask_rule_and_eval_forward():
    """A training forward drops gc2's input by the mask its generator draws
    (keep where uniform < 1 − rate, scaled by 1/(1 − rate)), and the gate
    hw2 reads the un-dropped h; an eval forward never drops."""
    n, d, rate = 120, 16, 0.3
    rng = np.random.default_rng(1)
    tri = np.stack([rng.integers(0, n, 500), rng.integers(0, 4, 500),
                    rng.integers(0, n, 500)], 1)
    op = build_adjacency(n, tri, weighting="funifun", norm="rw", n_rel=4)
    enc = AlignGCN(n_ent=n, dim=d, highway=True, dropout=rate)
    enc.load_state_dict(init_params(n, d, seed=2, highway=True))
    plain = AlignGCN(n_ent=n, dim=d, highway=True)
    plain.load_state_dict(enc.state_dict())
    with torch.no_grad():
        x, h, out = enc.layer_activations(op, train=True,
                                          generator=torch.Generator().manual_seed(7))
        u = torch.rand(h.shape, generator=torch.Generator().manual_seed(7))
        h_in = torch.where(u < 1 - rate, h / (1 - rate), 0.0)
        want = enc.hw2(h, enc.gc2(h_in, op))
        torch.testing.assert_close(out, want, rtol=0, atol=0)
        dropped = dropout(h, rate, torch.Generator().manual_seed(7))
        assert torch.equal(dropped, h_in)
        assert abs(float((dropped == 0).float().mean()) - rate) < 0.02
        assert not torch.equal(out, plain(op))
        torch.testing.assert_close(enc(op), plain(op), rtol=0, atol=0)


def test_highway_needs_hidden_equal_to_dim():
    with pytest.raises(ValueError, match="hidden == dim"):
        AlignGCN(n_ent=4, dim=8, hidden=16, highway=True)
    op = jax_build_adjacency(4, np.array([[0, 0, 1]], np.int32), use_native=False, fmt="ell")
    with pytest.raises(ValueError, match="hidden == dim"):
        JaxAlignGCN(n_ent=4, dim=8, hidden=16, highway=True).init(jax.random.PRNGKey(0), op)


def test_cli_highway_with_and_without_dropout(capsys):
    """Config highway through the CLI on the host; dropout changes the loss
    trajectory and leaves the step count alone."""
    sets = ["syn_n_ent=150", "syn_n_triples=600", "epochs=4", "neg_every=2", "k_neg=5",
            "dim=16", "eval_every=0"]
    finals = []
    for rate in (0.0, 0.3):
        argv = ["--config", "highway", "--device", "cpu", "--quiet", "--set", *sets,
                f"dropout={rate}"]
        assert cli_main(argv) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["config"] == "highway" and np.isfinite(out["final_loss"])
        finals.append(out["final_loss"])
    assert abs(finals[0] - finals[1]) > 1e-4
    res = run(get_config("highway", syn_n_ent=150, syn_n_triples=600, epochs=4, neg_every=2,
                         k_neg=5, dim=16, eval_every=0, dropout=0.3), device="cpu")
    assert res.timings["steps"] == 4 and res.losses[-1] == res.metrics["final_loss"]
