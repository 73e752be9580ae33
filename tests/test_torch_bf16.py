"""bf16 training in the port (``param_dtype="bfloat16"``: bf16 activations,
fp32 parameters and accumulation) against the JAX package, on the CPU,
where every kernel runs its plain version.

Tolerances, from bf16's unit roundoff 2^-8 (a rounding moves a value by at
most half of it, 2^-9):

* A layer's output and its gradients (no ReLU in between): the two
  packages round the same values at other points — the port's ``ell``
  layer computes (A·x)·W, JAX A·(x·W), and the plain ELL version rounds the
  bucket sum and the diagonal term apart — so each element carries up to
  three roundings of 2^-9 that differ: relative L2 ≤ 3·2^-9 ≈ 6e-3, held
  at 1e-2.
* The encoder's activations: the same per layer, at 1e-2.
* The encoder's gradients: a unit whose pre-activation lies within those
  roundings of 0 takes the other side of the ReLU in the other package,
  and its whole gradient moves with it.  On this graph a fraction
  f ≈ 2.9e-3 of the layer-1 pre-activations lies within 2^-8 of their RMS
  of 0, and flipped units make a relative L2 of at most ≈ sqrt(f) ≈ 5.4e-2:
  held at 2·sqrt(f) ≈ 1e-1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugraph.models.align import AlignMTL as JaxAlignMTL
from tpugraph.models.encoder import AlignGCN as JaxAlignGCN
from tpugraph.nn.graphconv import GraphConvolution as JaxGraphConvolution
from tpugraph.configs.configs import get_config as jax_get_config
from tpugraph.sparse.build import build_adjacency as jax_build_adjacency
from tpugraph_torch.configs.configs import get_config
from tpugraph_torch.convert import params_from_jax
from tpugraph_torch.data.synthetic import synthetic_align_task
from tpugraph_torch.models.align import AlignMTL, init_mtl_params
from tpugraph_torch.models.attr_channel import build_attr_operator
from tpugraph_torch.models.encoder import AlignGCN
from tpugraph_torch.nn.graphconv import GraphConvolution
from tpugraph_torch.sparse.build import build_adjacency
from tpugraph_torch.train.driver import run
from tpugraph_torch.train.loop import fit

LAYER_TOL = 1e-2
GRAD_TOL = 1e-1


def _rel(a, b) -> float:
    a, b = (np.asarray(v.detach() if isinstance(v, torch.Tensor) else v, np.float64)
            for v in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _graph(rng, n, impl, t=None):
    t = t or 4 * n
    tri = np.stack([rng.integers(0, n, t), rng.integers(0, 5, t),
                    rng.integers(0, n, t)], 1).astype(np.int32)
    fmt = "ell" if impl == "ell" else "sorted"
    return (jax_build_adjacency(n, tri, use_native=False, fmt=fmt, bucket=512),
            build_adjacency(n, tri, use_native=False, fmt=fmt, bucket=512))


@pytest.mark.parametrize("impl", ["ell", "sorted", "xla"])
def test_bf16_layer_matches_jax(impl):
    """One bf16 GraphConvolution: output and the gradients of x, W and b
    against jax.grad of the JAX layer on the same parameters (LAYER_TOL)."""
    rng = np.random.default_rng(0)
    jop, op = _graph(rng, 200, impl)
    x = rng.standard_normal((200, 24)).astype(np.float32)
    w = (0.2 * rng.standard_normal((24, 16))).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    cot = rng.standard_normal((200, 16)).astype(np.float32)
    jlayer = JaxGraphConvolution(16, impl=impl)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jlayer.apply({"params": {"w": w, "b": b}}, xb, jop)
    gx, gp = jax.grad(lambda x_, p: jnp.sum(jlayer.apply({"params": p}, x_, jop)
                                            .astype(jnp.float32) * cot),
                      argnums=(0, 1))(xb, {"w": jnp.asarray(w), "b": jnp.asarray(b)})
    layer = GraphConvolution(24, 16, impl=impl)
    layer.load_state_dict({"w": torch.from_numpy(w), "b": torch.from_numpy(b)})
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    got = layer(xt, op)
    assert got.dtype == torch.bfloat16
    (got.float() * torch.from_numpy(cot)).sum().backward()
    assert xt.grad.dtype == torch.bfloat16 and layer.w.grad.dtype == torch.float32
    assert _rel(got.float(), np.asarray(want, np.float32)) < LAYER_TOL
    assert _rel(xt.grad.float(), np.asarray(gx, np.float32)) < LAYER_TOL
    assert _rel(layer.w.grad, gp["w"]) < LAYER_TOL
    assert _rel(layer.b.grad, gp["b"]) < LAYER_TOL


@pytest.mark.parametrize("impl, highway", [("ell", False), ("sorted", False), ("ell", True)])
def test_bf16_encoder_matches_jax(impl, highway):
    """AlignGCN in bf16 (the table cast in, the gates in bf16, the output
    back in fp32): activations at LAYER_TOL, every parameter's gradient at
    GRAD_TOL, against the JAX encoder on the converted parameters."""
    rng = np.random.default_rng(1)
    n, dim = 300, 32
    jop, op = _graph(rng, n, impl)
    jm = JaxAlignGCN(n_ent=n, dim=dim, spmm_impl=impl, highway=highway,
                     compute_dtype="bfloat16")
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1), jop)["params"])
    params["gc1"]["b"] = 0.1 * rng.standard_normal(dim).astype(np.float32)
    params["gc2"]["b"] = 0.1 * rng.standard_normal(dim).astype(np.float32)
    cot = rng.standard_normal((n, dim)).astype(np.float32)
    want = jm.apply({"params": params}, jop, method="layer_activations")
    grads = params_from_jax(jax.grad(
        lambda p: jnp.sum(jm.apply({"params": p}, jop) * cot))(params))
    model = AlignGCN(n_ent=n, dim=dim, spmm_impl=impl, highway=highway,
                     compute_dtype="bfloat16")
    model.load_state_dict(params_from_jax(params))
    got = model.layer_activations(op)
    assert [a.dtype for a in got] == [torch.bfloat16, torch.bfloat16, torch.float32]
    (got[-1] * torch.from_numpy(cot)).sum().backward()
    for g, w in zip(got, want):
        assert _rel(g.detach().float(), np.asarray(w, np.float32)) < LAYER_TOL
    for k, v in model.named_parameters():
        assert v.grad.dtype == torch.float32
        assert _rel(v.grad, grads[k]) < GRAD_TOL, k


def test_bf16_fit_lands_near_fp32():
    """As tests/test_train_e2e.py::test_fit_bf16_compute_dtype holds the JAX
    trainer: a bf16 run trains, stays finite and lands within 0.15 Hits@10
    of the fp32 run."""
    kw = dict(syn_seed=2, syn_n_ent=250, syn_n_rel=6, syn_n_triples=900, syn_drop_frac=0.0,
              syn_noise_frac=0.0, dim=32, epochs=60, eval_every=30, k_neg=10, neg_every=5,
              pad_bucket=1024, neg_mode="uniform")
    r32 = fit(get_config("base", param_dtype="float32", **kw), device="cpu")
    r16 = fit(get_config("base", param_dtype="bfloat16", **kw), device="cpu")
    assert np.isfinite(r16.metrics["final_loss"])
    assert r16.history[-1]["loss"] < r16.history[0]["loss"]
    assert abs(r16.metrics["hits@10"] - r32.metrics["hits@10"]) < 0.15
    assert r16.losses != r32.losses  # the bf16 path ran


@pytest.mark.parametrize("config, over", [("base", dict(neg_mode="hard")),
                                          ("sinkhorn", dict(sinkhorn_iters=5))])
def test_bf16_fused_interval_equals_unfused(config, over):
    """A bf16 run fused (steps_per_call = neg_every; the host runs the
    interval's steps eagerly) equals the unfused run bit for bit."""
    kw = dict(syn_n_ent=150, syn_n_rel=5, syn_n_triples=600, syn_seed=6, dim=16, k_neg=5,
              neg_every=4, epochs=8, eval_every=4, param_dtype="bfloat16", **over)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = run(get_config(config, **kw), device="cpu")
        got = run(get_config(config, steps_per_call=4, **kw), device="cpu")
    finally:
        torch.set_num_threads(n)
    assert got.losses == want.losses and got.metrics == want.metrics
    for k, v in want.params.items():
        assert torch.equal(got.params[k], v), k


def test_attr_channel_stays_fp32_under_bf16():
    """With param_dtype bfloat16 the encoder computes in bf16 and the AE
    channel in fp32, in both packages: the port's channel output equals its
    fp32 model's exactly and the JAX channel's (fp32 tolerance)."""
    task = synthetic_align_task(seed=4, n_ent=120, n_rel=5, n_triples=480, n_attr=20)
    cfg16 = get_config("mtl", dim=16, use_attr_channel=True, param_dtype="bfloat16")
    kw = dict(n_rel=task.n_rel, n_attr=task.n_attr)
    op = build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel)
    attr_op = build_attr_operator(task.merged_attr_triples, task.n_ent, task.n_attr)
    params = init_mtl_params(cfg16, task.n_ent, task.n_rel, task.n_attr, seed=0)
    m16 = AlignMTL(task.n_ent, cfg16, **kw)
    m32 = AlignMTL(task.n_ent, cfg16.replace(param_dtype="float32"), **kw)
    for m in (m16, m32):
        m.load_state_dict(params)
    with torch.no_grad():
        ae16, ae32 = m16.ae_encoder(op, attr_op), m32.ae_encoder(op, attr_op)
        se16, se32 = m16.encoder(op), m32.encoder(op)
    assert ae16.dtype == torch.float32 and torch.equal(ae16, ae32)
    assert not torch.equal(se16, se32)  # the structural channel did run in bf16
    jop = jax_build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel,
                              use_native=False, fmt="ell")
    from tpugraph.models.attr_channel import build_attr_operator as jax_attr_operator

    jattr = jax_attr_operator(task.merged_attr_triples, task.n_ent, task.n_attr)
    jm = JaxAlignMTL(n_ent=task.n_ent, n_rel=task.n_rel, n_attr=task.n_attr,
                     cfg=jax_get_config("mtl", dim=16, use_attr_channel=True,
                                        param_dtype="bfloat16"))
    jparams = jm.init(jax.random.PRNGKey(0), jop, method="embed", attr_op=jattr)["params"]
    # the heads are not in an embed-only init
    missing = m16.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)),
                                  strict=False).missing_keys
    assert set(missing) <= {"rel_head.rel", "attr_head.w", "attr_head.b"}
    want = jm.apply({"params": jparams}, jop, jattr,
                    method=lambda mdl, o, a: mdl.ae_encoder(o, a))
    assert want.dtype == jnp.float32
    with torch.no_grad():
        got = m16.ae_encoder(op, attr_op)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
