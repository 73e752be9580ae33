"""The port's serving slice as a whole against the JAX package, and the
port's boundaries: no JAX import, the card by default, no grad on the card."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpugraph.configs.configs import get_config as jax_get_config
from tpugraph.sparse.build import build_adjacency as jax_build_adjacency
from tpugraph.train.eval import hits_at_k as jax_hits
from tpugraph.train.loop import build_model as jax_build_model
from tpugraph.train.loop import load_task as jax_load_task
from tpugraph_torch.configs.configs import get_config
from tpugraph_torch.convert import params_from_jax, save_params
from tpugraph_torch.serve import load_embeddings
from tpugraph_torch.train.driver import evaluate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(syn_n_ent=300, syn_n_triples=1200)


def _jax_reference(overrides):
    cfg = jax_get_config("base", **SMALL, **overrides)
    task = jax_load_task(cfg)
    op = jax_build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel,
                             weighting=cfg.weighting, norm=cfg.norm, use_native=False,
                             fmt="ell")
    model = jax_build_model(cfg, task)
    params = model.init(jax.random.PRNGKey(cfg.seed), op)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    emb = model.apply({"params": params}, op)
    return params, np.asarray(emb), jax_hits(emb, jnp.asarray(task.test_pairs))


def _assert_same(res, emb, metrics):
    np.testing.assert_allclose(res.emb.numpy(), emb, rtol=1e-5, atol=1e-4)
    for k in ("hits@1", "hits@10", "mrr", "hits@1_l2r", "hits@10_r2l"):
        assert res.metrics[k] == pytest.approx(metrics[k], abs=1e-3), k


@pytest.mark.parametrize("overrides", [
    {},
    {"weighting": "funifun", "norm": "rw", "l2_normalize": True, "syn_seed": 3},
    # config highway's gates, with dropout configured (an eval never drops)
    {"weighting": "funifun", "norm": "rw", "highway": True, "dropout": 0.3, "syn_seed": 5},
])
def test_evaluate_matches_jax_slice(overrides):
    params, emb, metrics = _jax_reference(overrides)
    res = evaluate(get_config("base", **SMALL, **overrides), params=params_from_jax(params),
                   device="cpu")
    _assert_same(res, emb, metrics)


def test_evaluate_from_checkpoint_dir(tmp_path):
    params, emb, metrics = _jax_reference({})
    save_params(str(tmp_path / "ckpt"), params_from_jax(params))
    cfg = get_config("base", **SMALL, checkpoint_dir=str(tmp_path / "ckpt"),
                     save_emb_path=str(tmp_path / "emb.pt"))
    res = evaluate(cfg, device="cpu")
    _assert_same(res, emb, metrics)
    torch.testing.assert_close(load_embeddings(str(tmp_path / "emb.pt")), res.emb)
    with pytest.raises(ValueError, match="random init"):
        evaluate(get_config("base", **SMALL, checkpoint_dir=str(tmp_path / "empty")),
                 device="cpu")


def test_evaluate_defaults_to_the_card():
    cfg = get_config("base", **SMALL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate(cfg, params={})


def test_port_never_imports_jax():
    code = (
        "import runpy, sys, pkgutil, importlib\n"
        "import tpugraph_torch\n"
        "for m in pkgutil.walk_packages(tpugraph_torch.__path__, 'tpugraph_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "try:\n"
        "    runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        "except SystemExit:\n"
        "    pass\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tpugraph'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
