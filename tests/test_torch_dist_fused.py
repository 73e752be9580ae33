"""The distributed trainer's fused interval and trace window
(``tpugraph_torch/dist/trainer.py``, ``steps_per_call = neg_every``,
``profile_dir``) against the JAX distributed trainer and against the
unfused run, on the CPU (gloo, one rank; the kernels run their plain
versions, and a fused interval's steps run eagerly):

* a fused run at 8 shards equals the unfused run bit for bit: each step's
  loss, the final parameters and the metrics, with hard negatives and on
  recipe v7r's surface;
* the JAX trainer's refusals of the fused interval, with its messages,
  the two refusals of a resume across a change of mode among them, and
  eval-only adopting a fused checkpoint as the JAX ``evaluate`` does;
* the history epochs and the saved epochs of one tiny fused run equal
  those of the JAX ``fit_distributed`` (dim 8, 2 shards, 8 epochs);
* ``profile_dir`` writes the trace of epochs 2-5; ``--config dwy100k_dist
  --fast`` trains from the CLI;
* at R = 1 the distributed step (and the boundary's forward) calls no
  ``torch.distributed`` function.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tpugraph.configs.configs import get_config as jax_get_config
from tpugraph.dist.trainer import fit_distributed as jax_fit_distributed
from tpugraph_torch.cli.main import main as cli_main
from tpugraph_torch.configs.configs import get_config
from tpugraph_torch.configs.recipes import RECIPES
from tpugraph_torch.data.synthetic import synthetic_align_task
from tpugraph_torch.dist import mp_worker
from tpugraph_torch.dist.mesh import make_mesh
from tpugraph_torch.dist.trainer import dist_parts, fit_distributed
from tpugraph_torch.train.driver import evaluate

TASK = dict(seed=4, n_ent=120, n_rel=5, n_triples=500)
KW = dict(dim=16, epochs=8, eval_every=4, k_neg=4, neg_every=4, syn_n_ent=120)
CASES = {
    "hard": get_config("base", n_shards=8, neg_mode="hard", **KW),
    # recipe v7r's surface: proposals from epoch 2, the OT head on a
    # subsample, the attribute head, CSLS mining and eval, dropout
    "v7r": get_config("dwy100k_dist", **{
        **RECIPES["v7r"], **KW, "boot_start": 2, "boot_cap": 20, "sinkhorn_pairs": 13,
        "neg_csls_k": 3, "eval_csls_k": 5, "neg_every": 2, "dropout": 0.3}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_fused_run_equals_the_unfused_run_bit_for_bit(case):
    task = synthetic_align_task(**TASK)
    cfg = CASES[case]
    plain = fit_distributed(cfg, task=task, device="cpu")
    fused = fit_distributed(cfg.replace(steps_per_call=cfg.neg_every), task=task, device="cpu")
    assert fused.losses == plain.losses
    assert set(fused.params) == set(plain.params)
    for k, v in plain.params.items():
        assert torch.equal(fused.params[k], v), k
    assert fused.metrics == plain.metrics
    assert fused.timings["steps"] == cfg.epochs
    assert fused.timings["minings"] == plain.timings["minings"] > 0


def test_the_jax_refusals_of_the_fused_interval(tmp_path):
    task = synthetic_align_task(**TASK)
    base = get_config("base", n_shards=2, **KW)
    for over, what in ((dict(steps_per_call=2), "steps_per_call == neg_every"),
                       (dict(steps_per_call=4, epochs=6), "not a multiple of steps_per_call=4"),
                       (dict(steps_per_call=4, profile_dir=str(tmp_path)),
                        r"profile_dir requires steps_per_call=1")):
        with pytest.raises(ValueError, match=what):
            fit_distributed(base.replace(**over), task=task, device="cpu")
    fused = base.replace(steps_per_call=4, eval_every=0, checkpoint_every=4)
    unfused = fused.replace(steps_per_call=1)
    for saved, resumed, what in (
            (fused, unfused, r"was saved with steps_per_call > 1 \(no interval-batch state\)"),
            (unfused, fused, r"was saved with steps_per_call == 1 \(carries interval-batch")):
        ck = str(tmp_path / f"ck{saved.steps_per_call}")
        fit_distributed(saved.replace(checkpoint_dir=ck, epochs=4), task=task, device="cpu")
        with pytest.raises(ValueError, match=what):
            fit_distributed(resumed.replace(checkpoint_dir=ck), task=task, device="cpu")
        # eval-only takes the checkpoint's mode, as the JAX evaluate does
        ev = evaluate(unfused.replace(checkpoint_dir=ck), task=task, device="cpu")
        assert ev.timings["start_epoch"] == 4 and ev.timings["steps"] == 0
    # a fused resume starts at the saved interval's end and equals the whole run
    ck = str(tmp_path / "ck4")
    whole = fit_distributed(fused, task=task, device="cpu")
    resumed = fit_distributed(fused.replace(checkpoint_dir=ck), task=task, device="cpu")
    assert resumed.timings["start_epoch"] == 4
    assert resumed.losses == whole.losses[4:]


def test_the_fused_windows_are_the_jax_trainers(tmp_path):
    """History and saves in one tiny fused run (2 steps a call, a save
    every 3 epochs, an eval every 4): the epochs whose interval ends in the
    window, ``last % every < steps``, and the run's last."""
    over = dict(n_shards=2, dim=8, epochs=8, neg_every=2, steps_per_call=2, k_neg=3,
                eval_every=4, checkpoint_every=3, syn_n_ent=60, syn_n_rel=4,
                syn_n_triples=240, neg_mode="uniform")
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    j = jax_fit_distributed(jax_get_config("dwy100k_dist", **over, checkpoint_dir=jax_dir))
    p = fit_distributed(get_config("dwy100k_dist", **over, checkpoint_dir=port_dir),
                        device="cpu")
    j_epochs, p_epochs = [r["epoch"] for r in j.history], [r["epoch"] for r in p.history]
    assert p_epochs == j_epochs == [1, 5, 7]
    j_saves = sorted(int(d) for d in os.listdir(jax_dir) if d.isdigit())
    p_saves = sorted(int(f[5:-3]) for f in os.listdir(port_dir) if f.startswith("ckpt-"))
    assert p_saves == j_saves == [1, 3, 7]
    assert p.timings["saves"] == 3 and p.timings["steps"] == 8


def test_profile_dir_traces_epochs_two_to_five(tmp_path):
    task = synthetic_align_task(**TASK)
    cfg = get_config("base", n_shards=2, **{**KW, "epochs": 7, "eval_every": 0},
                     profile_dir=str(tmp_path))
    res = fit_distributed(cfg, task=task, device="cpu")
    assert os.listdir(tmp_path) == ["trace-epochs-2-5.json"]
    with open(tmp_path / "trace-epochs-2-5.json") as f:
        assert json.load(f)["traceEvents"]
    assert res.timings["steps"] == 7


def test_the_cli_trains_the_config_fast(capsys):
    assert cli_main(["--config", "dwy100k_dist", "--fast", "--device", "cpu", "--quiet",
                     "--set", "syn_n_ent=60", "syn_n_rel=4", "syn_n_triples=200", "dim=8",
                     "k_neg=3", "epochs=6", "neg_every=3", "eval_every=0"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["config"] == "dwy100k_dist"
    assert all(np.isfinite(line[k]) for k in ("hits@1", "final_loss"))


def test_one_rank_calls_no_collective(monkeypatch):
    """At R = 1 the halo SpMM reads the boundary rows from x, the gather
    and the gradient sum are skipped: a step and a boundary forward run
    with every collective of ``torch.distributed`` made to raise."""
    task = synthetic_align_task(**TASK)
    cfg = CASES["v7r"].replace(dropout=0.0)
    with make_mesh(8, torch.device("cpu")) as mesh:
        parts = dist_parts(cfg, task, mesh)
        assert parts.op.direct and parts.op.bnd is not None
        batch = mp_worker.surface_batch(cfg, task)

        def refused(*args, **kwargs):
            raise AssertionError("a collective at R = 1")

        for name in ("all_to_all_single", "all_gather", "all_reduce", "batch_isend_irecv",
                     "barrier", "broadcast", "reduce_scatter_tensor", "all_gather_into_tensor"):
            monkeypatch.setattr(dist, name, refused)
        loss = parts.grads(batch)
        parts.embed()
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p.grad).all() for p in parts.model.parameters())
