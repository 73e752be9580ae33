"""The JAX worker's three multi-process rehearsals
(``tpugraph/dist/mp_worker.py``: ``fit``, ``fitprod``, ``fitprod2``; run
by ``tests/test_multiprocess.py`` on 2 processes of 4 devices) on the
port's spawned gloo ranks (``tpugraph_torch/dist/mp_worker.py``).  A port
rank is a process, so each mode runs on W = 4 ranks, one thread each:

* the port's copies of the rehearsal configurations equal the JAX
  builders' field by field (no JAX compile);
* ``fit_checkpoint`` at (L, Gr, F) = (1, 4, 1): 4 epochs with checkpoints,
  a relaunch to 6 epochs that resumes from the same directory, and the
  grouped exchange in halo groups of 2 ranks (its remap the identity on
  this task, so it equals the ungrouped 4 epochs);
* ``fitprod`` at (1, 2, 2): ring CSLS mining, proposals, the ring OT on a
  subsample, CSLS eval, the column gathers;
* ``fitprod2``: leg A at (1, 2, 2), the attribute channel with dropout and
  the attribute head; leg B at (2, 1, 2), the slice group the only one
  across ranks.

Each rank's losses and metrics are held to the W = 1 run of the same
config (the JAX test holds its processes to loss rel 1e-3 and Hits@1 abs
0.02): bit for bit where the port's fixed-order sums give it (the three
``fit_checkpoint`` runs, leg A's losses), else each loss, the final loss
and the metrics within rel 1e-6 (leg A's Hits@1 within the JAX test's abs
0.02: see ``test_four_ranks_equal_one``).
"""

import numpy as np
import pytest
import torch

from tpugraph.dist import mp_worker as jax_worker
from tpugraph_torch.dist import mp_worker
from tpugraph_torch.dist.mesh import grid_of

CONFIGS = {
    "fit": lambda w: w.fit_rehearsal_config(8, "ck"),
    "fit_resume": lambda w: w.fit_rehearsal_config(8, "ck", epochs=6),
    "fit_grouped": lambda w: w.fit_rehearsal_config(8, grouped=True),
    "prod": lambda w: w.fit_prod_rehearsal_config(8),
    "prod2_a": lambda w: w.fit_prod2_configs(8)[0],
    "prod2_b": lambda w: w.fit_prod2_configs(8)[1],
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_rehearsal_configs_equal_the_jax_builders(name):
    got, want = CONFIGS[name](mp_worker).to_dict(), CONFIGS[name](jax_worker).to_dict()
    assert got == want


def test_rehearsal_task_is_the_jax_one():
    from tpugraph_torch.data.synthetic import synthetic_align_task

    task, want = synthetic_align_task(**mp_worker.REHEARSAL_TASK), jax_worker.fit_rehearsal_task()
    np.testing.assert_array_equal(task.merged_triples, want.merged_triples)
    np.testing.assert_array_equal(task.train_pairs, want.train_pairs)
    np.testing.assert_array_equal(task.test_pairs, want.test_pairs)


# mode: its legs and the grid of each at W = 4
MODES = {
    "fit_checkpoint": {"fit4": (1, 4, 1), "fit6": (1, 4, 1), "grouped": (1, 4, 1)},
    "fitprod": {"prod": (1, 2, 2)},
    "fitprod2": {"leg_a": (1, 2, 2), "leg_b": (2, 1, 2)},
}
LEGS = [(mode, leg) for mode, legs in MODES.items() for leg in legs]
CONFIG_OF = {"fit4": "fit", "fit6": "fit_resume", "grouped": "fit_grouped", "prod": "prod",
             "leg_a": "prod2_a", "leg_b": "prod2_b"}
EXACT = ("fit4", "fit6", "grouped")  # losses and metrics bit for bit
METRICS = ("hits@1", "hits@10", "mrr", "final_loss")
# gradients 0 by construction (the margins read row differences): Adam
# steps them on rounding noise
ZERO_BY_CONSTRUCTION = ("gc2.b", "ae_encoder.gc2.b")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each mode on 4 spawned ranks and on one in-process rank (one
    thread, as each rank runs), computed at first use."""
    out = {}

    def get(mode):
        if mode not in out:
            tmp = tmp_path_factory.mktemp(mode)
            args = (str(tmp / "ck"),) if mode == "fit_checkpoint" else ()
            ranks = mp_worker.run_ranks(mode, 4, tmp, *args, timeout=240.0)
            one_args = (str(tmp / "ck_one"),) if mode == "fit_checkpoint" else ()
            threads = torch.get_num_threads()
            torch.set_num_threads(1)
            try:
                one = mp_worker.MODES[mode](*one_args)
            finally:
                torch.set_num_threads(threads)
            out[mode] = ranks, one, tmp
        return out[mode]

    return get


@pytest.mark.parametrize("mode,leg", LEGS)
def test_four_ranks_equal_one(runs, mode, leg):
    """Each rank's run of the leg equals W = 1: bit for bit where the
    sums keep their order; else each loss within rel 1e-6, the parameters
    within rel 1e-5 and the metrics within rel 1e-6, but for leg A's
    metrics: its attribute channel's output bias has a zero gradient, Adam
    steps it on rounding noise, and ``combine_channels`` normalises each
    row of that channel, so the evaluation sees the bias: Hits@1 is held to
    the JAX test's abs 0.02 (its losses stay equal bit for bit)."""
    ranks, one, _ = runs(mode)
    want = one[leg]
    cfg = CONFIGS[CONFIG_OF[leg]](mp_worker)
    assert grid_of(4, cfg.slice_shards, cfg.n_shards, cfg.feature_shards) == MODES[mode][leg]
    assert len(want["losses"]) == (2 if leg == "fit6" else 4)
    assert all(np.isfinite(want["losses"]))
    for r in ranks:
        got = r[leg]
        assert got["timings"]["start_epoch"] == want["timings"]["start_epoch"]
        if leg in EXACT:
            assert got["losses"] == want["losses"]
            assert got["metrics"] == want["metrics"]
            continue
        for k, v in want["params"].items():
            if k not in ZERO_BY_CONSTRUCTION:
                assert float((got["params"][k] - v).norm() / v.norm()) < 1e-5, k
        if leg == "leg_a":
            assert got["losses"] == want["losses"]
            assert got["metrics"]["final_loss"] == want["metrics"]["final_loss"]
            assert got["metrics"]["hits@1"] == pytest.approx(want["metrics"]["hits@1"], abs=0.02)
            continue
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
        for k in METRICS:
            assert got["metrics"][k] == pytest.approx(want["metrics"][k], rel=1e-6, abs=1e-6), k


def test_the_relaunch_resumes_the_checkpoints_of_four_ranks(runs):
    """The 4-epoch run saved at epochs 2 and 3 (rank 0 writing); the
    relaunch to 6 epochs restored epoch 3 on every rank, ran 4 and 5 and
    saved both (the newest three kept)."""
    import os

    ranks, one, tmp = runs("fit_checkpoint")
    assert sorted(os.listdir(tmp / "ck")) == ["ckpt-3.pt", "ckpt-4.pt", "ckpt-5.pt", "params.pt"]
    for r in ranks + [one]:
        assert r["fit4"]["timings"]["saves"] == 2 and r["fit4"]["timings"]["start_epoch"] == 0
        assert r["fit6"]["timings"]["start_epoch"] == 4 and r["fit6"]["timings"]["steps"] == 2
        assert r["fit6"]["timings"]["saves"] == 2


def test_the_grouped_leg_equals_the_ungrouped_run(runs):
    """The JAX rehearsal's last check: on this task the grouped remap is the
    identity (128 entities a side, r0 = 128 at 8 shards), so the grouped run
    across the halo groups reproduces the ungrouped 4 epochs."""
    ranks, one, _ = runs("fit_checkpoint")
    for r in ranks + [one]:
        assert r["grouped"]["losses"] == r["fit4"]["losses"]
        assert r["grouped"]["metrics"] == r["fit4"]["metrics"]
