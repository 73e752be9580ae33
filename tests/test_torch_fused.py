"""The fused resample interval in the port (``steps_per_call = neg_every``)
against the unfused port and the JAX package's fused trainer, on the CPU,
where the fused mode runs the interval's steps eagerly (on the card they
are replays of one captured step: tests/test_torch_gpu.py and
chip_smoke.py).

* A fused run equals the unfused run bit for bit — every step's loss, the
  final parameters and metrics — in ``base`` hard mode, with bootstrapping,
  through ``fit_mtl`` (both heads, the attribute channel, an OT subsample)
  and in config ``highway`` with dropout, as tests/test_train_e2e.py,
  tests/test_bootstrap.py and tests/test_mtl.py hold the JAX trainers.
  ``eval_every`` and ``checkpoint_every`` are multiples of ``neg_every``,
  since the fused windows fall at interval ends.
* Its eval and save epochs are those of the JAX fused run of the config.
* Each JAX refusal of the fused interval is the port's, with its message.
* A fused checkpoint resumes at an interval boundary (in either mode); a
  mid-interval one is refused.
* ``--fast`` sets what the JAX CLI's sets, and ``--set`` wins over it.
* A checkpoint's Adam state loads into either mode's Adam.
"""

import os
import signal

import pytest
import torch

import tpugraph.cli.main as jax_cli
import tpugraph.train.checkpoint as jax_checkpoint
import tpugraph.train.driver as jax_driver
from tpugraph.configs import get_config as jax_get_config
from tpugraph.data.synthetic import synthetic_align_task as jax_synthetic_task
from tpugraph.train.loop import fit as jax_fit
from tpugraph.train.mtl import fit_mtl as jax_fit_mtl
from tpugraph_torch.cli.main import main as cli_main
from tpugraph_torch.configs.configs import get_config
from tpugraph_torch.train import driver, loop
from tpugraph_torch.train.checkpoint import Checkpointer
from tpugraph_torch.train.driver import run
from tpugraph_torch.train.mtl import fit_mtl
from tpugraph_torch.train.optim import load_optimizer_state, make_optimizer, optimizer_state

SMALL = dict(syn_n_ent=150, syn_n_rel=5, syn_n_triples=600, syn_seed=6, dim=16, k_neg=5,
             neg_every=4, epochs=12, eval_every=4)
CASES = {
    "base_hard": ("base", dict(neg_mode="hard")),
    "base_boot": ("base", dict(neg_mode="hard", boot_cap=8, boot_start=4, boot_weight=0.5,
                               eval_csls_k=5)),
    "mtl_channel": ("mtl", dict(neg_mode="hard", sinkhorn_iters=5, rel_k_neg=3,
                                use_attr_channel=True, sinkhorn_pairs=16)),
    "highway_dropout": ("highway", dict(neg_mode="hard", dropout=0.3)),
}


@pytest.fixture
def task():
    return loop.load_task(get_config("base", **SMALL))


@pytest.fixture(autouse=True)
def one_thread():
    """One reduction order for every run of a comparison."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same_run(got, want):
    assert got.losses == want.losses
    for k, v in want.params.items():
        assert torch.equal(got.params[k], v), k
    assert got.metrics == want.metrics


@pytest.mark.parametrize("case", list(CASES))
def test_fused_equals_unfused(case, task, tmp_path):
    config, over = CASES[case]
    cfg = get_config(config, **SMALL, **over, checkpoint_every=8)
    plain = run(cfg.replace(checkpoint_dir=str(tmp_path / "plain")), task=task, device="cpu")
    fused = run(cfg.replace(steps_per_call=4, checkpoint_dir=str(tmp_path / "fused")),
                task=task, device="cpu")
    _assert_same_run(fused, plain)
    assert fused.timings["steps"] == 12 and len(fused.timings["step_s"]) == 3
    assert [r["epoch"] for r in fused.history] == [3, 7, 11]
    assert [r["epoch"] for r in plain.history] == [0, 4, 8, 11]
    # the unfused window fires at an interval's first epoch, the fused one at
    # its last (JAX's ``last % every < steps``)
    assert Checkpointer(str(tmp_path / "plain"), 8)._epochs() == [8, 11]
    assert Checkpointer(str(tmp_path / "fused"), 8)._epochs() == [3, 11]
    state = Checkpointer(str(tmp_path / "fused"), 8).restore_latest()[1]
    assert not state["neg_l"].any() and not state["neg_r"].any()  # placeholders: re-mined
    if "boot" in case:
        assert not state["boot_w"].any()


class _RecordingCheckpointer:
    """The JAX trainers' checkpointer, reduced to a record of its saves."""

    def __init__(self, directory, every):
        self.enabled, self.preempted, self.saves = bool(directory) and every > 0, False, []
        _RecordingCheckpointer.last = self

    def restore_latest(self, abstract):
        return None

    def maybe_save(self, epoch, state, force=False):
        self.saves.append(epoch)

    install_preemption_handler = restore_handler = close = lambda self: None


def test_fused_windows_are_the_jax_fused_windows(tmp_path, monkeypatch):
    """Eval and save epochs of a fused run whose windows are not multiples
    of the interval: the JAX fused run's, history and saves."""
    kw = dict(dim=8, k_neg=3, neg_every=2, steps_per_call=2, epochs=8, eval_every=3,
              checkpoint_every=5, neg_mode="uniform")
    monkeypatch.setattr(jax_checkpoint, "Checkpointer", _RecordingCheckpointer)
    jres = jax_fit(jax_get_config("base", checkpoint_dir=str(tmp_path / "jax"), **kw),
                   task=jax_synthetic_task(seed=6, n_ent=100, n_rel=5, n_triples=400))
    saves = []
    real_save = Checkpointer.save
    monkeypatch.setattr(Checkpointer, "save", lambda self, epoch, state, params: (
        saves.append(epoch), real_save(self, epoch, state, params)))
    res = run(get_config("base", syn_n_ent=100, syn_n_rel=5, syn_n_triples=400, syn_seed=6,
                         checkpoint_dir=str(tmp_path / "port"), **kw), device="cpu")
    assert [r["epoch"] for r in res.history] == [r["epoch"] for r in jres.history] == [1, 3, 7]
    assert saves == _RecordingCheckpointer.last.saves == [1, 5, 7]


REFUSALS = {
    "steps_not_neg_every": (dict(steps_per_call=4, neg_every=5, epochs=20),
                            "steps_per_call > 1 requires steps_per_call == neg_every"),
    "epochs_not_a_multiple": (dict(steps_per_call=4, neg_every=4, epochs=10),
                              "epochs=10 is not a multiple of steps_per_call=4"),
    "profile_dir_fused": (dict(steps_per_call=4, neg_every=4, epochs=8, profile_dir="prof"),
                          "profile_dir requires steps_per_call=1"),
}


# the JAX fit_mtl reads no profile_dir, so it has no such refusal to mirror
@pytest.mark.parametrize("case, trainer", [(c, t) for c in REFUSALS for t in ("fit", "fit_mtl")
                                           if not (t == "fit_mtl" and "profile" in c)])
def test_jax_refusals_are_mirrored(case, trainer, task):
    over, msg = REFUSALS[case]
    kw = dict(dim=8, k_neg=3, neg_mode="uniform", **over)
    jtask = jax_synthetic_task(seed=6, n_ent=150, n_rel=5, n_triples=600)
    if trainer == "fit":
        with pytest.raises(ValueError, match=msg):
            jax_fit(jax_get_config("base", **kw), task=jtask)
        with pytest.raises(ValueError, match=msg):
            run(get_config("base", **kw), task=task, device="cpu")
    else:  # the smallest fit_mtl config: the OT head alone
        with pytest.raises(ValueError, match=msg):
            jax_fit_mtl(jax_get_config("sinkhorn", sinkhorn_iters=1, **kw), task=jtask)
        with pytest.raises(ValueError, match=msg):
            fit_mtl(get_config("sinkhorn", sinkhorn_iters=1, **kw), task=task, device="cpu")


def test_mid_interval_resume_is_refused_as_in_jax(task, tmp_path, monkeypatch):
    """A checkpoint saved at epoch 4 resumes at 5, inside the interval
    [4, 8) of steps_per_call = 4: both packages refuse it."""
    cfg = get_config("base", **{**SMALL, "epochs": 5, "eval_every": 0},
                     checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=4)
    run(cfg, task=task, device="cpu")
    assert Checkpointer(cfg.checkpoint_dir, 4)._epochs() == [4]
    fused = cfg.replace(epochs=12, steps_per_call=4)
    with pytest.raises(ValueError, match="resumes at epoch 5, mid-interval"):
        run(fused, task=task, device="cpu")
    monkeypatch.setattr(jax_checkpoint, "Checkpointer", _RecordingCheckpointer)
    monkeypatch.setattr(_RecordingCheckpointer, "restore_latest",
                        lambda self, abstract: (4, abstract))  # saved at 4
    jcfg = jax_get_config("base", dim=8, k_neg=3, neg_every=4, steps_per_call=4, epochs=12,
                          checkpoint_dir=str(tmp_path / "jax"), checkpoint_every=4)
    with pytest.raises(ValueError, match="resumes at epoch 5, mid-interval"):
        jax_fit(jcfg, task=jax_synthetic_task(seed=6, n_ent=150, n_rel=5, n_triples=600))


@pytest.mark.parametrize("resume_fused", [True, False])
def test_fused_checkpoint_resumes_at_the_boundary(resume_fused, task, tmp_path, monkeypatch):
    """SIGTERM during epoch 5 of a fused run: the interval [4, 8) finishes,
    saves at 7 with placeholder negatives and stops; a relaunch (fused or
    not) starts at the boundary 8, re-mines, and ends as the uninterrupted
    run."""
    over = CASES["base_boot"][1]
    cfg = get_config("base", **{**SMALL, "eval_every": 0}, **over, steps_per_call=4,
                     checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=100)
    full = run(cfg.replace(checkpoint_dir=None), task=task, device="cpu")
    calls, real_loss = [0], loop.margin_align_loss

    def loss_then_signal(*args, **kwargs):
        calls[0] += 1
        if calls[0] == 6:
            os.kill(os.getpid(), signal.SIGTERM)
        return real_loss(*args, **kwargs)

    monkeypatch.setattr(loop, "margin_align_loss", loss_then_signal)
    stopped = run(cfg, task=task, device="cpu")
    monkeypatch.setattr(loop, "margin_align_loss", real_loss)
    assert stopped.timings["steps"] == 8
    assert Checkpointer(cfg.checkpoint_dir, 100).latest_step() == 7
    resumed = run(cfg if resume_fused else cfg.replace(steps_per_call=1), task=task,
                  device="cpu")
    assert resumed.timings["start_epoch"] == 8 and resumed.timings["minings"] == 1
    assert stopped.losses + resumed.losses == full.losses
    for k, v in full.params.items():
        assert torch.equal(resumed.params[k], v), k
    assert resumed.metrics == full.metrics


@pytest.mark.parametrize("argv, want", [
    (["--fast"], dict(steps_per_call=5, neg_metric="sqeuclidean", neg_approx=True)),
    (["--fast", "--recipe", "v6"], dict(steps_per_call=2, neg_every=2,
                                        neg_metric="sqeuclidean", neg_approx=True)),
    (["--fast", "--set", "neg_every=3"], dict(steps_per_call=3, neg_every=3)),
    (["--fast", "--set", "steps_per_call=1", "neg_metric=cityblock", "neg_approx=false"],
     dict(steps_per_call=1, neg_metric="cityblock", neg_approx=False)),
])
def test_fast_overrides_as_the_jax_cli(argv, want, monkeypatch):
    """Both CLIs resolve the same config; ``run`` is replaced by a stub that
    keeps it."""
    got = {}

    def keep(name):
        def stub(cfg, **kw):
            got[name] = cfg
            return _Result()
        return stub

    monkeypatch.setattr(driver, "run", keep("port"))
    monkeypatch.setattr(jax_driver, "run", keep("jax"))
    monkeypatch.setenv("TPUGRAPH_COMPILE_CACHE", "")
    assert cli_main([*argv, "--device", "cpu", "--quiet"]) == 0
    assert jax_cli.main([*argv, "--quiet"]) == 0
    for k, v in want.items():
        assert getattr(got["port"], k) == getattr(got["jax"], k) == v, k


class _Result:
    metrics = {"hits@1": 0.0}


def test_optimizer_state_loads_across_modes():
    """A checkpoint's Adam state has one form: a plain Adam's state loads
    into a capturable one (which keeps its flag and its learning-rate
    tensor, filled with the saved value) and back, with the moments and
    step count as saved.  (A capturable Adam steps only CUDA parameters:
    its steps are tests/test_torch_gpu.py's.)"""
    cfg = get_config("base", lr=3e-3, lr_warmup=4)
    p = torch.nn.Parameter(torch.arange(12.0).reshape(4, 3))
    opt, sched = make_optimizer(cfg, [p])
    for _ in range(3):
        opt.zero_grad()
        (p ** 2).sum().backward()
        opt.step()
        sched.step()
    saved = optimizer_state(opt)
    assert saved["param_groups"][0]["lr"] == pytest.approx(3e-3)
    q = torch.nn.Parameter(p.detach().clone())
    cap, cap_sched = make_optimizer(cfg, [q], capturable=True)
    lr = cap.param_groups[0]["lr"]
    load_optimizer_state(cap, saved)
    cap_sched.load_state_dict(sched.state_dict())
    group = cap.param_groups[0]
    assert group["capturable"] and group["lr"] is lr and float(lr) == pytest.approx(3e-3)
    for k in ("exp_avg", "exp_avg_sq", "step"):
        assert torch.equal(cap.state[q][k], opt.state[p][k]), k
    back = optimizer_state(cap)
    (g_back,), (g_saved,) = back["param_groups"], saved["param_groups"]
    assert g_back["lr"] == pytest.approx(g_saved["lr"], rel=1e-7)  # float32 on the card
    assert {**g_back, "lr": 0} == {**g_saved, "lr": 0}
    assert back["state"][0]["step"].device.type == "cpu"
    plain, _ = make_optimizer(cfg, [torch.nn.Parameter(q.detach().clone())])
    load_optimizer_state(plain, back)
    assert not plain.param_groups[0]["capturable"]
    assert plain.param_groups[0]["lr"] == pytest.approx(3e-3)
