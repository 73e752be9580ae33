"""Checkpoint and resume in the port (the counterparts of
tests/test_checkpoint.py's kill-and-resume tests, and of the eval-only
path): a resumed run reproduces the uninterrupted one bit for bit on the
CPU — in ``base`` hard mode, with bootstrapping, and through ``fit_mtl`` —
resuming mid-interval; SIGTERM saves and exits cleanly; the checkpointer
keeps the newest three and refuses a checkpoint without the resume state;
``driver.evaluate`` scores a trained directory as the run's final eval did."""

import json
import os
import signal

import pytest
import torch

from tpugraph_torch.cli.main import main as cli_main
from tpugraph_torch.configs.configs import get_config
from tpugraph_torch.train import loop
from tpugraph_torch.train.checkpoint import KEEP, Checkpointer
from tpugraph_torch.train.driver import evaluate, run

SMALL = dict(syn_n_ent=150, syn_n_rel=5, syn_n_triples=600, syn_seed=6, dim=16, k_neg=5,
             neg_every=4, eval_every=0)
CASES = {
    "base_hard": ("base", dict(neg_mode="hard")),
    "base_boot": ("base", dict(neg_mode="hard", boot_cap=8, boot_start=2, boot_weight=0.5,
                               eval_csls_k=5)),
    "mtl_boot": ("sinkhorn", dict(neg_mode="hard", boot_cap=8, boot_start=2, boot_weight=0.5,
                                  sinkhorn_iters=5, eval_csls_k=5)),
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
    for k, v in want.params.items():
        assert torch.equal(got.params[k], v), k
    assert got.metrics == want.metrics


@pytest.mark.parametrize("case", list(CASES))
def test_resume_reproduces_uninterrupted_run(case, task, tmp_path):
    """Saved at epochs 6 and 9 (the last of a 10-epoch run), resumed at 10,
    mid-interval (the boundary is 8): the saved negatives and proposals are
    reused, and the 15-epoch result is the uninterrupted one."""
    config, over = CASES[case]
    cfg = get_config(config, **SMALL, **over)
    full = run(cfg.replace(epochs=15), task=task, device="cpu")
    cfg_a = cfg.replace(epochs=10, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=6)
    first = run(cfg_a, task=task, device="cpu")
    assert Checkpointer(cfg_a.checkpoint_dir, 6)._epochs() == [6, 9]
    resumed = run(cfg_a.replace(epochs=15), task=task, device="cpu")
    assert resumed.timings["start_epoch"] == 10 and resumed.timings["steps"] == 5
    assert first.losses + resumed.losses == full.losses
    _assert_same_run(resumed, full)
    if "boot" in case:
        assert full.timings["proposals"] == 3  # epochs 4, 8 and 12
        state = Checkpointer(cfg_a.checkpoint_dir, 6).restore_latest()[1]
        assert state["boot_w"].sum() > 0 and state["neg_l"].shape == (len(task.train_pairs) + 8, 5)


def test_sigterm_saves_and_exits_cleanly(task, tmp_path, monkeypatch):
    """SIGTERM during epoch 4: the loop saves epoch 4, stops, restores the
    previous handler, and a relaunch finishes as the uninterrupted run."""
    calls = []
    prev = signal.signal(signal.SIGTERM, lambda *_: calls.append("outer"))
    real_loss = loop.margin_align_loss

    def loss_then_signal(*args, **kwargs):
        calls.append("step")
        if calls.count("step") == 5:
            os.kill(os.getpid(), signal.SIGTERM)
        return real_loss(*args, **kwargs)

    try:
        cfg = get_config("base", **SMALL, epochs=10, checkpoint_dir=str(tmp_path / "ck"),
                         checkpoint_every=100)
        full = run(cfg.replace(checkpoint_dir=None), task=task, device="cpu")
        monkeypatch.setattr(loop, "margin_align_loss", loss_then_signal)
        stopped = run(cfg, task=task, device="cpu")
        monkeypatch.setattr(loop, "margin_align_loss", real_loss)
        assert stopped.timings["steps"] == 5 and "outer" not in calls
        assert Checkpointer(cfg.checkpoint_dir, 100).latest_step() == 4
        assert signal.getsignal(signal.SIGTERM) is not signal.SIG_DFL
        os.kill(os.getpid(), signal.SIGTERM)  # the previous handler is back
        assert calls[-1] == "outer"
        resumed = run(cfg, task=task, device="cpu")
        assert resumed.timings["start_epoch"] == 5
        _assert_same_run(resumed, full)
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_checkpointer_keeps_the_newest_and_refuses_an_incomplete_one(task, tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"), 1)
    params = {"w": torch.ones(2)}
    for epoch in range(1, 6):
        ck.save(epoch, {"x": torch.tensor(epoch)}, params)
    ck.save(5, {"x": torch.tensor(50)}, params)  # already the newest: no-op
    assert ck._epochs() == [6 - KEEP + i for i in range(KEEP)] == [3, 4, 5]
    assert ck.restore_latest()[1]["x"].item() == 5
    assert sorted(os.listdir(ck.dir)) == ["ckpt-3.pt", "ckpt-4.pt", "ckpt-5.pt", "params.pt"]
    off = Checkpointer(None, 0)
    off.save(1, {}, params)
    assert off.restore_latest() is None and off.latest_step() is None
    cfg = get_config("base", **SMALL, epochs=8, checkpoint_dir=ck.dir, checkpoint_every=1)
    with pytest.raises(ValueError, match="predates the resume state"):
        run(cfg, task=task, device="cpu")


def test_evaluate_a_trained_directory(task, tmp_path, capsys):
    """v6's shape at a tiny size: the directory's params.pt scores as the
    run's final eval (CSLS), through driver.evaluate and --eval-only."""
    over = dict(CASES["mtl_boot"][1], checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=3)
    cfg = get_config("sinkhorn", **SMALL, **over, epochs=6)
    trained = run(cfg, task=task, device="cpu")
    ev = evaluate(cfg, task=task, device="cpu")
    assert ev.metrics == {k: v for k, v in trained.metrics.items() if k != "final_loss"}
    sets = [f"{k}={v}" for k, v in {**SMALL, **over}.items()]
    assert cli_main(["--config", "sinkhorn", "--eval-only", "--device", "cpu", "--quiet",
                     "--set", *sets]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["hits@1"] == round(ev.metrics["hits@1"], 4)
