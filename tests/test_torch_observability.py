"""The port's observability (counterparts of tests/test_metrics.py and of
the JAX trainer's ``profile_dir``): the TensorBoard sink writes an event
file with every numeric field as a scalar, the JAX sink's tags at the same
steps; ``profile_dir`` writes a trace of epochs start + 2 to start + 5, or
to the end of a shorter run; with ``steps_per_call > 1`` it is refused,
as the JAX trainer refuses it."""

import json
import os

import pytest
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

from tpugraph.train.metrics import MetricsLogger as JaxMetricsLogger
from tpugraph_torch.configs.configs import get_config
from tpugraph_torch.train.driver import run
from tpugraph_torch.train.metrics import MetricsLogger

TINY = dict(syn_n_ent=120, syn_n_rel=5, syn_n_triples=500, syn_seed=3, dim=16, k_neg=5,
            neg_every=2, eval_every=0)
RECORDS = ({"epoch": 0, "loss": 1.5, "hits@1": 0.1},
           {"epoch": 5, "loss": 0.5, "hits@1": 0.4, "note": "text ignored by tb"})


def _scalars(tb_dir) -> dict:
    acc = EventAccumulator(str(tb_dir))
    acc.Reload()
    return {t: [(s.step, s.value) for s in acc.Scalars(t)] for t in acc.Tags()["scalars"]}


def test_tensorboard_sink_writes_the_jax_sinks_events(tmp_path):
    for name, cls in (("port", MetricsLogger), ("jax", JaxMetricsLogger)):
        log = cls(str(tmp_path / f"{name}.jsonl"), config={"dim": 8},
                  tb_dir=str(tmp_path / name))
        for rec in RECORDS:
            log.log(rec)
        log.close()
    assert any("tfevents" in f for f in os.listdir(tmp_path / "port"))
    port = _scalars(tmp_path / "port")
    assert set(port) == {"loss", "hits@1"} and [s for s, _ in port["loss"]] == [0, 5]
    assert port == _scalars(tmp_path / "jax")
    lines = [json.loads(ln) for ln in (tmp_path / "port.jsonl").read_text().splitlines()]
    assert lines[0]["_config"] == {"dim": 8} and lines[2]["epoch"] == 5


def test_a_run_logs_its_history_to_tensorboard(tmp_path):
    res = run(get_config("base", **{**TINY, "eval_every": 2}, epochs=4,
                         tb_dir=str(tmp_path / "tb")), device="cpu")
    loss = _scalars(tmp_path / "tb")["loss"]
    assert [s for s, _ in loss] == [r["epoch"] for r in res.history] == [0, 2, 3]


def _traces(d) -> list[str]:
    return sorted(f for f in os.listdir(d)) if os.path.isdir(d) else []


@pytest.mark.parametrize("epochs, name", [(8, "trace-epochs-2-5.json"),
                                          (4, "trace-epochs-2-3.json")])
def test_profile_dir_writes_a_trace(epochs, name, tmp_path):
    """A run of 8 epochs traces epochs 2-5; one of 4 stops the trace at its
    end, so the trace is written all the same."""
    d = tmp_path / "prof"
    res = run(get_config("base", **TINY, epochs=epochs, profile_dir=str(d)), device="cpu")
    assert res.timings["steps"] == epochs and _traces(d) == [name]
    events = json.loads((d / name).read_text())["traceEvents"]
    assert any("gcn" in str(e.get("name", "")) or "mm" in str(e.get("name", ""))
               for e in events)
    short = tmp_path / "short"
    run(get_config("base", **TINY, epochs=2, profile_dir=str(short)), device="cpu")
    assert _traces(short) == []  # epoch start + 2 never came: nothing traced


def test_profile_dir_with_the_fused_interval_is_refused(tmp_path):
    cfg = get_config("base", **TINY, epochs=4, steps_per_call=2, profile_dir=str(tmp_path))
    with pytest.raises(ValueError, match="profile_dir requires steps_per_call=1"):
        run(cfg, device="cpu")
    assert _traces(tmp_path) == []
