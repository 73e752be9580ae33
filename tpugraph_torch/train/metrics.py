"""Metrics sinks and the edges/s convention (counterpart of
``tpugraph/train/metrics.py``): JSONL always, TensorBoard optionally.

Each JSONL line is one JSON record; the first records the config.
``tb_dir`` adds a TensorBoard event-file sink: every numeric field of a
record becomes a scalar, stepped by the record's ``epoch``/``step`` field.
It needs the ``tensorboard`` package, imported only when ``tb_dir`` is set.
"""

from __future__ import annotations

import json
import time


def epoch_edge_ops(nnz: int, use_attr_channel: bool = False) -> int:
    """Edge-ops of one training epoch: one forward+backward pass of one
    adjacency SpMM over one nonzero counts one edge-op, so the 2-layer GCN
    does 2·nnz per epoch (4·nnz with the AE channel).  Trainers log
    ``edges_per_s = epoch_edge_ops(...) * epochs / wall``."""
    return nnz * (4 if use_attr_channel else 2)


class MetricsLogger:
    """JSONL records, one per line; the first records the config.
    ``path=None`` drops every record; ``tb_dir`` writes them to TensorBoard
    too."""

    def __init__(self, path: str | None, config: dict | None = None,
                 tb_dir: str | None = None):
        self._tb = None
        if tb_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                raise ImportError(f"tb_dir={tb_dir!r} needs the 'tensorboard' package, "
                                  f"which is not installed ({e})") from e
            self._tb = SummaryWriter(log_dir=tb_dir)
            if config is not None:
                self._tb.add_text("config", json.dumps(config), 0)
        self._f = open(path, "a") if path else None
        if self._f and config is not None:
            self._write({"_config": config, "_t": time.time()})

    def _write(self, rec: dict):
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def log(self, rec: dict):
        if self._f:
            self._write({**rec, "_t": time.time()})
        if self._tb is not None:
            step = int(rec.get("epoch", rec.get("step", 0)))
            for k, v in rec.items():
                if k not in ("epoch", "step") and isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)

    def close(self):
        if self._f:
            self._f.close()
            self._f = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
