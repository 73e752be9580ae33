"""Metrics sink and the edges/s convention (counterpart of
``tpugraph/train/metrics.py``).  The TensorBoard sink is not ported."""

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
    ``path=None`` drops every record."""

    def __init__(self, path: str | None, config: dict | None = None,
                 tb_dir: str | None = None):
        if tb_dir:
            raise NotImplementedError("the TensorBoard sink is not ported yet")
        self._f = open(path, "a") if path else None
        if self._f and config is not None:
            self._write({"_config": config, "_t": time.time()})

    def _write(self, rec: dict):
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def log(self, rec: dict):
        if self._f:
            self._write({**rec, "_t": time.time()})

    def close(self):
        if self._f:
            self._f.close()
            self._f = None
