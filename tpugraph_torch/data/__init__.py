"""Datasets: the synthetic DBP15K-shaped generator and the DBP15K and
OpenEA readers."""

from tpugraph_torch.data.dbp15k import load_dbp15k
from tpugraph_torch.data.openea import load_openea
from tpugraph_torch.data.synthetic import synthetic_align_task

__all__ = ["load_dbp15k", "load_openea", "synthetic_align_task"]
