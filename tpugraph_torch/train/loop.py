"""Serving-side pieces of the training loop (counterpart of
``tpugraph/train/loop.py``): task loading, model construction, and the
no-grad forward that produces the embedding table.  ``fit`` comes with the
training slice.
"""

from __future__ import annotations

import torch

from tpugraph_torch.configs.configs import TrainConfig
from tpugraph_torch.data.synthetic import synthetic_align_task
from tpugraph_torch.models.encoder import AlignGCN
from tpugraph_torch.sparse.ell import EllOperator
from tpugraph_torch.sparse.graph import AlignTask


def load_task(cfg: TrainConfig) -> AlignTask:
    if cfg.dataset == "synthetic":
        return synthetic_align_task(
            seed=cfg.syn_seed,
            n_ent=cfg.syn_n_ent,
            n_rel=cfg.syn_n_rel,
            n_triples=cfg.syn_n_triples,
            drop_frac=cfg.syn_drop_frac,
            noise_frac=cfg.syn_noise_frac,
            train_ratio=cfg.train_ratio,
            name=f"synthetic-{cfg.pair}",
        )
    raise NotImplementedError(f"dataset {cfg.dataset!r} is not ported yet (synthetic only)")


def build_model(cfg: TrainConfig, task: AlignTask,
                device: torch.device | str | None = None) -> AlignGCN:
    if cfg.spmm_impl not in ("ell", "pallas"):
        raise NotImplementedError(f"spmm_impl={cfg.spmm_impl!r} is not ported yet (ell only)")
    return AlignGCN(
        n_ent=task.n_ent,
        dim=cfg.dim,
        hidden=cfg.hidden,
        highway=cfg.highway,
        dropout=cfg.dropout,
        compute_dtype=cfg.param_dtype,
        l2_normalize=cfg.l2_normalize,
        device=device,
    )


def embed(model: AlignGCN, op: EllOperator) -> torch.Tensor:
    """The encoder's output table (fp32), forward only."""
    with torch.no_grad():
        return model(op)
