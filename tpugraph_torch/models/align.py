"""AlignMTL — the encoder with the alignment losses (counterpart of
``tpugraph/models/align.py``, margin and Sinkhorn heads):

    L = L_margin + λ_ot·L_ot

The relation and attribute heads and the AE channel belong to the MTL
slice and raise (``ROADMAP.md``).
"""

from __future__ import annotations

import torch
from torch import nn

from tpugraph_torch.configs.configs import TrainConfig
from tpugraph_torch.models.encoder import AlignGCN
from tpugraph_torch.sparse.ell import EllOperator
from tpugraph_torch.train.losses import margin_align_loss
from tpugraph_torch.train.ot import sinkhorn_align_loss


class AlignMTL(nn.Module):
    """Parameters under ``encoder.`` (``convert.params_from_jax`` maps the
    flax tree {"encoder": {...}} onto them)."""

    def __init__(self, n_ent: int, cfg: TrainConfig, device: torch.device | str | None = None):
        super().__init__()
        for flag in ("use_rel_head", "use_attr_head", "use_attr_channel"):
            if getattr(cfg, flag):
                raise NotImplementedError(f"{flag} is not ported yet (the MTL slice)")
        self.cfg = cfg
        self.encoder = AlignGCN(n_ent=n_ent, dim=cfg.dim, hidden=cfg.hidden,
                                highway=cfg.highway, dropout=cfg.dropout,
                                compute_dtype=cfg.param_dtype,
                                l2_normalize=cfg.l2_normalize, device=device)

    def embed(self, op: EllOperator) -> torch.Tensor:
        """Evaluation embeddings (the SE channel)."""
        return self.encoder(op)

    def forward(self, op: EllOperator, batch: dict) -> tuple[torch.Tensor, dict]:
        """batch: pairs (S, 2), neg_l, neg_r (S', k) int64 on the model's
        device, and with bootstrapping pairs_aug (S', 2) and w (S',): the
        seed pairs and the proposals with their weights, for the margin loss
        only.  The Sinkhorn head stays on the seed pairs.  Returns (loss,
        {"margin", ["sinkhorn"], "total"})."""
        c = self.cfg
        emb = self.encoder(op)
        loss = margin_align_loss(emb, batch.get("pairs_aug", batch["pairs"]), batch["neg_l"],
                                 batch["neg_r"], c.gamma, batch.get("w"))
        aux = {"margin": loss}
        if c.use_sinkhorn:
            l_ot = sinkhorn_align_loss(emb, batch["pairs"], tau=c.sinkhorn_tau,
                                       n_iters=c.sinkhorn_iters)
            aux["sinkhorn"] = l_ot
            loss = loss + c.sinkhorn_weight * l_ot
        aux["total"] = loss
        return loss, aux
