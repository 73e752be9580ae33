"""AlignMTL — the flagship multi-task model (counterpart of
``tpugraph/models/align.py``): the shared AlignGCN encoder, the alignment
losses (margin, optional Sinkhorn OT), the auxiliary relation and
attribute heads, and optionally the GCN-Align attribute (AE) channel:

    L = L_margin + λ_ot·L_ot + λ_rel·L_rel + λ_attr·L_attr + λ_ae·L_ae
"""

from __future__ import annotations

import torch
from torch import nn

from tpugraph_torch.configs.configs import TrainConfig
from tpugraph_torch.models.attr_channel import (AttrChannelGCN, combine_channels,
                                                init_attr_channel_params)
from tpugraph_torch.models.encoder import AlignGCN, init_params
from tpugraph_torch.models.heads import AttributeHead, RelationHead, init_head_params
from tpugraph_torch.sparse.ell import EllOperator
from tpugraph_torch.sparse.graph import SpMMOperator
from tpugraph_torch.train.losses import MARGIN_INDEX, margin_align_loss
from tpugraph_torch.train.ot import sinkhorn_align_loss

Operator = EllOperator | SpMMOperator


class AlignMTL(nn.Module):
    """Parameters under ``encoder.``, ``rel_head.``, ``attr_head.`` and
    ``ae_encoder.`` (``convert.params_from_jax`` maps the flax tree onto
    them).  ``n_rel`` and ``n_attr`` size the heads and the AE channel."""

    def __init__(self, n_ent: int, cfg: TrainConfig, device: torch.device | str | None = None,
                 n_rel: int = 0, n_attr: int = 0):
        super().__init__()
        if (cfg.use_rel_head and n_rel < 1) or (
                (cfg.use_attr_head or cfg.use_attr_channel) and n_attr < 1):
            raise ValueError(f"the heads need n_rel >= 1 and n_attr >= 1 "
                             f"(got n_rel={n_rel}, n_attr={n_attr})")
        self.cfg = cfg
        self.encoder = AlignGCN(n_ent=n_ent, dim=cfg.dim, hidden=cfg.hidden,
                                highway=cfg.highway, dropout=cfg.dropout,
                                compute_dtype=cfg.param_dtype,
                                l2_normalize=cfg.l2_normalize, spmm_impl=cfg.spmm_impl,
                                device=device)
        self.rel_head = RelationHead(n_rel, cfg.dim, device) if cfg.use_rel_head else None
        self.attr_head = AttributeHead(cfg.dim, n_attr, device) if cfg.use_attr_head else None
        self.ae_encoder = (AttrChannelGCN(n_attr, cfg.dim, cfg.spmm_impl, device)
                           if cfg.use_attr_channel else None)

    def embed(self, op: Operator, attr_op: Operator | None = None) -> torch.Tensor:
        """Evaluation embeddings: the SE table, or with the attribute channel
        the β-weighted SE‖AE concat (2·dim wide)."""
        se = self.encoder(op)
        if self.ae_encoder is not None and attr_op is not None:
            return combine_channels(se, self.ae_encoder(op, attr_op), self.cfg.attr_beta)
        return se

    def forward(self, op: Operator, batch: dict, train: bool = False,
                attr_op: Operator | None = None,
                generator: torch.Generator | None = None) -> tuple[torch.Tensor, dict]:
        """batch (int64 ids on the model's device): pairs (S, 2), neg_l,
        neg_r (S', k); with bootstrapping pairs_aug (S', 2) and w (S'), the
        seed pairs and the proposals for the margin losses only; optional
        ot_pairs, the interval's subsample of the seed pairs for the OT head;
        per enabled head rel_triples (T, 3), rel_neg_t, rel_neg_h (T, k) and
        attr_triples (B, 2); optional ``MARGIN_INDEX``, the margins' backward
        index over the table's rows.  ``train`` (with ``generator``) turns the
        encoder's dropout on.  Returns (loss, {"margin", ["sinkhorn"],
        ["rel"], ["attr"], ["ae"], "total"})."""
        c = self.cfg
        emb = self.encoder(op, train=train, generator=generator)
        loss, aux = table_losses(c, emb, batch, self.rel_head, self.attr_head)
        if self.ae_encoder is not None and attr_op is not None:
            ae = self.ae_encoder(op, attr_op)
            l_ae = margin_align_loss(ae, batch.get("pairs_aug", batch["pairs"]), batch["neg_l"],
                                     batch["neg_r"], c.gamma, batch.get("w"),
                                     index=batch.get(MARGIN_INDEX))
            aux["ae"] = l_ae
            loss = loss + c.attr_channel_weight * l_ae
        aux["total"] = loss
        return loss, aux


def table_losses(cfg: TrainConfig, emb: torch.Tensor, batch: dict,
                 rel_head: RelationHead | None = None, attr_head: AttributeHead | None = None,
                 ot_loss=None) -> tuple[torch.Tensor, dict]:
    """The losses that read the entity table ``emb`` (``AlignMTL.forward``'s
    batch keys): the margin, the OT head (``ot_loss``, by default
    ``sinkhorn_align_loss``; the distributed trainer passes the ring loss)
    and the heads given, weighted; returns (loss, {"margin", ["sinkhorn"],
    ["rel"], ["attr"]})."""
    aux = {"margin": margin_align_loss(emb, batch.get("pairs_aug", batch["pairs"]),
                                       batch["neg_l"], batch["neg_r"], cfg.gamma, batch.get("w"),
                                       index=batch.get(MARGIN_INDEX))}
    if cfg.use_sinkhorn:
        aux["sinkhorn"] = (ot_loss or sinkhorn_align_loss)(
            emb, batch.get("ot_pairs", batch["pairs"]), tau=cfg.sinkhorn_tau,
            n_iters=cfg.sinkhorn_iters)
    if rel_head is not None:
        aux["rel"] = rel_head(emb, batch["rel_triples"], batch["rel_neg_t"], batch["rel_neg_h"])
    if attr_head is not None:
        aux["attr"] = attr_head(emb, batch["attr_triples"])
    return weighted_loss(cfg, aux), aux


# each term's weight in the config; the margin's is 1
LOSS_WEIGHTS = {"sinkhorn": "sinkhorn_weight", "rel": "rel_weight", "attr": "attr_weight",
                "ae": "attr_channel_weight"}


def weighted_loss(cfg: TrainConfig, aux: dict) -> torch.Tensor:
    """The loss of its terms ``aux`` (``table_losses``'s, and the AE
    channel's "ae"): the margin plus each other term times its weight, in
    ``aux``'s order."""
    loss = aux["margin"]
    for k, v in aux.items():
        if k != "margin":
            loss = loss + getattr(cfg, LOSS_WEIGHTS[k]) * v
    return loss


def init_mtl_params(cfg: TrainConfig, n_ent: int, n_rel: int = 0, n_attr: int = 0,
                    seed: int = 0) -> dict[str, torch.Tensor]:
    """Random AlignMTL parameters from a numpy seed: the encoder's are
    ``init_params(seed)``'s, the heads' and the AE channel's come from
    streams of their own."""
    params = {f"encoder.{k}": v for k, v in init_params(
        n_ent, cfg.dim, cfg.hidden, seed=seed, highway=cfg.highway).items()}
    params.update(init_head_params(cfg.dim, n_rel if cfg.use_rel_head else 0,
                                   n_attr if cfg.use_attr_head else 0, seed=seed))
    if cfg.use_attr_channel:
        params.update({f"ae_encoder.{k}": v
                       for k, v in init_attr_channel_params(n_attr, cfg.dim, seed).items()})
    return params
