"""Auxiliary multi-task heads (counterpart of ``tpugraph/models/heads.py``):
the relation and attribute heads that read the shared entity embeddings.

* ``RelationHead`` — DistMult, s(h, r, t) = Σ e_h ⊙ w_r ⊙ e_t, with a
  binary cross-entropy of the positives against corrupted tails and heads.
* ``AttributeHead`` — a linear map of the entity embedding to attribute
  logits, with a log-softmax cross-entropy per (entity, attribute) triple.

``init_head_params`` draws their parameters from the flax initialisers'
distributions with a numpy seed, as ``models/encoder.py::init_params`` does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class RelationHead(nn.Module):
    """Parameter ``rel`` (n_rel, dim), the flax tree's ``rel_head/rel``."""

    def __init__(self, n_rel: int, dim: int, device: torch.device | str | None = None):
        super().__init__()
        self.rel = nn.Parameter(torch.empty(n_rel, dim, device=device))

    def forward(self, emb: torch.Tensor, triples: torch.Tensor, neg_tails: torch.Tensor,
                neg_heads: torch.Tensor) -> torch.Tensor:
        """triples (T, 3) [h, r, t]; neg_tails, neg_heads (T, k) corrupted
        entity ids.  Returns the BCE loss: positives → 1, corruptions → 0."""
        h, r, t = emb[triples[:, 0]], self.rel[triples[:, 1]], emb[triples[:, 2]]
        pos = (h * r * t).sum(-1)  # (T,)
        neg_t = torch.einsum("td,tkd->tk", h * r, emb[neg_tails])
        neg_h = torch.einsum("td,tkd->tk", r * t, emb[neg_heads])
        pos_loss = -F.logsigmoid(pos).mean()
        neg_loss = -0.5 * (F.logsigmoid(-neg_t).mean() + F.logsigmoid(-neg_h).mean())
        return pos_loss + neg_loss


class AttributeHead(nn.Module):
    """Parameters ``w`` (dim, n_attr) and ``b`` (n_attr,), the flax tree's
    ``attr_head/Dense_0/{kernel, bias}``."""

    def __init__(self, dim: int, n_attr: int, device: torch.device | str | None = None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(dim, n_attr, device=device))
        self.b = nn.Parameter(torch.zeros(n_attr, device=device))

    def forward(self, emb: torch.Tensor, attr_triples: torch.Tensor) -> torch.Tensor:
        """attr_triples (B, 2) rows [ent, attr]; returns the mean CE."""
        logits = emb[attr_triples[:, 0]] @ self.w + self.b
        log_p = torch.log_softmax(logits, dim=-1)
        return -log_p.gather(1, attr_triples[:, 1:2]).mean()


def lecun_normal(rng: np.random.Generator, fan_in: int, fan_out: int) -> np.ndarray:
    """flax's default Dense kernel: a normal of variance 1/fan_in truncated
    at two standard deviations (and rescaled to keep that variance)."""
    std = np.sqrt(1.0 / fan_in) / 0.87962566103423978
    z = rng.standard_normal((fan_in, fan_out))
    while (out := np.abs(z) > 2.0).any():
        z[out] = rng.standard_normal(int(out.sum()))
    return (z * std).astype(np.float32)


def init_head_params(dim: int, n_rel: int = 0, n_attr: int = 0,
                     seed: int = 0) -> dict[str, torch.Tensor]:
    """Random head parameters from a numpy seed: ``rel_head.rel`` ~
    N(0, 1/dim) when ``n_rel`` > 0; ``attr_head.w`` lecun-normal and
    ``attr_head.b`` = 0 when ``n_attr`` > 0."""
    rng = np.random.default_rng([seed, 1])
    params = {}
    if n_rel:
        params["rel_head.rel"] = (rng.standard_normal((n_rel, dim)) / np.sqrt(dim)).astype(
            np.float32)
    if n_attr:
        params["attr_head.w"] = lecun_normal(rng, dim, n_attr)
        params["attr_head.b"] = np.zeros(n_attr, np.float32)
    return {k: torch.from_numpy(v) for k, v in params.items()}
