"""Attribute-channel GCN, the GCN-Align "AE" channel (counterpart of
``tpugraph/models/attr_channel.py``).

Each entity's input feature is the mean of its attributes' embeddings: a
product with the rectangular entity × attribute incidence, row-normalised,
held as an ELL operator, or as sorted padded edges for ``spmm_impl``
sorted/xla (``build_attr_operator``; no dense multihot matrix at any
scale).  Its gradient for the attribute table is the same product over
the prebuilt transpose (``kernels/spmm_ell.py::spmm_ell``,
``kernels/spmm.py::spmm``).  The features then go through a 2-layer GCN
over the merged adjacency, as the structural (SE) channel does.  The
channel computes in fp32 whatever the encoder's ``param_dtype``, as the
JAX channel takes no compute dtype.

At evaluation the channels combine GCN-Align-style (``combine_channels``):
the L1 distance of [β·se_n ‖ (1−β)·ae_n] is β·d_SE + (1−β)·d_AE on
L2-row-normalised channels.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tpugraph_torch.kernels.spmm import spmm, spmm_xla
from tpugraph_torch.kernels.spmm_ell import spmm_ell
from tpugraph_torch.nn.graphconv import GraphConvolution, operator_format
from tpugraph_torch.sparse.build import build_spmm_operator
from tpugraph_torch.sparse.ell import EllOperator, build_ell_operator
from tpugraph_torch.sparse.graph import PAD_BUCKET, SpMMOperator


def build_attr_operator(attr_triples: np.ndarray, n_ent: int, n_attr: int, fmt: str = "ell",
                        bucket: int = PAD_BUCKET) -> EllOperator | SpMMOperator:
    """Entity × attribute incidence, duplicates dropped, each row weighted
    1/deg (mean aggregation), on the host; ``fmt`` 'ell' or 'sorted' (padded
    to ``bucket``)."""
    ent = attr_triples[:, 0].astype(np.int64)
    att = attr_triples[:, 1].astype(np.int64)
    uniq = np.unique(ent * n_attr + att)
    ent, att = uniq // n_attr, uniq % n_attr
    deg = np.bincount(ent, minlength=n_ent).astype(np.float64)
    if fmt == "sorted":
        return build_spmm_operator(att, ent, 1.0 / deg[ent], n_ent, bucket=bucket,
                                   n_cols=n_attr)
    if fmt != "ell":
        raise ValueError(f"unknown fmt {fmt!r}; expected 'ell' or 'sorted'")
    return build_ell_operator(att, ent, 1.0 / deg[ent], n_ent, n_cols=n_attr)


class AttrChannelGCN(nn.Module):
    """Parameters ``attr_emb`` (n_attr, dim), ``gc1.{w,b}`` and ``gc2.{w,b}``:
    the flax tree's ``ae_encoder/{attr_emb, GraphConvolution_0,
    GraphConvolution_1}``."""

    def __init__(self, n_attr: int, dim: int, spmm_impl: str = "ell",
                 device: torch.device | str | None = None):
        super().__init__()
        operator_format(spmm_impl)
        self.impl = spmm_impl
        self.attr_emb = nn.Parameter(torch.empty(n_attr, dim, device=device))
        self.gc1 = GraphConvolution(dim, dim, impl=spmm_impl, device=device)
        self.gc2 = GraphConvolution(dim, dim, impl=spmm_impl, device=device)

    def forward(self, adj_op: EllOperator | SpMMOperator,
                attr_op: EllOperator | SpMMOperator) -> torch.Tensor:
        if self.impl == "sorted":
            x0 = spmm(attr_op, self.attr_emb)  # (n_ent, dim)
        elif self.impl == "xla":
            x0 = spmm_xla(attr_op, self.attr_emb)
        else:
            x0 = spmm_ell(attr_op, self.attr_emb)
        h = torch.relu(self.gc1(x0, adj_op))
        return self.gc2(h, adj_op)


def init_attr_channel_params(n_attr: int, dim: int, seed: int = 0) -> dict[str, torch.Tensor]:
    """Random AE-channel parameters from a numpy seed: ``attr_emb`` ~
    N(0, 1/dim), W xavier-uniform, b = 0 (flax's initialisers)."""
    rng = np.random.default_rng([seed, 2])
    lim = np.sqrt(6.0 / (2 * dim))
    params = {"attr_emb": rng.standard_normal((n_attr, dim)) / np.sqrt(dim)}
    for layer in ("gc1", "gc2"):
        params[f"{layer}.w"] = rng.uniform(-lim, lim, (dim, dim))
        params[f"{layer}.b"] = np.zeros(dim)
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in params.items()}


def combine_channels(se: torch.Tensor, ae: torch.Tensor, beta: float = 0.9) -> torch.Tensor:
    """[β·se_n ‖ (1−β)·ae_n], rows L2-normalised per channel: its L1
    distance is β·d_SE + (1−β)·d_AE.  The equality is L1's: a squared
    euclidean score weights the channels β² : (1−β)²."""
    se_n = se / (torch.linalg.vector_norm(se, dim=-1, keepdim=True) + 1e-8)
    ae_n = ae / (torch.linalg.vector_norm(ae, dim=-1, keepdim=True) + 1e-8)
    return torch.cat([beta * se_n, (1.0 - beta) * ae_n], dim=-1)
