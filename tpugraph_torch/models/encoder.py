"""AlignGCN — the 2-layer sparse-GCN entity-alignment encoder (counterpart
of ``tpugraph/models/encoder.py``).

A trainable entity-embedding table propagated through two
GraphConvolution layers over the merged KG-pair adjacency (an
``EllOperator`` for ``spmm_impl`` ell, an ``SpMMOperator`` for sorted and
xla), with optional highway gates (config ``highway``) and dropout on the
second layer's input.  With ``compute_dtype="bfloat16"`` the table is cast
to bf16 on the way in, the layers, gates and dropout run in bf16 over the
fp32 parameters, and the output goes back to fp32 for the losses and the
evals, as in the JAX encoder.
Dropout is active only in a training forward (``train=True``): the
evaluation embeddings, the proposals, mining and evals never drop.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tpugraph_torch.nn.graphconv import GraphConvolution
from tpugraph_torch.nn.highway import Highway
from tpugraph_torch.sparse.ell import EllOperator
from tpugraph_torch.sparse.graph import SpMMOperator

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def keep_mask(shape: tuple[int, ...], rate: float, generator: torch.Generator | None,
              device: torch.device) -> torch.Tensor:
    """flax's dropout rule as a bool mask: keep where uniform < 1 − rate,
    the uniforms from ``generator`` on ``device``."""
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Inverted dropout: x/(1 − rate) where ``mask`` (by default
    ``keep_mask`` of x's shape from ``generator``, on x's device) keeps, 0
    elsewhere."""
    mask = keep_mask(x.shape, rate, generator, x.device) if mask is None else mask
    return torch.where(mask, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class AlignGCN(nn.Module):
    """Parameters: ``emb`` (n_ent, dim), ``gc1.w`` (dim, hidden), ``gc1.b``,
    ``gc2.w`` (hidden, dim), ``gc2.b``, and with highway gates ``hw1.{w,b}``
    and ``hw2.{w,b}`` (dim, dim) — the flax tree's leaves, flattened
    (``convert.params_from_jax``)."""

    def __init__(self, n_ent: int, dim: int = 128, hidden: int | None = None,
                 highway: bool = False, dropout: float = 0.0,
                 compute_dtype: str = "float32", l2_normalize: bool = False,
                 spmm_impl: str = "ell", device: torch.device | str | None = None):
        super().__init__()
        if compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(_COMPUTE_DTYPES)}")
        hidden = hidden or dim
        if highway and hidden != dim:
            raise ValueError(
                f"highway gates require hidden == dim (got {hidden} != {dim}): the gate "
                "interpolates pre/post-aggregation states of equal width")
        self.compute_dtype = _COMPUTE_DTYPES[compute_dtype]
        self.l2_normalize = l2_normalize
        self.dropout = dropout
        self.emb = nn.Parameter(torch.empty(n_ent, dim, device=device))
        self.gc1 = GraphConvolution(dim, hidden, impl=spmm_impl, device=device)
        self.gc2 = GraphConvolution(hidden, dim, impl=spmm_impl, device=device)
        self.hw1 = Highway(dim, device=device) if highway else None
        self.hw2 = Highway(dim, device=device) if highway else None

    def layer_activations(self, op: EllOperator | SpMMOperator, train: bool = False,
                          generator: torch.Generator | None = None) -> list[torch.Tensor]:
        """[input embeddings, layer-1 act, layer-2 act] — the parity hook.
        ``train`` turns dropout on, with its uniforms from ``generator``."""
        x = self.emb.to(self.compute_dtype)
        h = torch.relu(self.gc1(x, op))
        if self.hw1 is not None:
            h = self.hw1(x, h)
        h_in = dropout(h, self.dropout, generator) if train and self.dropout > 0.0 else h
        h2 = self.gc2(h_in, op)
        if self.hw2 is not None:
            h2 = self.hw2(h, h2)  # the gate reads the un-dropped h
        out = h2.float()  # losses/eval always in fp32
        if self.l2_normalize:
            out = out / (torch.linalg.vector_norm(out, dim=-1, keepdim=True) + 1e-8)
        return [x, h, out]

    def forward(self, op: EllOperator | SpMMOperator, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return self.layer_activations(op, train, generator)[-1]


def init_params(n_ent: int, dim: int = 128, hidden: int | None = None,
                seed: int = 0, highway: bool = False) -> dict[str, torch.Tensor]:
    """Random AlignGCN parameters from a numpy seed, drawn from the flax
    initialisers' distributions: emb ~ N(0, 1/dim), W ~ xavier-uniform,
    b = 0, the highway gates' too.  (The numbers differ from a
    ``jax.random`` init of the same seed.)"""
    rng = np.random.default_rng(seed)
    hidden = hidden or dim

    def xavier(fan_in, fan_out):
        lim = np.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-lim, lim, (fan_in, fan_out)).astype(np.float32)

    params = {
        "emb": (rng.standard_normal((n_ent, dim)) / np.sqrt(dim)).astype(np.float32),
        "gc1.w": xavier(dim, hidden),
        "gc1.b": np.zeros(hidden, np.float32),
        "gc2.w": xavier(hidden, dim),
        "gc2.b": np.zeros(dim, np.float32),
    }
    if highway:
        for gate in ("hw1", "hw2"):
            params[f"{gate}.w"] = xavier(dim, dim)
            params[f"{gate}.b"] = np.zeros(dim, np.float32)
    return {k: torch.from_numpy(v) for k, v in params.items()}
