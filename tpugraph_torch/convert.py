"""Parameters between the two packages, and the port's parameter file.

``params_from_jax`` takes the flax parameter tree of ``AlignGCN``, or of
``AlignMTL`` (the encoder's tree under "encoder"), as nested dicts of numpy
arrays (the caller runs ``jax.tree_util.tree_map(np.asarray, params)``) and
returns the port's parameters: the matching state dict, with the same
leaves and layouts.
``save_params`` writes them where ``train.driver.evaluate`` reads them.
"""

from __future__ import annotations

import os

import numpy as np
import torch

PARAMS_FILE = "params.pt"


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """{"emb", "gc1": {"w", "b"}, "gc2": {"w", "b"}} -> {"emb", "gc1.w", ...};
    {"encoder": {...}} -> {"encoder.emb", "encoder.gc1.w", ...}."""
    if "encoder" in tree:
        extra = set(tree) - {"encoder"}
        if extra:
            raise NotImplementedError(f"parameters {sorted(extra)} are not ported yet")
        return {f"encoder.{k}": v for k, v in params_from_jax(tree["encoder"]).items()}
    extra = set(tree) - {"emb", "gc1", "gc2"}
    if extra:
        raise NotImplementedError(f"parameters {sorted(extra)} are not ported yet")
    out = {"emb": tree["emb"]}
    for layer in ("gc1", "gc2"):
        for leaf in ("w", "b"):
            out[f"{layer}.{leaf}"] = tree[layer][leaf]
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}


def save_params(checkpoint_dir: str, params: dict[str, torch.Tensor]) -> str:
    """Write ``<checkpoint_dir>/params.pt`` (to a temporary name, then
    renamed); returns its path."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, PARAMS_FILE)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({k: v.detach().cpu() for k, v in params.items()}, tmp)
    os.replace(tmp, path)
    return path


def load_params(checkpoint_dir: str) -> dict[str, torch.Tensor]:
    """The parameters ``save_params`` wrote, on the CPU."""
    return torch.load(os.path.join(checkpoint_dir, PARAMS_FILE), map_location="cpu",
                      weights_only=True)
