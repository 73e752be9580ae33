"""Parameters between the two packages, and the port's parameter file.

``params_from_jax`` takes the flax parameter tree of ``AlignGCN``, or of
``AlignMTL`` (the encoder's tree under "encoder", the heads' and the AE
channel's beside it), or of the distributed trainer (``AlignGCN``'s
leaves, its ``emb`` the padded (n_pad, dim) table, which
``dist/trainer.py::DistEncoder.load_full`` cuts into each rank's rows,
and the heads' ``rel`` and ``attr_out`` beside them), as
nested dicts of numpy arrays (the caller runs
``jax.tree_util.tree_map(np.asarray, params)``) and returns the port's
parameters: the matching state dict, with the same leaves and layouts.  A
gradient tree maps the same way.
``embed_params`` picks what the evaluation embeddings read from a model's
state dict; ``save_params`` writes it where ``train.driver.evaluate`` reads it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

PARAMS_FILE = "params.pt"
AE_PREFIX = "ae_encoder."


def _leaves(tree: dict, layers: dict[str, str], top: tuple[str, ...] = ()) -> dict:
    """{flax layer: {"w", "b"}} -> {"<port layer>.w", "<port layer>.b"},
    plus the leaves named in ``top`` as they are; anything else raises."""
    extra = set(tree) - set(layers) - set(top)
    if extra:
        raise ValueError(f"unknown parameters {sorted(extra)}")
    out = {k: tree[k] for k in top if k in tree}
    for flax_name, name in layers.items():
        if flax_name in tree:
            if set(tree[flax_name]) != {"w", "b"}:
                raise ValueError(f"{flax_name} holds {sorted(tree[flax_name])}, not w and b")
            out[f"{name}.w"], out[f"{name}.b"] = tree[flax_name]["w"], tree[flax_name]["b"]
    return out


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """{"emb", "gc1", "gc2"[, "hw1", "hw2"][, "rel"][, "attr_out"]} ->
    {"emb", "gc1.w", ..., "rel_head.rel", "attr_head.w", "attr_head.b"};
    {"encoder", ["rel_head"], ["attr_head"], ["ae_encoder"]} ->
    {"encoder.emb", ..., "rel_head.rel", "attr_head.w", "attr_head.b",
    "ae_encoder.attr_emb", "ae_encoder.gc1.w", ...}."""
    if "encoder" in tree:
        extra = set(tree) - {"encoder", "rel_head", "attr_head", "ae_encoder"}
        if extra:
            raise ValueError(f"unknown parameters {sorted(extra)}")
        out = {f"encoder.{k}": v for k, v in params_from_jax(tree["encoder"]).items()}
        if "rel_head" in tree:
            out.update({f"rel_head.{k}": v for k, v in _leaves(tree["rel_head"], {},
                                                                ("rel",)).items()})
        if "attr_head" in tree:
            dense = tree["attr_head"]
            if set(dense) != {"Dense_0"} or set(dense["Dense_0"]) != {"kernel", "bias"}:
                raise ValueError(f"attr_head holds {dense!r:.200}, not Dense_0/kernel, bias")
            out["attr_head.w"] = dense["Dense_0"]["kernel"]
            out["attr_head.b"] = dense["Dense_0"]["bias"]
        if "ae_encoder" in tree:
            ae = _leaves(tree["ae_encoder"], {"GraphConvolution_0": "gc1",
                                              "GraphConvolution_1": "gc2"}, ("attr_emb",))
            out.update({f"{AE_PREFIX}{k}": v for k, v in ae.items()})
    else:
        out = _leaves(tree, {"gc1": "gc1", "gc2": "gc2", "hw1": "hw1", "hw2": "hw2",
                             "attr_out": "attr_head"}, ("emb", "rel"))
        if "rel" in out:
            out["rel_head.rel"] = out.pop("rel")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in out.items()}


def embed_params(state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """What the evaluation embeddings read, from a model's state dict: an
    AlignGCN's as it is; from an AlignMTL's, the encoder's without its
    prefix and the AE channel's under ``ae_encoder.`` (the heads are left
    out)."""
    if not any(k.startswith("encoder.") for k in state):
        return dict(state)
    return {k.removeprefix("encoder."): v for k, v in state.items()
            if k.startswith(("encoder.", AE_PREFIX))}


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
