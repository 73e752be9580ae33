"""tpugraph_torch — the PyTorch/CUDA port of tpugraph for NVIDIA Hopper.

Each module mirrors its counterpart under ``tpugraph/`` (same path, same
public names) so the two are easy to hold side by side.  The port imports
``torch`` and numpy only.  Every kernel the JAX package wrote in Pallas for
the TPU is a kernel written by hand for ``sm_90a`` under ``csrc/``, built
with nvcc at first use and bound through ctypes (``kernels/_build.py``).

Layer map:
    data/      synthetic DBP15K-shaped generator and the DBP15K and OpenEA
               readers (numpy, arrays identical to the JAX package's)
    sparse/    KG containers, adjacency build, degree-bucketed ELL operator,
               sorted padded edge lists (``spmm_impl`` sorted/xla), the
               edge partitioner and each shard's halo operators
    native/    the C++ adjacency builder, compiled by g++ at first use
    kernels/   plain-torch ELL and sorted SpMM, distances and Sinkhorn
               solver, and the five CUDA kernels: the fused GCN layer
               (forward), the ELL SpMM (the layers' backward over the
               transpose, and the attribute incidence forward and
               backward), the sorted-segment SpMM (both directions under
               ``spmm_impl="sorted"``), the fused Sinkhorn potential
               update (the OT head's forward) and the shortlist distances
               (the approximate search paths' rerank); ELL and sorted
               SpMMs and the fused layer in fp32 or bf16
    nn/        GraphConvolution (trainable in fp32 and bf16, ELL, sorted or
               xla aggregation), the highway gate
    models/    AlignGCN encoder (highway gates, dropout), AlignMTL (margin,
               Sinkhorn, relation and attribute heads, the AE channel)
    train/     losses, OT head, negatives (exact and approximate), optimizer,
               metrics, Hits@k (exact, or within shortlists),
               the training loops (``fit``, ``fit_mtl``; the fused interval
               as a captured CUDA graph, ``fused.py``) and ``driver.py``
               (``run``, ``evaluate``)
    dist/      the edge-partitioned distributed trainer (config
               ``dwy100k_dist``) over ``torch.distributed``: shards to
               ranks, the halo-exchange SpMM on the hand SpMM kernels,
               ring mining and eval, ``fit_distributed``
    cli/       ``python -m tpugraph_torch.cli.main`` — train a named config
    configs/   TrainConfig copies of the capability configs
    serve.py   top-k alignment search, export, embedding save/load, CLI
    convert.py flax parameter tree -> port parameters

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``, which runs every kernel's plain PyTorch version.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on.  ``cuda`` without a card raises:
    only an explicit ``cpu`` runs the plain versions on the host."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
