"""Which rounding of the bf16 halo layers' weight gradients sits closer to
the fp32 step (the distributed trainer, config ``dwy100k_dist``).

The port sums the halo layers' weight and bias gradients over the rows in
fp32 and keeps them fp32 (``dist/trainer.py::_CastMatmul``, ``_CastBias``),
so a step does not depend on the number of ranks.  The JAX trainer takes
them from ``jax.grad`` through the cast: each device's partial xᵀ·ḡ (and
Σ ḡ) comes out of the bf16 product rounded to bf16, and the partials of the
shards are summed in fp32.  This script takes one step of ``dwy100k_dist``
at full width (8 shards on one rank) at each ``--dims`` width three ways,
from the same parameters and negatives: fp32, bf16 with the port's
rounding, and bf16 with the JAX rounding (each shard's partial rounded to
bf16); and prints, per parameter, the relative L2 distance of each bf16
gradient to the fp32 one.  The SpMMs run their plain versions (autograd
through ``kernels/spmm_ell.py::apply_with_diag``), which take any width;
the kernels take 128 and 256 only.

    python scripts/dist_bf16_rounding_probe.py [--dims 16 64 128] [--device cuda]
        [--syn-n-ent N]

Prints one JSON line per width, then the card's ``nvidia-smi`` name and
power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import os

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from tpugraph_torch.configs.configs import get_config  # noqa: E402
from tpugraph_torch.dist import halo, trainer  # noqa: E402
from tpugraph_torch.dist.mesh import make_mesh  # noqa: E402
from tpugraph_torch.dist.trainer import dist_parts  # noqa: E402
from tpugraph_torch.kernels.spmm_ell import apply_with_diag  # noqa: E402
from tpugraph_torch.train.loop import load_task  # noqa: E402
from tpugraph_torch.train.negatives import sample_uniform_negatives  # noqa: E402


@contextlib.contextmanager
def plain_aggregation():
    """The halo SpMM through the plain ELL version, differentiated by
    autograd (any width)."""
    real = halo.spmm_ell
    halo.spmm_ell = lambda op, x: apply_with_diag(op.fwd, op.diag, x)
    try:
        yield
    finally:
        halo.spmm_ell = real


@contextlib.contextmanager
def jax_rounding(n_loc: int):
    """``_CastMatmul`` and ``_CastBias`` with the JAX trainer's weight
    gradients: each shard's partial (its n_loc rows) rounded to bf16, the
    partials summed in fp32."""
    mm, bias = trainer._CastMatmul.backward, trainer._CastBias.backward

    def rounded(parts):
        return sum(p.to(torch.bfloat16).float() for p in parts)

    def mm_backward(ctx, g):
        x, w = ctx.saved_tensors
        return g @ w.to(g.dtype).t(), rounded(
            xs.float().t() @ gs.float() for xs, gs in zip(x.split(n_loc), g.split(n_loc)))

    def bias_backward(ctx, g):
        return g, rounded(gs.float().sum(0) for gs in g.split(n_loc))

    trainer._CastMatmul.backward = staticmethod(mm_backward)
    trainer._CastBias.backward = staticmethod(bias_backward)
    try:
        yield
    finally:
        trainer._CastMatmul.backward, trainer._CastBias.backward = (staticmethod(mm),
                                                                    staticmethod(bias))


def step(cfg, task, mesh, batch) -> dict[str, torch.Tensor]:
    parts = dist_parts(cfg, task, mesh)
    loss = parts.grads(batch)
    return {"loss": loss.float(), **{k: p.grad.float().clone()
                                     for k, p in parts.model.named_parameters()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dims", type=int, nargs="+", default=[16, 64, 128])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--syn-n-ent", type=int, default=None,
                    help="entities per KG (default: the config's 100,000)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    base = get_config("dwy100k_dist", epochs=10, neg_every=5, eval_every=0)
    if args.syn_n_ent:
        base = base.replace(syn_n_ent=args.syn_n_ent, syn_n_triples=5 * args.syn_n_ent)
    task = load_task(base)
    pairs = torch.as_tensor(task.train_pairs, dtype=torch.int64, device=dev)
    neg_l, neg_r = sample_uniform_negatives(torch.Generator().manual_seed(1), pairs,
                                            task.kg1.n_ent, task.n_ent, base.k_neg)
    batch = {"pairs": pairs, "neg_l": neg_l, "neg_r": neg_r}
    for dim in args.dims:
        cfg = base.replace(dim=dim)
        bf16 = cfg.replace(param_dtype="bfloat16")
        with make_mesh(cfg.n_shards, dev) as mesh, plain_aggregation():
            fp32 = step(cfg, task, mesh, batch)
            port = step(bf16, task, mesh, batch)
            n_loc = dist_parts(bf16, task, mesh).op.n_loc
            with jax_rounding(n_loc):
                jax_like = step(bf16, task, mesh, batch)

        def rel(a):
            return {k: float((a[k] - v).norm() / v.norm().clamp_min(1e-30))
                    for k, v in fp32.items() if k != "gc2.b"}  # gc2.b: 0 by construction

        r_port, r_jax = rel(port), rel(jax_like)
        print(json.dumps({"dim": dim, "n_ent": task.n_ent, "shards": cfg.n_shards,
                          "rel_l2_to_fp32": {"port_fp32_sums": r_port,
                                             "jax_bf16_partials": r_jax},
                          "jax_over_port": {k: r_jax[k] / max(r_port[k], 1e-30)
                                            for k in r_port}}), flush=True)
    try:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip())
    except (OSError, subprocess.SubprocessError):
        print("nvidia-smi: not available")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
