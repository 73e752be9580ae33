"""Where one training step of config ``dwy100k_dist`` parts between the
port's paths, on an NVIDIA GPU.

    python3 scripts/dist_step_probe.py

From the repository root: the full-width task of ``chip_smoke.py``'s dist
phase and one batch of injected uniform negatives, through four paths on
the same parameters: the single-device step (``driver.step_parts``) with
its kernels and with its plain versions (``chip_smoke._plain_kernels``),
and the distributed step (8 shards on an NCCL group of one rank) in ell
and in sorted.  For each pair it prints, as one JSON object: the loss's
relative difference; each gradient's relative L2 difference (``gc2.b``,
0 by construction, left out); the largest relative difference of the
layer-1 pre-activations and of the output table; the layer-1 units whose
ReLU takes the other side; and the L1 margin terms (a pair's row against
a right negative's, per component) whose sign differs.  A gradient's
relative L2 difference grows as the square root of the flipped units and
terms, so a few flips among 25.6 million units move it by ≈ 1e-3.
"""

from __future__ import annotations

import contextlib
import json
import os
import runpy
import sys

import torch


def main() -> int:
    sys.path.insert(0, os.getcwd())
    g = runpy.run_path("chip_smoke.py", run_name="not_main")["main"].__globals__
    smi = g["phase_device"]()
    dev = torch.device("cuda")
    cfg = g["get_config"]("dwy100k_dist", **g["DIST_CUTS"])
    task = g["load_task"](cfg)
    n = task.n_ent
    pairs = torch.as_tensor(task.train_pairs, dtype=torch.int64, device=dev)
    neg_l, neg_r = g["sample_uniform_negatives"](torch.Generator().manual_seed(1), pairs,
                                                 task.kg1.n_ent, n, cfg.k_neg)
    batch = {"pairs": pairs, "neg_l": neg_l, "neg_r": neg_r}
    paths = {}  # name -> (loss, grads, layer-1 pre-activations, output table)

    def grads_of(model):
        return {k: p.grad.detach().clone()[:n] if k == "emb" else p.grad.detach().clone()
                for k, p in model.named_parameters()}

    single = g["step_parts"](cfg.replace(n_shards=1), task, dev)
    for name, ctx in (("single_kernels", contextlib.nullcontext),
                      ("single_plain", g["_plain_kernels"])):
        with ctx():
            single.model.zero_grad(set_to_none=True)
            loss = single.loss_fn(batch, None)[0]
            loss.backward()
            with torch.no_grad():
                z1 = single.model.gc1(single.model.emb, single.op)
                table = single.model(single.op)
        paths[name] = (loss.item(), grads_of(single.model), z1, table)
    with g["make_mesh"](cfg.n_shards, dev) as mesh:
        for impl in ("ell", "sorted"):
            parts = g["dist_parts"](cfg.replace(spmm_impl=impl), task, mesh)
            loss = parts.grads(batch)
            with torch.no_grad():
                z1 = parts.model.gc1(parts.model.emb, parts.op)[:n]
                table = parts.embed()[:n]
            paths[f"dist_{impl}"] = (loss.item(), grads_of(parts.model), z1, table)
            del parts

    out = {}
    names = list(paths)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            (la, ga, za, ta), (lb, gb, zb, tb) = paths[a], paths[b]
            sa = torch.sign(ta[pairs[:, 0], None, :] - ta[neg_r])
            sb = torch.sign(tb[pairs[:, 0], None, :] - tb[neg_r])
            out[f"{a} ~ {b}"] = {
                "loss_rel": abs(la - lb) / abs(lb),
                "grad_rel_l2": {k: float((ga[k] - gb[k]).norm() / gb[k].norm())
                                for k in gb if k != "gc2.b"},
                "layer1_max_rel": float((za - zb).abs().max() / zb.abs().max()),
                "table_max_rel": float((ta - tb).abs().max() / tb.abs().max()),
                "relu1_flips": int(((za > 0) != (zb > 0)).sum()),
                "margin_sign_flips": int((sa != sb).sum())}
    z_plain = paths["single_plain"][2]
    print(json.dumps({"card": smi, "layer1_units": int(z_plain.numel()),
                      "layer1_active": int((z_plain > 0).sum()),
                      "margin_terms": int(pairs.shape[0] * cfg.k_neg * cfg.dim),
                      "pairs": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
