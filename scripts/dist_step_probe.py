"""Where one training step of config ``dwy100k_dist`` parts between the
port's paths, on an NVIDIA GPU.

    python3 scripts/dist_step_probe.py [--recipe v7r] [--gcn-src PATH ...]

From the repository root: the full-width task of ``chip_smoke.py``'s dist
phase and one batch of injected uniform negatives, through four paths on
the same parameters: the single-device step (``driver.step_parts``) with
its kernels and with its plain versions (``chip_smoke._plain_kernels``),
and the distributed step (8 shards on an NCCL group of one rank) in ell
and in sorted.  With ``--recipe v7r``, ``chip_smoke.py::phase_dist_v7r``'s
configuration (dim 256, k_neg 100, the ring OT on 4,096 pairs, the
attribute head) and its injected batch (``mp_worker.surface_batch``:
proposals at their weights, uniform negatives over seeds and proposals,
the interval's draws), through the single-device paths and the
distributed step in ell.  For each pair of paths it prints, as one JSON
object: the loss's relative difference; each gradient's relative L2
difference (``gc2.b``, 0 by construction, left out); the largest relative
difference of the layer-1 pre-activations and of the output table; the
layer-1 units whose ReLU takes the other side; the L1 margin terms (a
pair's row against a negative's, per component, both sides, over the
margin pairs of weight > 0) whose sign differs; and the hinge terms
(pair, negative) that are active on one path only.  A gradient's relative
L2 difference grows as the square root of the flipped units and terms, so
a few flips among 25.6 million units move it by ≈ 1e-3.

``--gcn-src PATH`` (repeatable): another version of
``tpugraph_torch/csrc/gcn_fused.cu`` (same C interface and headers),
labelled by its directory's name.  Each is built (its ptxas registers and
spills printed, or nvcc's refusal) and the single-device kernel step runs
once more with it in place of the checkout's library, as the path
``single_kernels@<label>``, compared with every other path.  Then
``layer``: the fp32 (128, 128) layer on the zh-en-scale operator and on
the step's DWY100K operator, with random x, W and b, through each
version (timed by CUDA events in turns, the checkout's first and last)
and through the plain version, each output's relative L2 error against
the same layer in float64, with the checkout's (256, 128) instance's
beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import runpy
import sys
from pathlib import Path

import numpy as np
import torch

BLOCK = 1024  # margin rows per comparison block: (1,024, k, d) fp32 each


def _margin_flips(ta, tb, pairs, neg_l, neg_r, gamma: float) -> tuple[int, int]:
    """(component sign flips of e_l − e_neg_r and e_neg_l − e_r, hinge
    activity flips) between the tables ``ta`` and ``tb``."""
    signs = hinges = 0
    for a in range(0, pairs.shape[0], BLOCK):
        p, nl, nr = pairs[a:a + BLOCK], neg_l[a:a + BLOCK], neg_r[a:a + BLOCK]
        active = []
        for t in (ta, tb):
            dr = t[p[:, 0], None, :] - t[nr]
            dl = t[nl] - t[p[:, 1], None, :]
            d_pos = (t[p[:, 0]] - t[p[:, 1]]).abs().sum(-1, keepdim=True)
            active.append((torch.sign(dr), torch.sign(dl),
                           d_pos + gamma - dr.abs().sum(-1) > 0,
                           d_pos + gamma - dl.abs().sum(-1) > 0))
        (sra, sla, hra, hla), (srb, slb, hrb, hlb) = active
        signs += int((sra != srb).sum()) + int((sla != slb).sum())
        hinges += int((hra != hrb).sum()) + int((hla != hlb).sum())
    return signs, hinges


def _gcn_versions(srcs: list[str], build) -> tuple[dict, dict]:
    """Each ``--gcn-src`` built: {label: loaded library} for those that
    built, and {label: ptxas lines or nvcc's error} for all."""
    libs, info = {}, {}
    for src in srcs:
        label = Path(src).resolve().parent.name
        try:
            built = build("gcn_fused", src)
        except RuntimeError as e:
            info[label] = {"src": src, "error": str(e)[-2000:]}
            continue
        libs[label] = ctypes.CDLL(str(built.path))
        info[label] = {"src": src, "ptxas": [ln.strip() for ln in built.log.splitlines()
                                             if "registers" in ln or "spill" in ln]}
    return libs, info


@contextlib.contextmanager
def _gcn_lib(build_mod, lib):
    """``kernels/gcn_fused.py`` launching ``lib`` (None: the checkout's)."""
    saved = build_mod._LIBS.get("gcn_fused")
    if lib is not None:
        build_mod._LIBS["gcn_fused"] = lib
    try:
        yield
    finally:
        if saved is None:
            build_mod._LIBS.pop("gcn_fused", None)
        else:
            build_mod._LIBS["gcn_fused"] = saved


def _layer_readings(g, build_mod, libs: dict, ops: dict, dev) -> dict:
    """The fp32 (128, 128) layer on each operator through each version and
    the plain version: relative L2 error against float64, ms in turns; the
    checkout's (256, 128) instance beside it."""
    from tpugraph_torch.kernels.gcn_fused import fused_gcn_layer, reference_layer

    rng = np.random.default_rng(0)
    out = {}
    for name, op in ops.items():
        csr = g["_csr_of"](op.fwd, op.diag).double()
        rec = {}
        for d_in in (128, 256):
            x = torch.from_numpy(rng.standard_normal((op.n_rows, d_in)).astype(np.float32)).to(dev)
            w = torch.from_numpy((rng.standard_normal((d_in, 128)) / np.sqrt(d_in))
                                 .astype(np.float32)).to(dev)
            b = torch.from_numpy(rng.standard_normal(128).astype(np.float32)).to(dev)
            want = torch.sparse.mm(csr, x.double()) @ w.double() + b.double()

            def rel(y):
                return float((y.double() - want).norm() / want.norm())

            plain = reference_layer(op.fwd, op.diag, x, w, b)
            versions = {"checkout": None, **libs} if d_in == 128 else {"checkout": None}
            got = {}
            for label, lib in versions.items():
                with _gcn_lib(build_mod, lib):
                    y = fused_gcn_layer(op.fwd, op.diag, x, w, b)
                got[label] = {"rel_l2_vs_float64": rel(y),
                              "max_abs_err_vs_plain": float((y - plain).abs().max())}
            if d_in == 128:
                order = [*versions, *reversed(versions)]
                times = {label: [] for label in versions}
                for label in order:
                    with _gcn_lib(build_mod, versions[label]):
                        times[label].append(g["time_ms"](
                            lambda: fused_gcn_layer(op.fwd, op.diag, x, w, b)))
                for label in versions:
                    got[label]["ms"] = times[label]
            rec[f"({d_in}, 128)"] = {"plain_rel_l2_vs_float64": rel(plain), **got}
        out[name] = {"rows": op.n_rows, "edges": op.nnz, **rec}
    return out


def main(argv=None) -> int:
    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("--recipe", choices=["v7r"], default=None)
    args.add_argument("--gcn-src", action="append", default=[],
                      help="another version of csrc/gcn_fused.cu (repeatable)")
    args = args.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    g = runpy.run_path("chip_smoke.py", run_name="not_main")["main"].__globals__
    smi = g["phase_device"]()
    dev = torch.device("cuda")
    build_mod = g["_build"]
    libs, versions = _gcn_versions(args.gcn_src, build_mod.build)
    if args.recipe:
        cfg = g["get_config"]("dwy100k_dist", **g["RECIPES"][args.recipe]).replace(
            sinkhorn_pairs=g["DIST_V7R_OT_PAIRS"], **g["DIST_V7R_CUTS"])
        task = g["load_task"](cfg)
        batch = g["mp_worker"].surface_batch(cfg, task, device=dev)
        impls = ("ell",)
    else:
        cfg = g["get_config"]("dwy100k_dist", **g["DIST_CUTS"])
        task = g["load_task"](cfg)
        pairs = torch.as_tensor(task.train_pairs, dtype=torch.int64, device=dev)
        neg_l, neg_r = g["sample_uniform_negatives"](torch.Generator().manual_seed(1), pairs,
                                                     task.kg1.n_ent, task.n_ent, cfg.k_neg)
        batch = {"pairs": pairs, "neg_l": neg_l, "neg_r": neg_r}
        impls = ("ell", "sorted")
    n = task.n_ent
    m_pairs = batch.get("pairs_aug", batch["pairs"])
    live = batch["w"] > 0 if "w" in batch else slice(None)  # the margin rows that count
    margin = (m_pairs[live], batch["neg_l"][live], batch["neg_r"][live])
    paths = {}  # name -> (loss, grads, layer-1 pre-activations, output table)

    def grads_of(model):
        return {k.removeprefix("encoder."): p.grad.detach().clone()[:n] if k.endswith("emb")
                else p.grad.detach().clone() for k, p in model.named_parameters()}

    single = g["step_parts"](cfg.replace(n_shards=1), task, dev)
    enc = getattr(single.model, "encoder", single.model)
    runs = [("single_kernels", contextlib.nullcontext), ("single_plain", g["_plain_kernels"]),
            *((f"single_kernels@{label}", lambda lib=lib: _gcn_lib(build_mod, lib))
              for label, lib in libs.items())]
    for name, ctx in runs:
        with ctx():
            single.model.zero_grad(set_to_none=True)
            loss = single.loss_fn(batch, None)[0]
            loss.backward()
            with torch.no_grad():
                z1 = enc.gc1(enc.emb, single.op)
                table = enc(single.op)
        paths[name] = (loss.item(), grads_of(single.model), z1, table)
    with g["make_mesh"](cfg.n_shards, dev) as mesh:
        for impl in impls:
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
            signs, hinges = _margin_flips(ta, tb, *margin, cfg.gamma)
            out[f"{a} ~ {b}"] = {
                "loss_rel": abs(la - lb) / abs(lb),
                "grad_rel_l2": {k: float((ga[k] - gb[k]).norm() / gb[k].norm())
                                for k in gb if k != "gc2.b"},
                "layer1_max_rel": float((za - zb).abs().max() / zb.abs().max()),
                "table_max_rel": float((ta - tb).abs().max() / tb.abs().max()),
                "relu1_flips": int(((za > 0) != (zb > 0)).sum()),
                "margin_sign_flips": signs, "hinge_flips": hinges}
    z_plain = paths["single_plain"][2]
    rows = margin[0].shape[0]
    layer = None
    if libs:
        zh = g["synthetic_align_task"](**g["ZH_EN"])
        ops = {"zh_en": g["build_adjacency"](zh.n_ent, zh.merged_triples, n_rel=zh.n_rel).to(dev),
               "dwy100k": single.op}
        layer = _layer_readings(g, build_mod, libs, ops, dev)
    print(json.dumps({"card": smi, "recipe": args.recipe, "dim": cfg.dim, "k_neg": cfg.k_neg,
                      "layer1_units": int(z_plain.numel()),
                      "layer1_active": int((z_plain > 0).sum()), "margin_rows": rows,
                      "margin_terms": int(2 * rows * cfg.k_neg * cfg.dim),
                      "hinge_terms": int(2 * rows * cfg.k_neg), "gcn_versions": versions,
                      "pairs": out, "layer": layer}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
