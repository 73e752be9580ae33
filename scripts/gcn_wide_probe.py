"""The fused GCN layer at (256, 256) against another commit's kernel, on
one CUDA card: a short first check of a new kernel before a full
``chip_smoke.py`` run.

    python3 scripts/gcn_wide_probe.py --parent DIR [--quick] [--dwy100k] [--skip-zh-en]
                                      [--variants NAME[+NAME],... [--variants-only]]

DIR holds the other commit's ``gcn_fused.cu`` (the C entry without the
cut-row table: the two-panel kernel).
Prints one JSON line per step: both kernels built (ptxas registers and
spills); the narrow instances' outputs on ``tests/test_torch_gpu.py``'s
``narrow_outputs`` inputs held bit for bit to the other kernel, with their
SHA-256 (the card test pins them); (256, 256) fp32 and bf16 on that
graph against the plain version, two launches bit for bit (``--quick``
stops here); ``chip_smoke.phase_kernel`` at zh-en
scale with the other kernel (each width against its plain version, the
narrow ones bit for bit, (256, 256) fp32 and bf16 in turns, both kernels'
device-time split); with ``--dwy100k``, (256, 256) fp32 and bf16 in turns
on the 200,000-row ``dwy100k_dist`` operator.  With ``--variants``,
copies of the checkout's ``gcn_fused.cu`` changed as ``VARIANTS`` says
(the product or the tiles' gather left out, other warp counts) are built
and timed in turns with it at (256, 256) on each operator.  The card's
name and power limit stand in every line.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tpugraph_torch.configs.configs import get_config  # noqa: E402
from tpugraph_torch.configs.recipes import RECIPES  # noqa: E402
from tpugraph_torch.kernels import _build, gcn_fused  # noqa: E402
from tpugraph_torch.sparse.build import build_adjacency  # noqa: E402
from tpugraph_torch.train.loop import load_task  # noqa: E402


# name -> (old, new) replacements of csrc/gcn_fused.cu's text
_TILE_GATHER = """        if (r1 > r0) {
          float acc[2][4] = {};
          int cur;
          ell::walk_vslots<T, D, false, kInFlight>"""
VARIANTS = {
    "no_product": [("} else if (p >= n_groups) {  // a tile, or bf16 cut rows, to multiply",
                    "} else if (false && p >= n_groups) {")],
    "no_tile_gather": [(_TILE_GATHER, _TILE_GATHER.replace("if (r1 > r0)", "if (false && r1 > r0)"))],
    "g4p8": [("constexpr int kGatherWarps = 8;", "constexpr int kGatherWarps = 4;"),
             ("constexpr int kProductWarps = 4;", "constexpr int kProductWarps = 8;")],
    "inflight4": [("constexpr int kInFlight = 8;", "constexpr int kInFlight = 4;")],
    # the products' operands passed unsplit (wrong results: the splits' cost)
    "no_split": [("  big = rna_tf32(__float_as_uint(x));\n"
                  "  small = rna_tf32(__float_as_uint(x - __uint_as_float(big)));",
                  "  big = __float_as_uint(x);\n  small = big ^ 1u;"),
                 ("  mid = __byte_perm(__float_as_uint(x1), __float_as_uint(y1), 0x7632);\n"
                  "  lo = __byte_perm(__float_as_uint(x2), __float_as_uint(y2), 0x7632);",
                  "  mid = hi ^ 1u;\n  lo = hi ^ 2u;")],
    # one product term of three (wrong results: the tensor cores' share)
    "one_term": [("for (int term = 2; term >= 0; --term)", "for (int term = 0; term >= 0; --term)"),
                 ("""          mma_tf32(t[mt][nt], ab[mt][0][k0], ab[mt][1][k0], ab[mt][0][k1], ab[mt][1][k1],
                   bs[nt][k0], bs[nt][k1]);
      }""", "          (void)0;\n      }"),
                 ("""          mma_tf32(t[mt][nt], as[mt][0][k0], as[mt][1][k0], as[mt][0][k1], as[mt][1][k1],
                   bb[nt][k0], bb[nt][k1]);
      }""", "          (void)0;\n      }")],
    # clock64 timers: each step's work and barrier wait, for gather warp 0
    # and the first product warp of every CTA (read by the exported gcn_prof)
    "timers": [
        ("namespace wide {\n\nconstexpr int D = 256;",
         "namespace wide {\n__device__ unsigned long long g_prof[8];\n\nconstexpr int D = 256;"),
        ("  pair_sync<P>();\n\n  // Step s:",
         "  pair_sync<P>();\n  long long prof_work = 0, prof_wait = 0, prof_steps = 0;\n\n  // Step s:"),
        ("    if (p >= total) break;\n    int4 td_next;",
         "    if (p >= total) break;\n    const long long t_start = clock64();\n    int4 td_next;"),
        ("      next = after;\n    }\n    pair_sync<P>();\n  }",
         "      next = after;\n    }\n    const long long t_work = clock64();\n    pair_sync<P>();\n"
         "    prof_work += t_work - t_start;\n    prof_wait += clock64() - t_work;\n    ++prof_steps;\n  }"),
        ("  // the last CTA out resets the counters for the next launch: every claim",
         "  if (lane == 0 && (warp == 0 || warp == kGatherWarps)) {\n"
         "    const int o = warp == 0 ? 0 : 3;\n"
         "    atomicAdd(&g_prof[o], static_cast<unsigned long long>(prof_work));\n"
         "    atomicAdd(&g_prof[o + 1], static_cast<unsigned long long>(prof_wait));\n"
         "    atomicAdd(&g_prof[o + 2], static_cast<unsigned long long>(prof_steps));\n"
         "    if (warp == 0) atomicAdd(&g_prof[7], 1ull);\n  }\n"
         "  // the last CTA out resets the counters for the next launch: every claim"),
        ("extern \"C\" int gcn_fused_forward(",
         "extern \"C\" int gcn_prof(unsigned long long* host, int reset) {\n"
         "  if (reset) {\n    unsigned long long z[8] = {};\n"
         "    return cudaMemcpyToSymbol(wide::g_prof, z, sizeof z);\n  }\n"
         "  return cudaMemcpyFromSymbol(host, wide::g_prof, 8 * sizeof(unsigned long long));\n}\n\n"
         "extern \"C\" int gcn_fused_forward("),
    ],
}


def _variant(name: str):
    """The checkout's kernel with VARIANTS[name] applied (names joined by
    "+" apply each), built; its library and ptxas lines."""
    src = (_build.CSRC / "gcn_fused.cu").read_text()
    for old, new in (pair for part in name.split("+") for pair in VARIANTS[part]):
        if src.count(old) != 1:
            raise ValueError(f"variant {name}: {old!r} is not in gcn_fused.cu once")
        src = src.replace(old, new)
    path = Path(_build.BUILD_DIR) / "variants" / f"gcn_fused_{name.replace('+', '_')}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    built = _build.build(f"gcn_fused_{name.replace('+', '_')}", path)
    return ctypes.CDLL(str(built.path)), [ln.strip() for ln in built.log.splitlines()
                                          if "registers" in ln or "spill" in ln]


def _time_variants(op, names, smi, where):
    """Each variant timed in turns with the checkout's kernel (this, variant,
    variant, this) at (256, 256) fp32 and bf16 on ``op``."""
    rng = np.random.default_rng(5)
    with ThreadPoolExecutor(len(names)) as ex:  # one nvcc per variant, together
        libs = dict(zip(names, ex.map(_variant, names)))
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.standard_normal((op.n_rows, 256)).astype(np.float32))
        wm = torch.from_numpy((rng.standard_normal((256, 256)) / 16).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal(256).astype(np.float32)).to(op.fwd.device)
        x, wm = x.to(op.fwd.device, dtype), wm.to(op.fwd.device, dtype)

        def call():
            return gcn_fused.fused_gcn_layer(op.fwd, op.diag, x, wm, b)

        want = call()
        own = _build._LIBS["gcn_fused"]

        def timed(lib):
            _build._LIBS["gcn_fused"] = lib
            try:
                return cs.time_ms(call)
            finally:
                _build._LIBS["gcn_fused"] = own

        for name, (lib, ptxas) in libs.items():
            _build._LIBS["gcn_fused"] = lib
            try:
                exact = bool(torch.equal(call(), want))
            finally:
                _build._LIBS["gcn_fused"] = own
            t = [timed(v) for v in (own, lib, lib, own)]
            prof = None
            if hasattr(lib, "gcn_prof"):  # the timers: one launch's cycles
                buf = (ctypes.c_ulonglong * 8)()
                _build._LIBS["gcn_fused"] = lib
                try:
                    lib.gcn_prof(buf, 1)
                    call()
                    torch.cuda.synchronize()
                    lib.gcn_prof(buf, 0)
                finally:
                    _build._LIBS["gcn_fused"] = own
                v = list(buf)
                prof = {"ctas": v[7], "steps_per_cta": v[2] / max(v[7], 1),
                        "gather_work_per_step": v[0] / max(v[2], 1),
                        "gather_wait_per_step": v[1] / max(v[2], 1),
                        "product_work_per_step": v[3] / max(v[5], 1),
                        "product_wait_per_step": v[4] / max(v[5], 1)}
            cs.emit({"phase": "variant", "operator": where, "variant": name,
                     "dtype": str(dtype).split(".")[1], "bitwise_with_checkout": exact,
                     "variant_ms": (t[1] + t[2]) / 2, "checkout_ms": (t[0] + t[3]) / 2,
                     "turns_ms": t, "cycles": prof, "ptxas": ptxas, "card": smi})


def _accuracy(op, parent, smi, where):
    """(256, 256) fp32 and bf16 on ``op`` (random x, W, b; x also through a
    ReLU, as layer 2 sees it): the checkout's kernel against the parent's —
    bit for bit on the rows the tiles hold, the largest difference on the
    cut rows — and each one's and the plain version's relative L2 error
    against float64."""
    rng = np.random.default_rng(11)
    plan = gcn_fused.layer_plan(op.fwd)
    cut = plan.hub[:, 1].long()
    tile_rows = torch.ones(op.n_rows, dtype=torch.bool, device=op.fwd.device)
    tile_rows[cut] = False
    csr = cs._csr_of(op.fwd, op.diag).double()
    for dtype in (torch.float32, torch.bfloat16):
        for relu in (False, True):
            x = torch.from_numpy(rng.standard_normal((op.n_rows, 256)).astype(np.float32))
            x = (x.clamp_min(0) if relu else x).to(op.fwd.device, dtype)
            w = torch.from_numpy((rng.standard_normal((256, 256)) / 16).astype(np.float32))
            w = w.to(op.fwd.device, dtype)
            b = torch.from_numpy(rng.standard_normal(256).astype(np.float32)).to(op.fwd.device)
            want = torch.sparse.mm(csr, x.double()) @ w.double() + b.double()

            def rel(y, rows=None):
                d, t = y.double() - want, want
                if rows is not None:
                    d, t = d[rows], t[rows]
                return float(d.norm() / t.norm())

            new = gcn_fused.fused_gcn_layer(op.fwd, op.diag, x, w, b)
            old = parent(op.fwd, op.diag, x, w, b, plan)
            plain = gcn_fused.reference_layer(op.fwd, op.diag, x, w, b)
            cs.emit({"phase": "accuracy", "operator": where, "dtype": str(dtype).split(".")[1],
                     "relu_input": relu,
                     "bitwise_with_parent": bool(torch.equal(new, old)),
                     "tile_rows_bitwise_with_parent": bool(torch.equal(new[tile_rows],
                                                                       old[tile_rows])),
                     "tile_rows_max_abs_diff": float((new[tile_rows].float()
                                                      - old[tile_rows].float()).abs().max()),
                     "cut_rows_max_abs_diff": float((new[cut].float() - old[cut].float())
                                                    .abs().max()),
                     "rel_l2_vs_float64": {"checkout": rel(new), "parent": rel(old),
                                           "plain": rel(plain)},
                     "cut_rows_rel_l2_vs_float64": {"checkout": rel(new, cut),
                                                    "parent": rel(old, cut),
                                                    "plain": rel(plain, cut)},
                     "card": smi})


def _step_checks(task, parent, smi, dev):
    """``chip_smoke.phase_recipe_v7r`` (its step check at PERF.md §2's
    limit) with the checkout's kernel, then with the parent's in its place."""
    launch = gcn_fused._launch

    def parent_launch(m, diag, x, w, b, plan):
        gcn_fused.launches += 1
        return parent(m, diag, x, w, b, plan)

    for label, fn in (("checkout", launch), ("parent", parent_launch)):
        gcn_fused._launch = fn
        try:
            cs.phase_recipe_v7r(task, smi, dev)
            cs.emit({"phase": "step_check", "kernel": label, "passed": True, "card": smi})
        except AssertionError as e:
            cs.emit({"phase": "step_check", "kernel": label, "passed": False,
                     "error": str(e)[:600], "card": smi})
        finally:
            gcn_fused._launch = launch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--dwy100k", action="store_true")
    ap.add_argument("--skip-zh-en", action="store_true")
    ap.add_argument("--variants", default="")
    ap.add_argument("--accuracy", action="store_true",
                    help="only the accuracy readings and the v7r step checks at zh-en")
    ap.add_argument("--variants-only", action="store_true",
                    help="time the variants without phase_kernel and the DWY100K cases")
    args = ap.parse_args()
    smi = cs.phase_device()
    t0 = time.perf_counter()
    built = _build.build("gcn_fused")
    cs.emit({"phase": "build", "kernel": "gcn_fused", "seconds": time.perf_counter() - t0,
             "ptxas": [ln.strip() for ln in built.log.splitlines()
                       if "registers" in ln or "spill" in ln], "card": smi})
    parent = cs._parent_gcn(args.parent)
    dev = torch.device("cuda")

    from test_torch_gpu import narrow_outputs, sha256_of
    new = narrow_outputs(dev)
    old = narrow_outputs(dev, lambda m, d, x, w, b: parent(m, d, x, w, b, gcn_fused.layer_plan(m)))
    cases = {name: {"bitwise": bool(torch.equal(y, old[name])), "sha256": sha256_of(y)}
             for name, y in new.items()}
    cs.emit({"phase": "narrow_outputs_vs_parent", "cases": cases, "card": smi})
    if not all(c["bitwise"] for c in cases.values()):
        raise AssertionError("a narrow instance differs from the parent's kernel")

    from test_torch_gpu import _hub_graph
    rng = np.random.default_rng(22)
    op = _hub_graph(rng, {3: 5300, 11: 300}).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.standard_normal((op.n_rows, 256)).astype(np.float32))
        wm = torch.from_numpy((rng.standard_normal((256, 256)) / 16).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal(256).astype(np.float32)).to(dev)
        x, wm = x.to(dev, dtype), wm.to(dev, dtype)
        got = gcn_fused.fused_gcn_layer(op.fwd, op.diag, x, wm, b)
        again = gcn_fused.fused_gcn_layer(op.fwd, op.diag, x, wm, b)
        want = gcn_fused.reference_layer(op.fwd, op.diag, x, wm, b)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        cs.emit({"phase": "wide_check", "dtype": str(dtype), "max_abs_err": err,
                 "bitwise_twice": bool(torch.equal(got, again)),
                 "counters_zero": not bool(gcn_fused.counters(
                     gcn_fused.layer_plan(op.fwd), 256, 256,
                     torch.cuda.current_stream().cuda_stream).any()), "card": smi})
        torch.testing.assert_close(got.float(), want.float(), **cs.TOL[dtype])
    if args.quick:
        print(smi, flush=True)
        return 0
    if args.accuracy:
        task = cs.synthetic_align_task(**cs.ZH_EN)
        op = build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel).to(dev)
        _accuracy(op, parent, smi, "zh_en")
        _step_checks(task, parent, smi, dev)
        print(smi, flush=True)
        return 0
    variants = [v for v in args.variants.split(",") if v]
    if not args.skip_zh_en:
        task = cs.synthetic_align_task(**cs.ZH_EN)
        if not args.variants_only:
            cs.phase_kernel(task, smi, dev, parent)
        if variants:
            op = build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel).to(dev)
            _time_variants(op, variants, smi, "zh_en")
    if args.dwy100k:
        cfg = get_config("dwy100k_dist", **RECIPES["v7r"])
        t0 = time.perf_counter()
        task = load_task(cfg)
        op = build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel).to(dev)
        cs.emit({"phase": "dwy100k_operator", "rows": op.n_rows, "edges": op.nnz,
                 "build_s": time.perf_counter() - t0, "card": smi})
        rng = np.random.default_rng(9)
        a_csr = cs._csr_of(op.fwd, op.diag)
        for dtype in (torch.float32, torch.bfloat16) if not args.variants_only else ():
            cs._gcn_case(op, a_csr, rng, 256, dtype, smi, split=True, where="dwy100k",
                         parent=parent)
        if variants:
            _time_variants(op, variants, smi, "dwy100k")
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
