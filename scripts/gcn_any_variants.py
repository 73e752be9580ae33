"""Where the fused GCN layer's any-width kernels spend their time, on the card.

Builds copies of ``tpugraph_torch/csrc/gcn_fused.cu`` with one part of the
redesigned kernel (``gcn_fused_kernel_wgmma``, namespace wg) left out or
changed (``VARIANTS``: no W copy, no W prologue, no product, no gather, one
product term, a gather walk a slab, seven gather warps, four CTAs a cluster;
their outputs are wrong where a part is left out, and only timed),
and times each in turns with the checkout's kernel (``base``), with the
per-tile kernel (``any_kernel``: ``gcn_fused_kernel_any`` under its plan
rule, ``gcn_fused.any_plan``), with that kernel's W staging left out (``any_w_once``:
W moved once per block, a stub), with the base kernel at other plans
(``PLANS``: one aggregate buffer, other W ring depths), and with the layer's
unfused route (x·W by ``torch.matmul``, then ``spmm_ell``) at zh-en scale,
by CUDA events (medians of the turns).  Where the plan keeps the per-tile kernel with W resident
((50, 300), (64, 64)), the wgmma kernel and its variants run under its own
plan (``gcn_fused.wgmma_plan``), held to ``reference_layer`` and to itself
over two calls.  One JSON line a width.  It needs a CUDA device and nvcc:

    python3 scripts/gcn_any_variants.py [--widths 384x384,768x768] [--bf16] [--rounds 1]
"""

import argparse
import concurrent.futures as cf
import ctypes
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpugraph_torch.data.synthetic import synthetic_align_task  # noqa: E402
from tpugraph_torch.kernels import _build, gcn_fused  # noqa: E402
from tpugraph_torch.kernels.spmm_ell import SEG_SLOTS, ell_spmm  # noqa: E402
from tpugraph_torch.sparse.build import build_adjacency  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = (ROOT / "tpugraph_torch" / "csrc" / "gcn_fused.cu").read_text()
# the zh-en-scale synthetic task of chip_smoke.py (ZH_EN)
ZH_EN = dict(seed=7, n_ent=19000, n_rel=1200, n_triples=70000, n_pairs=15000, n_attr=1000,
             attrs_per_ent=4, name="zh_en")

# (namespace, text of it, its replacement): each variant changes one part
VARIANTS = {
    "base": [],
    "no_w_copy": [("wg", """  mbar_expect_tx(&full[slot], kChunkBytes<T>);
  bulk_multicast(ring + slot * kChunkBytes<T> + rank * kShare,
                 wt + q * kChunkBytes<T> + rank * kShare, kShare, &full[slot],
                 (1 << kCluster) - 1);""", "  mbar_expect_tx(&full[slot], 0);")],
    # the layer's launch alone: the W prologue's layout left from the launch before
    "no_prologue": [("wg", """  wt_layout<T><<<pro_blocks, 256, 0, stream>>>(static_cast<const T*>(wmat), static_cast<T*>(wt),
                                                d_in, d_out, n_kc, n_elems);
""", "")],
    # seven gather warps, twelve in all (168 registers a thread)
    "warps12": [("wg", "constexpr int kGatherWarps = 11;", "constexpr int kGatherWarps = 7;"),
                ("wg", "constexpr int kProductWarp0 = 12;", "constexpr int kProductWarp0 = 8;")],
    # four CTAs a cluster share each W chunk: W read once per 256 rows
    "cluster4": [("wg", "constexpr int kCluster = 2;", "constexpr int kCluster = 4;")],
    "no_product": [("wg", "un.product(b + rank), bias, d_out, out,", "false, bias, d_out, out,")],
    "no_gather": [("wg", "    if (r1 <= r0) continue;", "    if (true) continue;")],
    # a walk a slab, as any::gather_tile walks (no slabs walked together)
    "slab_walks": [("wg", "    if constexpr (kVec) {  // up to three slabs a walk",
                    "    if constexpr (false) {  // up to three slabs a walk")],
    "one_term": [
        ("wg", "      wgmma_tf32(tmp, ab[0][k0], ab[1][k0], ab[0][k1], ab[1][k1], ds, ks);\n"
               "      wgmma_tf32(tmp, as[0][k0], as[1][k0], as[0][k1], as[1][k1], db, 1);\n", ""),
        ("wg", "wgmma_tf32(tmp, ab[0][k0], ab[1][k0], ab[0][k1], ab[1][k1], db, 1);",
         "wgmma_tf32(tmp, ab[0][k0], ab[1][k0], ab[0][k1], ab[1][k1], db, ks);"),
        ("wg", "for (int term = 2; term >= 0; --term)", "for (int term = 0; term >= 0; --term)"),
        ("wg", "a[term][3], db, term != 2);", "a[term][3], db, 0);")],
    # the per-tile kernel with its per-tile W staging left out: W as if moved once
    # per block (the staging's cost; its output is wrong)
    "any_w_once": [("any", "            stage_wt<T>(w_s, wmat, d_in, d_out, p * NP, k0, NP, "
                           "kWChunk, tid);", "")],
}
# the base kernel at other plans: (aggregate buffers, W ring slots) where they fit
PLANS = {"bufs1": (1, None), "bufs2": (2, None), "stages2": (None, 2), "stages4": (None, 4),
         "bufs1_max": (1, "max"), "bufs2_max": (2, "max")}


def variant_source(replacements) -> str:
    src = SRC
    for ns, old, new in replacements:
        a, b = src.index(f"namespace {ns} {{"), src.index(f"}}  // namespace {ns}")
        seg = src[a:b]
        if old not in seg:
            raise ValueError(f"namespace {ns} no longer holds: {old[:80]}")
        src = src[:a] + seg.replace(old, new) + src[b:]
    return src


def any_launcher(fn):
    """A launcher of the per-tile kernel's C entry ``fn``
    (``gcn_fused_any_forward``) under its plan rule (``gcn_fused.any_plan``),
    on its own cached scratch."""
    scratch = {}

    def launch(m, diag, x, wmat, bias):
        lplan = gcn_fused.layer_plan(m)
        d_in, d_out = x.shape[1], wmat.shape[1]
        stream = torch._C._cuda_getCurrentRawStream(x.device.index)
        key = (id(lplan), d_in, d_out, stream)
        if key not in scratch:
            n_split = lplan.split_p0.shape[0] - 1
            scratch[key] = torch.zeros(lplan.n_partials * gcn_fused.partial_floats(d_in) + 2
                                       + n_split, dtype=torch.float32, device=x.device)
        partial = scratch[key].data_ptr()
        t = lplan.tiles
        out = torch.empty((m.n_rows, d_out), dtype=x.dtype, device=x.device)
        plan = gcn_fused.any_plan(d_in, d_out, x.dtype)
        err = fn(x.data_ptr(), wmat.data_ptr(), None if bias is None else bias.data_ptr(),
                 None if diag is None else diag.data_ptr(), t.rows.data_ptr(), t.idx.data_ptr(),
                 t.w.data_ptr(), t.tiles.data_ptr(), t.tiles.shape[0], lplan.segs.data_ptr(),
                 lplan.segs.shape[0], SEG_SLOTS, lplan.split_p0.data_ptr(), lplan.hub.data_ptr(),
                 lplan.hub.shape[0],
                 partial + 4 * lplan.n_partials * gcn_fused.partial_floats(d_in), partial,
                 out.data_ptr(), d_in, d_out, 0 if x.dtype == torch.float32 else 1,
                 plan.k_chunk, plan.n_tiles_a_warp, int(plan.w_resident), plan.smem_bytes, stream)
        if err != 0:
            raise RuntimeError(f"gcn_fused_any_forward failed with CUDA error {err}")
        return out

    return launch


def _time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _entries(path):
    lib = ctypes.CDLL(str(path))
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    head = [p_, p_, p_, p_, p_, p_, p_, p_, i_, p_, i_, i_, p_, p_, i_, p_, p_, p_, i_, i_, i_]
    wg_fn, any_fn = lib.gcn_fused_wgmma_forward, lib.gcn_fused_any_forward
    wg_fn.argtypes = head + [p_, i_, i_, i_, p_]
    any_fn.argtypes = head + [i_, i_, i_, i_, p_]
    wg_fn.restype = any_fn.restype = ctypes.c_int
    return wg_fn, any_fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", default="384x384,768x768")
    ap.add_argument("--bf16", action="store_true", help="also time each width in bf16")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="the VARIANTS to build and time (base always)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of turns, each every call in order, then in reverse")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gcn_any_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    names = ["base"] + [v for v in args.variants.split(",") if v and v != "base"]
    out_dir = ROOT / "tpugraph_torch" / "_build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name in names:
        paths[name] = out_dir / f"gcn_fused_{name}.cu"
        paths[name].write_text(variant_source(VARIANTS[name]))
    with cf.ThreadPoolExecutor(len(paths)) as ex:
        built = dict(zip(paths, ex.map(lambda kv: _build.build(f"gcn_var_{kv[0]}", kv[1]),
                                       paths.items())))
    for name, b in built.items():
        print(json.dumps({"variant": name, "ptxas": [
            ln.strip() for ln in b.log.splitlines() if "registers" in ln or "spill" in ln
            or "Performance" in ln][:10]}),
            flush=True)
    entries = {name: _entries(b.path) for name, b in built.items()}
    own_lib, own_plan = gcn_fused._lib, gcn_fused.kernel_plan

    def use(name, plan=None):
        fn = entries[name][0]
        gcn_fused._lib = (lambda entry="gcn_fused_forward":
                          fn if entry == "gcn_fused_wgmma_forward" else own_lib(entry))
        if plan is None:
            gcn_fused.kernel_plan = own_plan
        else:
            gcn_fused.kernel_plan = lambda *a, **k: plan

    dev = torch.device("cuda")
    task = synthetic_align_task(**ZH_EN)
    op = build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel).to(dev)
    rng = np.random.default_rng(0)
    widths = [tuple(int(v) for v in w.split("x")) for w in args.widths.split(",")]
    dtypes = (torch.float32, torch.bfloat16) if args.bf16 else (torch.float32,)
    any_kernel = any_launcher(entries["base"][1])
    any_once = any_launcher(entries["any_w_once"][1]) if "any_w_once" in entries else None
    for dtype in dtypes:
        for d_in, d_out in widths:
            x = torch.from_numpy(rng.standard_normal((op.n_rows, d_in)).astype(np.float32))
            x = x.to(dev, dtype)
            wm = torch.from_numpy((rng.standard_normal((d_in, d_out)) / np.sqrt(d_in))
                                  .astype(np.float32)).to(dev, dtype)
            b = torch.from_numpy(rng.standard_normal(d_out).astype(np.float32)).to(dev)
            plan = own_plan(d_in, d_out, dtype)
            # the wgmma kernel's plan: the route's, or forced where the
            # per-tile kernel keeps W resident
            wplan = plan if plan.kernel == "gcn_fused_kernel_wgmma" else \
                gcn_fused.wgmma_plan(d_in, d_out, dtype)
            forced = wplan is not None and wplan is not plan
            fns = {}
            if wplan is not None:
                for name in names:
                    if name.startswith("any_"):
                        continue
                    fns[name] = (name, wplan if forced else None)
                for pname, (bufs, stages) in PLANS.items():
                    bufs = wplan.agg_buffers if bufs is None else bufs
                    if stages == "max":  # the most slots that fit beside the buffers
                        fixed = gcn_fused.wgmma_smem(d_in, dtype, bufs, 0)
                        stages = min(gcn_fused.WG_MAX_STAGES, (gcn_fused.SMEM_DYNAMIC - fixed)
                                     // (gcn_fused.wg_planes(dtype) * gcn_fused.WG_PLANE_BYTES))
                    stages = wplan.w_stages if stages is None else stages
                    if stages < 2:
                        continue
                    smem = gcn_fused.wgmma_smem(d_in, dtype, bufs, stages)
                    if smem <= gcn_fused.SMEM_DYNAMIC and (bufs, stages) != (
                            wplan.agg_buffers, wplan.w_stages):
                        fns[pname] = ("base", dataclasses.replace(
                            wplan, agg_buffers=bufs, w_stages=stages, smem_bytes=smem))
            calls = {k: (lambda v=v: (use(*v), gcn_fused.fused_gcn_layer(
                op.fwd, op.diag, x, wm, b))[1]) for k, v in fns.items()}
            calls["any_kernel"] = lambda: any_kernel(op.fwd, op.diag, x, wm, b)
            if any_once is not None:
                calls["any_w_once"] = lambda: any_once(op.fwd, op.diag, x, wm, b)
            calls["unfused"] = lambda: (use("base"), ell_spmm(op.fwd, op.diag,
                                                              torch.matmul(x, wm)) + b.to(dtype))[1]
            times = {}
            for name in (list(calls) + list(reversed(calls))) * args.rounds:
                times.setdefault(name, []).append(_time_ms(calls[name]))
            extra = {}
            if wplan is not None:
                use("base", wplan if forced else None)
                got = [gcn_fused.fused_gcn_layer(op.fwd, op.diag, x, wm, b) for _ in range(2)]
                want = gcn_fused.reference_layer(op.fwd, op.diag, x, wm, b).float()
                extra["wgmma_check"] = {
                    "max_abs_err": float((got[0].float() - want).abs().max()),
                    "bit_identical_runs": bool(torch.equal(got[0], got[1])),
                    "any_kernel_max_abs_err": float(
                        (any_kernel(op.fwd, op.diag, x, wm, b).float() - want).abs().max())}
                probe = ctypes.CDLL(str(built["base"].path)).gcn_fused_wgmma_probe
                probe.argtypes = [ctypes.c_int, ctypes.c_int]
                extra["clusters"] = probe(int(dtype != torch.float32), wplan.smem_bytes)
            use("base")
            print(json.dumps({**extra, "d_in": d_in, "d_out": d_out, "dtype": str(dtype)[6:],
                              "kernel": plan.kernel, "wgmma_forced": forced,
                              "bufs": None if wplan is None else wplan.agg_buffers,
                              "stages": None if wplan is None else wplan.w_stages,
                              **{k: float(np.median(v)) for k, v in times.items()},
                              "turns": times, "card": smi}), flush=True)
    gcn_fused._lib, gcn_fused.kernel_plan = own_lib, own_plan
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
