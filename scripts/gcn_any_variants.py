"""Where the fused GCN layer's any-width kernel spends its time, on the card.

Builds copies of ``tpugraph_torch/csrc/gcn_fused.cu`` with one part of
``gcn_fused_kernel_any`` left out (``VARIANTS``: the operand splits, two of
the three TF32 products, the staging of W, the product, the gather; their
outputs are wrong and only timed), and times each in turns with the
checkout's kernel (``base``) and with the layer's unfused route (x·W by
``torch.matmul``, then ``spmm_ell``) at zh-en scale, by CUDA events.  One
JSON line a width.  It needs a CUDA device and nvcc:

    python3 scripts/gcn_any_variants.py [--widths 384x384,50x300] [--bf16]
"""

import argparse
import concurrent.futures as cf
import ctypes
import json
import os
import pathlib
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpugraph_torch.data.synthetic import synthetic_align_task  # noqa: E402
from tpugraph_torch.kernels import _build, gcn_fused  # noqa: E402
from tpugraph_torch.kernels.spmm_ell import ell_spmm  # noqa: E402
from tpugraph_torch.sparse.build import build_adjacency  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = (ROOT / "tpugraph_torch" / "csrc" / "gcn_fused.cu").read_text()
# the zh-en-scale synthetic task of chip_smoke.py (ZH_EN)
ZH_EN = dict(seed=7, n_ent=19000, n_rel=1200, n_triples=70000, n_pairs=15000, n_attr=1000,
             attrs_per_ent=4, name="zh_en")


def _split(v, reg, i):
    return (f"wide::split_tf32_bits({v}, {reg}b{i}, {reg}s{i});",
            f"{reg}b{i} = __float_as_uint({v}); {reg}s{i} = 0;")


def _splits():
    out = []
    for e, c in enumerate("xyzw"):
        out.append((f"wide::split_tf32_bits(av[mt][h].{c}, ab[mt][h][{e}], as[mt][h][{e}]);",
                    f"ab[mt][h][{e}] = __float_as_uint(av[mt][h].{c}); as[mt][h][{e}] = 0;"))
        out.append((f"wide::split_tf32_bits(bv[nt].{c}, bb[nt][{e}], bs[nt][{e}]);",
                    f"bb[nt][{e}] = __float_as_uint(bv[nt].{c}); bs[nt][{e}] = 0;"))
    return out


# (text of namespace any, its replacement): each variant leaves one part out
VARIANTS = {
    "base": [],
    "no_splits": _splits(),
    "one_product": [
        ("            wide::mma_tf32(t[mt][nt], ab[mt][0][k0], ab[mt][1][k0], ab[mt][0][k1], "
         "ab[mt][1][k1],\n                           bs[nt][k0], bs[nt][k1]);", "            ;"),
        ("            wide::mma_tf32(t[mt][nt], as[mt][0][k0], as[mt][1][k0], as[mt][0][k1], "
         "as[mt][1][k1],\n                           bb[nt][k0], bb[nt][k1]);", "            ;")],
    "no_w_staging": [
        ("            stage_wt<T>(w_s, wmat, d_in, d_out, p * NP, k0, NP, kWChunk, tid);", "")],
    "no_product": [
        ("            product<T, NT>(c, a_s, ka, (k0 - ka0) / 4, w_s, kWChunk, warp * 8 * NT, 0,"
         "\n                           min(kWChunk, kend - k0), n_mt, lane);", ""),
        ("          product<T, NT>(c, a_s, ka, 0, w_s, pw, p * NP + warp * 8 * NT, ka0 / 4, "
         "kend - ka0,\n                         n_mt, lane);", "")],
    "no_gather": [
        ("              gather_tile<T, kVec>(x, diag, rows + td.x, idx, ew, k, td.w, r0, r1, "
         "d_in, kp, ka0,\n                                   ka, a_s, lane);", ";")],
}


def variant_source(replacements) -> str:
    a, b = SRC.index("namespace any {"), SRC.index("}  // namespace any")
    seg = SRC[a:b]
    for old, new in replacements:
        if old not in seg:
            raise ValueError(f"the source no longer holds: {old[:80]}")
        seg = seg.replace(old, new)
    return SRC[:a] + seg + SRC[b:]


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", default="384x384,512x512,768x768,64x64,50x300,300x50")
    ap.add_argument("--bf16", action="store_true", help="also time each width in bf16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gcn_any_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = ROOT / "tpugraph_torch" / "_build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, repl in VARIANTS.items():
        paths[name] = out_dir / f"gcn_fused_{name}.cu"
        paths[name].write_text(variant_source(repl))
    with cf.ThreadPoolExecutor(len(paths)) as ex:
        built = dict(zip(paths, ex.map(lambda kv: _build.build(f"gcn_var_{kv[0]}", kv[1]),
                                       paths.items())))
    fns = {}
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    for name, b in built.items():
        fn = ctypes.CDLL(str(b.path)).gcn_fused_any_forward
        fn.argtypes = [p_, p_, p_, p_, p_, p_, p_, p_, i_, p_, i_, i_, p_, p_, i_, p_, p_, p_,
                       i_, i_, i_, i_, i_, i_, i_, p_]
        fn.restype = ctypes.c_int
        fns[name] = fn
    own_lib = gcn_fused._lib

    def use(name):
        gcn_fused._lib = (lambda entry="gcn_fused_forward":
                          fns[name] if entry == "gcn_fused_any_forward" else own_lib(entry))

    dev = torch.device("cuda")
    task = synthetic_align_task(**ZH_EN)
    op = build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel).to(dev)
    rng = np.random.default_rng(0)
    widths = [tuple(int(v) for v in w.split("x")) for w in args.widths.split(",")]
    dtypes = (torch.float32, torch.bfloat16) if args.bf16 else (torch.float32,)
    for dtype in dtypes:
        for d_in, d_out in widths:
            x = torch.from_numpy(rng.standard_normal((op.n_rows, d_in)).astype(np.float32))
            x = x.to(dev, dtype)
            wm = torch.from_numpy((rng.standard_normal((d_in, d_out)) / np.sqrt(d_in))
                                  .astype(np.float32)).to(dev, dtype)
            b = torch.from_numpy(rng.standard_normal(d_out).astype(np.float32)).to(dev)
            times = {}
            for name in list(VARIANTS) + list(reversed(VARIANTS)):
                use(name)
                times.setdefault(name, []).append(_time_ms(
                    lambda: gcn_fused.fused_gcn_layer(op.fwd, op.diag, x, wm, b)))
            use("base")
            times["unfused"] = [_time_ms(
                lambda: ell_spmm(op.fwd, op.diag, torch.matmul(x, wm)) + b.to(dtype))]
            print(json.dumps({"d_in": d_in, "d_out": d_out, "dtype": str(dtype)[6:],
                              **{k: float(np.mean(v)) for k, v in times.items()},
                              "card": torch.cuda.get_device_name(0)}), flush=True)
    gcn_fused._lib = own_lib
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
