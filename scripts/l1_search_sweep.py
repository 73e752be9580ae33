"""Time copies of the exact L1 search kernel built with other tile constants.

Each variant is ``csrc/l1_search.cu`` (with ``topk_queue.cuh``) copied into
a scratch directory with its block's constants replaced: columns a thread
(a score warp's tile is 32 rows × 8·cols, four warps a tile) and the blocks
an SM asked of ptxas (``__launch_bounds__``); or another source as it is.
Each is built with the port's nvcc flags (all at once), and at each shape
its output is held bit for bit to the checkout's kernel (``l1_topk`` /
``l1_count``) and it is timed by CUDA events in turns with it, at one unit
a resident block and the deepest ring (3–6 stages) that lets the asked
blocks share an SM.  With ``--parent DIR`` (another commit's
``l1_search.cu`` and ``topk_queue.cuh``, PR 19's entry points) that kernel
is timed in the same turns.  It also writes each variant's d loop as SASS
(``cuobjdump``) to the output directory.

Run on the card, from the repository root:

    python3 scripts/l1_search_sweep.py --out chiprun_out/sweep [--parent DIR]
        [--variants 8x2,4x2,@DIR:256] [--shapes ranks,mining]

A variant is ``COLSxBLOCKS`` or ``@DIR:TILE`` (DIR's ``l1_search.cu`` and
``topk_queue.cuh`` as they are, with the same entry points, at TILE
candidates a tile).  It prints one JSON line a shape and a variant, and a
summary line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tpugraph_torch.kernels import _build, l1_search  # noqa: E402

SHAPES = (  # (name, entry, queries, candidates, d, k, options): chip_smoke.py's L1_SHAPES
    ("ranks", "count", 10500, 10500, 256, 0, {}),
    ("mining", "topk", 7000, 19000, 256, 100, {"exclude": True}),
    ("hubness", "topk", 10500, 10500, 256, 10, {}),
    ("proposals", "topk", 19000, 19000, 256, 1, {"mask": True}),
)
DEFAULT = "8x2,4x2,8x1"
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _variant_source(src: str, cols: int, blocks: int) -> str:
    subs = [(r"constexpr int kTR = 8, kTC = \d+;", f"constexpr int kTR = 8, kTC = {cols};"),
            (r"__launch_bounds__\(kThreads, \d+\)", f"__launch_bounds__(kThreads, {blocks})")]
    for pat, rep in subs:
        src, n = re.subn(pat, rep, src)
        if n != 1:
            raise RuntimeError(f"pattern {pat!r} matched {n} times")
    return src


def _build_variant(out: Path, spec: str) -> dict:
    if spec.startswith("@"):  # another source as it is: @DIR:TILE
        src_dir, tile = spec[1:].rsplit(":", 1)
        vdir = out / f"v_{Path(src_dir).name}"
        vdir.mkdir(parents=True, exist_ok=True)
        for f in ("l1_search.cu", "topk_queue.cuh"):
            shutil.copy(Path(src_dir) / f, vdir / f)
        cols, blocks = int(tile) // 32, 2
    else:
        cols, blocks = (int(x) for x in spec.split("x"))
        vdir = out / f"v_{spec}"
        vdir.mkdir(parents=True, exist_ok=True)
        shutil.copy(_build.CSRC / "topk_queue.cuh", vdir / "topk_queue.cuh")
        (vdir / "l1_search.cu").write_text(
            _variant_source((_build.CSRC / "l1_search.cu").read_text(), cols, blocks))
    lib = vdir / "l1_search.so"
    t0 = time.perf_counter()
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(vdir / "l1_search.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {spec}:\n{proc.stderr}")
    log = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
           if "registers" in ln or "spill" in ln]
    return {"spec": spec, "cols": cols, "blocks": blocks,
            "tile": 32 * cols, "lib": lib, "build_s": time.perf_counter() - t0,
            "ptxas": log}


class Variant:
    """One built variant's entries, planned as the port plans its own."""

    def __init__(self, info: dict, dev: torch.device):
        self.info, self.dev = info, dev
        self.lib = ctypes.CDLL(str(info["lib"]))
        self.lib.l1_topk_forward.argtypes = [P, P, P, P, P, F, I, I, I, I, I, I, I, P, P, P, P,
                                             P, P]
        self.lib.l1_count_forward.argtypes = [P, P, P, P, P, F, I, I, I, I, I, P, P, P, P]
        self.lib.l1_smem_bytes.restype = ctypes.c_longlong
        self.lib.l1_smem_bytes.argtypes = [I, I, I]
        self.lib.l1_blocks_per_sm.argtypes = [I, I, I, P]
        self.tickets = torch.zeros(65536, dtype=torch.int32, device=dev)
        self.sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def plan(self, mode: int, kq: int, s: int, c: int) -> tuple[int, int, int]:
        stages = None
        for per_sm in sorted({self.info["blocks"], 2, 1}, reverse=True):
            for st in range(6, 2, -1):
                n = self.lib.l1_smem_bytes(mode, kq, st)
                if n <= l1_search.BLOCK_SMEM_MAX and per_sm * (
                        n + l1_search.BLOCK_SMEM_RESERVED) <= l1_search.SM_SMEM_BYTES:
                    stages = st
                    break
            if stages is not None:
                break
        out = ctypes.c_int(0)
        l1_search._raise_on(self.lib.l1_blocks_per_sm(mode, kq, stages, ctypes.byref(out)),
                            "l1_blocks_per_sm")
        tiles = -(-s // l1_search.STRIP) * -(-c // self.info["tile"])
        return min(tiles, self.sms * out.value), stages, out.value

    def call(self, entry: str, q, cands, k: int, kw: dict):
        s, c, d = q.shape[0], cands.shape[0], q.shape[1]
        stream = l1_search._stream(q)
        ptr = l1_search._ptr
        if entry == "count":
            units, stages, _ = self.plan(1, 32, s, c)
            part = torch.empty((s // 32 + 2 + units) * 32, dtype=torch.int32, device=q.device)
            out = torch.empty(s, dtype=torch.int64, device=q.device)
            l1_search._raise_on(self.lib.l1_count_forward(
                q.data_ptr(), cands.data_ptr(), ptr(kw.get("bias")), kw["thresh"].data_ptr(),
                ptr(kw.get("self_col")), float(kw.get("a", 1.0)), s, c, d, units, stages,
                part.data_ptr(), self.tickets.data_ptr(), out.data_ptr(), stream), "count")
            return (out,)
        kq = l1_search.queue_len(k)
        units, stages, _ = self.plan(0, kq, s, c)
        n = (s // 32 + 2 + units) * 32 * k
        pv = torch.empty(n, dtype=torch.float32, device=q.device)
        pi = torch.empty(n, dtype=torch.int32, device=q.device)
        vals = torch.empty((s, k), dtype=torch.float32, device=q.device)
        idx = torch.empty((s, k), dtype=torch.int64, device=q.device)
        l1_search._raise_on(self.lib.l1_topk_forward(
            q.data_ptr(), cands.data_ptr(), ptr(kw.get("bias")),
            ptr(l1_search._mask_bytes(kw.get("col_mask"))), ptr(kw.get("exclude")),
            float(kw.get("a", 1.0)), s, c, d, k, kq, units, stages, pv.data_ptr(), pi.data_ptr(),
            self.tickets.data_ptr(), idx.data_ptr(), vals.data_ptr(), stream), "topk")
        return vals, idx


def _inputs(rng, entry, s, c, d, opts, dev):
    q = torch.from_numpy(rng.standard_normal((s, d)).astype(np.float32)).to(dev)
    cands = torch.from_numpy(rng.standard_normal((c, d)).astype(np.float32)).to(dev)
    kw = {}
    if opts.get("exclude"):
        kw["exclude"] = torch.from_numpy(rng.integers(0, c, s)).to(dev)
    if opts.get("mask"):
        kw["col_mask"] = torch.from_numpy(rng.random(c) >= 0.24).to(dev)
    if entry == "count":
        kw["self_col"] = torch.arange(s, device=dev)
        kw["thresh"] = (q - cands[:s]).abs().sum(1).contiguous()
    return q, cands, kw


def _ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def _dump_loop(lib: Path, path: Path) -> None:
    """The d loop (the backward branch whose body holds the most FADDs) of
    each kernel in the library, as cuobjdump prints it."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import l1_sass_mix
    cuda = Path(_build._nvcc()).parent
    sass = subprocess.run([str(cuda / "cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    lines = []
    for fn, ins in l1_sass_mix._functions(sass).items():
        loop = l1_sass_mix.mix(ins)["d_loop"]
        if loop is None:
            continue
        lo, hi = int(loop["from"], 16), int(loop["to"], 16)
        lines.append(f"== {fn}")
        lines += [f"{a:05x} {t}" for a, t, _ in ins if lo <= a <= hi]
    path.write_text("\n".join(lines))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--parent", default=None)
    ap.add_argument("--variants", default=DEFAULT)
    ap.add_argument("--shapes", default=",".join(name for name, *_ in SHAPES),
                    help="the shapes to time, by name")
    args = ap.parse_args()
    dev = torch.device("cuda")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    specs = args.variants.split(",")
    with ThreadPoolExecutor(len(specs)) as ex:
        infos = list(ex.map(lambda sp: _build_variant(out, sp), specs))
    for info in infos:
        print(json.dumps({k: (str(v) if k == "lib" else v) for k, v in info.items()}),
              flush=True)
        _dump_loop(info["lib"], out / f"loop_{Path(info['lib']).parent.name}.sass")
    variants = [Variant(info, dev) for info in infos]
    parent = None
    if args.parent is not None:
        sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
        import runpy
        g = runpy.run_path(str(Path(__file__).resolve().parent.parent / "chip_smoke.py"),
                           run_name="not_main")["main"].__globals__
        parent = g["_parent_l1"](args.parent)
    rng = np.random.default_rng(8)
    summary = {}
    for name, entry, s, c, d, k, opts in SHAPES:
        if name not in args.shapes.split(","):
            continue
        q, cands, kw = _inputs(rng, entry, s, c, d, opts, dev)
        if entry == "count":
            ref = (l1_search.l1_count(q, cands, kw["thresh"], self_col=kw["self_col"]),)
            def base():
                return l1_search.l1_count(q, cands, kw["thresh"], self_col=kw["self_col"])
            old = (None if parent is None else
                   (lambda: parent["count"](q, cands, kw["thresh"], self_col=kw["self_col"])))
        else:
            opt = {key: v for key, v in kw.items() if key in ("exclude", "col_mask")}
            ref = l1_search.l1_topk(q, cands, k, **opt)
            def base():
                return l1_search.l1_topk(q, cands, k, **opt)
            old = None if parent is None else (lambda: parent["topk"](q, cands, k, **opt))
        rows = {}
        for v in variants:
            got = v.call(entry, q, cands, k, kw)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, ref))

            def fn(v=v):
                return v.call(entry, q, cands, k, kw)
            turns = [_ms(base), _ms(fn), _ms(fn), _ms(base)]
            units, stages, bps = v.plan(1 if entry == "count" else 0,
                                        32 if entry == "count" else l1_search.queue_len(k), s, c)
            row = {"shape": name, "variant": v.info["spec"], "bitwise": same,
                   "ms": (turns[1] + turns[2]) / 2, "checkout_ms": (turns[0] + turns[3]) / 2,
                   "units": units, "stages": stages, "blocks_per_sm": bps, "card": smi}
            print(json.dumps(row), flush=True)
            rows[v.info["spec"]] = row
        if old is not None:
            turns = [_ms(old), _ms(base), _ms(base), _ms(old)]
            rows["parent"] = {"ms": (turns[0] + turns[3]) / 2,
                              "checkout_ms": (turns[1] + turns[2]) / 2}
            print(json.dumps({"shape": name, "variant": "parent", **rows["parent"]}), flush=True)
        summary[name] = {key: round(r["ms"], 4) for key, r in rows.items()}
    print(json.dumps({"summary": summary, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
