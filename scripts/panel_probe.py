"""Time the SpMM kernels' panel path (the widths without an instance)
beside the instances, on the card, by CUDA events in turns.

    python3 scripts/panel_probe.py [--widths 128,256,384] [--reps 3] [--sass FILE]

On the zh-en transpose operator (the layers' backward; ``chip_smoke.py``'s
``ZH_EN`` task) it builds ``csrc/spmm_ell.cu`` as it is and a copy whose
dispatch skips the instances (every width on the panel path), then times,
at each width in fp32 and bf16: the checkout's kernel (an instance where
there is one) and the panel path, each held to the other bit for bit where
both run the same width (the sums per element are the same operations in
the same order).  Prints one JSON line per (width, type) with the times of
each turn, the device's name and its power limit.  ``--sass FILE``
writes the checkout library's SASS (``cuobjdump -sass``) to FILE and prints
each kernel's opcode counts.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

from tpugraph_torch.data import synthetic_align_task  # noqa: E402
from tpugraph_torch.kernels import _build, spmm_ell  # noqa: E402
from tpugraph_torch.sparse.build import build_adjacency  # noqa: E402

ZH_EN = dict(seed=7, n_ent=19000, n_rel=1200, n_triples=70000, n_pairs=15000, n_attr=1000,
             attrs_per_ent=4, name="zh_en")
PANEL = spmm_ell.PANEL


def _panels_only() -> ctypes.CDLL:
    """``spmm_ell.cu`` with the instances' dispatch lines removed."""
    src = (_build.CSRC / "spmm_ell.cu").read_text()
    instance = r"\n  if \(dtype == [01] && d == (64|128|256)\) return SPMM_ELL_LAUNCH\([^\n]*"
    src, n = re.subn(instance, "", src)
    if n != 6:
        raise RuntimeError(f"found {n} of the 6 instance dispatch lines in spmm_ell.cu")
    path = _build.BUILD_DIR / "probe_spmm_ell_panels.cu"
    _build.BUILD_DIR.mkdir(exist_ok=True)
    path.write_text(src)
    fn = ctypes.CDLL(str(_build.build("spmm_ell_panels", path).path)).spmm_ell_forward
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, i, p, p, p, p, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _panel_call(fn, m, diag, x):
    """One launch of the panels-only library, with scratch laid out for
    panels (partials of 128·P floats, a counter per cut row and panel)."""
    plan = spmm_ell.segment_plan(m)
    d = x.shape[1]
    panels = -(-d // PANEL)
    n_split = plan.split_p0.shape[0] - 1
    key = ("panels", d)
    scratch = plan.scratch.get(key)
    if scratch is None:
        scratch = torch.zeros(plan.n_partials * PANEL * panels + n_split * panels,
                              dtype=torch.float32, device=x.device)
        plan.scratch[key] = scratch
    base = scratch.data_ptr()
    out = torch.empty((m.n_rows, d), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(x.data_ptr(), None if diag is None else diag.data_ptr(), plan.base.rows.data_ptr(),
             plan.base.idx.data_ptr(), plan.base.w.data_ptr(), plan.items.data_ptr(),
             plan.items.shape[0], plan.split_p0.data_ptr(), base + 4 * plan.n_partials * PANEL
             * panels, base, out.data_ptr(), d, 0 if x.dtype == torch.float32 else 1, stream)
    if err:
        raise RuntimeError(f"panel launch failed: {err}")
    return out


def _ms(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", default="128,256,384")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sass", default=None, help="write the library's SASS here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("panel_probe needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    task = synthetic_align_task(**ZH_EN)
    op = build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel).to(dev)
    m, diag = op.bwd, op.diag
    panels = _panels_only()
    if args.sass:
        cuda = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
        sass = subprocess.run([os.path.join(cuda, "bin", "cuobjdump"), "-sass",
                               str(_build.build("spmm_ell").path)],
                              capture_output=True, text=True, check=True).stdout
        with open(args.sass, "w") as f:
            f.write(sass)
        for fn in re.split(r"\n\s*Function : ", sass)[1:]:
            name, body = fn.split("\n", 1)
            ops = [re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[0]
                   for t in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", body)]
            print(json.dumps({"kernel": name.strip(), "instructions": len(ops),
                              "opcodes": {o: ops.count(o) for o in sorted(set(ops))}}),
                  flush=True)
    rng = np.random.default_rng(3)
    for d in (int(w) for w in args.widths.split(",")):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.standard_normal((m.n_cols, d)).astype(np.float32))
            x = x.to(dev, dtype)
            routes = {"checkout": lambda: spmm_ell.ell_spmm(m, diag, x),
                      "panels": lambda: _panel_call(panels, m, diag, x)}
            same = torch.equal(routes["checkout"](), routes["panels"]())
            turns = {k: [] for k in routes}
            for _ in range(args.reps):
                for k in (*routes, *reversed(routes)):
                    turns[k].append(_ms(routes[k]))
            print(json.dumps({"d": d, "dtype": str(dtype)[6:], "bitwise_equal": same,
                              "instance": d in spmm_ell.SUPPORTED_DIMS,
                              "ms": {k: float(np.median(v)) for k, v in turns.items()},
                              "turns": turns, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
