"""Device times of the sorted-segment SpMM kernel (``kernels/spmm.py::
sorted_spmm``) at zh-en scale, on an NVIDIA GPU.

    python3 /path/to/scripts/sorted_spmm_times.py [--label NAME]
    python3 scripts/sorted_spmm_times.py --sweep

Without ``--sweep`` it times the kernel of the checkout it is run from
(the working directory's ``tpugraph_torch`` and ``chip_smoke.py``) on the
synthetic zh-en task of ``chip_smoke.py``: the adjacency as
``spmm_impl="sorted"`` builds it (A and Aᵀ) and the attribute incidence
and its transpose (``fmt="sorted"``), at d = 128 and 256, fp32 and bf16.
It prints one JSON line of device ms (``chip_smoke.device_ms``: the
profiler's sum of one call's device work).  To compare two checkouts, run
it from each in turns (a, b, b, a) on one card; it needs only what every
checkout of the port has.

``--sweep`` times this checkout's kernel over its work table's two
constants (``SEG_EDGES``, ``PACK_SLOTS``: the same binary, only the host's
table changes), each pair of values twice, with each result held to the
plain version and the device time of the hub rows' items apart; one JSON
line per pair.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import runpy
import sys

import numpy as np
import torch

SEG_CAPS = (64, 96, 128, 192)
PACKINGS = (32, 64, 128)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default=os.path.basename(os.getcwd()))
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    smoke = runpy.run_path("chip_smoke.py", run_name="not_main")["main"].__globals__
    if not torch.cuda.is_available():
        print("sorted_spmm_times: no CUDA device", file=sys.stderr)
        return 2
    spmm_mod, device_ms = smoke["spmm_mod"], smoke["device_ms"]
    task = smoke["synthetic_align_task"](**smoke["ZH_EN"])
    dev = torch.device("cuda")
    op = smoke["build_adjacency"](task.n_ent, task.merged_triples, n_rel=task.n_rel,
                                  fmt="sorted")
    inc = smoke["build_attr_operator"](task.merged_attr_triples, task.n_ent, task.n_attr,
                                       fmt="sorted")
    lists = {"A": op.fwd, "At": op.bwd, "inc": inc.fwd, "incT": inc.bwd}
    rng = np.random.default_rng(4)
    xs = {(name, d, dt): torch.from_numpy(rng.standard_normal((e.n_cols, d)).astype(np.float32))
          .to(dev, dt) for name, e in lists.items() for d in (128, 256)
          for dt in (torch.float32, torch.bfloat16)}
    card = torch.cuda.get_device_name(0)
    if not args.sweep:
        row = {"label": args.label, "card": card}
        for (name, d, dt), x in xs.items():
            edges = lists[name].to(dev)
            spmm_mod.sorted_spmm(edges, x)
            row[f"{name}_{d}_{str(dt)[6:]}"] = device_ms(lambda: spmm_mod.sorted_spmm(edges, x))
        print(json.dumps(row), flush=True)
        return 0
    deg = np.bincount(op.fwd.dst[:op.fwd.nnz].numpy(), minlength=op.fwd.n_rows)
    cases = [("A", 128, torch.float32), ("A", 128, torch.bfloat16), ("A", 256, torch.float32),
             ("incT", 128, torch.float32), ("incT", 256, torch.float32),
             ("inc", 128, torch.float32)]
    for rep in range(2):
        for seg in SEG_CAPS:
            for pack in PACKINGS:
                spmm_mod.SEG_EDGES, spmm_mod.PACK_SLOTS = seg, pack
                row = {"seg_edges": seg, "pack_slots": pack, "rep": rep, "card": card}
                for name, d, dt in cases:
                    edges, x = lists[name].to(dev), xs[name, d, dt]  # a copy: a new table
                    got = spmm_mod.sorted_spmm(edges, x)
                    torch.testing.assert_close(got.float(),
                                               spmm_mod.segment_spmm(edges, x).float(),
                                               **smoke["SORTED_TOL"][dt])
                    row[f"{name}_{d}_{str(dt)[6:]}"] = device_ms(
                        lambda: spmm_mod.sorted_spmm(edges, x))
                    if (name, d, dt) == ("A", 128, torch.float32):
                        row["items"] = int(spmm_mod.segment_plan(edges).items.shape[0])
                        split = smoke["_sorted_split"](edges, x, deg)
                        row["hub_ms"] = split["deg_ge_256"]["device_ms"]
                        row["rest_ms"] = split["deg_lt_256"]["device_ms"]
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
