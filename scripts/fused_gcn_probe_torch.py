"""The fused GCN layer's probe on the H100 (the port's counterpart of
scripts/fused_gcn_probe.py, stages 0-2).

    stage 0  one row copied by a kernel that reads its index
             (kernels/probe.py::row_copy, csrc/row_copy.cu), bit for bit
    stage 1  one small ELL bucket through gcn_fused.fused_bucket_apply
             (n 2,000, R 512, K 4, d 128) against its plain version
    stage 2  a gather-rate sized bucket (n 160,000, R 65,536, K 8, d 128),
             timed by CUDA events, in gathered rows/s, beside the plain
             version (index_select, einsum, matmul)

It needs a CUDA device (it exits 2 without one) and prints one JSON line a
stage.  Run: python3 scripts/fused_gcn_probe_torch.py [--stage N]
[--dtype float32|bfloat16] [--iters N]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpugraph_torch.kernels import gcn_fused, probe  # noqa: E402


def _events_ms(fn, iters: int) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _bucket(rng, n: int, r: int, k: int, d: int, dtype, dev):
    idx = torch.from_numpy(rng.integers(0, n, (r, k)).astype(np.int32)).to(dev)
    w = torch.from_numpy(rng.standard_normal((r, k)).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev, dtype)
    wm = torch.from_numpy((rng.standard_normal((d, d)) * 0.1).astype(np.float32)).to(dev, dtype)
    return idx, w, x, wm


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


# the port's limits for the layer (PERF.md §2; the bf16 bound of tests/test_fused_gcn.py)
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4), torch.bfloat16: dict(rtol=0.05, atol=0.5)}


def run(stage: int, dtype: torch.dtype, iters: int = 20) -> list[dict]:
    """Stages 0..``stage`` on the card, each held to its plain version
    (stage 0 bit for bit, the buckets at ``TOL``); one result a stage."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    out = []
    x0 = torch.from_numpy(rng.standard_normal((16, 128)).astype(np.float32)).to(dev, dtype)
    idx0 = torch.tensor([[3]], dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    y = probe.row_copy(x0, idx0)
    torch.cuda.synchronize()
    if not torch.equal(y, probe.row_copy_plain(x0, idx0)):
        raise AssertionError("stage 0: the row copy differs from x[idx[0, 0]]")
    out.append({"stage": 0, "s": time.perf_counter() - t0, "shape": list(y.shape),
                "bit_identical": True})
    if stage < 1:
        return out

    n, r, k, d = 2000, 512, 4, 128
    idx, w, x, wm = _bucket(rng, n, r, k, d, dtype, dev)
    t0 = time.perf_counter()
    got = gcn_fused.fused_bucket_apply(idx, w, x, wm)
    torch.cuda.synchronize()
    want = gcn_fused.fused_bucket_apply_plain(idx, w, x, wm)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    out.append({"stage": 1, "s": time.perf_counter() - t0, "shape": list(got.shape),
                "rel_err": _rel_err(got[:r], want[:r]),
                "max_abs_err": float((got.float() - want.float()).abs().max())})
    if stage < 2:
        return out

    n, r, k = 160_000, 65_536, 8
    idx, w, x, wm = _bucket(rng, n, r, k, d, dtype, dev)
    m = gcn_fused.bucket_matrix(idx, w, n)
    t0 = time.perf_counter()
    got = gcn_fused.fused_bucket_apply(idx, w, x, wm, matrix=m)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    want = gcn_fused.fused_bucket_apply_plain(idx, w, x, wm)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    ms = _events_ms(lambda: gcn_fused.fused_bucket_apply(idx, w, x, wm, matrix=m), iters)
    plain_ms = _events_ms(lambda: gcn_fused.fused_bucket_apply_plain(idx, w, x, wm), iters)
    out.append({"stage": 2, "first_call_s": first_s, "rel_err": _rel_err(got[:r], want[:r]),
                "kernel_ms": ms, "rows_per_s": r * k / (ms / 1e3), "plain_ms": plain_ms,
                "plain_rows_per_s": r * k / (plain_ms / 1e3), "plain_over_kernel": plain_ms / ms})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stage", type=int, default=2, help="run stages 0..N")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fused_gcn_probe_torch: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    for result in run(args.stage, getattr(torch, args.dtype), args.iters):
        print(json.dumps({**result, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
