"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA card and nvcc):

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — fail at once without a CUDA device; name and power limit.
2. build   — compile every kernel of the serving path with nvcc (sm_90a).
3. kernel  — the fused GCN-layer kernel against its plain PyTorch version at
             the zh-en-scale operator, fp32 and bf16, including the rows that
             lie in no ELL bucket; kernel, plain and library timings and the
             card's bound for the same work.
4. slice   — config ``base`` served at zh-en scale through the port's entry
             points: parameters saved with ``save_params``, restored by
             ``driver.evaluate`` (one forward + exact Hits@k), then
             ``topk_alignments``; checked against the plain path and a
             brute-force search, and the kernel's launch count read.

It then prints the kernel table, the ``nvidia-smi`` name/power line, and
as its last line ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before that line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from tpugraph_torch.configs.configs import get_config
from tpugraph_torch.convert import save_params
from tpugraph_torch.data.synthetic import synthetic_align_task
from tpugraph_torch.kernels import _build, gcn_fused
from tpugraph_torch.kernels.gcn_fused import fused_gcn_layer, fused_plan, reference_layer
from tpugraph_torch.models.encoder import init_params
from tpugraph_torch.serve import topk_alignments
from tpugraph_torch.sparse.build import build_adjacency, coo_from_triples, coo_normalize
from tpugraph_torch.train.driver import evaluate
from tpugraph_torch.train.eval import _both_direction_ranks
from tpugraph_torch.train.loop import embed

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and the
# rate for each input type — fp32 outside the tensor cores, bf16 on them
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
# the repo's zh-en-scale synthetic shape (scripts/disk_rehearsal.py, leg A)
ZH_EN = dict(seed=7, n_ent=19000, n_rel=1200, n_triples=70000, n_pairs=15000,
             n_attr=1000, attrs_per_ent=4, name="zh_en")
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),  # sum order differs
       torch.bfloat16: dict(rtol=0.05, atol=0.5)}  # the bf16 tolerance of tests/test_fused_gcn.py


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_cold_ms(fn, iters: int = 10) -> float:
    """Median device time of one call after a 256 MB write has evicted the
    50 MB L2, as a caller whose inputs were not just written would see it."""
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        raise SystemExit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return smi


def phase_build() -> None:
    b = _build.build("gcn_fused")
    lines = [ln.strip() for ln in b.log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "kernel": "gcn_fused", "seconds": round(b.seconds, 3),
          "ptxas": lines})


def _bound_ms(op, x, wmat, bias) -> tuple[float, str]:
    """Least time for one layer on this operator: each input byte read once
    (x, W, b, the buckets' rows/idx/w, diag), the output written once; the
    operations this graph needs (real edges incl. the diagonal, then the
    GEMM) at the peak rate of x's type."""
    m = op.fwd
    n, d_in, d_out = m.n_rows, x.shape[1], wmat.shape[1]
    es = x.element_size()
    ell_bytes = sum(b.rows.numel() * 4 + b.idx.numel() * 4 + b.w.numel() * 4 for b in m.buckets)
    nbytes = (n * d_in * es + d_in * d_out * es + bias.numel() * 4 + op.diag.numel() * 4
              + ell_bytes + n * d_out * es)
    ops = 2 * (m.nnz + op.n_diag) * d_in + 2 * n * d_in * d_out
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[x.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernel(task, smi: str, dev: torch.device) -> dict:
    t0 = time.perf_counter()
    op_host = build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel)
    op = op_host.to(dev)
    plan = fused_plan(op.fwd)
    sync(dev)
    build_s = time.perf_counter() - t0
    ks = [b.k for b in op.fwd.buckets]
    emit({"phase": "operator", "n_ent": task.n_ent,
          "merged_triples": int(len(task.merged_triples)),
          "edges": op.nnz, "diag_edges": op.n_diag, "offdiag_edges": op.fwd.nnz,
          "buckets": len(ks), "k_min": min(ks), "k_max": max(ks),
          "bucket_rows": {str(b.k): int(b.rows.numel()) for b in op.fwd.buckets},
          "padded_slots": op.fwd.padded_edges, "rows_in_no_bucket": plan.n_zero_rows,
          "tiles": int(plan.tiles.shape[0]), "train_pairs": int(len(task.train_pairs)),
          "test_pairs": int(len(task.test_pairs)), "build_s": build_s, "card": smi})

    # the library yardstick: one CSR product (cuSPARSE) then the GEMM —
    # timed here only, never called by the port
    src, dst, w = coo_from_triples(task.n_ent, task.merged_triples, n_rel=task.n_rel)
    w = coo_normalize(src, dst, w, task.n_ent)
    order = np.lexsort((src, dst))
    crow = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=task.n_ent))])
    with warnings.catch_warnings():  # CSR support is "beta" in PyTorch
        warnings.simplefilter("ignore", UserWarning)
        a_csr = torch.sparse_csr_tensor(
            torch.from_numpy(crow), torch.from_numpy(src[order]),
            torch.from_numpy(w[order].astype(np.float32)),
            size=(task.n_ent, task.n_ent), check_invariants=True).to(dev)

    zero_rows = plan.rows[-plan.n_zero_rows:].long() if plan.n_zero_rows else None
    rng = np.random.default_rng(0)
    d = 128
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(rng.standard_normal((task.n_ent, d)).astype(np.float32)).to(dev)
        wm = torch.from_numpy((rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.standard_normal(d).astype(np.float32)).to(dev)
        x, wm = x.to(dtype), wm.to(dtype)
        got = fused_gcn_layer(op.fwd, op.diag, x, wm, b)
        sync(dev)
        want = reference_layer(op.fwd, op.diag, x, wm, b)
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
        err = float((got.float() - want.float()).abs().max())
        zero_err = None
        if zero_rows is not None:
            # rows in no bucket: diag·x·W + b, computed without the ELL
            zx = (op.diag[zero_rows, None] * x[zero_rows].float()) @ wm.float() + b
            torch.testing.assert_close(got[zero_rows].float(), zx, **TOL[dtype])
            zero_err = float((got[zero_rows].float() - zx).abs().max())
        ms = time_ms(lambda: fused_gcn_layer(op.fwd, op.diag, x, wm, b))
        ms_cold = time_cold_ms(lambda: fused_gcn_layer(op.fwd, op.diag, x, wm, b))
        plain_ms = time_ms(lambda: reference_layer(op.fwd, op.diag, x, wm, b), iters=5)
        lib_ms = lib_cold = None
        if dtype == torch.float32:
            lib = torch.sparse.mm(a_csr, x) @ wm + b
            torch.testing.assert_close(lib, want, **TOL[dtype])
            lib_ms = time_ms(lambda: torch.sparse.mm(a_csr, x) @ wm + b)
            lib_cold = time_cold_ms(lambda: torch.sparse.mm(a_csr, x) @ wm + b)
        bound, bound_by = _bound_ms(op, x, wm, b)
        results[dtype] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                              bound_by=bound_by, library_ms=lib_ms)
        emit({"phase": "kernel", "kernel": "gcn_fused", "dtype": str(dtype).split(".")[1],
              "max_abs_err": err, "no_bucket_rows_max_abs_err": zero_err, "ms": ms,
              "ms_cold_l2": ms_cold, "plain_ms": plain_ms, "library_ms": lib_ms,
              "library_ms_cold_l2": lib_cold, "bound_ms": bound,
              "bound_by": bound_by, "share_of_bound": bound / ms, "card": smi})
    return results[torch.float32]


def phase_slice(task, smi: str, dev: torch.device) -> int:
    cfg = get_config("base", syn_n_ent=task.kg1.n_ent, syn_n_rel=task.kg1.n_rel,
                     syn_seed=ZH_EN["seed"])
    params = init_params(task.n_ent, cfg.dim, cfg.hidden, seed=ZH_EN["seed"])
    n1 = task.kg1.n_ent
    queries = task.test_pairs[:, 0]
    candidates = np.arange(n1, task.n_ent)
    with tempfile.TemporaryDirectory() as ckpt:
        save_params(ckpt, params)
        # the main path: counts at 0 just before, read just after
        gcn_fused.launches = 0
        res = evaluate(cfg.replace(checkpoint_dir=ckpt), task=task, device=dev)
        t0 = time.perf_counter()
        vals, ids = topk_alignments(res.emb, queries, candidates, k=10)
        sync(dev)
        topk_s = time.perf_counter() - t0
        launches = gcn_fused.launches
    # a second forward on the restored model: the first one also built the
    # kernel's tile table and loaded the library
    t0 = time.perf_counter()
    embed(res.model, res.op)
    sync(dev)
    forward_warm_s = time.perf_counter() - t0

    expected = 2  # two GraphConvolution layers, one launch each
    if launches != expected:
        raise AssertionError(f"gcn_fused launched {launches} times, expected {expected}")
    emb = res.emb
    if emb.shape != (task.n_ent, cfg.dim) or not bool(torch.isfinite(emb).all()):
        raise AssertionError(f"bad embedding: shape {tuple(emb.shape)} or non-finite values")

    # the same forward through the plain version, on the card
    p = {k: v.to(dev) for k, v in params.items()}
    op = res.op
    h = torch.relu(reference_layer(op.fwd, op.diag, p["emb"], p["gc1.w"], p["gc1.b"]))
    plain = reference_layer(op.fwd, op.diag, h, p["gc2.w"], p["gc2.b"])
    torch.testing.assert_close(emb, plain, **TOL[torch.float32])
    emb_err = float((emb - plain).abs().max())

    # eval and top-k against a brute-force search on the first 64 queries
    sub = 64
    pairs = torch.as_tensor(task.test_pairs, dtype=torch.int64, device=dev)
    ranks_l2r, _ = _both_direction_ranks(emb, pairs)
    left, right = emb[pairs[:sub, 0]], emb[pairs[:, 1]]
    dist = torch.cdist(left.double(), right.double(), p=1)
    d_true = dist[torch.arange(sub), torch.arange(sub)]
    dist[torch.arange(sub), torch.arange(sub)] = float("inf")
    # fp32 ranks against float64 distances: only candidates within rounding
    # of the threshold may fall either way
    eps = 1e-5 * d_true[:, None]
    lo = (dist < d_true[:, None] - eps).sum(1)
    hi = (dist < d_true[:, None] + eps).sum(1)
    got_r = ranks_l2r[:sub]
    if not bool(((lo <= got_r) & (got_r <= hi)).all()):
        raise AssertionError("Hits@k ranks disagree with a brute-force search")
    full = torch.cdist(emb[torch.as_tensor(queries[:sub], device=dev)].double(),
                       emb[torch.as_tensor(candidates, device=dev)].double(), p=1)
    bv, bi = torch.topk(full, 10, largest=False)
    np.testing.assert_allclose(vals[:sub], bv.cpu().numpy(), rtol=1e-5)
    same_ids = float((candidates[bi.cpu().numpy()] == ids[:sub]).mean())
    if same_ids < 0.99:
        raise AssertionError(f"top-k ids agree with a brute-force search on {same_ids:.3f}")

    emit({"phase": "slice", "config": "base", "n_ent": task.n_ent, "dim": cfg.dim,
          "test_pairs": int(len(task.test_pairs)),
          "metrics": {k: res.metrics[k] for k in ("hits@1", "hits@10", "mrr")},
          "gcn_fused_launches": launches, "emb_max_abs_err_vs_plain": emb_err,
          "topk_ids_match_brute_force": same_ids,
          "wall_s": {**res.timings, "forward_warm_s": forward_warm_s, "topk_s": topk_s}, "topk_queries": int(len(queries)),
          "topk_candidates": int(len(candidates)), "card": smi})
    return launches


def main() -> int:
    smi = phase_device()
    phase_build()
    task = synthetic_align_task(**ZH_EN)
    dev = torch.device("cuda")
    k = phase_kernel(task, smi, dev)
    launches = phase_slice(task, smi, dev)
    emit({"kernels": [{
        "name": "gcn_fused", "route": "cuda", "source": "tpugraph_torch/csrc/gcn_fused.cu",
        "replaces": "tpugraph/kernels/gcn_fused_pallas.py:40", "launches": launches,
        **k}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
