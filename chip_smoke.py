"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA card and nvcc):

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — fail at once without a CUDA device; name and power limit.
2. build   — compile every kernel of the serving and training paths with
             nvcc (sm_90a), one nvcc per source, all started together.
3. kernel  — the fused GCN-layer kernel against its plain PyTorch version at
             the zh-en-scale operator, fp32 and bf16, including the rows that
             lie in no ELL bucket; kernel, plain and library timings and the
             card's bound for the same work.  Then the same for the ELL SpMM
             kernel on the transpose operator (the layers' backward; two
             launches must agree bit for bit; its device time is split
             between the hub rows' work and the rest, and a call's host
             time is read beside it) and for the Sinkhorn potential-update
             kernel at 4,500 × 4,500 × 128 (at τ = 0.3 and 0.05, and at
             twice the query rows).  Kernel times are CUDA events over
             back-to-back calls; ``device_ms`` is the profiler's sum of the
             call's device work alone.
4. slice   — config ``base`` served at zh-en scale through the port's entry
             points: parameters saved with ``save_params``, restored by
             ``driver.evaluate`` (one forward + exact Hits@k), then
             ``topk_alignments``; checked against the plain path and a
             brute-force search, and the kernel's launch count read.
5. train   — config ``sinkhorn`` trained at zh-en scale for 10 epochs
             through ``driver.run`` (uniform negatives, then one hard-mining
             interval); every kernel's launches counted; one step's loss and
             gradients held against the plain path on the card; the step's
             time split into forward, backward, OT forward, OT backward and
             Adam.

It then prints the kernel table, the ``nvidia-smi`` name/power line, and
as its last line ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before that line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tpugraph_torch.configs.configs import get_config
from tpugraph_torch.convert import save_params
from tpugraph_torch.data.synthetic import synthetic_align_task
from tpugraph_torch.kernels import _build, gcn_fused, sinkhorn_fused, spmm_ell
from tpugraph_torch.kernels.gcn_fused import fused_gcn_layer, reference_layer
from tpugraph_torch.kernels.sinkhorn_fused import (PRECISION, stream_plan,
                                                   sinkhorn_potential_update,
                                                   sinkhorn_update_plain, sq_norms)
from tpugraph_torch.kernels.spmm_ell import (SEG_SLOTS, apply_with_diag, ell_spmm, fused_plan,
                                             segment_plan)
from tpugraph_torch.models.encoder import init_params
from tpugraph_torch.serve import topk_alignments
from tpugraph_torch.sparse.build import build_adjacency, coo_from_triples, coo_normalize
from tpugraph_torch.train.driver import evaluate, run
from tpugraph_torch.train.eval import _both_direction_ranks
from tpugraph_torch.train.loop import embed
from tpugraph_torch.train.losses import margin_align_loss
from tpugraph_torch.train.metrics import epoch_edge_ops
from tpugraph_torch.train.negatives import sample_uniform_negatives
from tpugraph_torch.train.optim import make_optimizer
from tpugraph_torch.train.ot import sinkhorn_align_loss, sinkhorn_align_loss_plain

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and the
# rate for each input type — fp32 outside the tensor cores, bf16 on them
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_TF32_OPS = 495e12  # fp32 inputs rounded to TF32 on the tensor cores
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


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call from a torch.profiler trace: the time of its
    kernels and memsets on the card, summed, so the host's launch cost is
    left out (``time_ms`` includes it when it exceeds the device's work)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / iters / 1e3


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


KERNELS = ("gcn_fused", "spmm_ell", "sinkhorn_fused")


def phase_build() -> None:
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as ex:  # one nvcc per source, together
        built = list(ex.map(_build.build, KERNELS))
    wall = time.perf_counter() - t0
    for name, b in zip(KERNELS, built):
        lines = [ln.strip() for ln in b.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        emit({"phase": "build", "kernel": name, "seconds": round(b.seconds, 3),
              "ptxas": lines})
    emit({"phase": "build", "wall_s": round(wall, 3)})


def _bound(nbytes: float, ops: float, dtype: torch.dtype = torch.float32) -> tuple[float, str]:
    """The least time for the work, in ms: its bytes at the HBM rate or its
    operations at the peak rate of ``dtype``, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    return _bound(nbytes, ops, x.dtype)


def _csr(task, dev: torch.device, transpose: bool = False) -> torch.Tensor:
    """The whole normalised adjacency (diagonal included) as a CSR tensor:
    A, or Aᵀ — the library yardsticks' operand, built here only."""
    src, dst, w = coo_from_triples(task.n_ent, task.merged_triples, n_rel=task.n_rel)
    w = coo_normalize(src, dst, w, task.n_ent)
    rows, cols = (src, dst) if transpose else (dst, src)
    order = np.lexsort((cols, rows))
    crow = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=task.n_ent))])
    with warnings.catch_warnings():  # CSR support is "beta" in PyTorch
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.from_numpy(crow), torch.from_numpy(cols[order]),
            torch.from_numpy(w[order].astype(np.float32)),
            size=(task.n_ent, task.n_ent), check_invariants=True).to(dev)


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
    a_csr = _csr(task, dev)

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
        dev_ms = device_ms(lambda: fused_gcn_layer(op.fwd, op.diag, x, wm, b))
        ms_cold = time_cold_ms(lambda: fused_gcn_layer(op.fwd, op.diag, x, wm, b))
        plain_ms = time_ms(lambda: reference_layer(op.fwd, op.diag, x, wm, b), iters=5)
        lib_ms = lib_cold = lib_dev = lib_refused = None

        def library():
            return torch.sparse.mm(a_lib, x) @ wm + b.to(dtype)

        try:
            a_lib = a_csr.to(dtype)
            lib = library()
        except RuntimeError as e:  # a refusal of bf16 by the library is the finding
            lib_refused = str(e).splitlines()[0][:200]
        if lib_refused is None:
            torch.testing.assert_close(lib.float(), want.float(), **TOL[dtype])
            lib_ms = time_ms(library)
            lib_dev = device_ms(library)
            lib_cold = time_cold_ms(library)
        bound, bound_by = _bound_ms(op, x, wm, b)
        results[dtype] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                              bound_by=bound_by, library_ms=lib_ms, device_ms=dev_ms,
                              library_device_ms=lib_dev)
        emit({"phase": "kernel", "kernel": "gcn_fused", "dtype": str(dtype).split(".")[1],
              "max_abs_err": err, "no_bucket_rows_max_abs_err": zero_err, "ms": ms,
              "device_ms": dev_ms, "ms_cold_l2": ms_cold, "plain_ms": plain_ms,
              "library_ms": lib_ms, "library_device_ms": lib_dev,
              "library_ms_cold_l2": lib_cold, "library_refused": lib_refused, "bound_ms": bound,
              "bound_by": bound_by, "share_of_bound": bound / ms, "card": smi})
    return results[torch.float32]


def host_ms(fn, calls: int = 200) -> float:
    """Host time of one call: ``calls`` calls queued without a synchronise
    (far fewer than the launch queue holds), so the device's time is not in it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return t


def _spmm_split(m, diag, g, hub_ks=(256, 1024)) -> dict:
    """The kernel's device time on parts of its work table: all of it, then
    for each K in ``hub_ks`` only the work of rows with K ≥ that K, and the
    rest (the output rows outside the part are left unwritten; only the
    time is read).  Device time, because a call's host time exceeds it."""
    plan = segment_plan(m)
    parts = [("all", plan)]
    for k in hub_ks:
        hub = plan.items[:, 2] >= k  # every segment of a cut row falls on one side
        parts += [(f"k_ge_{k}", dataclasses.replace(plan, items=plan.items[hub].contiguous())),
                  (f"k_lt_{k}", dataclasses.replace(plan, items=plan.items[~hub].contiguous()))]
    return {name: {"items": int(part.items.shape[0]),
                   "device_ms": device_ms(lambda part=part: spmm_ell._launch(m, diag, g, part))}
            for name, part in parts}


def phase_spmm(task, smi: str, dev: torch.device) -> dict:
    """The ELL SpMM kernel where training runs it: u = Aᵀ·ḡ over the
    transpose operator, d = 128, fp32."""
    op = build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel).to(dev)
    m = op.bwd
    plan = fused_plan(m)
    hist = {str(b.k): int(b.rows.numel()) for b in m.buckets}
    emit({"phase": "operator_transpose", "buckets": len(m.buckets), "bucket_rows": hist,
          "same_k_histogram_as_fwd": hist == {str(b.k): int(b.rows.numel())
                                              for b in op.fwd.buckets},
          "offdiag_edges": m.nnz, "padded_slots": m.padded_edges,
          "rows_in_no_bucket": plan.n_zero_rows, "tiles": int(plan.tiles.shape[0]),
          "card": smi})
    at_csr = _csr(task, dev, transpose=True)
    rng = np.random.default_rng(1)
    d = 128
    g = torch.from_numpy(rng.standard_normal((task.n_ent, d)).astype(np.float32)).to(dev)
    got = ell_spmm(m, op.diag, g)
    sync(dev)
    want = apply_with_diag(m, op.diag, g)
    torch.testing.assert_close(got, want, **TOL[torch.float32])
    err = float((got - want).abs().max())
    if not torch.equal(got, ell_spmm(m, op.diag, g)):  # the segments' sums run in a fixed order
        raise AssertionError("spmm_ell: two launches on the same input differ")
    seg = segment_plan(m)
    lib = torch.sparse.mm(at_csr, g)
    torch.testing.assert_close(lib, want, **TOL[torch.float32])
    ms = time_ms(lambda: ell_spmm(m, op.diag, g))
    ms_cold = time_cold_ms(lambda: ell_spmm(m, op.diag, g))
    plain_ms = time_ms(lambda: apply_with_diag(m, op.diag, g), iters=5)
    lib_ms = time_ms(lambda: torch.sparse.mm(at_csr, g))
    dev_ms = device_ms(lambda: ell_spmm(m, op.diag, g))
    lib_dev = device_ms(lambda: torch.sparse.mm(at_csr, g))
    lib_cold = time_cold_ms(lambda: torch.sparse.mm(at_csr, g))
    host = host_ms(lambda: ell_spmm(m, op.diag, g))
    lib_host = host_ms(lambda: torch.sparse.mm(at_csr, g))
    split = _spmm_split(m, op.diag, g)
    # each input byte once (g, diag, the buckets' rows/idx/w), the output
    # once; 2 operations per real edge (diagonal included) and column
    ell_bytes = sum(b.rows.numel() * 4 + b.idx.numel() * 4 + b.w.numel() * 4
                    for b in m.buckets)
    nbytes = 2 * m.n_rows * d * 4 + op.diag.numel() * 4 + ell_bytes
    bound, bound_by = _bound(nbytes, 2 * (m.nnz + op.n_diag) * d)
    emit({"phase": "kernel", "kernel": "spmm_ell", "operator": "transpose", "dtype": "float32",
          "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "ms_cold_l2": ms_cold,
          "plain_ms": plain_ms, "library_ms": lib_ms, "library_device_ms": lib_dev,
          "library_ms_cold_l2": lib_cold, "host_ms": host, "library_host_ms": lib_host,
          "bound_ms": bound, "bound_by": bound_by, "share_of_bound": bound / ms,
          "share_of_bound_device": bound / dev_ms, "bit_identical_runs": True,
          "seg_cap": SEG_SLOTS, "work_items": int(seg.items.shape[0]),
          "longest_item_slots": seg.max_item_slots, "cut_rows": int(seg.split_p0.shape[0] - 1),
          "split": split, "card": smi})
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                library_ms=lib_ms, device_ms=dev_ms, library_device_ms=lib_dev, seg_cap=SEG_SLOTS,
                work_items=int(seg.items.shape[0]),
                longest_item_slots=seg.max_item_slots)


def _sinkhorn_inputs(dev: torch.device, s: int = 4500, d: int = 128, rows: int | None = None):
    """l (``rows`` or s, d) and r (s, d) of unit rows, g (s,), log μ: one
    update of config sinkhorn's OT head at zh-en scale."""
    rng = np.random.default_rng(2)

    def unit_rows(n):
        x = rng.standard_normal((n, d)).astype(np.float32)
        return torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True)).to(dev)

    l, r = unit_rows(s), unit_rows(s)
    g = torch.from_numpy((0.1 * rng.standard_normal(s)).astype(np.float32)).to(dev)
    if rows is not None:
        l = torch.cat([l, unit_rows(rows - s)])
    log_mu = torch.full((l.shape[0],), -math.log(l.shape[0]), dtype=torch.float32, device=dev)
    return l, r, g, log_mu


def phase_sinkhorn(smi: str, dev: torch.device, s: int = 4500, d: int = 128,
                   tau: float = 0.3) -> dict:
    """One potential update of config sinkhorn's OT head at zh-en scale."""
    l, r, g, log_mu = _sinkhorn_inputs(dev, s, d)
    l_sq, r_sq = sq_norms(l), sq_norms(r)

    def kernel():
        return sinkhorn_potential_update(l, r, g, log_mu, tau, l_sq, r_sq)

    got = kernel()
    sync(dev)
    want = sinkhorn_update_plain(l, r, g, log_mu, tau, l_sq, r_sq)
    torch.testing.assert_close(got, want, **TOL[torch.float32])
    err = float((got - want).abs().max())
    # the config's default τ, where exp amplifies a product's rounding most
    got05 = sinkhorn_potential_update(l, r, g, log_mu, 0.05, l_sq, r_sq)
    want05 = sinkhorn_update_plain(l, r, g, log_mu, 0.05, l_sq, r_sq)
    torch.testing.assert_close(got05, want05, **TOL[torch.float32])
    err05 = float((got05 - want05).abs().max())
    # the yardstick, two library calls: one addmm builds
    # z = (g_j − ‖r_j‖² + 2·l_i·r_j)/τ, one logsumexp reduces it; ‖l_i‖²/τ
    # comes off the row LSE (no clamp at 0: equal up to rounding)
    bias = ((g - r_sq) / tau)[None, :]

    def lib_build():
        return torch.addmm(bias, l, r.t(), beta=1.0, alpha=2.0 / tau)

    z = lib_build()
    lib = tau * (log_mu - (torch.logsumexp(z, dim=1) - l_sq / tau))
    torch.testing.assert_close(lib, want, **TOL[torch.float32])
    ms = time_ms(kernel)
    ms_cold = time_cold_ms(kernel)
    plain_ms = time_ms(lambda: sinkhorn_update_plain(l, r, g, log_mu, tau, l_sq, r_sq), iters=5)
    addmm_ms = time_ms(lib_build)
    lse_ms = time_ms(lambda: torch.logsumexp(z, dim=1))
    dev_ms = device_ms(kernel)
    lib_dev = device_ms(lambda: torch.logsumexp(lib_build(), dim=1))
    # twice the query rows against the same candidates: twice the work on
    # the same grid, so the fixed cost per launch shows
    l2x, _, _, mu2x = _sinkhorn_inputs(dev, s, d, rows=2 * s)
    l2x_sq = sq_norms(l2x)
    ms_2x = time_ms(lambda: sinkhorn_potential_update(l2x, r, g, mu2x, tau, l2x_sq, r_sq))
    # inputs l, r, ‖l‖², ‖r‖², g, log μ once and f once.  What the kernel
    # runs: three TF32 products of 2·Q·C·d on the tensor cores plus one exp
    # per cost entry at the fp32 rate; beside it the fp32 bound of one
    # product outside the tensor cores
    nbytes = (2 * s * d + 5 * s) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (3 * 2 * s * s * d / PEAK_TF32_OPS + s * s / PEAK_OPS[torch.float32]) * 1e3
    bound, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    bound_fp32, _ = _bound(nbytes, 2 * s * s * d + s * s)
    grid, n_splits = stream_plan(s, s, torch.cuda.get_device_properties(dev).multi_processor_count)
    emit({"phase": "kernel", "kernel": "sinkhorn_fused", "q": s, "c": s, "d": d, "tau": tau,
          "precision": PRECISION, "grid": grid, "candidate_splits": n_splits,
          "max_abs_err": err, "max_abs_err_tau_0.05": err05, "ms": ms, "device_ms": dev_ms,
          "ms_cold_l2": ms_cold, "plain_ms": plain_ms, "library_ms": addmm_ms + lse_ms,
          "library_device_ms": lib_dev, "library_addmm_ms": addmm_ms,
          "library_logsumexp_ms": lse_ms, "bound_ms": bound, "bound_by": bound_by,
          "share_of_bound": bound / ms, "bound_fp32_ms": bound_fp32,
          "share_of_fp32_bound": bound_fp32 / ms, "ms_2x_queries": ms_2x, "card": smi})
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                library_ms=addmm_ms + lse_ms, device_ms=dev_ms, library_device_ms=lib_dev,
                bound_fp32_ms=bound_fp32, precision=PRECISION,
                candidate_splits=n_splits)


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


def _launch_counts() -> dict:
    return {"gcn_fused": gcn_fused.launches, "spmm_ell": spmm_ell.launches,
            "sinkhorn_fused": sinkhorn_fused.launches}


def _reset_launch_counts() -> None:
    gcn_fused.launches = spmm_ell.launches = sinkhorn_fused.launches = 0


def _step_batch(res, cfg, dev):
    task = res.task
    pairs = torch.as_tensor(task.train_pairs, dtype=torch.int64, device=dev)
    neg_l, neg_r = sample_uniform_negatives(torch.Generator().manual_seed(1), pairs,
                                            task.kg1.n_ent, task.n_ent, cfg.k_neg)
    return {"pairs": pairs, "neg_l": neg_l, "neg_r": neg_r}


def _check_step(res, cfg, dev) -> dict:
    """One step of the trained model through the kernels against the plain
    path on the card: loss rel 1e-4, each gradient relative L2 1e-3."""
    model, op, batch = res.model, res.op, _step_batch(res, cfg, dev)
    model.zero_grad(set_to_none=True)
    _reset_launch_counts()
    loss, _ = model(op, batch)
    loss.backward()
    sync(dev)
    per_step = _launch_counts()
    expect = {"gcn_fused": 2, "spmm_ell": 2, "sinkhorn_fused": 2 * cfg.sinkhorn_iters + 1}
    if per_step != expect:
        raise AssertionError(f"one step launched {per_step}, expected {expect}")
    # the plain path: the fused layer's and the OT head's plain versions,
    # differentiated by autograd
    p = {k: v.detach().clone().requires_grad_(True) for k, v in model.named_parameters()}
    h = torch.relu(reference_layer(op.fwd, op.diag, p["encoder.emb"], p["encoder.gc1.w"],
                                   p["encoder.gc1.b"]))
    emb = reference_layer(op.fwd, op.diag, h, p["encoder.gc2.w"], p["encoder.gc2.b"])
    plain = (margin_align_loss(emb, batch["pairs"], batch["neg_l"], batch["neg_r"], cfg.gamma)
             + cfg.sinkhorn_weight * sinkhorn_align_loss_plain(
                 emb, batch["pairs"], tau=cfg.sinkhorn_tau, n_iters=cfg.sinkhorn_iters))
    plain.backward()
    loss_rel = abs(loss.item() - plain.item()) / abs(plain.item())
    grad_rel = {k: float((v.grad - p[k].grad).norm() / p[k].grad.norm().clamp_min(1e-30))
                for k, v in model.named_parameters()}
    if loss_rel > 1e-4 or max(grad_rel.values()) > 1e-3:
        raise AssertionError(f"step vs plain path: loss rel {loss_rel}, grads {grad_rel}")
    return {"per_step_launches": per_step, "loss": loss.item(), "loss_plain": plain.item(),
            "loss_rel_err": loss_rel, "grad_rel_l2": grad_rel}


def _profile_step(res, cfg, dev, reps: int = 5) -> dict:
    """Median host wall time of each stage of a step, each ended by a
    synchronise: encoder + margin forward, OT forward, OT backward, the
    rest of the backward (margin + both layers), Adam."""
    model, op, batch = res.model, res.op, _step_batch(res, cfg, dev)
    opt, _ = make_optimizer(cfg, model.parameters())
    names = ("forward", "ot_forward", "ot_backward", "backward", "adam")
    times = {k: [] for k in (*names, "step")}
    for i in range(reps + 1):  # the first is a warm-up
        sync(dev)
        t = [time.perf_counter()]
        opt.zero_grad(set_to_none=True)
        emb = model.encoder(op)
        margin = margin_align_loss(emb, batch["pairs"], batch["neg_l"], batch["neg_r"],
                                   cfg.gamma)
        sync(dev)
        t.append(time.perf_counter())
        emb_ot = emb.detach().requires_grad_(True)
        ot = sinkhorn_align_loss(emb_ot, batch["pairs"], tau=cfg.sinkhorn_tau,
                                 n_iters=cfg.sinkhorn_iters)
        sync(dev)
        t.append(time.perf_counter())
        (cfg.sinkhorn_weight * ot).backward()
        sync(dev)
        t.append(time.perf_counter())
        torch.autograd.backward([margin, emb], [None, emb_ot.grad])
        sync(dev)
        t.append(time.perf_counter())
        opt.step()
        sync(dev)
        t.append(time.perf_counter())
        if i:
            for k, a, b in zip(names, t, t[1:]):
                times[k].append(b - a)
            times["step"].append(t[-1] - t[0])
    med = {f"{k}_s": float(np.median(v)) for k, v in times.items()}
    med["shares"] = {k: med[f"{k}_s"] / med["step_s"] for k in names}
    return med


def _device_busy(res, cfg, dev, steps: int = 3) -> dict:
    """Device busy share over ``steps`` training steps (after one warm-up),
    from a torch.profiler trace: the kernels' and copies' device time over
    the window's host wall time, and the kernels that take the most.  All
    None when the trace holds no device events."""
    model, op, batch = res.model, res.op, _step_batch(res, cfg, dev)
    opt, _ = make_optimizer(cfg, model.parameters())

    def step():
        opt.zero_grad(set_to_none=True)
        loss, _ = model(op, batch)
        loss.backward()
        opt.step()

    step()
    sync(dev)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    if not by_name:
        return {"busy_share": None, "idle_share": None, "top_kernels_ms_per_step": None}
    busy = sum(by_name.values()) / wall_us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"busy_share": busy, "idle_share": 1.0 - busy, "window_steps": steps,
            "window_wall_ms_per_step": wall_us / steps / 1e3,
            "top_kernels_ms_per_step": {k[:80]: v / steps / 1e3 for k, v in top}}


def phase_train(task, smi: str, dev: torch.device) -> dict:
    """Config sinkhorn through driver.run at zh-en scale: uniform negatives
    for epochs 0-4, one hard-mining interval for 5-9."""
    cfg = get_config("sinkhorn", syn_n_ent=task.kg1.n_ent, syn_n_rel=task.kg1.n_rel,
                     syn_seed=ZH_EN["seed"], epochs=10, neg_every=5)
    # the main path: counts at 0 just before, read just after
    _reset_launch_counts()
    t0 = time.perf_counter()
    res = run(cfg, task=task, device=dev)
    sync(dev)
    run_s = time.perf_counter() - t0
    counts = _launch_counts()
    t = res.timings
    expected = {"gcn_fused": 2 * (t["steps"] + t["minings"] + t["evals"]),
                "spmm_ell": 2 * t["steps"],
                "sinkhorn_fused": (2 * cfg.sinkhorn_iters + 1) * t["steps"]}
    if counts != expected or t["steps"] != 10 or t["minings"] != 1:
        raise AssertionError(f"launches {counts} (expected {expected}), timings {t}")
    losses = res.losses
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite or not falling: {losses}")
    metrics = res.metrics
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"non-finite metrics {metrics}")
    step = _check_step(res, cfg, dev)
    prof = _profile_step(res, cfg, dev)
    busy = _device_busy(res, cfg, dev)
    emit({"phase": "train", "config": "sinkhorn", "n_ent": task.n_ent,
          "train_pairs": int(len(task.train_pairs)), "dim": cfg.dim, "k_neg": cfg.k_neg,
          "sinkhorn": {"tau": cfg.sinkhorn_tau, "iters": cfg.sinkhorn_iters,
                       "weight": cfg.sinkhorn_weight},
          "epochs": cfg.epochs, "neg_every": cfg.neg_every, "losses": losses,
          "metrics": {k: metrics[k] for k in ("hits@1", "hits@10", "mrr")},
          "launches": counts, "timings": t, "run_s": run_s,
          "step_ms_mean": t["train_s"] / t["steps"] * 1e3,
          "mine_s": t["mine_s"] / t["minings"], "eval_s": t["eval_s"] / t["evals"],
          "edges_per_s_steps": epoch_edge_ops(res.op.nnz) * t["steps"] / t["train_s"],
          "edges_per_s_run": res.history[-1]["edges_per_s"],
          "step_check": step, "step_profile": prof, "device_busy": busy, "card": smi})
    return counts


def main() -> int:
    smi = phase_device()
    phase_build()
    task = synthetic_align_task(**ZH_EN)
    dev = torch.device("cuda")
    k_gcn = phase_kernel(task, smi, dev)
    k_spmm = phase_spmm(task, smi, dev)
    k_sink = phase_sinkhorn(smi, dev)
    serve_launches = phase_slice(task, smi, dev)
    train = phase_train(task, smi, dev)
    emit({"kernels": [
        {"name": "gcn_fused", "route": "cuda", "source": "tpugraph_torch/csrc/gcn_fused.cu",
         "replaces": "tpugraph/kernels/gcn_fused_pallas.py:40", "launches": train["gcn_fused"],
         "launches_serve": serve_launches, **k_gcn},
        {"name": "spmm_ell", "route": "cuda", "source": "tpugraph_torch/csrc/spmm_ell.cu",
         "replaces": "tpugraph/kernels/spmm_ell.py:19", "launches": train["spmm_ell"],
         **k_spmm},
        {"name": "sinkhorn_fused", "route": "cuda",
         "source": "tpugraph_torch/csrc/sinkhorn_fused.cu",
         "replaces": "tpugraph/kernels/sinkhorn_pallas.py:38",
         "launches": train["sinkhorn_fused"], **k_sink},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
