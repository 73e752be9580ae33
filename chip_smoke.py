"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA card and nvcc):

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — fail at once without a CUDA device; name and power limit.
2. build   — compile every kernel of the serving and training paths with
             nvcc (sm_90a), one nvcc per source, all started together.
3. kernel  — the fused GCN-layer kernel against its plain PyTorch version at
             the zh-en-scale operator, at (d_in, d_out) = (128, 128) and
             (256, 256), fp32 and bf16, including the rows that lie in no
             ELL bucket (two launches must agree bit for bit); kernel,
             plain and library timings, the card's bound for the same
             work, and its device time split between the hub rows'
             segments, the rest, the short rows and the K = 0 tiles.  Then
             the same for the ELL SpMM kernel on the transpose operator
             (the layers' backward, d = 128 and 256; two launches must
             agree bit for bit; at d = 128 its device time is split between
             the hub rows' work and the rest, and a call's host time is
             read beside it) and for the Sinkhorn potential-update kernel
             at 4,500 × 4,500 × 128 and × 256 (at τ = 0.3 and 0.05, and at
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
6. recipe  — recipe v6 (dim 256, bootstrapping, the OT head, CSLS eval) at
             zh-en scale through ``driver.run``, cut to 10 of 600 epochs,
             proposals from epoch 2 (not 200), no periodic eval; every
             kernel's launches counted; one step with the run's proposals
             held against the plain path; the same run preempted by SIGTERM
             during epoch 5 and resumed to epoch 10, its final loss held to
             the uninterrupted run's; ``driver.evaluate`` from the run's
             checkpoint directory (CSLS) and the CSLS top-10 for the 10,500
             test queries, both held against a float64 search; the time of
             each stage.
7. incidence — the ELL SpMM kernel on the attribute channel's entity ×
             attribute incidence (no diagonal) and its transpose, at d = 128
             and 256, against its plain version and ``torch.sparse.mm``.
8. recipe_v7r — recipe v7r (v6 + the attribute head at weight 0.25) through
             ``driver.run``, cut as v6 is (10 of 900 epochs); v7 resolved
             and held to differ only in ``attr_weight``; one step with the
             run's last interval batch held against the plain path; the
             step's stages, the attribute head's among them.
9. mtl      — config ``mtl`` with the attribute channel at dim 128 for 10
             epochs: launches per step and per ``embed``; one step held
             against the plain path, and one with an OT subsample of 2,048
             pairs; a SIGTERM mid-interval and the resume; ``driver.evaluate``
             from the run's directory; the relation head's and the channel's
             shares of the step.
10. highway — config ``highway`` (funifun weights, rw norm, highway gates)
             with dropout 0.3 at dim 128 for 10 epochs: one step held against
             the plain path with the same mask generator; the loss falling;
             the eval forward equal with and without dropout.

A step is held against its plain path by running the same model code with
every kernel swapped for its plain version (``_plain_kernels``), which
autograd differentiates.

It then prints the kernel table, the ``nvidia-smi`` name/power line, and
as its last line ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before that line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tpugraph_torch.configs.configs import get_config
from tpugraph_torch.configs.recipes import RECIPES
from tpugraph_torch.convert import save_params
from tpugraph_torch.data.synthetic import synthetic_align_task
from tpugraph_torch.kernels import _build, gcn_fused, sinkhorn_fused, spmm_ell
from tpugraph_torch.kernels.gcn_fused import fused_gcn_layer, reference_layer
from tpugraph_torch.kernels.sinkhorn_fused import (PRECISION, stream_plan,
                                                   sinkhorn_potential_update,
                                                   sinkhorn_update_plain, sq_norms)
from tpugraph_torch.kernels.spmm_ell import (SEG_SLOTS, apply_with_diag, ell_spmm, fused_plan,
                                             segment_plan)
import tpugraph_torch.models.align as align_mod
import tpugraph_torch.models.attr_channel as attr_channel_mod
import tpugraph_torch.nn.graphconv as graphconv_mod
from tpugraph_torch.models.align import AlignMTL
from tpugraph_torch.models.attr_channel import build_attr_operator
from tpugraph_torch.models.encoder import AlignGCN, init_params
from tpugraph_torch.serve import topk_alignments
from tpugraph_torch.sparse.build import build_adjacency
from tpugraph_torch.train.checkpoint import Checkpointer
from tpugraph_torch.train.driver import evaluate, run
from tpugraph_torch.train.eval import _both_direction_ranks
from tpugraph_torch.train.loop import embed
from tpugraph_torch.train.losses import margin_align_loss
from tpugraph_torch.train.metrics import epoch_edge_ops
from tpugraph_torch.train.mtl import draw_interval
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


def device_ms(fn, iters: int = 20, tries: int = 3) -> float | None:
    """Device time of one call from a torch.profiler trace: the time of its
    kernels and memsets on the card, summed, so the host's launch cost is
    left out (``time_ms`` includes it when it exceeds the device's work).
    A trace can come back without device events: the window is then taken
    again, and after ``tries`` empty ones the time is None."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / iters / 1e3
    return None


def ratio(a: float | None, b: float | None) -> float | None:
    """a / b, or None where either time was not measured."""
    return None if a is None or b is None else a / b


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


def _bound_ms(op, x, wmat, bias) -> tuple[float, str, float]:
    """Least time for one layer on this operator: each input byte read once
    (x, W, b, the buckets' rows/idx/w, diag), the output written once; the
    operations this graph needs as the kernel runs them: the real edges
    (the diagonal included) at the fp32 SIMT rate, then the product as
    three TF32 products on the tensor cores (two for a bf16 W, which is
    exact in TF32).  Third, the bound with the whole product at the peak
    rate of x's type (fp32 SIMT, or bf16 tensor cores)."""
    m = op.fwd
    n, d_in, d_out = m.n_rows, x.shape[1], wmat.shape[1]
    es = x.element_size()
    ell_bytes = sum(b.rows.numel() * 4 + b.idx.numel() * 4 + b.w.numel() * 4 for b in m.buckets)
    nbytes = (n * d_in * es + d_in * d_out * es + bias.numel() * 4 + op.diag.numel() * 4
              + ell_bytes + n * d_out * es)
    edge_ops, gemm_ops = 2 * (m.nnz + op.n_diag) * d_in, 2 * n * d_in * d_out
    n_products = 3 if x.dtype == torch.float32 else 2
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (edge_ops / PEAK_OPS[torch.float32] + n_products * gemm_ops / PEAK_TF32_OPS) * 1e3
    bound, bound_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return bound, bound_by, _bound(nbytes, edge_ops + gemm_ops, x.dtype)[0]


def _csr_of(m, diag: torch.Tensor | None = None) -> torch.Tensor:
    """An EllMatrix plus its split diagonal as one CSR tensor on its device
    (the pad slots, weight 0, dropped): the library yardsticks' operand,
    built here only."""
    parts = [(np.repeat(b.rows.cpu().numpy(), b.k), b.idx.cpu().numpy().reshape(-1),
              b.w.cpu().numpy().reshape(-1)) for b in m.buckets]
    if diag is not None:
        parts.append((np.arange(m.n_rows), np.arange(m.n_rows), diag.cpu().numpy()))
    rows, cols, w = (np.concatenate(a) for a in zip(*parts))
    keep = w != 0
    rows, cols, w = rows[keep], cols[keep], w[keep]
    order = np.lexsort((cols, rows))
    crow = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=m.n_rows))])
    with warnings.catch_warnings():  # CSR support is "beta" in PyTorch
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.from_numpy(crow), torch.from_numpy(cols[order].astype(np.int64)),
            torch.from_numpy(w[order]), size=(m.n_rows, m.n_cols),
            check_invariants=True).to(m.device)


def _gcn_split(m, diag, x, wmat, bias) -> dict:
    """The fused layer's device time on parts of its work: all of it, the
    rows of K ≥ 1,024 (their segments) and the rest, the short rows
    (1 ≤ K ≤ 7), and the K = 0 tiles (no ELL gather: the diagonal and the
    product alone).  Rows outside the part are left unwritten; only the
    time is read."""
    plan = gcn_fused.layer_plan(m)
    tk, sk = plan.tiles.tiles[:, 2], plan.segs[:, 2]
    masks = {"all": None, "k_ge_1024": (tk >= 1024, sk >= 1024),
             "k_lt_1024": (tk < 1024, sk < 1024), "k_1_to_7": ((tk >= 1) & (tk <= 7), sk < 0),
             "k_0": (tk == 0, sk < 0)}
    out = {}
    for name, mask in masks.items():
        part = plan if mask is None else dataclasses.replace(
            plan, tiles=dataclasses.replace(plan.tiles, tiles=plan.tiles.tiles[mask[0]].contiguous()),
            segs=plan.segs[mask[1]].contiguous())
        out[name] = {"tiles": int(part.tiles.tiles.shape[0]), "segments": int(part.segs.shape[0]),
                     "device_ms": device_ms(
                         lambda part=part: gcn_fused._launch(m, diag, x, wmat, bias, part))}
    out["k_ge_1024_share"] = ratio(out["k_ge_1024"]["device_ms"], out["all"]["device_ms"])
    return out


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
    a_csr = _csr_of(op.fwd, op.diag)

    zero_rows = plan.rows[-plan.n_zero_rows:].long() if plan.n_zero_rows else None
    rng = np.random.default_rng(0)
    results = {}
    for d, dtype in ((128, torch.float32), (128, torch.bfloat16), (256, torch.float32),
                     (256, torch.bfloat16)):
        x = torch.from_numpy(rng.standard_normal((task.n_ent, d)).astype(np.float32)).to(dev)
        wm = torch.from_numpy((rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.standard_normal(d).astype(np.float32)).to(dev)
        x, wm = x.to(dtype), wm.to(dtype)
        got = fused_gcn_layer(op.fwd, op.diag, x, wm, b)
        sync(dev)
        want = reference_layer(op.fwd, op.diag, x, wm, b)
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
        err = float((got.float() - want.float()).abs().max())
        # every row's sum runs in a fixed order
        same = torch.equal(got, fused_gcn_layer(op.fwd, op.diag, x, wm, b))
        if not same:
            raise AssertionError("gcn_fused: two launches on the same input differ")
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
        bound, bound_by, bound_x_type = _bound_ms(op, x, wm, b)
        split = _gcn_split(op.fwd, op.diag, x, wm, b)
        results[d, dtype] = dict(
            d_in=d, d_out=d, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=bound_by, library_ms=lib_ms, device_ms=dev_ms, ms_cold_l2=ms_cold,
            library_device_ms=lib_dev, bound_x_type_ms=bound_x_type,
            panels=gcn_fused.PANELS[d, d],
            precision="3xtf32" if dtype == torch.float32 else "2xtf32")
        emit({"phase": "kernel", "kernel": "gcn_fused", "d_in": d, "d_out": d,
              "panels": gcn_fused.PANELS[d, d], "dtype": str(dtype).split(".")[1],
              "max_abs_err": err, "no_bucket_rows_max_abs_err": zero_err, "ms": ms,
              "device_ms": dev_ms, "ms_cold_l2": ms_cold, "plain_ms": plain_ms,
              "library_ms": lib_ms, "library_device_ms": lib_dev,
              "library_ms_cold_l2": lib_cold, "library_refused": lib_refused, "bound_ms": bound,
              "bound_by": bound_by, "share_of_bound": bound / ms,
              "share_of_bound_device": ratio(bound, dev_ms), "bound_x_type_ms": bound_x_type,
              "share_of_x_type_bound_device": ratio(bound_x_type, dev_ms),
              "bit_identical_runs": same, "split": split, "card": smi})
    # the recipe's width first; the others beside it
    return {**results[256, torch.float32],
            "bf16": results[256, torch.bfloat16],
            "at_d128": {**results[128, torch.float32], "bf16": results[128, torch.bfloat16]}}


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


def phase_spmm(task, smi: str, dev: torch.device, d: int = 128, split: bool = True) -> dict:
    """The ELL SpMM kernel where training runs it: u = Aᵀ·ḡ over the
    transpose operator, fp32, at width ``d``; ``split`` adds the device
    time of parts of its work and a call's host time."""
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
    at_csr = _csr_of(m, op.diag)
    rng = np.random.default_rng(1)
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
    host = host_ms(lambda: ell_spmm(m, op.diag, g)) if split else None
    lib_host = host_ms(lambda: torch.sparse.mm(at_csr, g)) if split else None
    split = _spmm_split(m, op.diag, g) if split else None
    # each input byte once (g, diag, the buckets' rows/idx/w), the output
    # once; 2 operations per real edge (diagonal included) and column
    ell_bytes = sum(b.rows.numel() * 4 + b.idx.numel() * 4 + b.w.numel() * 4
                    for b in m.buckets)
    nbytes = 2 * m.n_rows * d * 4 + op.diag.numel() * 4 + ell_bytes
    bound, bound_by = _bound(nbytes, 2 * (m.nnz + op.n_diag) * d)
    emit({"phase": "kernel", "kernel": "spmm_ell", "operator": "transpose", "dtype": "float32",
          "d": d, "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "ms_cold_l2": ms_cold,
          "plain_ms": plain_ms, "library_ms": lib_ms, "library_device_ms": lib_dev,
          "library_ms_cold_l2": lib_cold, "host_ms": host, "library_host_ms": lib_host,
          "bound_ms": bound, "bound_by": bound_by, "share_of_bound": bound / ms,
          "share_of_bound_device": ratio(bound, dev_ms), "bit_identical_runs": True,
          "seg_cap": SEG_SLOTS, "work_items": int(seg.items.shape[0]),
          "longest_item_slots": seg.max_item_slots, "cut_rows": int(seg.split_p0.shape[0] - 1),
          "split": split, "card": smi})
    return dict(d=d, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=lib_ms, device_ms=dev_ms, ms_cold_l2=ms_cold,
                library_device_ms=lib_dev, seg_cap=SEG_SLOTS,
                work_items=int(seg.items.shape[0]), longest_item_slots=seg.max_item_slots)


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
    return dict(q=s, c=s, d=d, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=addmm_ms + lse_ms, device_ms=dev_ms,
                ms_cold_l2=ms_cold, library_device_ms=lib_dev, bound_fp32_ms=bound_fp32,
                precision=PRECISION, candidate_splits=n_splits)


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


def _expected_launches(cfg, t: dict) -> dict:
    """A training run's launches from its timings' counts: two fused layers
    per encoder forward (each step, each interval boundary's forward, each
    eval), two SpMMs per step (the layers' backward), 2·iters + 1 potential
    updates per step with the OT head.  The attribute channel adds two
    fused layers per forward, four SpMMs per step (its layers' backward,
    the incidence forward and backward) and one per boundary forward and
    eval (the incidence forward)."""
    ae = cfg.use_attr_channel
    forwards = t["steps"] + t["forwards"] + t["evals"]
    return {"gcn_fused": (4 if ae else 2) * forwards,
            "spmm_ell": (6 if ae else 2) * t["steps"] + (t["forwards"] + t["evals"] if ae else 0),
            "sinkhorn_fused": (2 * cfg.sinkhorn_iters + 1) * t["steps"] if cfg.use_sinkhorn else 0}


def _mtl_step_launches(cfg) -> dict:
    """One AlignMTL training step's launches (``_expected_launches``'s per step)."""
    ae = cfg.use_attr_channel
    return {"gcn_fused": 4 if ae else 2, "spmm_ell": 6 if ae else 2,
            "sinkhorn_fused": 2 * cfg.sinkhorn_iters + 1 if cfg.use_sinkhorn else 0}


def _step_batch(res, cfg, dev):
    task = res.task
    pairs = torch.as_tensor(task.train_pairs, dtype=torch.int64, device=dev)
    neg_l, neg_r = sample_uniform_negatives(torch.Generator().manual_seed(1), pairs,
                                            task.kg1.n_ent, task.n_ent, cfg.k_neg)
    return {"pairs": pairs, "neg_l": neg_l, "neg_r": neg_r}


def _saved_batch(ckpt_dir: str, cfg, task, dev) -> tuple[dict, int]:
    """The last interval's batch as the run saved it: its negatives, its
    proposals with their weights, fit_mtl's draws; and the proposals of
    weight > 0.  The relation triples join it as fit_mtl's constant."""
    saved = Checkpointer(ckpt_dir, cfg.checkpoint_every).restore_latest(dev)[1]
    pairs = torch.as_tensor(task.train_pairs, dtype=torch.int64, device=dev)
    batch = {"pairs": pairs, "neg_l": saved["neg_l"], "neg_r": saved["neg_r"],
             **saved.get("extra", {})}
    n_boot = 0
    if cfg.boot_cap > 0:
        n_boot = int((saved["boot_w"] > 0).sum())
        batch["pairs_aug"] = torch.cat([pairs, saved["boot_pairs"]])
        batch["w"] = torch.cat([torch.ones(len(pairs), device=dev),
                                saved["boot_w"] * cfg.boot_weight])
    if cfg.use_rel_head:
        batch["rel_triples"] = torch.as_tensor(task.merged_triples, dtype=torch.int64,
                                               device=dev)
    return batch, n_boot


@contextlib.contextmanager
def _plain_kernels():
    """The plain path: every kernel of a training step swapped for its plain
    PyTorch version where the model calls it (the GCN layer, the incidence
    SpMM, the OT head), differentiated by autograd."""
    saved = (graphconv_mod.gcn_layer, attr_channel_mod.spmm_ell, align_mod.sinkhorn_align_loss)
    graphconv_mod.gcn_layer = lambda op, x, w, b=None: reference_layer(op.fwd, op.diag, x, w, b)
    attr_channel_mod.spmm_ell = lambda op, x: apply_with_diag(op.fwd, op.diag, x)
    align_mod.sinkhorn_align_loss = sinkhorn_align_loss_plain
    try:
        yield
    finally:
        (graphconv_mod.gcn_layer, attr_channel_mod.spmm_ell,
         align_mod.sinkhorn_align_loss) = saved


def _check_step(model, loss_fn, expect: dict, zero_grads: tuple[str, ...] = ()) -> dict:
    """One training step's loss and gradients through the kernels against
    the plain path on the card (``_plain_kernels``, which must launch no
    kernel): loss rel 1e-4, each gradient relative L2 1e-3.  ``loss_fn()``
    returns the step's loss; ``expect``, the kernels' launches in it.
    ``zero_grads``: parameters whose gradient is 0 by construction (the AE
    layer-2 bias: the AE margin reads only differences of rows); both paths
    must give rounding noise there, under 1e-5 of the step's largest
    gradient entry."""
    model.zero_grad(set_to_none=True)
    _reset_launch_counts()
    loss = loss_fn()
    loss.backward()
    sync(loss.device)
    per_step = _launch_counts()
    if per_step != expect:
        raise AssertionError(f"one step launched {per_step}, expected {expect}")
    grads = {k: v.grad for k, v in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    with _plain_kernels():
        plain = loss_fn()
        plain.backward()
    sync(loss.device)
    if any(_launch_counts()[k] != v for k, v in per_step.items()):
        raise AssertionError(f"the plain path launched kernels: {_launch_counts()}")
    loss_rel = abs(loss.item() - plain.item()) / abs(plain.item())
    plain_grads = dict((k, v.grad) for k, v in model.named_parameters())
    grad_rel = {k: float((grads[k] - v).norm() / v.norm().clamp_min(1e-30))
                for k, v in plain_grads.items() if k not in zero_grads}
    scale = max(float(v.abs().max()) for v in plain_grads.values())
    zero_abs = {k: max(float(grads[k].abs().max()), float(plain_grads[k].abs().max()))
                for k in zero_grads}
    if (loss_rel > 1e-4 or max(grad_rel.values()) > 1e-3
            or any(v > 1e-5 * scale for v in zero_abs.values())):
        raise AssertionError(f"step vs plain path: loss rel {loss_rel}, grads {grad_rel}, "
                             f"zero grads {zero_abs} at scale {scale}")
    return {"per_step_launches": per_step, "loss": loss.item(), "loss_plain": plain.item(),
            "loss_rel_err": loss_rel, "grad_rel_l2": grad_rel,
            "zero_grad_max_abs": zero_abs, "grad_max_abs": scale}


def _profile_step(model, op, batch, cfg, dev, attr_op=None, reps: int = 5) -> dict:
    """Median host wall time of each stage of an AlignMTL step, each ended
    by a synchronise: encoder + margin forward; the OT head's forward and
    backward; the relation head and the attribute head (forward and
    backward each, on the detached table); the AE channel (its forward,
    margin and backward); the rest of the backward (margin + the encoder's
    layers); Adam."""
    opt, _ = make_optimizer(cfg, model.parameters())
    m_pairs = batch.get("pairs_aug", batch["pairs"])
    heads = []
    if model.rel_head is not None:
        heads.append(("rel_head", lambda e: cfg.rel_weight * model.rel_head(
            e, batch["rel_triples"], batch["rel_neg_t"], batch["rel_neg_h"])))
    if model.attr_head is not None:
        heads.append(("attr_head", lambda e: cfg.attr_weight * model.attr_head(
            e, batch["attr_triples"])))
    names = ["forward", *(["ot_forward", "ot_backward"] if cfg.use_sinkhorn else []),
             *(h for h, _ in heads), *(["ae_channel"] if attr_op is not None else []),
             "backward", "adam"]
    times = {k: [] for k in (*names, "step")}
    for i in range(reps + 1):  # the first is a warm-up
        sync(dev)
        t = [time.perf_counter()]

        def mark():
            sync(dev)
            t.append(time.perf_counter())

        opt.zero_grad(set_to_none=True)
        emb = model.encoder(op)
        margin = margin_align_loss(emb, m_pairs, batch["neg_l"], batch["neg_r"], cfg.gamma,
                                   batch.get("w"))
        mark()
        emb_d = emb.detach().requires_grad_(True)
        if cfg.use_sinkhorn:
            ot = sinkhorn_align_loss(emb_d, batch.get("ot_pairs", batch["pairs"]),
                                     tau=cfg.sinkhorn_tau, n_iters=cfg.sinkhorn_iters)
            mark()
            (cfg.sinkhorn_weight * ot).backward()
            mark()
        for _, head in heads:
            head(emb_d).backward()
            mark()
        if attr_op is not None:
            ae = model.ae_encoder(op, attr_op)
            (cfg.attr_channel_weight * margin_align_loss(
                ae, m_pairs, batch["neg_l"], batch["neg_r"], cfg.gamma, batch.get("w"))).backward()
            mark()
        torch.autograd.backward([margin, emb], [None, emb_d.grad])
        mark()
        opt.step()
        mark()
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


def _run_checked(cfg, task, dev, **timing_counts) -> tuple:
    """A run through driver.run with every count at 0 just before and read
    just after: its result, its launches (held to ``_expected_launches``),
    its wall seconds; ``timing_counts`` (steps, minings, ...) are held too."""
    _reset_launch_counts()
    t0 = time.perf_counter()
    res = run(cfg, task=task, device=dev)
    sync(dev)
    run_s = time.perf_counter() - t0
    counts, t = _launch_counts(), res.timings
    expected = _expected_launches(cfg, t)
    if counts != expected or any(t[k] != v for k, v in timing_counts.items()):
        raise AssertionError(f"launches {counts} (expected {expected}), timings {t}")
    losses = res.losses
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite or not falling: {losses}")
    if not all(math.isfinite(v) for v in res.metrics.values()):
        raise AssertionError(f"non-finite metrics {res.metrics}")
    return res, counts, run_s


def _stages(t: dict) -> dict:
    def per(key, count):
        return t[key] / t[count] if t[count] else None

    return {"step_median_s": float(np.median(t["step_s"])), "step_mean_s": per("train_s", "steps"),
            "boundary_forward_s": per("forward_s", "forwards"),
            "proposal_s": per("propose_s", "proposals"), "mining_s": per("mine_s", "minings"),
            "draw_s": per("draw_s", "draws"), "final_eval_s": per("eval_s", "evals"),
            "save_s": per("save_s", "saves")}


def phase_train(task, smi: str, dev: torch.device) -> dict:
    """Config sinkhorn through driver.run at zh-en scale: uniform negatives
    for epochs 0-4, one hard-mining interval for 5-9."""
    cfg = get_config("sinkhorn", syn_n_ent=task.kg1.n_ent, syn_n_rel=task.kg1.n_rel,
                     syn_seed=ZH_EN["seed"], epochs=10, neg_every=5)
    res, counts, run_s = _run_checked(cfg, task, dev, steps=10, minings=1)
    t, losses, metrics = res.timings, res.losses, res.metrics
    batch = _step_batch(res, cfg, dev)
    step = _check_step(res.model, lambda: res.model(res.op, batch)[0], _mtl_step_launches(cfg))
    prof = _profile_step(res.model, res.op, batch, cfg, dev)
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


# a recipe as chip_smoke runs it: only these are cut
RECIPE = "v6"
RECIPE_CUTS = {"epochs": 10, "boot_start": 2, "eval_every": 0}


def _cut_config(task, name: str, cuts: dict, recipe: str | None = None, **over):
    """The named config (with ``recipe`` applied) at the zh-en task, with
    ``cuts`` applied, and what each cut replaced: ``reduced``."""
    full = get_config(name, **(RECIPES[recipe] if recipe else {})).replace(
        syn_n_ent=task.kg1.n_ent, syn_n_rel=task.kg1.n_rel, syn_seed=ZH_EN["seed"], **over)
    origin = f"recipe {recipe}" if recipe else f"config {name}"
    return full.replace(**cuts), {k: f"{v} ({origin}: {getattr(full, k)})"
                                  for k, v in cuts.items()}


@contextlib.contextmanager
def _sigterm_in_step(n: int):
    """Send this process SIGTERM during the n-th training step (the n-th
    call of AlignMTL.forward), as a scheduler preempts a run."""
    real, calls = AlignMTL.forward, [0]

    def forward(self, *args, **kwargs):
        calls[0] += 1
        if calls[0] == n:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(self, *args, **kwargs)

    AlignMTL.forward = forward
    try:
        yield
    finally:
        AlignMTL.forward = real


def _hubness64(q: torch.Tensor, cands: torch.Tensor, k: int, block: int = 1024) -> torch.Tensor:
    """Each candidate's mean float64 L1 distance to its k nearest queries."""
    return torch.cat([torch.topk(torch.cdist(q, cands[c0:c0 + block], p=1), k, dim=0,
                                 largest=False).values.mean(0)
                      for c0 in range(0, cands.shape[0], block)])


def _check_csls(emb, task, queries, candidates, vals, ids, k: int, csls_k: int,
                dev: torch.device, sub: int = 64) -> dict:
    """CSLS ranks (l2r) and top-k of the first ``sub`` queries against a
    float64 search: a rank may differ only by the candidates whose score
    lies within 1e-5 of the distance scale of the threshold; top-k ids agree
    on 99 %, values within 1e-5 of that scale."""
    pairs = torch.as_tensor(task.test_pairs, dtype=torch.int64, device=dev)
    ranks_l2r, _ = _both_direction_ranks(emb, pairs, csls_k=csls_k)
    left, right = emb[pairs[:, 0]].double(), emb[pairs[:, 1]].double()
    r = _hubness64(left, right, csls_k)
    d = torch.cdist(left[:sub], right, p=1)
    eps = 1e-5 * d.max(dim=1, keepdim=True).values
    score = 2 * d - r[None, :]
    idx = torch.arange(sub, device=dev)
    thresh = score[idx, idx][:, None]
    score[idx, idx] = float("inf")
    lo, hi = (score < thresh - eps).sum(1), (score < thresh + eps).sum(1)
    got_r = ranks_l2r[:sub]
    if not bool(((lo <= got_r) & (got_r <= hi)).all()):
        raise AssertionError("CSLS ranks disagree with a float64 search")
    q = emb[torch.as_tensor(queries, device=dev)].double()
    c = emb[torch.as_tensor(candidates, device=dev)].double()
    r = _hubness64(q, c, csls_k)
    bv, bi = torch.topk(2 * torch.cdist(q[:sub], c, p=1) - r[None, :], k, largest=False)
    scale = float(r.max())
    np.testing.assert_allclose(vals[:sub], bv.cpu().numpy(), rtol=1e-5, atol=1e-5 * scale)
    same_ids = float((candidates[bi.cpu().numpy()] == ids[:sub]).mean())
    if same_ids < 0.99:
        raise AssertionError(f"CSLS top-k ids agree with a float64 search on {same_ids:.3f}")
    return {"ranks_checked": sub, "topk_ids_match_float64": same_ids}


def phase_recipe(task, smi: str, dev: torch.device) -> dict:
    """Recipe v6 through driver.run at zh-en scale (RECIPE_CUTS), then
    checkpoint/resume, eval-only from the run's directory and CSLS
    serving."""
    cfg, reduced = _cut_config(task, "base", RECIPE_CUTS, RECIPE, checkpoint_every=4)
    with tempfile.TemporaryDirectory() as tmp:
        full_dir, kill_dir = os.path.join(tmp, "full"), os.path.join(tmp, "killed")
        boundaries = (cfg.epochs - 1) // cfg.neg_every  # 2, 4, 6, 8: proposals and mining
        res, counts, run_s = _run_checked(
            cfg.replace(checkpoint_dir=full_dir), task, dev, steps=cfg.epochs,
            forwards=boundaries, proposals=boundaries, minings=boundaries)
        t, losses = res.timings, res.losses
        enc = res.model.encoder
        widths = [tuple(enc.gc1.w.shape), tuple(enc.gc2.w.shape)]
        if widths != [(256, 256), (256, 256)]:
            raise AssertionError(f"gcn_fused ran at {widths}, not (256, 256)")
        # the last interval's batch as the run saved it: its proposals and negatives
        batch, n_boot = _saved_batch(full_dir, cfg, task, dev)
        if n_boot == 0:
            raise AssertionError("no proposal with weight > 0")
        step = _check_step(res.model, lambda: res.model(res.op, batch, train=True)[0],
                           _mtl_step_launches(cfg))

        # the same run preempted during epoch 5 (saved at 4 and 5), resumed to 10
        with _sigterm_in_step(6):
            killed = run(cfg.replace(checkpoint_dir=kill_dir), task=task, device=dev)
        killed_at = Checkpointer(kill_dir, cfg.checkpoint_every).latest_step()
        resumed = run(cfg.replace(checkpoint_dir=kill_dir), task=task, device=dev)
        want, got = res.metrics["final_loss"], resumed.metrics["final_loss"]
        resume_rel = abs(got - want) / abs(want)
        if (killed.timings["steps"] != 6 or killed_at != 5
                or resumed.timings["start_epoch"] != 6 or resume_rel > 1e-4):
            raise AssertionError(f"resume: killed after {killed.timings['steps']} steps, saved "
                                 f"at {killed_at}, resumed at {resumed.timings['start_epoch']}, "
                                 f"final loss {got} against {want}")

        # eval-only from the trained directory, then CSLS serving
        ev = evaluate(cfg.replace(checkpoint_dir=full_dir), task=task, device=dev)
        eval_diff = max(abs(ev.metrics[k] - res.metrics[k]) for k in ev.metrics)
        if eval_diff > 1e-4:
            raise AssertionError(f"evaluate {ev.metrics} against the run's {res.metrics}")
    n1 = task.kg1.n_ent
    queries, candidates = task.test_pairs[:, 0], np.arange(n1, task.n_ent)
    t0 = time.perf_counter()
    vals, ids = topk_alignments(ev.emb, queries, candidates, k=10, csls_k=cfg.eval_csls_k)
    sync(dev)
    topk_s = time.perf_counter() - t0
    csls = _check_csls(ev.emb, task, queries, candidates, vals, ids, 10, cfg.eval_csls_k, dev)

    stages = {**_stages(t), "evaluate_build_s": ev.timings["build_s"],
              "evaluate_forward_s": ev.timings["forward_s"],
              "evaluate_eval_csls_s": ev.timings["eval_s"], "topk_csls_s": topk_s,
              "load_s": resumed.timings["load_s"]}
    emit({"phase": "recipe", "recipe": RECIPE, "n_ent": task.n_ent,
          "train_pairs": int(len(task.train_pairs)), "test_pairs": int(len(task.test_pairs)),
          "dim": cfg.dim, "gamma": cfg.gamma, "k_neg": cfg.k_neg, "neg_every": cfg.neg_every,
          "boot": {"cap": cfg.boot_cap, "start": cfg.boot_start, "weight": cfg.boot_weight,
                   "csls_k": cfg.boot_csls_k, "last_proposals_weighted": n_boot},
          "sinkhorn": {"weight": cfg.sinkhorn_weight, "tau": cfg.sinkhorn_tau,
                       "iters": cfg.sinkhorn_iters},
          "eval_csls_k": cfg.eval_csls_k, "epochs": cfg.epochs,
          "reduced": reduced,
          "losses": losses, "metrics": {k: res.metrics[k] for k in ("hits@1", "hits@10", "mrr")},
          "launches": counts, "gcn_fused_dims": widths, "timings": t, "run_s": run_s,
          "stages_s": stages, "step_check": step,
          "resume": {"killed_after_steps": killed.timings["steps"], "saved_at": killed_at,
                     "resumed_at": resumed.timings["start_epoch"], "final_loss": got,
                     "uninterrupted_final_loss": want, "rel_err": resume_rel},
          "evaluate_metrics_max_diff": eval_diff, "topk_queries": int(len(queries)),
          "topk_candidates": int(len(candidates)), "csls_check": csls, "card": smi})
    return counts


def phase_incidence(task, smi: str, dev: torch.device, d: int) -> dict:
    """The ELL SpMM kernel on the attribute channel's incidence, where
    config mtl runs it: x0 = A_attr·attr_emb (entities × attributes, K ≤ 4,
    no diagonal) and its gradient Aᵀ·ḡ (attributes × entities, K in the
    hundreds, so nearly every row is cut into segments)."""
    t0 = time.perf_counter()
    op = build_attr_operator(task.merged_attr_triples, task.n_ent, task.n_attr).to(dev)
    sync(dev)
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    out = {}
    for name, m in (("forward", op.fwd), ("transpose", op.bwd)):
        x = torch.from_numpy(rng.standard_normal((m.n_cols, d)).astype(np.float32)).to(dev)
        got = ell_spmm(m, None, x)
        sync(dev)
        want = apply_with_diag(m, None, x)
        torch.testing.assert_close(got, want, **TOL[torch.float32])
        err = float((got - want).abs().max())
        if not torch.equal(got, ell_spmm(m, None, x)):
            raise AssertionError(f"spmm_ell ({name} incidence): two launches differ")
        csr = _csr_of(m)
        lib = torch.sparse.mm(csr, x)
        torch.testing.assert_close(lib, want, **TOL[torch.float32])
        seg = segment_plan(m)
        ms = time_ms(lambda: ell_spmm(m, None, x))
        ms_cold = time_cold_ms(lambda: ell_spmm(m, None, x))
        dev_ms = device_ms(lambda: ell_spmm(m, None, x))
        plain_ms = time_ms(lambda: apply_with_diag(m, None, x), iters=5)
        lib_ms = time_ms(lambda: torch.sparse.mm(csr, x))
        lib_dev = device_ms(lambda: torch.sparse.mm(csr, x))
        # x and the output once, the buckets' rows/idx/w once; 2 operations
        # per nonzero and column
        ell_bytes = sum(b.rows.numel() * 4 + b.idx.numel() * 8 for b in m.buckets)
        bound, bound_by = _bound((m.n_cols + m.n_rows) * d * 4 + ell_bytes, 2 * m.nnz * d)
        ks = [b.k for b in m.buckets]
        out[name] = dict(
            rows=m.n_rows, cols=m.n_cols, nnz=m.nnz, k_min=min(ks), k_max=max(ks),
            max_abs_err=err, ms=ms, device_ms=dev_ms, ms_cold_l2=ms_cold, plain_ms=plain_ms,
            library_ms=lib_ms, library_device_ms=lib_dev, bound_ms=bound, bound_by=bound_by,
            share_of_bound_device=ratio(bound, dev_ms), work_items=int(seg.items.shape[0]),
            cut_rows=int(seg.split_p0.shape[0] - 1), longest_item_slots=seg.max_item_slots)
    emit({"phase": "incidence", "kernel": "spmm_ell", "d": d, "n_attr": task.n_attr,
          "build_s": build_s, "bit_identical_runs": True, **out, "card": smi})
    return out


def phase_recipe_v7r(task, smi: str, dev: torch.device) -> dict:
    """Recipe v7r (v6 + the attribute head at weight 0.25) through
    driver.run at zh-en scale, cut as v6 is (RECIPE_CUTS); v7 held to differ
    from it only in attr_weight; one step with the run's last interval
    batch against the plain path; the step's stages."""
    v7, v7r = (get_config("base", **RECIPES[r]).to_dict() for r in ("v7", "v7r"))
    differ = sorted(k for k in v7 if v7[k] != v7r[k])
    if differ != ["attr_weight"]:
        raise AssertionError(f"v7 and v7r differ in {differ}")
    cfg, reduced = _cut_config(task, "base", RECIPE_CUTS, "v7r", checkpoint_every=4)
    boundaries = (cfg.epochs - 1) // cfg.neg_every  # 2, 4, 6, 8
    with tempfile.TemporaryDirectory() as tmp:
        res, counts, run_s = _run_checked(
            cfg.replace(checkpoint_dir=tmp), task, dev, steps=cfg.epochs, forwards=boundaries,
            proposals=boundaries, minings=boundaries, draws=boundaries + 1)
        batch, n_boot = _saved_batch(tmp, cfg, task, dev)
    model = res.model
    widths = [tuple(model.encoder.gc1.w.shape), tuple(model.encoder.gc2.w.shape),
              tuple(model.attr_head.w.shape)]
    if widths != [(256, 256), (256, 256), (256, task.n_attr)] or n_boot == 0:
        raise AssertionError(f"widths {widths}, weighted proposals {n_boot}")
    step = _check_step(model, lambda: model(res.op, batch, train=True)[0],
                       _mtl_step_launches(cfg))
    prof = _profile_step(model, res.op, batch, cfg, dev)
    emit({"phase": "recipe_v7r", "recipe": "v7r", "n_ent": task.n_ent, "n_attr": task.n_attr,
          "dim": cfg.dim, "attr_weight": cfg.attr_weight,
          "attr_batch": int(batch["attr_triples"].shape[0]), "v7_differs_in": differ,
          "epochs": cfg.epochs, "reduced": reduced, "losses": res.losses,
          "metrics": {k: res.metrics[k] for k in ("hits@1", "hits@10", "mrr")},
          "launches": counts, "gcn_fused_dims": widths[:2], "timings": res.timings,
          "run_s": run_s, "stages_s": _stages(res.timings), "step_check": step,
          "step_profile": prof, "card": smi})
    return counts


def phase_mtl(task, smi: str, dev: torch.device) -> dict:
    """Config mtl with the attribute channel at zh-en scale, dim 128, 10
    epochs: launches per run, step and embed; one step against the plain
    path, and one with an OT subsample of 2,048 seed pairs; SIGTERM
    mid-interval and the resume; eval-only from the run's directory; the
    step's stages."""
    cfg, reduced = _cut_config(task, "mtl", {"epochs": 10, "eval_every": 0},
                               use_attr_channel=True, checkpoint_every=4)
    with tempfile.TemporaryDirectory() as tmp:
        full_dir, kill_dir = os.path.join(tmp, "full"), os.path.join(tmp, "killed")
        res, counts, run_s = _run_checked(cfg.replace(checkpoint_dir=full_dir), task, dev,
                                          steps=10, forwards=1, minings=1, draws=2)
        model, op = res.model, res.op
        attr_op = build_attr_operator(task.merged_attr_triples, task.n_ent,
                                      task.n_attr).to(dev)
        # the incidence's share of the run's SpMM launches: all but the
        # four layers' backward of each step
        incidence = counts["spmm_ell"] - 4 * res.timings["steps"]
        _reset_launch_counts()
        with torch.no_grad():
            emb = model.embed(op, attr_op)
        sync(dev)
        per_embed = _launch_counts()
        if per_embed != {"gcn_fused": 4, "spmm_ell": 1, "sinkhorn_fused": 0} or emb.shape != (
                task.n_ent, 2 * cfg.dim):
            raise AssertionError(f"embed launched {per_embed}, shape {tuple(emb.shape)}")
        batch, _ = _saved_batch(full_dir, cfg, task, dev)
        zero = ("ae_encoder.gc2.b",)
        step = _check_step(model, lambda: model(op, batch, train=True, attr_op=attr_op)[0],
                           _mtl_step_launches(cfg), zero)
        ot_cfg = cfg.replace(sinkhorn_pairs=2048, use_rel_head=False, use_attr_head=False)
        sub = draw_interval(ot_cfg, 0, batch["pairs"], task.n_ent, 0, None)["ot_pairs"]
        ot_batch = {**batch, "ot_pairs": sub}
        step_ot = _check_step(model, lambda: model(op, ot_batch, train=True, attr_op=attr_op)[0],
                              _mtl_step_launches(cfg), zero)

        # preempted during epoch 7 (saved at 4 and 7), mid-interval (the
        # boundary is 5), resumed to 10
        with _sigterm_in_step(8):
            killed = run(cfg.replace(checkpoint_dir=kill_dir), task=task, device=dev)
        killed_at = Checkpointer(kill_dir, cfg.checkpoint_every).latest_step()
        resumed = run(cfg.replace(checkpoint_dir=kill_dir), task=task, device=dev)
        want, got = res.metrics["final_loss"], resumed.metrics["final_loss"]
        resume_rel = abs(got - want) / abs(want)
        if (killed.timings["steps"] != 8 or killed_at != 7
                or resumed.timings["start_epoch"] != 8 or resume_rel > 1e-4):
            raise AssertionError(f"resume: killed after {killed.timings['steps']} steps, saved "
                                 f"at {killed_at}, resumed at {resumed.timings['start_epoch']}, "
                                 f"final loss {got} against {want}")
        ev = evaluate(cfg.replace(checkpoint_dir=full_dir), task=task, device=dev)
        eval_diff = max(abs(ev.metrics[k] - res.metrics[k]) for k in ev.metrics)
        if eval_diff > 1e-4 or ev.emb.shape != (task.n_ent, 2 * cfg.dim):
            raise AssertionError(f"evaluate {ev.metrics} against the run's {res.metrics}")
    prof = _profile_step(model, op, batch, cfg, dev, attr_op=attr_op)
    emit({"phase": "mtl", "config": "mtl", "use_attr_channel": True, "n_ent": task.n_ent,
          "n_attr": task.n_attr, "rel_triples": int(batch["rel_triples"].shape[0]),
          "dim": cfg.dim, "combined_dim": 2 * cfg.dim, "rel_k_neg": cfg.rel_k_neg,
          "weights": {"sinkhorn": cfg.sinkhorn_weight, "rel": cfg.rel_weight,
                      "attr": cfg.attr_weight, "ae": cfg.attr_channel_weight},
          "epochs": cfg.epochs, "reduced": reduced, "losses": res.losses,
          "metrics": {k: res.metrics[k] for k in ("hits@1", "hits@10", "mrr")},
          "launches": counts, "incidence_launches": incidence, "per_embed_launches": per_embed,
          "timings": res.timings, "run_s": run_s, "stages_s": _stages(res.timings),
          "step_check": step, "step_check_ot_2048": step_ot,
          "resume": {"killed_after_steps": killed.timings["steps"], "saved_at": killed_at,
                     "resumed_at": resumed.timings["start_epoch"], "final_loss": got,
                     "uninterrupted_final_loss": want, "rel_err": resume_rel},
          "evaluate_metrics_max_diff": eval_diff, "step_profile": prof, "card": smi})
    return {**counts, "incidence": incidence}


def phase_highway(task, smi: str, dev: torch.device) -> dict:
    """Config highway (funifun weights, rw norm, highway gates) with dropout
    0.3 at zh-en scale, dim 128, 10 epochs: one step against the plain path
    with the same mask generator; the eval forward equal with and without
    dropout."""
    cfg, reduced = _cut_config(task, "highway", {"epochs": 10, "eval_every": 0}, dropout=0.3)
    res, counts, run_s = _run_checked(cfg, task, dev, steps=10, forwards=1, minings=1)
    model, op = res.model, res.op
    batch = _step_batch(res, cfg, dev)

    def loss_fn():
        gen = torch.Generator(device=dev).manual_seed(1234)
        return margin_align_loss(model(op, train=True, generator=gen), batch["pairs"],
                                 batch["neg_l"], batch["neg_r"], cfg.gamma)

    step = _check_step(model, loss_fn, {"gcn_fused": 2, "spmm_ell": 2, "sinkhorn_fused": 0})
    no_drop = AlignGCN(n_ent=task.n_ent, dim=cfg.dim, highway=True, device=dev)
    no_drop.load_state_dict(model.state_dict())
    with torch.no_grad():
        a, b, dropped = model(op), no_drop(op), model(op, train=True, generator=torch.Generator(
            device=dev).manual_seed(1234))
    if not torch.equal(a, b) or torch.equal(a, dropped):
        raise AssertionError("the eval forward depends on dropout, or the training one does not")
    emit({"phase": "highway", "config": "highway", "weighting": cfg.weighting, "norm": cfg.norm,
          "dropout": cfg.dropout, "n_ent": task.n_ent, "dim": cfg.dim, "edges": op.nnz,
          "transpose_differs": not torch.equal(op.fwd.row_order, op.bwd.row_order) or any(
              not torch.equal(x.w, y.w) for x, y in zip(op.fwd.buckets, op.bwd.buckets)),
          "epochs": cfg.epochs, "reduced": reduced, "losses": res.losses,
          "metrics": {k: res.metrics[k] for k in ("hits@1", "hits@10", "mrr")},
          "launches": counts, "timings": res.timings, "run_s": run_s,
          "stages_s": _stages(res.timings), "step_check": step,
          "eval_forward_equal_without_dropout": True, "card": smi})
    return counts



def main() -> int:
    smi = phase_device()
    phase_build()
    task = synthetic_align_task(**ZH_EN)
    dev = torch.device("cuda")
    k_gcn = phase_kernel(task, smi, dev)
    k_spmm = {**phase_spmm(task, smi, dev, d=256, split=False),
              "at_d128": phase_spmm(task, smi, dev, d=128)}
    k_sink = {**phase_sinkhorn(smi, dev, d=256), "at_d128": phase_sinkhorn(smi, dev, d=128)}
    serve_launches = phase_slice(task, smi, dev)
    train = phase_train(task, smi, dev)
    recipe = phase_recipe(task, smi, dev)
    incidence = {**phase_incidence(task, smi, dev, d=128),
                 "at_d256": phase_incidence(task, smi, dev, d=256)}
    v7r = phase_recipe_v7r(task, smi, dev)
    mtl = phase_mtl(task, smi, dev)
    highway = phase_highway(task, smi, dev)
    # the numbers at the recipe's width (d = 256); launches of the recipe's
    # run, with those of the other runs beside (the incidence's at mtl's
    # width, d = 128, where config mtl runs it)
    emit({"kernels": [
        {"name": "gcn_fused", "route": "cuda", "source": "tpugraph_torch/csrc/gcn_fused.cu",
         "replaces": "tpugraph/kernels/gcn_fused_pallas.py:40", "launches": recipe["gcn_fused"],
         "launches_train": train["gcn_fused"], "launches_serve": serve_launches,
         "launches_v7r": v7r["gcn_fused"], "launches_mtl": mtl["gcn_fused"],
         "launches_highway": highway["gcn_fused"], **k_gcn},
        {"name": "spmm_ell", "route": "cuda", "source": "tpugraph_torch/csrc/spmm_ell.cu",
         "replaces": "tpugraph/kernels/spmm_ell.py:19", "launches": recipe["spmm_ell"],
         "launches_train": train["spmm_ell"], "launches_v7r": v7r["spmm_ell"],
         "launches_mtl": mtl["spmm_ell"], "launches_mtl_incidence": mtl["incidence"],
         "launches_highway": highway["spmm_ell"], **k_spmm, "incidence": incidence},
        {"name": "sinkhorn_fused", "route": "cuda",
         "source": "tpugraph_torch/csrc/sinkhorn_fused.cu",
         "replaces": "tpugraph/kernels/sinkhorn_pallas.py:38",
         "launches": recipe["sinkhorn_fused"], "launches_train": train["sinkhorn_fused"],
         "launches_v7r": v7r["sinkhorn_fused"], "launches_mtl": mtl["sinkhorn_fused"], **k_sink},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
