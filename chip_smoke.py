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
             kernel on the transpose operator (the layers' backward) and for
             the Sinkhorn potential-update kernel at 4,500 × 4,500 × 128.
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
from tpugraph_torch.kernels.sinkhorn_fused import (sinkhorn_potential_update,
                                                   sinkhorn_update_plain, sq_norms)
from tpugraph_torch.kernels.spmm_ell import apply_with_diag, ell_spmm, fused_plan
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
    lib = torch.sparse.mm(at_csr, g)
    torch.testing.assert_close(lib, want, **TOL[torch.float32])
    ms = time_ms(lambda: ell_spmm(m, op.diag, g))
    ms_cold = time_cold_ms(lambda: ell_spmm(m, op.diag, g))
    plain_ms = time_ms(lambda: apply_with_diag(m, op.diag, g), iters=5)
    lib_ms = time_ms(lambda: torch.sparse.mm(at_csr, g))
    lib_cold = time_cold_ms(lambda: torch.sparse.mm(at_csr, g))
    # each input byte once (g, diag, the buckets' rows/idx/w), the output
    # once; 2 operations per real edge (diagonal included) and column
    ell_bytes = sum(b.rows.numel() * 4 + b.idx.numel() * 4 + b.w.numel() * 4
                    for b in m.buckets)
    nbytes = 2 * m.n_rows * d * 4 + op.diag.numel() * 4 + ell_bytes
    bound, bound_by = _bound(nbytes, 2 * (m.nnz + op.n_diag) * d)
    emit({"phase": "kernel", "kernel": "spmm_ell", "operator": "transpose", "dtype": "float32",
          "max_abs_err": err, "ms": ms, "ms_cold_l2": ms_cold, "plain_ms": plain_ms,
          "library_ms": lib_ms, "library_ms_cold_l2": lib_cold, "bound_ms": bound,
          "bound_by": bound_by, "share_of_bound": bound / ms, "card": smi})
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                library_ms=lib_ms)


def phase_sinkhorn(smi: str, dev: torch.device, s: int = 4500, d: int = 128,
                   tau: float = 0.3) -> dict:
    """One potential update of config sinkhorn's OT head at zh-en scale."""
    rng = np.random.default_rng(2)

    def unit_rows():
        x = rng.standard_normal((s, d)).astype(np.float32)
        return torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True)).to(dev)

    l, r = unit_rows(), unit_rows()
    g = torch.from_numpy((0.1 * rng.standard_normal(s)).astype(np.float32)).to(dev)
    log_mu = torch.full((s,), -math.log(s), dtype=torch.float32, device=dev)
    l_sq, r_sq = sq_norms(l), sq_norms(r)

    def kernel():
        return sinkhorn_potential_update(l, r, g, log_mu, tau, l_sq, r_sq)

    got = kernel()
    sync(dev)
    want = sinkhorn_update_plain(l, r, g, log_mu, tau, l_sq, r_sq)
    torch.testing.assert_close(got, want, **TOL[torch.float32])
    err = float((got - want).abs().max())
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
    # inputs l, r, ‖l‖², ‖r‖², g, log μ once and f once; 2·Q·C·d for the
    # dot products plus one exp per cost entry, at the fp32 rate
    nbytes = (2 * s * d + 5 * s) * 4
    bound, bound_by = _bound(nbytes, 2 * s * s * d + s * s)
    emit({"phase": "kernel", "kernel": "sinkhorn_fused", "q": s, "c": s, "d": d, "tau": tau,
          "max_abs_err": err, "ms": ms, "ms_cold_l2": ms_cold, "plain_ms": plain_ms,
          "library_ms": addmm_ms + lse_ms, "library_addmm_ms": addmm_ms,
          "library_logsumexp_ms": lse_ms, "bound_ms": bound, "bound_by": bound_by,
          "share_of_bound": bound / ms, "card": smi})
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                library_ms=addmm_ms + lse_ms)


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
