"""Spawned ranks for the multi-process tests of the distributed trainer
(counterpart of ``tpugraph/dist/mp_worker.py``).

``run_ranks(mode, world, tmp_dir, *args)`` starts ``world`` processes by
the ``spawn`` method; each joins a gloo group over a ``FileStore`` in
``tmp_dir`` (no port to collide on when test workers run side by side),
runs with one thread, calls ``MODES[mode](*args)`` as its rank and saves
what it returns as ``tmp_dir/result-<rank>.pt``.  The parent joins every
child within ``timeout`` seconds (a hung rank fails the test; it is
killed) and returns the ranks' results in rank order.  The children import
the port only, never JAX.

Mode ``check`` runs, one after the other, the halo SpMM forward and
gradient in both impls (``halo_mode``), ring mining and eval
(``ring_mode``) and ``fit_distributed`` (``fit_mode``).  The JAX worker's
rehearsal modes
(checkpoint save and resume, the production surface with CSLS, boot, the
ring OT and tensor parallelism, and the attribute-channel and slice legs)
exercise parts the port refuses: they raise ``NotImplementedError``.
"""

from __future__ import annotations

import multiprocessing
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

# the JAX worker's modes over parts that are not ported yet (ROADMAP.md)
REHEARSALS = ("fit_checkpoint", "fitprod", "fitprod2")


def halo_graph(n: int = 96, t: int = 400, seed: int = 0):
    """A small random graph as sym-normalised COO (the JAX tests' graph)."""
    from tpugraph_torch.sparse.build import coo_from_triples, coo_normalize

    rng = np.random.default_rng(seed)
    h, tt = rng.integers(0, n, t), rng.integers(0, n, t)
    keep = h != tt
    tri = np.stack([h[keep], rng.integers(0, 5, keep.sum()), tt[keep]], axis=1)
    src, dst, w = coo_from_triples(n, tri, weighting="uniform")
    return src, dst, coo_normalize(src, dst, w, n, "sym")


def halo_mode(n_shards: int, d: int = 8, seed: int = 1) -> dict:
    """The rank's rows of A·x and of the gradient of Σ(A·x)² over x, for
    impls ell and sorted, x of the padded (n_pad, d) table from ``seed``."""
    from tpugraph_torch.dist.halo import halo_spmm, halo_spmm_ell
    from tpugraph_torch.dist.mesh import make_mesh, shard_operator
    from tpugraph_torch.sparse.partition import partition_edges

    src, dst, w = halo_graph()
    n = 96
    hg = partition_edges(src, dst, w, n, n_shards)
    x_all = np.zeros((hg.n_loc * n_shards, d), np.float32)
    x_all[:n] = np.random.default_rng(seed).standard_normal((n, d))
    out = {}
    with make_mesh(n_shards, torch.device("cpu")) as mesh:
        rows = slice(mesh.shards.start * hg.n_loc, mesh.shards.stop * hg.n_loc)
        for impl, fn in (("ell", halo_spmm_ell), ("sorted", halo_spmm)):
            op = shard_operator(hg, mesh, impl)
            x = torch.from_numpy(x_all[rows].copy()).requires_grad_()
            y = fn(x, op)
            (y ** 2).sum().backward()
            out[impl] = (y.detach(), x.grad)
    return out


def ring_mode(n_shards: int, seed: int = 3) -> dict:
    """Ring mining (both metrics, a pool smaller than k included) and ring
    eval on random tables."""
    from tpugraph_torch.dist.mesh import make_mesh
    from tpugraph_torch.dist.ring import ring_hits_at_k, ring_knn

    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((37, 8)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((101, 8)).astype(np.float32))
    ex = torch.from_numpy(rng.integers(0, 101, 37))
    emb = torch.from_numpy(rng.standard_normal((300, 8)).astype(np.float32))
    pairs = np.stack([rng.choice(150, 83, replace=False),
                      150 + rng.choice(150, 83, replace=False)], axis=1)
    with make_mesh(n_shards, torch.device("cpu")) as mesh:
        return {"cityblock": ring_knn(q, c, ex, 5, mesh),
                "sqeuclidean": ring_knn(q, c, ex, 5, mesh, metric="sqeuclidean"),
                "tiny_pool": ring_knn(q, c[:3], ex % 3, 5, mesh),
                "hits": ring_hits_at_k(emb, pairs, mesh)}


def fit_mode(cfg, task_kw: dict) -> dict:
    from tpugraph_torch.data import synthetic_align_task
    from tpugraph_torch.dist.trainer import fit_distributed

    res = fit_distributed(cfg, task=synthetic_align_task(**task_kw), device="cpu")
    return {"losses": res.losses, "history": res.history, "metrics": res.metrics,
            "params": res.params}


def check_mode(n_shards: int, cfg, task_kw: dict) -> dict:
    """The halo SpMM, the ring stages and ``fit_distributed`` in one spawn."""
    return {"halo": halo_mode(n_shards), "ring": ring_mode(n_shards),
            "fit": fit_mode(cfg, task_kw)}


MODES = {"check": check_mode}


def _entry(mode: str, rank: int, world: int, tmp_dir: str, args: tuple) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        torch.save(MODES[mode](*args), os.path.join(tmp_dir, f"result-{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp_dir, f"error-{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(mode: str, world: int, tmp_dir, *args, timeout: float = 120.0) -> list:
    """Run ``MODES[mode](*args)`` on ``world`` spawned gloo ranks; their
    results in rank order.  Raises if a rank fails or outlives ``timeout``."""
    if mode in REHEARSALS:
        raise NotImplementedError(
            f"the multi-process rehearsal mode {mode!r} runs parts of the distributed "
            f"trainer that are not ported yet; see ROADMAP.md")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {sorted(MODES)}")
    tmp_dir = str(tmp_dir)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(mode, r, world, tmp_dir, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        if hung:
            raise TimeoutError(f"ranks {hung} of {world} still running after {timeout} s")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errors = {}
    for r in range(world):
        path = os.path.join(tmp_dir, f"error-{r}.txt")
        if os.path.exists(path):
            with open(path) as f:
                errors[r] = f.read()
    failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if failed or errors:
        raise RuntimeError(f"ranks {failed} failed: {errors}")
    return [torch.load(os.path.join(tmp_dir, f"result-{r}.pt"), weights_only=False)
            for r in range(world)]
