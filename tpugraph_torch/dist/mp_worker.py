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
gradient in both impls (``halo_mode``), ring mining and eval, raw and
CSLS, and the ring OT's potentials, loss and gradient (``ring_mode``),
``fit_distributed`` (``fit_mode``), and with a config of recipe v7r's
surface (bootstrapping, the OT head on a subsample, the relation and
attribute heads, CSLS) one step on an injected batch (``surface_batch``)
and a run (``surface_mode``).  The JAX worker's rehearsal modes
(checkpoint save and resume, the production surface with tensor
parallelism, and the attribute-channel and slice legs) exercise parts the
port refuses: they raise ``NotImplementedError``.
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


def ot_pairs_of(s: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A (120, 8) table and s pairs of it for the ring OT's checks."""
    rng = np.random.default_rng(seed)
    emb = torch.from_numpy(rng.standard_normal((120, 8)).astype(np.float32))
    pairs = np.stack([rng.choice(60, s, replace=False), 60 + rng.choice(60, s, replace=False)], 1)
    return emb, torch.from_numpy(pairs)


OT_SIZES = (37, 9, 2)  # 2 pairs on 4 shards leave rank 1 of 2 without a real row


def ring_mode(n_shards: int, seed: int = 3) -> dict:
    """Ring mining (both metrics, a pool smaller than k included, CSLS) and
    ring eval (raw and CSLS) on random tables; the ring OT's potentials and
    loss with its gradient for each of ``OT_SIZES`` pairs."""
    from tpugraph_torch.dist.mesh import make_mesh
    from tpugraph_torch.dist.ring import (ring_hits_at_k, ring_knn, ring_sinkhorn_align_loss,
                                          ring_sinkhorn_potentials)

    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((37, 8)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((101, 8)).astype(np.float32))
    ex = torch.from_numpy(rng.integers(0, 101, 37))
    emb = torch.from_numpy(rng.standard_normal((300, 8)).astype(np.float32))
    pairs = np.stack([rng.choice(150, 83, replace=False),
                      150 + rng.choice(150, 83, replace=False)], axis=1)
    with make_mesh(n_shards, torch.device("cpu")) as mesh:
        out = {"cityblock": ring_knn(q, c, ex, 5, mesh),
               "sqeuclidean": ring_knn(q, c, ex, 5, mesh, metric="sqeuclidean"),
               "tiny_pool": ring_knn(q, c[:3], ex % 3, 5, mesh),
               "csls": ring_knn(q, c, ex, 5, mesh, csls_k=7),
               "hits": ring_hits_at_k(emb, pairs, mesh),
               "hits_csls": ring_hits_at_k(emb, pairs, mesh, csls_k=10)}
        for s in OT_SIZES:
            table, ot_pairs = ot_pairs_of(s, seed)
            x = table.clone().requires_grad_()
            loss = ring_sinkhorn_align_loss(x, ot_pairs, mesh, tau=0.1, n_iters=12)
            loss.backward()
            pots = ring_sinkhorn_potentials(table[ot_pairs[:, 0]], table[ot_pairs[:, 1]], mesh,
                                            tau=0.1, n_iters=25)
            out[f"ot_{s}"] = (loss.detach(), x.grad, *pots)
        return out


def fit_mode(cfg, task_kw: dict) -> dict:
    from tpugraph_torch.data import synthetic_align_task
    from tpugraph_torch.dist.trainer import fit_distributed

    res = fit_distributed(cfg, task=synthetic_align_task(**task_kw), device="cpu")
    return {"losses": res.losses, "history": res.history, "metrics": res.metrics,
            "params": res.params}


def surface_batch(cfg, task, seed: int = 5, device: str | torch.device = "cpu") -> dict:
    """An injected interval batch of ``cfg``'s surface, the same for every
    rank: the seed pairs and ``boot_cap`` proposals of distinct eligible
    entities (two thirds of weight 1, the rest weight-0 placeholders),
    uniform negatives over both, and ``train/mtl.py::draw_interval``'s
    draws."""
    from tpugraph_torch.train.loop import IntervalBatch
    from tpugraph_torch.train.mtl import draw_interval

    make = IntervalBatch(cfg, task, torch.device(device))
    gen = torch.Generator().manual_seed(seed)
    left = make.mask1.nonzero()[:, 0].cpu()
    right = make.mask2.nonzero()[:, 0].cpu() + task.kg1.n_ent
    cap = cfg.boot_cap
    live = 2 * min(cap, len(left), len(right)) // 3
    boot = make.placeholder[0].cpu().clone()
    boot[:live, 0] = left[torch.randperm(len(left), generator=gen)[:live]]
    boot[:live, 1] = right[torch.randperm(len(right), generator=gen)[:live]]
    w = (torch.arange(cap) < live).float()
    batch = make((boot.to(make.pairs.device), w.to(make.pairs.device)))
    make.uniform(batch, 0)
    attr = torch.as_tensor(task.merged_attr_triples, dtype=torch.int64, device=make.pairs.device)
    batch.update(draw_interval(cfg, 0, make.pairs, task.n_ent, len(task.merged_triples), attr))
    return batch


def surface_mode(n_shards: int, cfg, task_kw: dict) -> dict:
    """One step of ``cfg`` on ``surface_batch`` (its loss, terms and the
    rank's gradients: the table's own rows, the rest whole) and a run of
    ``cfg`` (``fit_mode``)."""
    from tpugraph_torch.data import synthetic_align_task
    from tpugraph_torch.dist.mesh import make_mesh
    from tpugraph_torch.dist.trainer import dist_parts

    task = synthetic_align_task(**task_kw)
    with make_mesh(n_shards, torch.device("cpu")) as mesh:
        parts = dist_parts(cfg.replace(n_shards=n_shards), task, mesh)
        loss = parts.grads(surface_batch(cfg, task))
        step = {"loss": loss, "aux": parts.aux,
                "grads": {k: p.grad for k, p in parts.model.named_parameters()}}
    return {"step": step, "fit": fit_mode(cfg.replace(n_shards=n_shards), task_kw)}


def check_mode(n_shards: int, cfg, task_kw: dict, surface_cfg=None) -> dict:
    """The halo SpMM, the ring stages, ``fit_distributed`` and, given
    ``surface_cfg``, ``surface_mode`` in one spawn."""
    out = {"halo": halo_mode(n_shards), "ring": ring_mode(n_shards),
           "fit": fit_mode(cfg, task_kw)}
    if surface_cfg is not None:
        out["surface"] = surface_mode(n_shards, surface_cfg, task_kw)
    return out


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
