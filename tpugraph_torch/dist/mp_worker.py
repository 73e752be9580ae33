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
and a run (``surface_mode``); the approximate ring stages; one step with
the encoder's options (``step_mode``); and a checkpointed run that a
SIGTERM reaching one rank stops (``preempt_mode``, ``sigterm_at_call``);
a fused run (``steps_per_call = neg_every``); the run of ``fit_mode``
traced with ``profile_dir`` (each rank its own directory).

Mode ``mesh`` runs on a grid of slices and feature blocks (``dist/mesh.py``;
each config's ``feature_shards`` and ``slice_shards`` with the world's
size): steps from given whole parameters and batches, or from the
config's own (``whole_step``: the encoder's output, the loss, its terms and
every gradient whole on every rank), and a checkpointed run that SIGTERM
stops (``preempt_mode``).  Mode ``grouped`` runs the grouped halo exchange
(``halo_grouped``): the halo SpMM on a graph of two components and runs of
the given configs, counting the ``all_to_all_single`` calls and their
groups' sizes, or refusing every one.

The JAX worker's three rehearsal modes, on the port's copies of its
configurations (``fit_rehearsal_config``, ``fit_prod_rehearsal_config``,
``fit_prod2_configs``, the task ``REHEARSAL_TASK``; the JAX ones run 2
processes of 4 devices, a port rank is a process, so W = 4 ranks hold its
8 devices' blocks): ``fit_checkpoint`` (the JAX ``fit``: 4 epochs with
checkpoints, a relaunch to 6 epochs that resumes from the same directory,
then the grouped exchange across the ranks), ``fitprod`` (ring CSLS
mining, proposals, the ring OT on a subsample, CSLS eval, tensor
parallelism) and ``fitprod2`` (leg A: the attribute channel with dropout
and the attribute head; leg B: slices, the slice group the only one
across ranks).  Each returns ``fit_mode``'s results of its runs.
"""

from __future__ import annotations

import multiprocessing
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

# the JAX worker's rehearsal task (tpugraph/dist/mp_worker.py::fit_rehearsal_task)
REHEARSAL_TASK = dict(seed=23, n_ent=128, n_rel=6, n_triples=500)


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
        for metric in ("cityblock", "sqeuclidean"):  # the approximate stages
            out[f"approx_{metric}"] = ring_knn(q, c, ex, 5, mesh, metric=metric, approx=True)
            out[f"approx_csls_{metric}"] = ring_knn(q, c, ex, 5, mesh, metric=metric, csls_k=7,
                                                    approx=True)
        out["hits_approx"] = ring_hits_at_k(emb, pairs, mesh, approx_k=8)
        out["hits_approx_csls"] = ring_hits_at_k(emb, pairs, mesh, csls_k=10, approx_k=8)
        for s in OT_SIZES:
            table, ot_pairs = ot_pairs_of(s, seed)
            x = table.clone().requires_grad_()
            loss = ring_sinkhorn_align_loss(x, ot_pairs, mesh, tau=0.1, n_iters=12)
            loss.backward()
            pots = ring_sinkhorn_potentials(table[ot_pairs[:, 0]], table[ot_pairs[:, 1]], mesh,
                                            tau=0.1, n_iters=25)
            out[f"ot_{s}"] = (loss.detach(), x.grad, *pots)
        return out


def fit_mode(cfg, task_kw: dict, profile_root: str | None = None) -> dict:
    """``fit_distributed`` of ``cfg``; with ``profile_root`` traced into
    ``profile_root/rank<r>`` (rank 0 alone writes a trace)."""
    from tpugraph_torch.data import synthetic_align_task
    from tpugraph_torch.dist.trainer import fit_distributed

    if profile_root is not None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        cfg = cfg.replace(profile_dir=os.path.join(profile_root, f"rank{rank}"))
    res = fit_distributed(cfg, task=synthetic_align_task(**task_kw), device="cpu")
    return {"losses": res.losses, "history": res.history, "metrics": res.metrics,
            "params": res.params, "timings": res.timings}


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


def step_mode(n_shards: int, cfg, task_kw: dict, mask_epoch: int | None = None) -> dict:
    """One step of ``cfg`` on ``surface_batch`` (with dropout, epoch
    ``mask_epoch``'s keep mask): its loss, terms and the rank's gradients
    (the table's own rows, the rest whole)."""
    from tpugraph_torch.data import synthetic_align_task
    from tpugraph_torch.dist.mesh import make_mesh
    from tpugraph_torch.dist.trainer import dist_parts

    task = synthetic_align_task(**task_kw)
    with make_mesh(n_shards, torch.device("cpu")) as mesh:
        parts = dist_parts(cfg.replace(n_shards=n_shards), task, mesh)
        mask = None if mask_epoch is None else parts.drop_mask(mask_epoch)
        loss = parts.grads(surface_batch(cfg, task), mask)
        return {"loss": loss, "aux": parts.aux,
                "grads": {k: p.grad for k, p in parts.model.named_parameters()}}


def surface_mode(n_shards: int, cfg, task_kw: dict) -> dict:
    """One step of ``cfg`` (``step_mode``) and a run of ``cfg``
    (``fit_mode``)."""
    return {"step": step_mode(n_shards, cfg, task_kw),
            "fit": fit_mode(cfg.replace(n_shards=n_shards), task_kw)}


def sigterm_at_call(n: int, rank: int | None = None):
    """Wrap ``DistParts.grads`` so that its n-th call (on ``rank`` only, on
    every rank when None) first sends this process SIGTERM: a preemption
    that reaches one rank in the middle of a run.  Returns the undo."""
    import signal

    from tpugraph_torch.dist import trainer

    orig, calls = trainer.DistParts.grads, [0]

    def grads(self, *args, **kw):
        calls[0] += 1
        if calls[0] == n and (rank is None or self.op.mesh.rank == rank):
            os.kill(os.getpid(), signal.SIGTERM)
        return orig(self, *args, **kw)

    trainer.DistParts.grads = grads
    return lambda: setattr(trainer.DistParts, "grads", orig)


def preempt_mode(cfg, task_kw: dict, ckpt_dir: str, stop_call: int, stop_rank: int) -> dict:
    """``cfg`` with checkpoints in ``ckpt_dir``, SIGTERM reaching rank
    ``stop_rank`` alone at its ``stop_call``-th step: the steps each rank
    ran, its losses and its saves."""
    from tpugraph_torch.data import synthetic_align_task
    from tpugraph_torch.dist.trainer import fit_distributed

    undo = sigterm_at_call(stop_call, stop_rank)
    try:
        res = fit_distributed(cfg.replace(checkpoint_dir=ckpt_dir), task=synthetic_align_task(
            **task_kw), device="cpu")
    finally:
        undo()
    return {"steps": res.timings["steps"], "losses": res.losses, "saves": res.timings["saves"]}


def check_mode(n_shards: int, cfg, task_kw: dict, surface_cfg=None, options_cfg=None,
               preempt: tuple | None = None, fused_cfg=None,
               profile_root: str | None = None) -> dict:
    """The halo SpMM, the ring stages (exact and approximate),
    ``fit_distributed`` (traced with ``profile_root``) and, given
    ``surface_cfg``, ``surface_mode``, given ``options_cfg``, its
    ``step_mode``, given ``preempt`` (``preempt_mode``'s arguments after
    ``task_kw``) a run that a SIGTERM stops, and given ``fused_cfg`` a fused
    run, in one spawn."""
    out = {"halo": halo_mode(n_shards), "ring": ring_mode(n_shards),
           "fit": fit_mode(cfg, task_kw, profile_root)}
    if fused_cfg is not None:
        out["fused"] = fit_mode(fused_cfg, task_kw)
    if surface_cfg is not None:
        out["surface"] = surface_mode(n_shards, surface_cfg, task_kw)
    if options_cfg is not None:  # the encoder's options, dropout with epoch 1's mask
        out["options"] = step_mode(n_shards, options_cfg, task_kw, mask_epoch=1)
    if preempt is not None:
        out["preempt"] = preempt_mode(preempt[0], task_kw, *preempt[1:])
    return out


def whole_step(cfg, task_kw: dict, params: dict | None = None,
               batch: dict | None = None, mask_epoch: int | None = None) -> dict:
    """One step of ``cfg`` on its grid (``cfg.feature_shards``,
    ``cfg.slice_shards``) from the whole parameter set ``params`` (None:
    the config's initialisation) on ``batch`` (None: ``surface_batch``),
    with dropout epoch ``mask_epoch``'s keep mask: the encoder's whole
    output, the loss, its terms and every gradient, gathered whole on every
    rank (``DistEncoder.whole``)."""
    from tpugraph_torch.data import synthetic_align_task
    from tpugraph_torch.dist.mesh import make_mesh
    from tpugraph_torch.dist.trainer import dist_parts

    task = synthetic_align_task(**task_kw)
    with make_mesh(cfg.n_shards, torch.device("cpu"), cfg.feature_shards,
                   cfg.slice_shards) as mesh:
        parts = dist_parts(cfg, task, mesh)
        if params is not None:
            parts.model.load_full(params)
        emb = parts.embed()
        mask = None if mask_epoch is None else parts.drop_mask(mask_epoch)
        loss = parts.grads(surface_batch(cfg, task) if batch is None else batch, mask)
        return {"emb": emb, "loss": loss, "aux": parts.aux, "grid": mesh.grid,
                "grads": {k: parts.model.whole(k, p.grad)
                          for k, p in parts.model.named_parameters()}}


def mesh_mode(steps: dict, preempt: tuple | None = None, fit: tuple | None = None) -> dict:
    """``whole_step(*args)`` for each of ``steps`` (name: args), then,
    given ``preempt``, ``preempt_mode(*preempt)``, and given ``fit``,
    ``fit_mode(*fit)``, in one spawn."""
    out = {name: whole_step(*args) for name, args in steps.items()}
    if preempt is not None:
        out["preempt"] = preempt_mode(*preempt)
    if fit is not None:
        out["fit"] = fit_mode(*fit)
    return out


def two_components(n1: int = 60, n2: int = 84, t: int = 300, seed: int = 0):
    """A graph of two components, rows [0, n1) and [n1, n1 + n2) (the
    merged KG pair's shape), as sym-normalised COO with n = n1 + n2."""
    from tpugraph_torch.sparse.build import coo_from_triples, coo_normalize

    rng = np.random.default_rng(seed)
    tris = []
    for base, nn in ((0, n1), (n1, n2)):
        h, tt = base + rng.integers(0, nn, t), base + rng.integers(0, nn, t)
        keep = h != tt
        tris.append(np.stack([h[keep], rng.integers(0, 5, keep.sum()), tt[keep]], 1))
    n = n1 + n2
    src, dst, w = coo_from_triples(n, np.concatenate(tris), weighting="uniform")
    return src, dst, coo_normalize(src, dst, w, n, "sym")


def grouped_halo_mode(n_shards: int, exchange: bool | None = None, d: int = 8, seed: int = 1,
                      n1: int = 60, n2: int = 84) -> dict:
    """``halo_mode`` under the grouped layout: ``two_components`` with KG2
    moved to row r0 (``dist/trainer.py::RowLayout``), partitioned into two
    groups; the rank's rows of A·x and of the gradient of Σ(A·x)², both
    impls, by the route ``exchange`` picks (``shard_operator``'s), and
    whether the boundary read x's rows (``direct``)."""
    from tpugraph_torch.dist.halo import halo_spmm, halo_spmm_ell
    from tpugraph_torch.dist.mesh import make_mesh, shard_operator
    from tpugraph_torch.sparse.partition import partition_edges

    src, dst, w = two_components(n1, n2)
    half = n_shards // 2
    r0 = half * -(-max(n1, n2) // half)
    src, dst = (np.where(a < n1, a, a - n1 + r0) for a in (src, dst))
    hg = partition_edges(src, dst, w, 2 * r0, n_shards, n_groups=2)
    x_all = np.zeros((hg.n_loc * n_shards, d), np.float32)
    x = np.random.default_rng(seed).standard_normal((n1 + n2, d)).astype(np.float32)
    x_all[:n1], x_all[r0:r0 + n2] = x[:n1], x[n1:]
    out = {"r0": r0}
    with make_mesh(n_shards, torch.device("cpu"), halo_grouped=True) as mesh:
        rows = slice(mesh.shards.start * hg.n_loc, mesh.shards.stop * hg.n_loc)
        for impl, fn in (("ell", halo_spmm_ell), ("sorted", halo_spmm)):
            op = shard_operator(hg, mesh, impl, exchange)
            xt = torch.from_numpy(x_all[rows].copy()).requires_grad_()
            y = fn(xt, op)
            (y ** 2).sum().backward()
            out[impl] = (y.detach(), xt.grad)
            out["direct"] = op.direct
    return out


def grouped_mode(n_shards: int, cfgs: dict, task_kw: dict, refuse_exchange: bool) -> dict:
    """``grouped_halo_mode`` and ``fit_mode`` of each of ``cfgs`` (name:
    config), with every ``all_to_all_single`` refused (``refuse_exchange``:
    it raises) or counted: ``calls``, the size of each call's group."""
    orig, calls = dist.all_to_all_single, []

    def all_to_all_single(out, inp, *args, group=None, **kw):
        if refuse_exchange:
            raise AssertionError("an all_to_all_single where each rank holds its KG half")
        calls.append(dist.get_world_size(group))
        return orig(out, inp, *args, group=group, **kw)

    dist.all_to_all_single = all_to_all_single
    try:
        out = {"halo": grouped_halo_mode(n_shards)}
        out.update({name: fit_mode(cfg, task_kw) for name, cfg in cfgs.items()})
    finally:
        dist.all_to_all_single = orig
    return {**out, "calls": calls}


def fit_rehearsal_config(n_devices: int, ckpt_dir: str | None = None, epochs: int = 4,
                         grouped: bool = False):
    """The JAX worker's ``fit_rehearsal_config``: the pinned tiny config of
    the checkpoint rehearsal."""
    from tpugraph_torch.configs.configs import get_config

    return get_config(
        "base", n_shards=n_devices, dim=16, epochs=epochs, eval_every=2, k_neg=4, neg_every=2,
        neg_mode="uniform", syn_n_ent=128, syn_n_triples=500, checkpoint_dir=ckpt_dir or "",
        checkpoint_every=2, halo_grouped=grouped)


def fit_prod_rehearsal_config(n_devices: int):
    """The JAX worker's ``fit_prod_rehearsal_config``: hard CSLS ring
    mining, proposals, the ring OT on a seed subsample, CSLS eval, tensor
    parallelism."""
    from tpugraph_torch.configs.configs import get_config

    return get_config(
        "base", n_shards=n_devices // 2, feature_shards=2, dim=16, epochs=4, eval_every=2,
        k_neg=4, neg_every=2, neg_mode="hard", neg_csls_k=4, boot_cap=8, boot_start=2,
        boot_weight=0.5, use_sinkhorn=True, sinkhorn_iters=4, sinkhorn_pairs=16, eval_csls_k=5,
        syn_n_ent=128, syn_n_triples=500)


def fit_prod2_configs(n_devices: int):
    """The JAX worker's ``fit_prod2_configs``: leg A, the attribute channel,
    the attribute head and dropout on (graph, feature) ranks; leg B, the
    same on slices × graph × feature."""
    from tpugraph_torch.configs.configs import get_config

    common = dict(dim=16, epochs=4, eval_every=2, k_neg=4, neg_every=2, neg_mode="uniform",
                  syn_n_ent=128, dropout=0.3, use_attr_channel=True, attr_channel_weight=0.5,
                  attr_beta=0.8, use_attr_head=True)
    return (get_config("base", n_shards=n_devices // 2, feature_shards=2, **common),
            get_config("base", slice_shards=2, n_shards=n_devices // 4, feature_shards=2,
                       **common))


def fit_checkpoint_mode(ckpt_dir: str, n_devices: int = 8) -> dict:
    """The JAX worker's ``fit`` rehearsal: ``fit_rehearsal_config`` for 4
    epochs with checkpoints in ``ckpt_dir`` (saves at 2 and 3), a relaunch
    to 6 epochs that resumes there, and the grouped config's 4 epochs."""
    return {"fit4": fit_mode(fit_rehearsal_config(n_devices, ckpt_dir), REHEARSAL_TASK),
            "fit6": fit_mode(fit_rehearsal_config(n_devices, ckpt_dir, epochs=6),
                             REHEARSAL_TASK),
            "grouped": fit_mode(fit_rehearsal_config(n_devices, grouped=True), REHEARSAL_TASK)}


def fitprod_mode(n_devices: int = 8) -> dict:
    """The JAX worker's ``fitprod`` rehearsal: ``fit_prod_rehearsal_config``."""
    return {"prod": fit_mode(fit_prod_rehearsal_config(n_devices), REHEARSAL_TASK)}


def fitprod2_mode(n_devices: int = 8) -> dict:
    """The JAX worker's ``fitprod2`` rehearsal: both legs of
    ``fit_prod2_configs``."""
    leg_a, leg_b = fit_prod2_configs(n_devices)
    return {"leg_a": fit_mode(leg_a, REHEARSAL_TASK), "leg_b": fit_mode(leg_b, REHEARSAL_TASK)}


MODES = {"check": check_mode, "mesh": mesh_mode, "grouped": grouped_mode,
         "fit_checkpoint": fit_checkpoint_mode, "fitprod": fitprod_mode,
         "fitprod2": fitprod2_mode}


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
