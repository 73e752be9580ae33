"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Usage (from the repository root, on a machine with a CUDA card and nvcc):

    python3 chip_smoke.py [--parent-l1 DIR] [--parent-gcn DIR] [--parent-margin DIR]

``--parent-l1 DIR``: DIR holds another commit's ``l1_search.cu`` and
``topk_queue.cuh`` (PR 19's entry points); ``phase_l1_search`` builds it
there and holds the port's kernel to it at every shape, bit for bit and
timed in turns.  ``--parent-gcn DIR``: DIR holds another commit's
``gcn_fused.cu`` whose C entry takes no cut-row table (the two-panel
kernel at (256, 256)); ``phase_kernel`` holds the port's kernel to it at zh-en
scale — the narrow widths bit for bit, (256, 256) fp32 and bf16 timed in
turns, with its device-time split — and ``phase_single_sharded`` times the
two in turns at (256, 256) on the DWY100K operator.  ``--parent-margin
DIR``: DIR holds the previous design's ``margin_l1.cu`` (commit 461a30d:
its backward reads the table's rows again over an index built in every
call); ``phase_step_losses``
holds the port's margin kernel to it bit for bit at every margin shape and
times the two in turns, alone and in the steps by head.  Without them
those comparisons are not run.

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
             time split into the encoder's forward, the margin's forward and
             backward, OT forward, OT backward, the encoder's backward and
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
11. approx  — the select-and-rerank kernel against its plain version at
             the shapes its callers run at zh-en scale (mining with its
             exclusions, sqeuclidean CSLS mining, bf16 proposals with the
             seed mask in both metrics, hubness, CSLS eval and serving;
             d = 256, and 512), timed beside the route it replaces
             (selection tile, ``torch.topk``, gather kernel), and the
             gather-only entry against its plain version; recipe v6 cut as
             in phase 6 with approximate proposals,
             approximate mining and approximate history evals every 2
             epochs, its stage times beside phase 6's exact run; then on
             its final table each approximate stage held against the same
             stage with every kernel swapped for its plain version and
             against the exact stage (mining cityblock and sqeuclidean +
             CSLS, proposals raw and CSLS, Hits@k raw and CSLS, the top-10
             raw and CSLS), exact sqeuclidean mining against a float64
             search, each approximate stage's device time by kernel and
             its peak device memory (below one (4,096, C) selection tile),
             and the serve CLI with ``--approx-k 128 --csls-k 10``.
             Between the two, ``l1_search``: the exact L1 search's top-k
             and rank-count entries against their plain versions at their
             callers' shapes (``L1_SHAPES``: zh-en mining at k 100 with
             exclusions, proposals at k 1 with the seed mask, CSLS hubness
             at k 10 and d 256 and 512, serving's CSLS top-10, the rank
             count raw and CSLS, one ring block of ``dwy100k_dist`` v7r's
             mining and CSLS eval, and the tile route above the queue at
             k 300), timed beside the plain version, ``torch.cdist(p=1)``
             with ``torch.topk`` or a compare-and-sum, and the bound, with
             each launch's plan (strip, splits, units, waves, fill) and the
             SM clock and power sampled while it runs.  The
             exact cityblock stages of every run (proposals, mining, CSLS
             hubness, evals, serving, the ring's) launch it, and each
             run's launches are held to ``_l1_launches``.

12. fused   — the fused interval (``steps_per_call = neg_every``): one
             interval of v6 with ``--fast``'s settings (``neg_every`` 2,
             sqeuclidean approximate mining), ``highway`` with dropout 0.3
             (``neg_every`` 5), ``base``, ``sinkhorn`` and ``mtl`` with the
             channel, from the trainers' own model, loss and epoch-0
             batch (``driver.step_parts``, ``loop.first_batch``), as
             replays of the captured step against the same ``train_step``s
             eager (each loss rel 1e-6, the parameters relative L2 1e-6;
             the distance to the unfused path's Adam read beside), the
             replayed kernels counted in a profiler trace (exactly the
             interval's steps times the step's launches) and the device's
             busy share over one replayed interval beside one unfused
             interval; v6 ``--fast`` cut as in phase 6, ``base`` and
             ``highway`` + dropout (20 epochs) through ``driver.run`` fused
             and unfused (losses falling, v6's final loss rel 1e-4 and
             Hits@1 within 0.01, the steady step wall of each), then the
             fused run again under the profiler, whose trace gives its
             launches on the device; a fused run stopped by SIGTERM and
             resumed at its interval boundary, and a mid-interval
             checkpoint refused.
13. profile — a 6-epoch ``base`` run with ``profile_dir``: the trace of
             epochs 2-5 it writes and its top device operations; a fused
             ``sinkhorn`` run (``fit_mtl``, captured) with ``profile_dir``:
             the trace of the intervals holding epochs 2-5.
14. readers — the zh-en task written as a DBP15K and as an OpenEA
             directory, read back by the port's readers and held to the
             task (each load timed), and the trainer CLI on the DBP15K
             directory for 2 epochs.
15. bf16    — the ELL SpMM's bf16 instance on Aᵀ at d = 256 and 128 (in
             phase 3's kernel lines), then bf16 training: recipe v6 at dim
             256 cut as phase 6 is, and config base at dim 128, 20 epochs:
             launches, one step against the plain path at the bf16
             tolerance (``STEP_TOL``), the forward + backward against the
             same parameters in fp32.
16. sorted  — the sorted-segment SpMM kernel on A and Aᵀ of the zh-en
             adjacency and on the attribute incidence and its transpose
             (``fmt="sorted"``), fp32 and bf16 at d = 128 and 256, against
             its plain version and bit-identical over two launches; timed
             (A and Aᵀ at d = 128, the incidence at both widths) beside its
             bound and ``torch.sparse.mm``, with the device time of the
             work items of the rows of degree ≥ 256 apart from the rest;
             then config base with ``spmm_impl`` ell fp32, sorted fp32 and
             sorted bf16 for 20 epochs (sorted's final loss within rel 1e-3
             of ell's), one step of each sorted run against the plain path.
             Phase 12 replays a captured interval of sorted ``base`` and of
             bf16 v6.
17. native  — the native adjacency builder against the numpy one at
             zh-en scale (timed, held equal).
18. debug_nans — a poisoned run (learning rate 1e30) with ``debug_nans``
             raises FloatingPointError unfused (naming the epoch) and fused
             (naming the captured interval).
19. dist    — config ``dwy100k_dist`` at full width (100,000 entities per
             KG, 500,000 triples, 8 shards, dim 128, k_neg 25) through
             ``driver.run`` on an NCCL group of one rank holding the 8
             shards, cut to 10 of 400 epochs (one uniform interval, one
             mined by ``ring_knn``, the exact final eval): the partition,
             each stage's time, the launches (``spmm_ell`` on the rank's
             stacked local and boundary operators, both ways; at R = 1 the
             boundary reads the table's own rows), the loss falling in
             each interval; one step with injected negatives against the
             single-device port's step on the same parameters, in ell and
             in sorted, timed beside it (the single-device step through
             its kernels is held against its plain path too); both SpMM
             kernels on the rank's
             local, boundary and boundary-transpose operators (output
             memory prefilled with NaN) against their plain versions, timed
             beside ``torch.sparse.mm`` and the bound.

20. dist_v7r — recipe v7r on config ``dwy100k_dist`` at full width (dim
             256, k_neg 100, the OT head on 4,096 seed pairs, the attribute
             head, bootstrapping, CSLS eval) through ``driver.run`` on the
             same one-rank group, cut to 4 of 900 epochs, proposals from
             epoch 2 (not 200), no periodic eval: the launches
             (``sinkhorn_fused`` 41 per step through the ring OT,
             ``spmm_ell`` 8 per step and 4 per forward), each stage's time
             (one exact proposal, one mining, the exact CSLS final eval), the
             peak device memory, the loss falling in each interval; one step
             on an injected batch (proposals, negatives, the OT subsample,
             the attribute batch) against the single-device step's plain
             path on the same parameters; the ring OT alone at 4,096 × 256
             against its plain version, timed beside the single-device
             loss; and the potential update at the ring caller's shape.

20a. step_losses — the training step's two loss kernels against their
             plain versions: ``margin_l1`` (the L1 margin loss, forward and
             its fixed-order backward) at recipe v6's zh-en shape, config
             sinkhorn's, ``dwy100k_dist``'s d-128 one and v7r's on it
             (``MARGIN_SHAPES``): the loss and the table's gradient on the
             rows as drawn at PERF.md §2's step limit with the hinge flips
             counted, and with the hinges 1e-4 clear of their threshold at
             rel 1e-5 / relative L2 1e-5; ``sinkhorn_reverse`` (the reverse
             of one potential update) at 4,500² from d 256 and 128 rows and
             at the ring's 4,096² block, rows and columns mode: C̄ and b̄ at
             relative L2 1e-5.  Each: outputs on NaN-prefilled memory, two
             calls bit for bit, a captured replay equal to eager, CUDA
             events warm and with the L2 flushed beside the plain version
             and the bound.  The margin's backward index is built once
             beforehand, as the batch carries it, and the margin also: a
             captured call whose negatives and index are reloaded equal to
             the second batch's eager call; its gather-only entry (the
             forward's floor) against its plain version and timed; its sign
             planes' MB.  With ``--parent-margin DIR`` (the previous design's
             ``margin_l1.cu``): the loss and the gradient bit for bit PR
             23's kernel's at every shape, on both sets of rows, and the
             two timed in turns (forward, forward + backward warm and
             flushed, the index).  Then config sinkhorn's, recipe v6's and
             v7r's steps (phases 5, 6 and 8) and the distributed v7r step
             (phase 20) by events and split by head, on the kernels and on
             the parent's route (the two kernels' plain versions), with
             ``--parent-margin`` also on the previous margin kernel, in turns.
             Every checked run's margin index builds equal its batches (one
             a resample interval, none inside a step).

20b. single_sharded — the single-device trainers on ``dwy100k_dist``
             as the JAX ``fit`` and ``fit_mtl`` train it (one card, the whole
             200,000-row graph, the shard fields unread), called directly on
             the tasks of phases 19 and 20: ``fit`` cut as phase 19 and
             ``fit_mtl`` under v7r cut as phase 20, each with its launches
             held to the single-device model (``gcn_fused`` for every
             forward), the loss falling in each interval, the final loss
             within rel 1e-3 and Hits@1 within 0.01 of that phase's
             distributed run, peak memory, step median and stage times beside
             it; one step of ``fit``'s trained model held against its plain
             path; ``gcn_fused`` on each leg's operator at (128, 128) and
             (256, 256) fp32, and (256, 256) bf16, against its plain
             version, timed beside cuSPARSE + GEMM and the bound (with
             ``--parent-gcn``, (256, 256) in turns with that kernel).

21. dist_options — the distributed trainer's run options on
             ``dwy100k_dist`` at full width through ``driver.run`` /
             ``driver.evaluate`` on the same one-rank group.  A: recipe v7r
             as in phase 20 with the ``--fast`` search set (sqeuclidean
             mining, shortlisted), shortlisted proposals and a shortlisted
             CSLS history eval every 2 epochs: the select-and-rerank
             launches (one per direction and shard block of each ring
             stage) beside the other kernels' phase-20 counts, the stage
             times beside phase 20's exact ones, and on the last table
             each stage alone, mining against exact ``ring_knn`` (recall ≥
             0.8), the eval against the exact final eval (within 0.02),
             the kernel at the ring's block shapes against its plain
             version, timed.  B: ``DIST_CUTS`` with checkpoints, the run
             stopped by SIGTERM mid-interval and resumed (every loss bit for
             bit), eval-only from the directory (within 1e-4), save and
             load times, the checkpoint's size.  C: one step each with the
             attribute channel, dropout 0.3, ``l2_normalize`` and bf16
             against the single-device step's plain path on the same
             parameters, batch and mask, with ``spmm_ell``'s launches.  D:
             ``debug_nans`` at lr 1e30 raises naming epoch 1.

22. dist_mesh — tensor parallelism and slices (``feature_shards = 2``,
             ``slice_shards = 2``) on ``dwy100k_dist`` at full width on the
             same one-rank group, which holds every feature block and
             slice: one step at d 128, one v7r step at d 256 and one step
             at d 384 (column blocks of 192: the SpMMs' panels) equal to the
             F = L = 1 steps bit for bit with the same launches, no
             ``nccl`` event in the d-128 step's trace; then ``spmm_ell`` and
             ``spmm_sorted`` at a tensor-parallel rank's width (d/F = 64)
             on the rank's stacked operators against their plain versions.

23. dist_grouped — the grouped halo exchange (``halo_grouped``) on
             ``dwy100k_dist`` at full width on the same one-rank group: at
             the config's identity remap one d-128 step grouped equal to
             the ungrouped step bit for bit in ell and in sorted (output,
             loss, gradients, launches), the two steps' times by events; at
             99,998 entities a KG (KG2 moved by 2 rows) the two steps from
             the same parameters by entity within PERF.md §2's fp32 limits;
             phase 21 A's run grouped, equal to it; that run cut by SIGTERM
             and resumed grouped, equal to it; the resume without
             ``halo_grouped`` refused by the layout stamp; ``spmm_ell`` and
             ``spmm_sorted`` on the moved task's grouped rank operators
             against their plain versions, timed.

24. dist_fused — ``dwy100k_dist`` at full width on the same one-rank
             group.  The R = 1 step at d 128 fp32 (``DIST_CUTS``): its
             launches in ell and sorted, its time by events beside the
             15.8 ms of the step through the exchange (PERF.md §5) and the
             single-device step's, its device events (no
             ``nccl``; copies and index adds read), two calls bit for bit;
             the same step through the exchange route (the NCCL self-copy,
             the fixed-order backward) at PERF.md §2's step limits, two
             backward calls of the exchange bit for bit, the halo SpMM with
             and without ``force_serialize``.  One interval at d 128 and
             on v7r (``steps_per_call = neg_every = 2``) replayed against
             eager (PERF.md §2's replay limits), the replays' launches in a
             profiler trace, the capture's seconds, the steady step fused
             and unfused by events and the busy share of each;
             ``--config dwy100k_dist --fast`` through the CLI and the fused
             v7r run of phase 21 A's configuration, their steady steps
             beside phases 19's and 21 A's unfused runs; ``profile_dir``
             on a 6-epoch run (the trace of epochs 2-5 holds ``spmm_ell``).

25. widths — every width the JAX package takes: the ELL SpMM on the zh-en
             transpose and the sorted SpMM on the zh-en adjacency (their
             128-column panels), the L1 margin at recipe v6's shape (its
             masked instances at 50 and 300, float4 ones at 384 and 512,
             the column slabs above 512) and the Sinkhorn update at 4,500²
             (the strip streamed above 256, zero columns at 50, 514 and
             1,030), at d 50, 300, 384, 512, 514, 768 and 1,030 in fp32
             and the SpMMs at 300, 384 and 768 in bf16; above 512 also the
             L1 search's mining top-k and rank count and the select
             kernel's mining and CSLS eval (its strip streamed): against
             their plain versions (the SpMMs and the margin on
             NaN-prefilled memory), two launches bit for bit, timed beside
             the plain version, the library call and the bound; then
             ``driver.run`` at zh-en scale with recipe v6 at dim 384, 512
             and 768 and at 384 in bf16, config ``base`` at dim 64, at dim
             50 with hidden 300 and at 384 with ``spmm_impl="sorted"``,
             config ``mtl`` with the attribute channel at dim 384 (its
             search table 768 wide) (``WIDTH_RUNS``): launches held to a
             model that knows each layer's route (``gcn_fused`` at a fused
             width, else x·W and ``spmm_ell``), the loss falling in every
             resample interval, one step held to the plain path (the bf16
             limits for bf16), the run wall and the step median; and one
             ``dwy100k_dist`` step at dim 384 and at 768 (one rank holding
             the 8 shards) held to the single-device step's plain path.

A step is held against its plain path by running the same model code with
every kernel swapped for its plain version (``_plain_kernels``), which
autograd differentiates.

It then prints the kernel table, the ``nvidia-smi`` name/power line, and
as its last line ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero before that line.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import itertools
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

from tpugraph_torch.configs.configs import TrainConfig, get_config
from tpugraph_torch.configs.recipes import RECIPES
from tpugraph_torch.convert import save_params
from tpugraph_torch.data import load_dbp15k, load_openea, synthetic_align_task
from tpugraph_torch import native
from tpugraph_torch.dist import mp_worker
from tpugraph_torch.cli.main import main as cli_main
from tpugraph_torch.dist.halo import exchange, halo_spmm_ell
from tpugraph_torch.dist.mesh import make_mesh, shard_operator
from tpugraph_torch.dist.ring import ring_hits_at_k, ring_knn, ring_sinkhorn_align_loss
from tpugraph_torch.dist.trainer import RowLayout, dist_parts
from tpugraph_torch.kernels import (_build, gcn_fused, l1_search, margin_l1, shortlist_dist,
                                    sinkhorn_fused, spmm_ell)
from tpugraph_torch.kernels import spmm as spmm_mod
from tpugraph_torch.kernels.spmm import SEG_EDGES, segment_spmm, sorted_spmm, spmm_xla
from tpugraph_torch.kernels.gcn_fused import fused_gcn_layer, reference_layer
from tpugraph_torch.kernels.margin_l1 import forward_plain as margin_forward_plain
from tpugraph_torch.kernels.margin_l1 import margin_loss_plain
from tpugraph_torch.kernels.sinkhorn_fused import (PRECISION, stream_plan,
                                                   sinkhorn_potential_update,
                                                   sinkhorn_reverse, sinkhorn_reverse_plain,
                                                   sinkhorn_update_plain, sq_norms)
from tpugraph_torch.kernels.spmm_ell import (SEG_SLOTS, apply_with_diag, ell_spmm, fused_plan,
                                             segment_plan)
import tpugraph_torch.dist.ring as ring_mod
import tpugraph_torch.models.align as align_mod
import tpugraph_torch.models.attr_channel as attr_channel_mod
import tpugraph_torch.nn.graphconv as graphconv_mod
import tpugraph_torch.serve as serve_mod
import tpugraph_torch.train.bootstrap as bootstrap_mod
import tpugraph_torch.train.eval as eval_mod
import tpugraph_torch.train.losses as losses_mod
import tpugraph_torch.train.negatives as negatives_mod
import tpugraph_torch.train.ot as ot_mod
from tpugraph_torch.models.align import AlignMTL
from tpugraph_torch.models.attr_channel import build_attr_operator
from tpugraph_torch.models.encoder import AlignGCN, init_params
from tpugraph_torch.serve import save_embeddings, topk_alignments
from tpugraph_torch.nn.graphconv import operator_format
from tpugraph_torch.sparse.build import build_adjacency, coo_from_triples, coo_normalize
from tpugraph_torch.train.checkpoint import Checkpointer
from tpugraph_torch.train.driver import evaluate, run, step_parts, uses_mtl
from tpugraph_torch.train.bootstrap import propose_mutual_nn_pairs
from tpugraph_torch.train.eval import _both_direction_ranks
from tpugraph_torch.train.fused import CapturedStep, train_step
from tpugraph_torch.train.loop import (IntervalBatch, build_model, embed, first_batch, fit,
                                       load_task, step_generator, step_seed)
from tpugraph_torch.train.losses import MARGIN_INDEX, margin_align_loss, pairwise_l1
from tpugraph_torch.train.metrics import epoch_edge_ops
from tpugraph_torch.train.mtl import draw_interval, fit_mtl
from tpugraph_torch.train.negatives import (blockwise_knn_l1, sample_hard_negatives,
                                            sample_uniform_negatives)
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


def device_ms(fn, iters: int = 20, tries: int = 3, floor_ms: float | None = None,
              log: list | None = None) -> float | None:
    """Device time of one call from a torch.profiler trace: the time of its
    kernels and memsets on the card, summed, so the host's launch cost is
    left out (``time_ms`` includes it when it exceeds the device's work).
    A trace can come back without device events: the window is then taken
    again, and after ``tries`` empty ones the time is None.  With
    ``floor_ms``, the least time the card could take for the call's work
    (its bound), a reading below it is a trace that lost kernel records:
    it is taken again too, and after ``tries`` traces without a reading at
    or above the floor the call raises.  ``log`` gains each trace's reading
    and its count of device events."""
    fn()
    torch.cuda.synchronize()
    low = []
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        ms = sum(e.time_range.elapsed_us() for e in events) / iters / 1e3
        if log is not None:
            log.append({"device_ms": ms, "device_events": len(events), "calls": iters})
        if ms > 0 and (floor_ms is None or ms >= floor_ms):
            return ms
        if ms > 0:
            low.append(ms)
    if low:
        raise AssertionError(f"device time {low} ms under the bound {floor_ms} ms in every "
                             f"trace with device events ({tries} traces)")
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


KERNELS = ("gcn_fused", "spmm_ell", "sinkhorn_fused", "shortlist_dist", "spmm_sorted",
           "l1_search", "margin_l1", "sinkhorn_reverse")


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
    ``gcn_fused.PRODUCTS`` says: three TF32 products on the tensor cores
    (two for a bf16 W below (256, 256), which is exact in TF32), or at bf16
    (256, 256) three bf16 products on the bf16 tensor cores.  Third, the
    bound with the whole product once at the peak rate of x's type (fp32
    SIMT, or bf16 tensor cores)."""
    m = op.fwd
    n, d_in, d_out = m.n_rows, x.shape[1], wmat.shape[1]
    es = x.element_size()
    ell_bytes = sum(b.rows.numel() * 4 + b.idx.numel() * 4 + b.w.numel() * 4 for b in m.buckets)
    nbytes = (n * d_in * es + d_in * d_out * es + bias.numel() * 4 + op.diag.numel() * 4
              + ell_bytes + n * d_out * es)
    edge_ops, gemm_ops = 2 * (m.nnz + op.n_diag) * d_in, 2 * n * d_in * d_out
    n_products, unit = gcn_fused.PRODUCTS[d_in, d_out, x.dtype]
    peak = PEAK_TF32_OPS if unit == "tf32" else PEAK_OPS[torch.bfloat16]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (edge_ops / PEAK_OPS[torch.float32] + n_products * gemm_ops / peak) * 1e3
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


def _gcn_split(m, diag, x, wmat, bias, launch=None) -> dict:
    """The fused layer's device time on parts of its work: all of it, the
    rows of K ≥ 1,024 (their segments) and the rest, the short rows
    (1 ≤ K ≤ 7), and the K = 0 tiles (no ELL gather: the diagonal and the
    product alone).  Rows outside the part are left unwritten; only the
    time is read.  ``launch``: another kernel's launcher (``_parent_gcn``)
    in place of the port's."""
    launch = gcn_fused._launch if launch is None else launch
    plan = gcn_fused.layer_plan(m)
    tk, sk = plan.tiles.tiles[:, 2], plan.segs[:, 2]
    masks = {"all": None, "k_ge_1024": (tk >= 1024, sk >= 1024),
             "k_lt_1024": (tk < 1024, sk < 1024), "k_1_to_7": ((tk >= 1) & (tk <= 7), sk < 0),
             "k_0": (tk == 0, sk < 0)}
    out = {}
    for name, mask in masks.items():
        part = plan if mask is None else gcn_fused.sub_plan(
            plan, plan.tiles.tiles[mask[0]].contiguous(), plan.segs[mask[1]].contiguous())
        out[name] = {"tiles": int(part.tiles.tiles.shape[0]), "segments": int(part.segs.shape[0]),
                     "cut_rows": int(part.hub.shape[0]),
                     "device_ms": device_ms(
                         lambda part=part: launch(m, diag, x, wmat, bias, part))}
    out["k_ge_1024_share"] = ratio(out["k_ge_1024"]["device_ms"], out["all"]["device_ms"])
    return out


def phase_kernel(task, smi: str, dev: torch.device, parent=None) -> dict:
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

    rng = np.random.default_rng(0)
    results = {}
    for d, dtype in ((128, torch.float32), (128, torch.bfloat16), (256, torch.float32),
                     (256, torch.bfloat16)):
        results[d, dtype] = _gcn_case(op, a_csr, rng, d, dtype, smi, parent=parent)
    if parent is not None:
        results["narrow_vs_parent"] = _gcn_narrow_bitwise(op, parent, smi)
    # the recipe's width first; the others beside it
    return {**results[256, torch.float32],
            "bf16": results[256, torch.bfloat16],
            "at_d128": {**results[128, torch.float32], "bf16": results[128, torch.bfloat16]},
            **({"narrow_vs_parent": results["narrow_vs_parent"]} if parent is not None else {})}


def _gcn_case(op, a_csr, rng, d: int, dtype: torch.dtype, smi: str, split: bool = True,
              where: str = "zh_en", parent=None) -> dict:
    """``gcn_fused`` at (d, d) on ``op`` with random x, W and b: against its
    plain version (the rows in no ELL bucket too), two launches bit for
    bit; timed beside the plain version and cuSPARSE + GEMM (``a_csr``),
    the bound, and with ``split`` its device time over parts of its work.
    With ``parent`` (``_parent_gcn``) at d = 256, that kernel too: against
    the plain version, timed in turns with this one (and split)."""
    dev, plan = op.fwd.device, fused_plan(op.fwd)
    zero_rows = plan.rows[-plan.n_zero_rows:].long() if plan.n_zero_rows else None
    x = torch.from_numpy(rng.standard_normal((op.n_rows, d)).astype(np.float32)).to(dev)
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
    versus = None
    if parent is not None and d == 256:
        versus = _gcn_parent_case(op, x, wm, b, dtype, parent, split)
    n_products, unit = gcn_fused.PRODUCTS[d, d, dtype]
    emit({"phase": "kernel", "kernel": "gcn_fused", "operator": where, "rows": op.n_rows,
          "edges": op.nnz, "d_in": d, "d_out": d,
          "panels": gcn_fused.PANELS[d, d, dtype], "dtype": str(dtype).split(".")[1],
          "max_abs_err": err, "no_bucket_rows_max_abs_err": zero_err, "ms": ms,
          "device_ms": dev_ms, "ms_cold_l2": ms_cold, "plain_ms": plain_ms,
          "library_ms": lib_ms, "library_device_ms": lib_dev,
          "library_ms_cold_l2": lib_cold, "library_refused": lib_refused, "bound_ms": bound,
          "bound_by": bound_by, "share_of_bound": bound / ms,
          "share_of_bound_device": ratio(bound, dev_ms), "bound_x_type_ms": bound_x_type,
          "share_of_x_type_bound_device": ratio(bound_x_type, dev_ms),
          "bit_identical_runs": same, "parent": versus,
          "split": _gcn_split(op.fwd, op.diag, x, wm, b) if split else None, "card": smi})
    return dict(d_in=d, d_out=d, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=lib_ms, device_ms=dev_ms, ms_cold_l2=ms_cold,
                library_device_ms=lib_dev, bound_x_type_ms=bound_x_type,
                panels=gcn_fused.PANELS[d, d, dtype], precision=f"{n_products}x{unit}",
                **({} if versus is None else {"parent_ms": versus["parent_ms"],
                                              "ratio_to_parent": versus["ratio"]}))


def _parent_gcn(src: str):
    """The fused layer of another commit: ``gcn_fused.cu`` in ``src``, whose
    C entry takes no cut-row table, built by nvcc with the port's flags and
    headers, and a launcher taking ``gcn_fused._launch``'s arguments (its
    own scratch: at (256, 256) two panels' partials and counters)."""
    t0 = time.perf_counter()
    built = _build.build("gcn_fused_parent", os.path.join(src, "gcn_fused.cu"))
    fn = ctypes.CDLL(str(built.path)).gcn_fused_forward
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, P, P, P, I, P, I, I, P, P, P, P, I, I, I, P]
    fn.restype = ctypes.c_int
    scratch = {}

    def launch(m, diag, x, wmat, bias, plan):
        d_in, d_out = x.shape[1], wmat.shape[1]
        panels = 2 if (d_in, d_out) == (256, 256) else 1
        n_split = plan.split_p0.shape[0] - 1
        stream = torch._C._cuda_getCurrentRawStream(x.device.index)
        key = (plan.n_partials, n_split, d_in, d_out, stream)  # left at zero by every launch
        if key not in scratch:
            scratch[key] = torch.zeros(panels * (plan.n_partials * d_in + n_split) + panels + 1,
                                       dtype=torch.float32, device=x.device)
        partial = scratch[key].data_ptr()
        out = torch.empty((m.n_rows, d_out), dtype=x.dtype, device=x.device)
        t = plan.tiles
        err = fn(x.data_ptr(), wmat.data_ptr(), None if bias is None else bias.data_ptr(),
                 None if diag is None else diag.data_ptr(), t.rows.data_ptr(), t.idx.data_ptr(),
                 t.w.data_ptr(), t.tiles.data_ptr(), t.tiles.shape[0], plan.segs.data_ptr(),
                 plan.segs.shape[0], SEG_SLOTS, plan.split_p0.data_ptr(),
                 partial + 4 * panels * plan.n_partials * d_in, partial, out.data_ptr(), d_in,
                 d_out, 0 if x.dtype == torch.float32 else 1, stream)
        if err != 0:
            raise RuntimeError(f"the parent's gcn_fused failed with CUDA error {err}")
        return out

    emit({"phase": "parent_gcn_build", "src": src, "build_s": time.perf_counter() - t0,
          "ptxas": [ln.strip() for ln in built.log.splitlines()
                    if "registers" in ln or "spill" in ln]})
    return launch


def _gcn_parent_case(op, x, wm, b, dtype, parent, split: bool) -> dict:
    """The parent commit's layer on the same inputs: against the plain
    version at ``TOL``, two launches bit for bit, and both kernels timed in
    turns (parent, this, this, parent) by CUDA events; with ``split`` the
    parent's device-time split (``_gcn_split``)."""
    plan = gcn_fused.layer_plan(op.fwd)

    def old():
        return parent(op.fwd, op.diag, x, wm, b, plan)

    def new():
        return fused_gcn_layer(op.fwd, op.diag, x, wm, b)

    want = reference_layer(op.fwd, op.diag, x, wm, b)
    got = old()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    if not torch.equal(got, old()):
        raise AssertionError("the parent's gcn_fused: two launches differ")
    times = [time_ms(f, warmup=3, iters=20) for f in (old, new, new, old)]
    return {"parent_ms": (times[0] + times[3]) / 2, "ms": (times[1] + times[2]) / 2,
            "ratio": (times[1] + times[2]) / (times[0] + times[3]), "turns_ms": times,
            "parent_max_abs_err": float((got.float() - want.float()).abs().max()),
            "parent_split": (_gcn_split(op.fwd, op.diag, x, wm, b, launch=parent)
                             if split else None)}


def _gcn_narrow_bitwise(op, parent, smi: str) -> dict:
    """The narrow instances, (128, 128), (128, 256) and (256, 128) in fp32
    and bf16, against the parent commit's kernel on the same inputs: bit
    for bit, and each output's SHA-256 (the card tests pin them)."""
    rng = np.random.default_rng(12)
    plan = gcn_fused.layer_plan(op.fwd)
    out = {}
    for (d_in, d_out), dtype in itertools.product(((128, 128), (128, 256), (256, 128)),
                                                  (torch.float32, torch.bfloat16)):
        x = torch.from_numpy(rng.standard_normal((op.n_rows, d_in)).astype(np.float32))
        wm = torch.from_numpy((rng.standard_normal((d_in, d_out)) / np.sqrt(d_in))
                              .astype(np.float32))
        b = torch.from_numpy(rng.standard_normal(d_out).astype(np.float32)).to(op.fwd.device)
        x, wm = x.to(op.fwd.device, dtype), wm.to(op.fwd.device, dtype)
        got = fused_gcn_layer(op.fwd, op.diag, x, wm, b)
        want = parent(op.fwd, op.diag, x, wm, b, plan)
        name = f"({d_in}, {d_out}) {str(dtype).split('.')[1]}"
        out[name] = {"bitwise": bool(torch.equal(got, want)),
                     "sha256": hashlib.sha256(got.view(torch.uint8).cpu().numpy()).hexdigest()}
        if not out[name]["bitwise"]:
            raise AssertionError(f"gcn_fused {name}: differs from the parent's kernel")
    emit({"phase": "kernel_narrow_vs_parent", "kernel": "gcn_fused", "cases": out, "card": smi})
    return out


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


def phase_spmm(task, smi: str, dev: torch.device, d: int = 128, split: bool = True,
               dtype: torch.dtype = torch.float32) -> dict:
    """The ELL SpMM kernel where training runs it: u = Aᵀ·ḡ over the
    transpose operator, at width ``d``, in ``dtype`` (fp32, or bf16 under
    bf16 training); ``split`` adds the device time of parts of its work
    and a call's host time.  A bf16 result is held to the fp32 plain
    version of the same bf16 input within half a bf16 ulp (one rounding of
    fp32 sums), and to the bf16 plain version at the bf16 tolerance."""
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
    g = torch.from_numpy(rng.standard_normal((task.n_ent, d)).astype(np.float32)).to(dev, dtype)
    got = ell_spmm(m, op.diag, g)
    sync(dev)
    want = apply_with_diag(m, op.diag, g)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL[torch.float32])
    else:
        torch.testing.assert_close(got.float(), apply_with_diag(m, op.diag, g.float()),
                                   rtol=2 ** -8, atol=1e-3)
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    err = float((got.float() - want.float()).abs().max())
    if not torch.equal(got, ell_spmm(m, op.diag, g)):  # the segments' sums run in a fixed order
        raise AssertionError("spmm_ell: two launches on the same input differ")
    seg = segment_plan(m)
    lib_ms = lib_dev = lib_cold = lib_refused = None
    try:
        a_lib = at_csr.to(dtype)
        lib = torch.sparse.mm(a_lib, g)
    except RuntimeError as e:  # a refusal of bf16 by the library is the finding
        lib_refused = str(e).splitlines()[0][:200]
    if lib_refused is None:
        torch.testing.assert_close(lib.float(), want.float(), **TOL[dtype])
        lib_ms = time_ms(lambda: torch.sparse.mm(a_lib, g))
        lib_dev = device_ms(lambda: torch.sparse.mm(a_lib, g))
        lib_cold = time_cold_ms(lambda: torch.sparse.mm(a_lib, g))
    ms = time_ms(lambda: ell_spmm(m, op.diag, g))
    ms_cold = time_cold_ms(lambda: ell_spmm(m, op.diag, g))
    plain_ms = time_ms(lambda: apply_with_diag(m, op.diag, g), iters=5)
    dev_ms = device_ms(lambda: ell_spmm(m, op.diag, g))
    host = host_ms(lambda: ell_spmm(m, op.diag, g)) if split else None
    lib_host = host_ms(lambda: torch.sparse.mm(at_csr, g)) if split else None
    split = _spmm_split(m, op.diag, g) if split else None
    # each input byte once (g, diag, the buckets' rows/idx/w), the output
    # once; 2 operations per real edge (diagonal included) and column
    ell_bytes = sum(b.rows.numel() * 4 + b.idx.numel() * 4 + b.w.numel() * 4
                    for b in m.buckets)
    nbytes = 2 * m.n_rows * d * g.element_size() + op.diag.numel() * 4 + ell_bytes
    bound, bound_by = _bound(nbytes, 2 * (m.nnz + op.n_diag) * d)  # fp32 sums either way
    emit({"phase": "kernel", "kernel": "spmm_ell", "operator": "transpose",
          "dtype": str(dtype).split(".")[1], "d": d, "max_abs_err": err, "ms": ms,
          "device_ms": dev_ms, "ms_cold_l2": ms_cold, "plain_ms": plain_ms, "library_ms": lib_ms,
          "library_device_ms": lib_dev, "library_ms_cold_l2": lib_cold,
          "library_refused": lib_refused, "host_ms": host, "library_host_ms": lib_host,
          "bound_ms": bound, "bound_by": bound_by, "share_of_bound": bound / ms,
          "share_of_bound_device": ratio(bound, dev_ms), "bit_identical_runs": True,
          "seg_cap": SEG_SLOTS, "work_items": int(seg.items.shape[0]),
          "longest_item_slots": seg.max_item_slots, "cut_rows": int(seg.split_p0.shape[0] - 1),
          "split": split, "card": smi})
    return dict(d=d, dtype=str(dtype).split(".")[1], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=bound_by, library_ms=lib_ms, device_ms=dev_ms,
                ms_cold_l2=ms_cold, library_device_ms=lib_dev, library_refused=lib_refused,
                seg_cap=SEG_SLOTS, work_items=int(seg.items.shape[0]),
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
    traces = []  # each trace's reading and device events: a lost record shows as fewer
    dev_ms = device_ms(kernel, floor_ms=bound, log=traces)
    bound_fp32, _ = _bound(nbytes, 2 * s * s * d + s * s)
    grid, n_splits = stream_plan(s, s, torch.cuda.get_device_properties(dev).multi_processor_count)
    emit({"phase": "kernel", "kernel": "sinkhorn_fused", "q": s, "c": s, "d": d, "tau": tau,
          "precision": PRECISION, "grid": grid, "candidate_splits": n_splits,
          "max_abs_err": err, "max_abs_err_tau_0.05": err05, "ms": ms, "device_ms": dev_ms,
          "device_traces": traces, "ms_cold_l2": ms_cold, "plain_ms": plain_ms,
          "library_ms": addmm_ms + lse_ms,
          "library_device_ms": lib_dev, "library_addmm_ms": addmm_ms,
          "library_logsumexp_ms": lse_ms, "bound_ms": bound, "bound_by": bound_by,
          "share_of_bound": bound / ms, "bound_fp32_ms": bound_fp32,
          "share_of_fp32_bound": bound_fp32 / ms, "ms_2x_queries": ms_2x, "card": smi})
    return dict(q=s, c=s, d=d, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, library_ms=addmm_ms + lse_ms, device_ms=dev_ms,
                device_traces=traces, ms_cold_l2=ms_cold, library_device_ms=lib_dev,
                bound_fp32_ms=bound_fp32,
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
    """Each kernel's launches; ``shortlist_dist`` is the select-and-rerank
    kernel, ``shortlist_gather`` its gather-only entry (the unfused route);
    ``l1_topk``, ``l1_count`` and ``l1_tile`` the L1 search's three entries;
    ``margin_l1`` the margin's forward and backward (one each),
    ``sinkhorn_reverse`` the OT head's reverse updates."""
    return {"gcn_fused": gcn_fused.launches, "spmm_ell": spmm_ell.launches,
            "sinkhorn_fused": sinkhorn_fused.launches,
            "shortlist_dist": shortlist_dist.select_launches,
            "shortlist_gather": shortlist_dist.launches, "spmm_sorted": spmm_mod.launches,
            "l1_topk": l1_search.topk_launches, "l1_count": l1_search.count_launches,
            "l1_tile": l1_search.tile_launches, "margin_l1": margin_l1.launches,
            "sinkhorn_reverse": sinkhorn_fused.reverse_launches}


L1_NONE = {"l1_topk": 0, "l1_count": 0, "l1_tile": 0}  # a step's: it searches nothing
LOSS_NONE = {"margin_l1": 0, "sinkhorn_reverse": 0}  # a forward's: it trains nothing


def _reset_launch_counts() -> None:
    gcn_fused.launches = spmm_ell.launches = sinkhorn_fused.launches = 0
    shortlist_dist.launches = shortlist_dist.select_launches = spmm_mod.launches = 0
    l1_search.topk_launches = l1_search.count_launches = l1_search.tile_launches = 0
    margin_l1.launches = sinkhorn_fused.reverse_launches = 0
    margin_l1.index_builds = margin_l1.gather_launches = 0


def _loss_launches(cfg, steps: int) -> dict:
    """The loss kernels' launches in ``steps`` training steps: the margin's
    forward and backward, for the table and for the AE channel's; with the
    OT head 2·iters + 1 reverse updates (one per held block: one at R = 1)."""
    return {"margin_l1": 2 * (1 + bool(cfg.use_attr_channel)) * steps,
            "sinkhorn_reverse": (2 * cfg.sinkhorn_iters + 1) * steps if cfg.use_sinkhorn else 0}


def _nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def _l1_launches(cfg, t: dict, per_mining_block: int = 1) -> dict:
    """A run's L1 search launches (each over all of a stage's queries): per
    exact cityblock mining one top-k per direction (``per_mining_block``:
    per direction and shard block on the ring), one more per direction
    with CSLS (the hubness); approximate cityblock mining with CSLS is
    exact too; per exact cityblock proposal one top-k (k = 1) per
    direction, with CSLS as many again; per exact eval (the final always,
    the history ones without ``eval_approx_k``) one count per direction
    (and shard block), with CSLS one hubness top-k per direction.  The
    tile route (k above the queue) never runs: k_neg and csls_k are ≤ 256."""
    city = cfg.neg_metric == "cityblock"
    mine_exact = city and (not cfg.neg_approx or cfg.neg_csls_k > 0)
    per_mining = 2 * (per_mining_block + bool(cfg.neg_csls_k)) if mine_exact else 0
    per_proposal = 2 * (1 + bool(cfg.boot_csls_k)) if city and not cfg.boot_approx else 0
    exact_evals = min(t["evals"], 1) if cfg.eval_approx_k else t["evals"]
    if max(cfg.k_neg, cfg.eval_csls_k, cfg.neg_csls_k, cfg.boot_csls_k) > l1_search.QUEUE_MAX:
        raise NotImplementedError("a search above the queue: the tile route")
    return {"l1_topk": per_mining * t["minings"] + per_proposal * t["proposals"]
            + 2 * bool(cfg.eval_csls_k) * exact_evals,
            "l1_count": 2 * per_mining_block * exact_evals, "l1_tile": 0}


def _dist_l1_launches(t: dict, cfg) -> dict:
    """``_l1_launches`` of a distributed run at R = 1: the ring folds one
    search per (direction, shard block) of its mining and evals; its
    hubness one per direction (one held chunk); the proposals run on the
    gathered table."""
    return _l1_launches(cfg, t, per_mining_block=cfg.n_shards)


def _sorted_launches(cfg, counts: dict) -> dict:
    """The ELL model's launches moved to the sorted kernel for ``spmm_impl``
    sorted: each fused layer is one sorted SpMM forward, each ELL SpMM (a
    layer's backward, the incidence) one sorted SpMM."""
    if operator_format(cfg.spmm_impl) != "sorted":
        return {**counts, "spmm_sorted": 0}
    return {**counts, "gcn_fused": 0, "spmm_ell": 0,
            "spmm_sorted": counts["gcn_fused"] + counts["spmm_ell"]}


def _shortlist_launches(cfg, task, t: dict) -> int:
    """A run's select-and-rerank launches, one per call over all of a
    direction's queries: per approximate proposal one per direction, and
    with CSLS one more per direction (the hubness); per approximate mining
    one per direction for cityblock without CSLS and for sqeuclidean (one
    more per direction with CSLS), none for cityblock with CSLS (exact L1
    tiles); per approximate history eval one per direction, one more per
    direction with CSLS.  A shortlist above the kernel's queue would take
    the unfused route, which these runs must not: it raises."""
    k_eff = min(cfg.k_neg, task.n_ent - task.kg1.n_ent, task.kg1.n_ent)
    shortlists = [16 if cfg.boot_approx else 0, cfg.eval_approx_k,
                  max(2 * k_eff, k_eff + 8) if cfg.neg_approx else 0]
    if max(shortlists) > shortlist_dist.QUEUE_MAX:
        raise NotImplementedError(f"a shortlist above the queue: {shortlists}")
    per_proposal = 2 * (1 + bool(cfg.boot_csls_k)) if cfg.boot_cap and cfg.boot_approx else 0
    if not cfg.neg_approx:
        per_mining = 0
    elif cfg.neg_metric == "sqeuclidean":
        per_mining = 2 * (1 + bool(cfg.neg_csls_k))
    else:
        per_mining = 0 if cfg.neg_csls_k else 2
    per_eval = 2 * (1 + bool(cfg.eval_csls_k)) if cfg.eval_approx_k else 0
    return (per_proposal * t["proposals"] + per_mining * t["minings"]
            + per_eval * (t["evals"] - 1))  # the final eval is exact


def _layer_routes(cfg) -> tuple[int, int]:
    """(fused, unfused) GCN layers of one forward: the encoder's (dim,
    hidden) and (hidden, dim), and the attribute channel's two (dim, dim).
    A layer at a width with a fused instance (``gcn_fused.fused_width``) is
    one ``gcn_fused`` launch; any other runs x·W and one ``spmm_ell``."""
    hidden = cfg.hidden or cfg.dim
    widths = [(cfg.dim, hidden), (hidden, cfg.dim)]
    widths += [(cfg.dim, cfg.dim)] * (2 if cfg.use_attr_channel else 0)
    fused = sum(gcn_fused.fused_width(*w) for w in widths)
    return fused, len(widths) - fused


def _expected_launches(cfg, t: dict, task) -> dict:
    """A training run's launches from its timings' counts: per encoder
    forward (each step, each interval boundary's forward, each eval) one
    launch per GCN layer, ``gcn_fused`` for a layer at a fused width and
    ``spmm_ell`` for any other (``_layer_routes``); one SpMM per layer and
    step (the layers' backward); 2·iters + 1 potential updates per step
    with the OT head.  The attribute channel's two layers count as the
    encoder's; it adds two SpMMs per step (the incidence forward and
    backward) and one per boundary forward and eval (the incidence
    forward).  The shortlist kernel runs only on the approximate search
    paths (``_shortlist_launches``), the L1 search on the exact cityblock
    ones (``_l1_launches``)."""
    ae = cfg.use_attr_channel
    forwards = t["steps"] + t["forwards"] + t["evals"]
    fused, unfused = _layer_routes(cfg)
    return _sorted_launches(cfg, {
        "gcn_fused": fused * forwards,
        "spmm_ell": (fused + unfused + (2 if ae else 0)) * t["steps"] + unfused * forwards
        + (t["forwards"] + t["evals"] if ae else 0),
        "sinkhorn_fused": (2 * cfg.sinkhorn_iters + 1) * t["steps"] if cfg.use_sinkhorn else 0,
        "shortlist_dist": _shortlist_launches(cfg, task, t), "shortlist_gather": 0,
        **_l1_launches(cfg, t), **_loss_launches(cfg, t["steps"])})


def _mtl_step_launches(cfg) -> dict:
    """One AlignMTL training step's launches (``_expected_launches``'s per step)."""
    ae = cfg.use_attr_channel
    fused, unfused = _layer_routes(cfg)
    return _sorted_launches(cfg, {
        "gcn_fused": fused, "spmm_ell": fused + 2 * unfused + (2 if ae else 0),
        "sinkhorn_fused": 2 * cfg.sinkhorn_iters + 1 if cfg.use_sinkhorn else 0,
        "shortlist_dist": 0, "shortlist_gather": 0, **L1_NONE, **_loss_launches(cfg, 1)})


# (model, operator, batch, config) of the steps phase_step_losses splits by
# head: config sinkhorn's (phase_train), recipe v6's and v7r's with their
# runs' last interval batches (phase_recipe, phase_recipe_v7r)
STEP_CASES: dict[str, tuple] = {}


def _with_index(batch: dict, n_rows: int) -> dict:
    """``batch`` with the margin's backward index over a table of
    ``n_rows`` rows, as ``loop.IntervalBatch`` adds it once per batch."""
    return {**batch, MARGIN_INDEX: margin_l1.build_index(
        batch.get("pairs_aug", batch["pairs"]), batch["neg_l"], batch["neg_r"], n_rows)}


def _step_batch(res, cfg, dev):
    task = res.task
    pairs = torch.as_tensor(task.train_pairs, dtype=torch.int64, device=dev)
    neg_l, neg_r = sample_uniform_negatives(torch.Generator().manual_seed(1), pairs,
                                            task.kg1.n_ent, task.n_ent, cfg.k_neg)
    return _with_index({"pairs": pairs, "neg_l": neg_l, "neg_r": neg_r}, task.n_ent)


def _saved_batch(ckpt_dir: str, cfg, task, dev) -> tuple[dict, int]:
    """The last interval's batch as the run saved it: its negatives, its
    proposals with their weights, fit_mtl's draws, the margin's index; and
    the proposals of weight > 0.  The relation triples join it as
    fit_mtl's constant."""
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
    return _with_index(batch, task.n_ent), n_boot


SHORTLIST_CALLERS = (negatives_mod, bootstrap_mod, eval_mod, serve_mod)
# the L1 search's entries where the port calls them, and their plain versions
L1_CALLERS = ((eval_mod, ("l1_topk", "l1_count", "l1_tile")), (negatives_mod, ("l1_topk",)),
              (bootstrap_mod, ("l1_topk",)), (serve_mod, ("l1_topk",)),
              (ring_mod, ("l1_topk", "l1_count")))


def _plain_margin(*args, index=None):
    """The margin's composite where the port calls the kernel (it reads no
    index)."""
    return margin_loss_plain(*args)


@contextlib.contextmanager
def _plain_kernels():
    """The plain path: every kernel swapped for its plain PyTorch version
    where the port calls it (the GCN layer, the ELL and sorted SpMMs, the
    OT head, differentiated by autograd; the search paths'
    select-and-rerank and L1 search; the margin loss's composite)."""
    saved = (graphconv_mod.gcn_layer, graphconv_mod.spmm, attr_channel_mod.spmm_ell,
             attr_channel_mod.spmm, align_mod.sinkhorn_align_loss, losses_mod.margin_l1_loss,
             [m.select_rerank for m in SHORTLIST_CALLERS],
             [[getattr(m, n) for n in names] for m, names in L1_CALLERS])
    graphconv_mod.gcn_layer = gcn_fused.gcn_layer_plain
    graphconv_mod.spmm = attr_channel_mod.spmm = spmm_xla
    attr_channel_mod.spmm_ell = lambda op, x: apply_with_diag(op.fwd, op.diag, x)
    align_mod.sinkhorn_align_loss = sinkhorn_align_loss_plain
    losses_mod.margin_l1_loss = _plain_margin
    for m in SHORTLIST_CALLERS:
        m.select_rerank = shortlist_dist.shortlist_select_plain
    for m, names in L1_CALLERS:
        for n in names:
            setattr(m, n, getattr(l1_search, f"{n}_plain"))
    try:
        yield
    finally:
        (graphconv_mod.gcn_layer, graphconv_mod.spmm, attr_channel_mod.spmm_ell,
         attr_channel_mod.spmm, align_mod.sinkhorn_align_loss, losses_mod.margin_l1_loss, fns,
         l1_fns) = saved
        for m, fn in zip(SHORTLIST_CALLERS, fns):
            m.select_rerank = fn
        for (m, names), got in zip(L1_CALLERS, l1_fns):
            for n, fn in zip(names, got):
                setattr(m, n, fn)


# one step through the kernels against the plain path: fp32, the sums in
# another order (PERF.md §2); bf16, the two paths round at other points,
# and a unit within those roundings of 0 takes the other side of the
# layer-1 ReLU, moving its whole gradient: a fraction f ≈ 3e-3 of the
# pre-activations lies within 2^-8 of their RMS of 0 (measured at the card
# tests' shapes, tests/test_torch_gpu.py::BF16_STEP_TOL), giving a
# relative L2 of up to sqrt(f) ≈ 5.5e-2, held at 2·sqrt(f) ≈ 1e-1; the
# loss, a mean of many hinge terms, within a bf16 ulp (2^-7).  A gradient
# that is 0 by construction is rounding noise in both paths: under 1e-5 of
# the largest gradient entry in fp32; in bf16 the sum over the n rows of
# each row's cotangent rounding (≤ 2^-9), under sqrt(n)·2^-8 of it.
STEP_TOL = {torch.float32: dict(loss_rel=1e-4, grad_rel_l2=1e-3),
            torch.bfloat16: dict(loss_rel=2 ** -7, grad_rel_l2=1e-1)}


def _check_step(model, loss_fn, expect: dict, zero_grads: tuple[str, ...] = (),
                dtype: torch.dtype = torch.float32) -> dict:
    """One training step's loss and gradients through the kernels against
    the plain path on the card (``_plain_kernels``, which must launch no
    kernel) at ``STEP_TOL[dtype]``, the compute type.  ``loss_fn()``
    returns the step's loss; ``expect``, the kernels' launches in it.
    ``zero_grads``: parameters whose gradient is 0 by construction (the AE
    layer-2 bias: the AE margin reads only differences of rows), held as
    rounding noise (``_step_gap``)."""
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
    n_rows = max(p.shape[0] for p in model.parameters())  # the embedding table's rows
    zero_rel = 1e-5 if dtype == torch.float32 else math.sqrt(n_rows) * 2 ** -8
    return {"per_step_launches": per_step,
            **_step_gap(loss, grads, plain, {k: v.grad for k, v in model.named_parameters()},
                        zero_grads, zero_rel, STEP_TOL[dtype])}


def _step_gap(loss, grads: dict, ref_loss, ref: dict, zero_grads: tuple[str, ...] = (),
              zero_rel: float = 1e-5, tol: dict | None = None) -> dict:
    """A step's loss and gradients against a reference step's on the same
    parameters and batch: the loss's relative error, each gradient's
    relative L2 distance; a gradient 0 by construction (``zero_grads``) is
    rounding noise in both, under ``zero_rel`` of the largest gradient
    entry.  Held at ``tol`` (a STEP_TOL entry) unless it is None."""
    loss_rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    rel = {k: float((grads[k] - v).norm() / v.norm().clamp_min(1e-30))
           for k, v in ref.items() if k not in zero_grads}
    scale = max(float(v.abs().max()) for v in ref.values())
    zero = {k: max(float(grads[k].abs().max()), float(ref[k].abs().max())) for k in zero_grads}
    if tol is not None and (loss_rel > tol["loss_rel"] or max(rel.values()) > tol["grad_rel_l2"]
                            or any(v > zero_rel * scale for v in zero.values())):
        raise AssertionError(f"step vs its reference: loss rel {loss_rel}, grads {rel}, "
                             f"zero grads {zero} at scale {scale}")
    return {"loss": loss.item(), "loss_reference": ref_loss.item(), "loss_rel_err": loss_rel,
            "grad_rel_l2": rel, "tolerance": tol, "zero_grad_max_abs": zero,
            "grad_max_abs": scale}


def _stage_medians(step, names: list[str], dev, reps: int = 5) -> dict:
    """Median host wall time of each stage of ``step(mark)``, which calls
    ``mark()`` at the end of each stage named in ``names``, in order;
    ``mark`` synchronises first.  One warm-up call, then ``reps`` timed."""
    times = {k: [] for k in (*names, "step")}
    for i in range(reps + 1):
        sync(dev)
        t = [time.perf_counter()]

        def mark():
            sync(dev)
            t.append(time.perf_counter())

        step(mark)
        if i:
            for k, a, b in zip(names, t, t[1:]):
                times[k].append(b - a)
            times["step"].append(t[-1] - t[0])
    med = {f"{k}_s": float(np.median(v)) for k, v in times.items()}
    med["shares"] = {k: med[f"{k}_s"] / med["step_s"] for k in names}
    return med


def _table_heads(cfg, batch: dict, rel_head, attr_head, rel_triples) -> list:
    """(name, loss of the table) of the relation and attribute heads a step runs."""
    heads = []
    if rel_head is not None:
        heads.append(("rel_head", lambda e: cfg.rel_weight * rel_head(
            e, rel_triples, batch["rel_neg_t"], batch["rel_neg_h"])))
    if attr_head is not None:
        heads.append(("attr_head", lambda e: cfg.attr_weight * attr_head(
            e, batch["attr_triples"])))
    return heads


def _loss_stages(emb_d, batch: dict, cfg, heads: list, ot_loss, mark) -> None:
    """The table losses' stages of a step on the detached table ``emb_d``,
    each ended by ``mark()``: the margin's forward and backward, the OT
    head's forward and backward, each head's forward and backward."""
    margin = margin_align_loss(emb_d, batch.get("pairs_aug", batch["pairs"]), batch["neg_l"],
                               batch["neg_r"], cfg.gamma, batch.get("w"),
                               index=batch.get(MARGIN_INDEX))
    mark()
    margin.backward()
    mark()
    if cfg.use_sinkhorn:
        ot = ot_loss(emb_d, batch.get("ot_pairs", batch["pairs"]), tau=cfg.sinkhorn_tau,
                     n_iters=cfg.sinkhorn_iters)
        mark()
        (cfg.sinkhorn_weight * ot).backward()
        mark()
    for _, head in heads:
        head(emb_d).backward()
        mark()


def _loss_stage_names(cfg, heads: list) -> list[str]:
    return ["margin_forward", "margin_backward",
            *(["ot_forward", "ot_backward"] if cfg.use_sinkhorn else []), *(h for h, _ in heads)]


def _profile_step(model, op, batch, cfg, dev, attr_op=None, reps: int = 5) -> dict:
    """Median host wall time of each stage of an AlignMTL step, each ended
    by a synchronise: the encoder's forward; the margin's forward and
    backward (on the detached table); the OT head's forward and backward;
    the relation head and the attribute head (forward and backward each, on
    the detached table); the AE channel (its forward, margin and backward);
    the encoder's backward; Adam."""
    opt, _ = make_optimizer(cfg, model.parameters())
    heads = _table_heads(cfg, batch, model.rel_head, model.attr_head, batch.get("rel_triples"))
    names = ["forward", *_loss_stage_names(cfg, heads),
             *(["ae_channel"] if attr_op is not None else []), "backward", "adam"]

    def step(mark):
        opt.zero_grad(set_to_none=True)
        emb = model.encoder(op)
        mark()
        emb_d = emb.detach().requires_grad_(True)
        _loss_stages(emb_d, batch, cfg, heads, sinkhorn_align_loss, mark)
        if attr_op is not None:
            ae = model.ae_encoder(op, attr_op)
            (cfg.attr_channel_weight * margin_align_loss(
                ae, batch.get("pairs_aug", batch["pairs"]), batch["neg_l"], batch["neg_r"],
                cfg.gamma, batch.get("w"), index=batch.get(MARGIN_INDEX))).backward()
            mark()
        emb.backward(emb_d.grad)
        mark()
        opt.step()
        mark()

    return _stage_medians(step, names, dev, reps)


def _profile_dist_step(parts, batch, cfg, dev, reps: int = 5) -> dict:
    """``_profile_step`` for a distributed step (``DistParts``): the
    tables' forward, the table losses' stages with the ring OT, and the
    encoder's backward."""
    model, mesh = parts.model, parts.op.mesh
    heads = _table_heads(cfg, batch, model.rel_head, model.attr_head, parts.rel_triples)

    def ring_ot(emb, pairs, **kw):
        return ring_sinkhorn_align_loss(emb, pairs, mesh, **kw)

    def step(mark):
        model.zero_grad(set_to_none=True)
        se, _ = parts.tables()
        mark()
        se_d = se.detach().requires_grad_(True)
        _loss_stages(se_d, batch, cfg, heads, ring_ot, mark)
        se.backward(se_d.grad)
        mark()

    return _stage_medians(step, ["forward", *_loss_stage_names(cfg, heads), "backward"], dev,
                          reps)


@contextlib.contextmanager
def _parent_loss_route():
    """The step's two loss kernels swapped for their plain versions where
    the port calls them, the route of the step before ``margin_l1`` and
    ``sinkhorn_reverse``: the margin's composite with autograd, and the
    reverse updates as torch's elementwise passes (single-device and ring)."""
    saved = losses_mod.margin_l1_loss, ot_mod.sinkhorn_reverse, ring_mod.sinkhorn_reverse
    losses_mod.margin_l1_loss = _plain_margin
    ot_mod.sinkhorn_reverse = ring_mod.sinkhorn_reverse = sinkhorn_reverse_plain
    try:
        yield
    finally:
        losses_mod.margin_l1_loss, ot_mod.sinkhorn_reverse, ring_mod.sinkhorn_reverse = saved


# the previous margin kernel (``--parent-margin``, ``_parent_margin``), or None
PARENT_MARGIN: dict | None = None


@contextlib.contextmanager
def _parent_margin_route():
    """The step with the previous margin kernel where the port calls the margin
    (it builds its index in every backward, as it did)."""
    saved = losses_mod.margin_l1_loss
    losses_mod.margin_l1_loss = PARENT_MARGIN["loss"]
    try:
        yield
    finally:
        losses_mod.margin_l1_loss = saved


def _in_turns(split, rounds: int = 2) -> dict:
    """``split()`` under the parent's loss route (the loss kernels' plain
    versions), with ``--parent-margin`` also under the previous margin kernel
    ("previous_margin"), and on the kernels, in turns (parent, [previous_margin,]
    kernels, then backwards, ...): each route's readings."""
    routes = ("parent", *(("previous_margin",) if PARENT_MARGIN else ()), "kernels")
    contexts = {"parent": _parent_loss_route, "previous_margin": _parent_margin_route,
                "kernels": contextlib.nullcontext}
    out = {route: [] for route in routes}
    for r in range(rounds):
        for route in (routes if r % 2 == 0 else routes[::-1]):
            with contexts[route]():
                out[route].append(split())
    return out


def _device_split(fn, dev, top: int = 6) -> dict:
    """One call of ``fn`` (after one warm-up call) from a torch.profiler
    trace: its host wall time, the device busy share (the kernels' and
    copies' device time over that wall time), the ``top`` kernels by device
    time, and the most device memory the call held beyond what was
    allocated before it.  None where the trace holds no device events."""
    fn()
    sync(dev)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    base = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    peak_mb = ((torch.cuda.max_memory_allocated(dev) - base) / 2**20 if dev.type == "cuda"
               else None)
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + e.time_range.elapsed_us()
    if not by_name:
        return {"wall_ms": wall_us / 1e3, "busy_share": None, "top_kernels_ms": None,
                "peak_extra_mb": peak_mb}
    top_k = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall_us / 1e3, "busy_share": sum(by_name.values()) / wall_us,
            "top_kernels_ms": {k: v / 1e3 for k, v in top_k}, "peak_extra_mb": peak_mb}


def _device_busy(res, cfg, dev, steps: int = 3) -> dict:
    """``_device_split`` of a window of ``steps`` training steps, per step."""
    model, op, batch = res.model, res.op, _step_batch(res, cfg, dev)
    opt, _ = make_optimizer(cfg, model.parameters())

    def window():
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            loss, _ = model(op, batch)
            loss.backward()
            opt.step()

    split = _device_split(window, dev, top=8)
    busy, top = split["busy_share"], split["top_kernels_ms"]
    return {"busy_share": busy, "idle_share": None if busy is None else 1.0 - busy,
            "window_steps": steps, "window_wall_ms_per_step": split["wall_ms"] / steps,
            "top_kernels_ms_per_step": top and {k: v / steps for k, v in top.items()}}


def _run_checked(cfg, task, dev, **timing_counts) -> tuple:
    """A run through driver.run with every count at 0 just before and read
    just after: its result, its launches (held to ``_expected_launches``),
    its wall seconds; ``timing_counts`` (steps, minings, ...) are held too,
    and the margin's index builds to the run's batches (one a resample
    interval: none inside a step)."""
    _reset_launch_counts()
    t0 = time.perf_counter()
    res = run(cfg, task=task, device=dev)
    sync(dev)
    run_s = time.perf_counter() - t0
    counts, t = _launch_counts(), res.timings
    expected = _expected_launches(cfg, t, task)
    if counts != expected or any(t[k] != v for k, v in timing_counts.items()):
        raise AssertionError(f"launches {counts} (expected {expected}), timings {t}")
    batches = len(range(t["start_epoch"], cfg.epochs, cfg.neg_every))
    if margin_l1.index_builds != batches:
        raise AssertionError(f"the margin's index was built {margin_l1.index_builds} times "
                             f"in a run of {batches} batches")
    INDEX_BUILDS.append({"config": cfg.name, "param_dtype": cfg.param_dtype,
                         "spmm_impl": cfg.spmm_impl, "epochs": cfg.epochs,
                         "neg_every": cfg.neg_every, "batches": batches,
                         "index_builds": margin_l1.index_builds,
                         "margin_launches": counts["margin_l1"]})
    losses = res.losses
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses not finite or not falling: {losses}")
    if not all(math.isfinite(v) for v in res.metrics.values()):
        raise AssertionError(f"non-finite metrics {res.metrics}")
    return res, counts, run_s


# each checked run's margin index builds beside its batches and margin launches
INDEX_BUILDS: list[dict] = []


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
    STEP_CASES["sinkhorn"] = (res.model, res.op, batch, cfg)
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
        if not (counts["l1_topk"] and counts["l1_count"]):
            raise AssertionError(f"the exact stages never launched the L1 search: {counts}")
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
        STEP_CASES["v6"] = (res.model, res.op, batch, cfg)

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
    return counts, stages


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
    STEP_CASES["v7r"] = (model, res.op, batch, cfg)
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
        if per_embed != {"gcn_fused": 4, "spmm_ell": 1, "sinkhorn_fused": 0, "spmm_sorted": 0,
                         "shortlist_dist": 0, "shortlist_gather": 0, **L1_NONE,
                         **LOSS_NONE} or emb.shape != (
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

    step = _check_step(model, loss_fn, {"gcn_fused": 2, "spmm_ell": 2, "sinkhorn_fused": 0,
                                        "spmm_sorted": 0, "shortlist_dist": 0,
                                        "shortlist_gather": 0, **L1_NONE,
                                        **_loss_launches(cfg, 1)})
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


# the gather-only entry (the unfused route) at the shapes its callers
# had before the select kernel: (caller, queries S, entries K, table rows C, d, metric)
SHORTLIST_SHAPES = (("mining", 7000, 200, 19000, 256, "cityblock"),
                    ("proposals", 19000, 16, 19000, 256, "cityblock"),
                    ("proposals_sq", 19000, 16, 19000, 256, "sqeuclidean"),
                    ("hubness", 10500, 10, 10500, 256, "cityblock"),
                    ("eval", 10500, 128, 10500, 256, "cityblock"),
                    ("serving", 10500, 128, 19000, 256, "cityblock"),
                    ("eval_d512", 10500, 128, 10500, 512, "cityblock"))
SHORTLIST_TOL = dict(rtol=1e-5, atol=1e-5)  # d terms summed in another order
# the select-and-rerank kernel where its callers run it at zh-en scale:
# (caller, queries S, k, candidates C, d, options); "csls": a = 2 and a
# hubness bias, "mask": a column mask (the proposals' seed entities),
# "exclude": each query's partner
SELECT_SHAPES = (
    ("mining", 7000, 200, 19000, 256, dict(exclude=True, rerank="cityblock")),
    ("mining_sq_csls", 7000, 100, 19000, 256, dict(exclude=True, csls=True)),
    ("proposals", 19000, 16, 19000, 256, dict(bf16=True, mask=True, rerank="cityblock")),
    ("proposals_sq_csls", 19000, 16, 19000, 256,
     dict(bf16=True, mask=True, csls=True, rerank="sqeuclidean")),
    ("hubness", 10500, 10, 10500, 256, dict(rerank="cityblock")),
    ("eval_csls", 10500, 128, 10500, 256, dict(csls=True, rerank="cityblock")),
    ("serving_csls", 10500, 128, 19000, 256, dict(csls=True, rerank="cityblock")),
    ("eval_csls_d512", 10500, 128, 10500, 512, dict(csls=True, rerank="cityblock")))


def _gather_entry(smi: str, dev: torch.device) -> dict:
    """The gather-only kernel (the route above the select kernel's queue)
    against its plain version at each of those shapes: random rows and
    random shortlists; two launches must agree bit for bit."""
    rng = np.random.default_rng(5)
    out = {}
    for name, s, k, c, d, metric in SHORTLIST_SHAPES:
        q = torch.from_numpy(rng.standard_normal((s, d)).astype(np.float32)).to(dev)
        table = torch.from_numpy(rng.standard_normal((c, d)).astype(np.float32)).to(dev)
        idx = torch.from_numpy(rng.integers(0, c, (s, k))).to(dev)

        def kernel():
            return shortlist_dist.shortlist_dist(q, table, idx, metric)

        got = kernel()
        sync(dev)
        want = shortlist_dist.shortlist_dist_plain(q, table, idx, metric)
        torch.testing.assert_close(got, want, **SHORTLIST_TOL)
        err = float((got - want).abs().max())
        if not torch.equal(got, kernel()):
            raise AssertionError(f"shortlist_dist gather ({name}): two launches differ")
        # q, the table, idx once and out once; 3 operations a term
        # (difference, |·| or square, sum) at the fp32 SIMT rate
        bound, bound_by = _bound((s * d + c * d + s * k) * 4 + s * k * 8, 3 * s * k * d)
        ms, dev_ms = time_ms(kernel), device_ms(kernel)
        out[name] = dict(s=s, k=k, c=c, d=d, metric=metric, max_abs_err=err, ms=ms,
                         device_ms=dev_ms, ms_cold_l2=time_cold_ms(kernel),
                         plain_ms=time_ms(lambda: shortlist_dist.shortlist_dist_plain(
                             q, table, idx, metric), warmup=1, iters=3),
                         bound_ms=bound, bound_by=bound_by, share_of_bound_device=ratio(
                             bound, dev_ms), gathered_bytes=s * k * d * 4, library_ms=None)
        emit({"phase": "kernel", "kernel": "shortlist_dist_gather", "caller": name, **out[name],
              "bit_identical_runs": True, "card": smi})
    return out


def _select_inputs(rng, s: int, c: int, d: int, opts: dict, dev: torch.device):
    """Random rows and the options of one caller: the partner of query i
    at a random column, a mask of 24 % of the columns (the seed entities
    proposals skip), a CSLS bias near the sqeuclidean scale of the rows."""
    q = torch.from_numpy(rng.standard_normal((s, d)).astype(np.float32)).to(dev)
    cands = torch.from_numpy(rng.standard_normal((c, d)).astype(np.float32)).to(dev)
    kw = {k: opts[k] for k in ("bf16", "rerank") if k in opts}
    if opts.get("exclude"):
        kw["exclude"] = torch.from_numpy(rng.integers(0, c, s)).to(dev)
    if opts.get("mask"):
        kw["col_mask"] = torch.from_numpy(rng.random(c) >= 0.24).to(dev)
    if opts.get("csls"):
        kw["a"] = 2.0
        kw["bias"] = torch.from_numpy(
            (1.6 * d + 0.1 * d * rng.standard_normal(c)).astype(np.float32)).to(dev)
    return q, cands, kw


def _composite(q, cands, k: int, kw: dict):
    """The route the select kernel replaces, as its callers ran it before: per
    4,096 queries the fp32 (or bf16-rounded) selection tile, the bias and
    masks, ``torch.topk``, then the gather kernel."""
    c2 = shortlist_dist.sq_norms(cands)
    ct = (cands.to(torch.bfloat16) if kw.get("bf16") else cands).float().t()
    cols = torch.arange(cands.shape[0], device=q.device)
    out = []
    for r0 in range(0, q.shape[0], shortlist_dist.PLAIN_BLOCK_Q):
        qq = q[r0:r0 + shortlist_dist.PLAIN_BLOCK_Q]
        qa = (qq.to(torch.bfloat16) if kw.get("bf16") else qq).float()
        sel = shortlist_dist.sq_norms(qq)[:, None] + c2[None, :] - 2.0 * (qa @ ct)
        if "bias" in kw:
            sel = 2.0 * sel - kw["bias"][None, :]
        if "col_mask" in kw:
            sel.masked_fill_(~kw["col_mask"][None, :], float("inf"))
        if "exclude" in kw:
            sel.masked_fill_(cols[None, :] == kw["exclude"][r0:r0 + len(qq), None],
                             float("inf"))
        idx = torch.topk(sel, k, dim=1, largest=False).indices
        out.append(shortlist_dist.shortlist_dist(qq, cands, idx, kw["rerank"])
                   if kw.get("rerank") else idx)
    return out


def _select_bound(s: int, c: int, d: int, k: int, kw: dict) -> tuple[float, str]:
    """The least time of one select-and-rerank call: its inputs read once
    (rows, norms, bias, mask, exclusions) and its outputs written once, or
    its operations, whichever is larger: the product (3 TF32 products per
    fp32 one, or one bf16 product) at its tensor-core rate, 3 fp32
    operations per score (the two affine steps, the threshold compare) and
    3 per rerank term (difference, |·| or square, sum)."""
    nbytes = ((s + c) * d * 4 + (s + c) * 4 + c * 4 * ("bias" in kw) + c * ("col_mask" in kw)
              + s * 8 * ("exclude" in kw) + s * k * (8 + 4 + 4 * bool(kw.get("rerank"))))
    product = (2 * s * c * d / PEAK_OPS[torch.bfloat16] if kw.get("bf16")
               else 3 * 2 * s * c * d / PEAK_TF32_OPS)
    fp32 = (3 * s * c + 3 * s * k * d * bool(kw.get("rerank"))) / PEAK_OPS[torch.float32]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, (product + fp32) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _by_id(idx: torch.Tensor, *vals: torch.Tensor) -> list:
    """Each row's values ordered by column id."""
    order = idx.argsort(dim=1)
    return [v.gather(1, order) for v in vals]


def _select_case(name: str, q, cands, k: int, kw: dict, opts: dict, smi: str,
                 kernel_name: str = "shortlist_dist") -> dict:
    """The select-and-rerank kernel on (q, cands, k, kw) against its plain
    version (the same sets on ≥ 99 % of rows; where the sets agree, the
    rerank within 1e-5 + 1e-5·|x| and the selection score within 1e-5 of
    a·(max ‖q‖² + max ‖c‖²), the expanded form's scale; two launches bit for
    bit), timed beside the route it replaces and its bound."""
    s, c, d = q.shape[0], cands.shape[0], q.shape[1]

    def kernel():
        return shortlist_dist.shortlist_select(q, cands, k, **kw)

    got = kernel()
    sync(q.device)
    want = shortlist_dist.shortlist_select_plain(q, cands, k, **kw)
    same = _same_rows(got[0], want[0])
    rows = (got[0].sort(dim=1).values == want[0].sort(dim=1).values).all(dim=1)
    g_val, w_val = _by_id(got[0][rows], got[1][rows])[0], _by_id(want[0][rows],
                                                                want[1][rows])[0]
    scale = kw.get("a", 1.0) * float(shortlist_dist.sq_norms(q).max()
                                     + shortlist_dist.sq_norms(cands).max())
    sval_err = float((g_val - w_val).abs().max())
    dist_err = None
    if kw.get("rerank"):
        g_d, w_d = _by_id(got[0][rows], got[2][rows])[0], _by_id(want[0][rows],
                                                              want[2][rows])[0]
        torch.testing.assert_close(g_d, w_d, **SHORTLIST_TOL)
        dist_err = float((g_d - w_d).abs().max())
    again = kernel()
    if same < 0.99 or sval_err > 1e-5 * scale or not all(
            a is None and b is None or torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"shortlist_select ({name}): same rows {same}, score error "
                             f"{sval_err} at scale {scale}, or two launches differ")
    bound, bound_by = _select_bound(s, c, d, k, kw)
    ms, dev_ms = time_ms(kernel), device_ms(kernel)
    comp_ms = time_ms(lambda: _composite(q, cands, k, kw), warmup=1, iters=5)
    out = dict(s=s, k=k, c=c, d=d, options=opts, same_sets_share=same,
               max_abs_err=dist_err, sval_max_abs_err=sval_err,
               sval_scale=scale, ms=ms, device_ms=dev_ms,
               ms_cold_l2=time_cold_ms(kernel),
               plain_ms=time_ms(lambda: shortlist_dist.shortlist_select_plain(
                   q, cands, k, **kw), warmup=1, iters=3),
               bound_ms=bound, bound_by=bound_by,
               share_of_bound_device=ratio(bound, dev_ms),
               library_ms=comp_ms,
               library_device_ms=device_ms(lambda: _composite(q, cands, k, kw), iters=3),
               library="the replaced route: selection tile, torch.topk, gather kernel")
    emit({"phase": "kernel", "kernel": kernel_name, "caller": name, **out,
          "bit_identical_runs": True, "card": smi})
    return out


def phase_shortlist(smi: str, dev: torch.device) -> tuple[dict, dict]:
    """The select-and-rerank kernel against its plain version at each
    caller's shape (``_select_case``), timed beside the route it replaces;
    then the gather-only entry against its plain version."""
    rng = np.random.default_rng(6)
    out = {}
    for name, s, k, c, d, opts in SELECT_SHAPES:
        q, cands, kw = _select_inputs(rng, s, c, d, opts, dev)
        out[name] = _select_case(name, q, cands, k, kw, opts, smi)
    return out, _gather_entry(smi, dev)


# the L1 search at its callers' shapes: (name, entry, queries, candidates,
# d, k, options); zh-en (7,000 mining queries: 4,500 seed pairs and 2,500
# proposals; 19,000 entities a KG; 10,500 test pairs) and one ring block of
# dwy100k_dist v7r (17,500 mining queries against a 12,500-row block; the
# CSLS eval's 35,000 queries against a 4,375-row block)
L1_SHAPES = (
    ("mining", "topk", 7000, 19000, 256, 100, dict(exclude=True)),
    ("proposals", "topk", 19000, 19000, 256, 1, dict(mask=True)),
    ("hubness", "topk", 10500, 10500, 256, 10, {}),
    ("serving_csls", "topk", 10500, 19000, 256, 10, dict(csls=True)),
    ("ranks", "count", 10500, 10500, 256, 0, {}),
    ("ranks_csls", "count", 10500, 10500, 256, 0, dict(csls=True)),
    ("dist_mining_block", "topk", 17500, 12500, 256, 100, dict(exclude=True)),
    ("dist_ranks_csls_block", "count", 35000, 4375, 256, 0, dict(csls=True)),
    ("hubness_d512", "topk", 10500, 10500, 512, 10, {}),
    ("above_queue_k300", "topk", 10500, 10500, 256, 300, {}),
)
L1_TOL = 1e-5  # PERF.md §2: top-k values rtol (CSLS: of the distance scale); counts' band
# one fp32 instruction per lane per clock: the 67 TFLOP/s of PEAK_OPS counts an FMA as two
SIMT_INSTR_PER_S = PEAK_OPS[torch.float32] / 2


def _l1_bound(entry: str, s: int, c: int, d: int, k: int, kw: dict) -> tuple[float, str]:
    """The least time of one L1 search: its rows, bias, mask, exclusions or
    thresholds read once and its outputs written once, or its S·C·d terms
    |a − b| at two fp32 instructions each (a subtract, an add of the
    absolute value; L1 has no tensor-core form), whichever is larger."""
    nbytes = ((s + c) * d * 4 + c * 4 * ("bias" in kw) + c * ("col_mask" in kw)
              + s * 8 * ("exclude" in kw or "self_col" in kw) + s * 4 * ("thresh" in kw)
              + (s * k * 12 if entry == "topk" else s * 8))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * s * c * d / SIMT_INSTR_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _l1_library(entry: str, q, cands, k: int, kw: dict):
    """One PyTorch call that computes the same function: ``torch.cdist(q, c,
    p=1)``, then the CSLS affine step and masks, then ``torch.topk`` or a
    compare-and-sum (the (Q, C) tile fits at every shape here)."""
    d = torch.cdist(q, cands, p=1)
    if "bias" in kw:
        d = kw["a"] * d - kw["bias"][None, :]
    if entry == "count":
        cols = torch.arange(cands.shape[0], device=q.device)
        return ((d < kw["thresh"][:, None]) & (cols[None, :] != kw["self_col"][:, None])).sum(1)
    if "col_mask" in kw:
        d.masked_fill_(~kw["col_mask"][None, :], float("inf"))
    if "exclude" in kw:
        cols = torch.arange(cands.shape[0], device=q.device)
        d.masked_fill_(cols[None, :] == kw["exclude"][:, None], float("inf"))
    return torch.topk(d, k, dim=1, largest=False)


def _parent_l1(src: str) -> dict:
    """The L1 search of another commit: ``l1_search.cu`` (with its
    ``topk_queue.cuh``) in ``src``, built there by nvcc with the port's
    flags, its top-k and count entries (PR 19's C signatures) wrapped to
    take the port's arguments."""
    lib_path = os.path.join(src, "l1_search_parent.so")
    t0 = time.perf_counter()
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib_path,
                           os.path.join(src, "l1_search.cu")], capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the parent's l1_search.cu:\n{proc.stderr}")
    lib = ctypes.CDLL(lib_path)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.l1_topk_forward.argtypes = [P, P, P, P, P, F, I, I, I, I, I, P, P, P]
    lib.l1_count_forward.argtypes = [P, P, P, P, P, F, I, I, I, P, P]
    ptr = l1_search._ptr

    def topk(q, cands, k, a=1.0, bias=None, col_mask=None, exclude=None):
        vals = torch.empty((q.shape[0], k), dtype=torch.float32, device=q.device)
        idx = torch.empty((q.shape[0], k), dtype=torch.int64, device=q.device)
        l1_search._raise_on(lib.l1_topk_forward(
            q.data_ptr(), cands.data_ptr(), ptr(bias), ptr(l1_search._mask_bytes(col_mask)),
            ptr(exclude), float(a), q.shape[0], cands.shape[0], q.shape[1], k,
            l1_search.queue_len(k), idx.data_ptr(), vals.data_ptr(), l1_search._stream(q)),
            "parent l1_topk")
        return vals, idx

    def count(q, cands, thresh, a=1.0, bias=None, self_col=None):
        out = torch.empty(q.shape[0], dtype=torch.int64, device=q.device)
        l1_search._raise_on(lib.l1_count_forward(
            q.data_ptr(), cands.data_ptr(), ptr(bias), thresh.data_ptr(), ptr(self_col),
            float(a), q.shape[0], cands.shape[0], q.shape[1], out.data_ptr(),
            l1_search._stream(q)), "parent l1_count")
        return out

    emit({"phase": "parent_l1_build", "src": src, "build_s": time.perf_counter() - t0,
          "ptxas": [ln for ln in (proc.stdout + proc.stderr).splitlines()
                    if "registers" in ln or "spill" in ln]})
    return {"topk": topk, "count": count}


def _parent_margin(src: str) -> dict:
    """The previous margin kernel: ``margin_l1.cu`` in ``src``, built by nvcc
    with the port's flags, its forward and backward (commit 461a30d's C signatures:
    the backward reads the table's rows again, over an int64 index that it
    builds in every call) as an autograd Function taking the port's
    arguments.  "loss" (a stand-in for ``margin_l1_loss``: it ignores a
    batch's index), "index" (its per-call index build) and "build_s"."""
    t0 = time.perf_counter()
    built = _build.build("margin_l1_parent", os.path.join(src, "margin_l1.cu"))
    lib = ctypes.CDLL(str(built.path))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.margin_l1_forward.argtypes = [P, P, P, P, P, F, I, I, I, P, P, P, P, P]
    lib.margin_l1_backward.argtypes = [P] * 11 + [I] * 5 + [P, P, P]
    stream = margin_l1._stream

    def index(pairs, neg_l, neg_r, n_rows):
        keys, order, row_ptr = margin_l1.contribution_index(pairs, neg_l, neg_r, n_rows)
        item_ptr, n_items = margin_l1.record_items(row_ptr, len(keys))
        return order, row_ptr, item_ptr, n_items

    class ParentMargin(torch.autograd.Function):
        @staticmethod
        def forward(ctx, emb, pairs, neg_l, neg_r, w, gamma):
            (s, k), d = neg_r.shape, emb.shape[1]
            flags = torch.empty((s, k), dtype=torch.uint8, device=emb.device)
            row_sum = torch.empty(s, dtype=torch.float32, device=emb.device)
            loss = torch.empty((), dtype=torch.float32, device=emb.device)
            denom = torch.empty(1, dtype=torch.float32, device=emb.device)
            err = lib.margin_l1_forward(
                emb.data_ptr(), pairs.data_ptr(), neg_l.data_ptr(), neg_r.data_ptr(),
                None if w is None else w.data_ptr(), float(gamma), s, k, d, flags.data_ptr(),
                row_sum.data_ptr(), loss.data_ptr(), denom.data_ptr(), stream(emb))
            if err != 0:
                raise RuntimeError(f"the parent's margin forward failed with CUDA error {err}")
            ctx.save_for_backward(emb, pairs, neg_l, neg_r, w, flags, denom)
            return loss

        @staticmethod
        def backward(ctx, grad):
            emb, pairs, neg_l, neg_r, w, flags, denom = ctx.saved_tensors
            (s, k), (n, d) = neg_r.shape, emb.shape
            order, row_ptr, item_ptr, n_items = index(pairs, neg_l, neg_r, n)
            grad = grad.to(torch.float32).reshape(1).contiguous()
            partial = torch.empty((n_items, d), dtype=torch.float32, device=emb.device)
            out = torch.empty_like(emb)
            err = lib.margin_l1_backward(
                emb.data_ptr(), pairs.data_ptr(), neg_l.data_ptr(), neg_r.data_ptr(),
                None if w is None else w.data_ptr(), flags.data_ptr(), denom.data_ptr(),
                grad.data_ptr(), order.data_ptr(), row_ptr.data_ptr(), item_ptr.data_ptr(),
                n_items, n, s, k, d, partial.data_ptr(), out.data_ptr(), stream(emb))
            if err != 0:
                raise RuntimeError(f"the parent's margin backward failed with CUDA error {err}")
            return out, None, None, None, None, None

    def loss(emb, pairs, neg_l, neg_r, gamma=10.0, weights=None, index=None):
        ids = [t.to(torch.int64).contiguous() for t in (pairs, neg_l, neg_r)]
        w = None if weights is None else weights.to(torch.float32).contiguous()
        return ParentMargin.apply(emb.contiguous(), *ids, w, float(gamma))

    out = {"loss": loss, "index": index, "build_s": time.perf_counter() - t0}
    emit({"phase": "parent_margin_build", "src": src, "build_s": out["build_s"],
          "ptxas": [ln.strip() for ln in built.log.splitlines()
                    if "registers" in ln or "spill" in ln]})
    return out


def _smi_sample(fn, seconds: float = 1.0) -> dict:
    """The SM clock (MHz) and power draw (W) that ``nvidia-smi`` samples
    every 100 ms while ``fn`` runs back to back for ``seconds``: the median
    of the samples after the first."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                             "--format=csv,noheader,nounits", "-lms", "100"],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(4):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    rows = [ln.split(",") for ln in out.splitlines() if ln.count(",") == 1]
    vals = [(float(a), float(b)) for a, b in rows[1:]
            if a.strip().replace(".", "", 1).isdigit() and b.strip().replace(".", "", 1).isdigit()]
    if not vals:
        return {"sm_clock_mhz": None, "power_w": None, "samples": 0}
    return {"sm_clock_mhz": float(np.median([v[0] for v in vals])),
            "power_w": float(np.median([v[1] for v in vals])), "samples": len(vals)}


def _l1_plan(entry: str, q, cands, k: int) -> dict:
    """The plan ``l1_search`` launches this call with."""
    kq = l1_search.queue_len(k) if entry == "topk" else 32
    p, stages = l1_search._planned(q, cands.shape[0], k, entry, kq, None)
    return {"strip": p.strip, "tile": p.tile, "splits": p.splits(), "units": p.units,
            "slots": p.slots, "waves": p.waves, "fill": p.fill, "stages": stages,
            "blocks_per_sm": p.slots // torch.cuda.get_device_properties(q.device)
            .multi_processor_count}


def _l1_parent_case(entry: str, kernel, parent_fn, args, opts, got) -> dict:
    """The parent commit's kernel on the same inputs: its outputs against
    this kernel's bit for bit, and both timed in turns (parent, this, this,
    parent) by CUDA events."""
    def old():
        return parent_fn(*args, **opts)

    want = old()
    torch.cuda.synchronize()
    bitwise = (all(torch.equal(a, b) for a, b in zip(got, want)) if entry == "topk"
               else torch.equal(got, want))
    times = [time_ms(f, warmup=2, iters=10) for f in (old, kernel, kernel, old)]
    return {"bitwise": bitwise, "parent_ms": (times[0] + times[3]) / 2,
            "ms": (times[1] + times[2]) / 2, "ratio": (times[1] + times[2]) / (times[0] + times[3]),
            "turns_ms": times}


def _l1_case(name: str, entry: str, q, cands, k: int, kw: dict, smi: str,
             parent: dict | None = None) -> dict:
    """One L1 search entry on the card against its plain version (top-k:
    the same sets on ≥ 99 % of rows and, where they agree, the values within
    rtol L1_TOL, atol L1_TOL of the distance scale; count: equal but for the
    candidates whose plain score lies within L1_TOL·|thresh| of the
    threshold), two launches bit for bit, one launch a call (the tile route
    above the queue: one tile launch a block of 4,096 queries); timed beside
    its plain version, ``cdist`` + ``topk`` or compare-and-sum, and its
    bound."""
    s, c, d = q.shape[0], cands.shape[0], q.shape[1]
    if entry == "topk":
        fn, plain = l1_search.l1_topk, l1_search.l1_topk_plain
        opts = {key: v for key, v in kw.items() if key in ("a", "bias", "col_mask", "exclude")}
        args = (q, cands, k)
    else:
        fn, plain = l1_search.l1_count, l1_search.l1_count_plain
        opts = {key: v for key, v in kw.items() if key in ("a", "bias", "self_col")}
        args = (q, cands, kw["thresh"])

    def kernel():
        return fn(*args, **opts)

    before = _launch_counts()
    got = kernel()
    sync(q.device)
    launched = {key: v - before[key] for key, v in _launch_counts().items() if v != before[key]}
    want = plain(*args, **opts)
    if entry == "topk":
        rows = (got[1].sort(dim=1).values == want[1].sort(dim=1).values).all(dim=1)
        same = float(rows.double().mean())
        scale = 1.0
        if "bias" in kw:
            fin = torch.isfinite(want[0])
            scale = float((want[0] + kw["bias"][want[1]])[fin].max())
        g_val, w_val = _by_id(got[1][rows], got[0][rows])[0], _by_id(want[1][rows],
                                                                    want[0][rows])[0]
        fin = torch.isfinite(w_val)
        err = float((g_val - w_val)[fin].abs().max()) if bool(fin.any()) else 0.0
        ok = same >= 0.99 and torch.equal(torch.isinf(g_val), torch.isinf(w_val)) and bool(
            ((g_val - w_val)[fin].abs() <= L1_TOL * scale + L1_TOL * w_val[fin].abs()).all())
        check = {"same_sets_share": same, "max_abs_err": err, "value_scale": scale}
        want_launch = ({"l1_topk": 1} if k <= l1_search.QUEUE_MAX
                       else {"l1_tile": -(-s // l1_search.TILE_BLOCK_Q)})
    else:
        near = torch.zeros(s, dtype=torch.int64, device=q.device)
        for r0 in range(0, s, l1_search.BLOCK_Q * 16):
            sc = l1_search.l1_tile_plain(q[r0:r0 + l1_search.BLOCK_Q * 16], cands,
                                         **{key: v for key, v in opts.items() if key != "self_col"})
            th = kw["thresh"][r0:r0 + len(sc), None]
            near[r0:r0 + len(sc)] = ((sc - th).abs() <= L1_TOL * th.abs()).sum(1)
        diff = (got - want).abs()
        ok = bool((diff <= near).all()) and int(want.sum()) > 0
        check = {"rows_equal_share": float((diff == 0).double().mean()),
                 "max_count_diff": int(diff.max()), "near_threshold_max": int(near.max())}
        err = float(diff.max())
        want_launch = {"l1_count": 1}
    again = kernel()
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again)) if entry == "topk" else \
        torch.equal(got, again)
    if not ok or not bitwise or launched != want_launch:
        raise AssertionError(f"l1_search ({name}): {check}, bit for bit {bitwise}, launches "
                             f"{launched} (expected {want_launch})")
    bound, bound_by = _l1_bound(entry, s, c, d, k, kw)
    below = k <= l1_search.QUEUE_MAX
    plan = _l1_plan(entry, q, cands, k) if below else None
    versus = (_l1_parent_case(entry, kernel, parent[entry], args, opts, got)
              if parent is not None and below else None)
    if versus is not None and not versus["bitwise"]:
        raise AssertionError(f"l1_search ({name}): the outputs differ from the parent "
                             f"kernel's ({versus})")
    clock = _smi_sample(kernel)
    ms = time_ms(kernel)
    # below the queue a call is one kernel, so a trace holding fewer device
    # events than calls lost records (its reading would be low): taken
    # again, and after three such traces the device time is not measured
    dev_ms, traces = None, []
    for _ in range(3 if k <= l1_search.QUEUE_MAX else 1):
        log = []
        reading = device_ms(kernel, iters=10, log=log)
        traces += log
        if k > l1_search.QUEUE_MAX or (log and log[-1]["device_events"] == log[-1]["calls"]):
            dev_ms = reading
            break
    out = dict(entry=entry, s=s, c=c, d=d, k=k, options=sorted(kw), **check,
               ms=ms, device_ms=dev_ms, device_traces=traces,
               ms_cold_l2=time_cold_ms(kernel, iters=3),
               plain_ms=time_ms(lambda: plain(*args, **opts), warmup=1, iters=2),
               bound_ms=bound, bound_by=bound_by, share_of_bound=ratio(bound, ms),
               share_of_bound_device=ratio(bound, dev_ms),
               library_ms=time_ms(lambda: _l1_library(entry, q, cands, k, kw), warmup=1,
                                  iters=2),
               library="torch.cdist(p=1), then torch.topk or a compare-and-sum",
               plan=plan, **clock, parent=versus)
    emit({"phase": "kernel", "kernel": "l1_search", "caller": name, **out,
          "bit_identical_runs": True, "card": smi})
    return out


def _l1_inputs(rng, entry: str, s: int, c: int, d: int, opts: dict, dev: torch.device):
    """Random rows and one caller's options (``phase_l1_search``'s)."""
    q = torch.from_numpy(rng.standard_normal((s, d)).astype(np.float32)).to(dev)
    cands = torch.from_numpy(rng.standard_normal((c, d)).astype(np.float32)).to(dev)
    kw = {}
    if opts.get("exclude"):
        kw["exclude"] = torch.from_numpy(rng.integers(0, c, s)).to(dev)
    if opts.get("mask"):
        kw["col_mask"] = torch.from_numpy(rng.random(c) >= 0.24).to(dev)
    if opts.get("csls"):
        kw["a"] = 2.0
        kw["bias"] = torch.from_numpy(
            (1.0 * d + 0.05 * d * rng.standard_normal(c)).astype(np.float32)).to(dev)
    if entry == "count":
        kw["self_col"] = (torch.arange(s, device=dev) if s == c
                          else torch.from_numpy(rng.integers(-1, c, s)).to(dev))
        own = kw["self_col"].clamp_min(0)
        elsewhere = torch.from_numpy(rng.standard_normal((s, d)).astype(np.float32)).to(dev)
        match = torch.where(kw["self_col"][:, None] >= 0, cands[own], elsewhere)
        d_true = pairwise_l1(q, match).float()
        kw["thresh"] = (2.0 * d_true - kw["bias"][own] if "bias" in kw
                        else d_true).contiguous()
    return q, cands, kw


def phase_l1_search(smi: str, dev: torch.device, parent_src: str | None = None) -> dict:
    """The L1 search's two entries on the card against their plain versions
    at each caller's shape (``L1_SHAPES``): random rows; the partner of
    query i at a random column; a mask of 24 % of the columns (the seed
    entities proposals skip); a CSLS bias near the rows' L1 hubness; for
    the counts each row's threshold its true match's score, as the eval's:
    the match at column i (aligned pools) or at a random column of the
    block, excluded by index, or (-1) outside the block, a row of its
    own.  With ``parent_src`` each shape also runs the kernel built from
    that directory (``_parent_l1``): outputs bit for bit, times in turns."""
    parent = _parent_l1(parent_src) if parent_src is not None else None
    rng = np.random.default_rng(8)
    out = {}
    t0 = time.perf_counter()
    for name, entry, s, c, d, k, opts in L1_SHAPES:
        q, cands, kw = _l1_inputs(rng, entry, s, c, d, opts, dev)
        out[name] = _l1_case(name, entry, q, cands, k, kw, smi, parent)
        del q, cands, kw
    emit({"phase": "l1_search", "cases": len(out), "phase_s": time.perf_counter() - t0,
          "card": smi})
    return out


def _recall(a: torch.Tensor, b: torch.Tensor) -> float:
    """Mean over rows of |set(a_i) ∩ set(b_i)| / |set(b_i)|."""
    a, b = a.cpu().numpy(), b.cpu().numpy()
    return float(np.mean([len(set(x) & set(y)) / len(set(y)) for x, y in zip(a, b)]))


def _same_rows(a: torch.Tensor, b: torch.Tensor) -> float:
    """The share of rows whose index sets are equal."""
    return float((a.sort(dim=1).values == b.sort(dim=1).values).all(dim=1).float().mean())


def _pair_set(pairs: torch.Tensor, w: torch.Tensor) -> set:
    return {tuple(r) for r in pairs[w > 0].tolist()}


def _timed(dev: torch.device, fn):
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


def _stage(dev, name: str, approx_fn, exact_fn, vs_plain, vs_exact) -> dict:
    """One approximate stage on the run's table, timed; the same call with
    every kernel swapped for its plain version (which must launch none);
    the exact stage, timed.  ``vs_plain`` and ``vs_exact`` are each
    (agreement(approx, other), floor)."""
    approx, approx_s = _timed(dev, approx_fn)
    with _plain_kernels():
        before = _launch_counts()
        plain = approx_fn()
        if _launch_counts() != before:
            raise AssertionError(f"{name}: the plain path launched a kernel")
    exact, exact_s = _timed(dev, exact_fn)
    (f_plain, plain_floor), (f_exact, exact_floor) = vs_plain, vs_exact
    a_plain, a_exact = f_plain(approx, plain), f_exact(approx, exact)
    if a_plain < plain_floor or a_exact < exact_floor:
        raise AssertionError(f"{name}: {a_plain} of the plain path (floor {plain_floor}), "
                             f"{a_exact} of the exact stage (floor {exact_floor})")
    return {"approx_s": approx_s, "exact_s": exact_s, "vs_plain": a_plain,
            "vs_plain_floor": plain_floor, "vs_exact": a_exact, "vs_exact_floor": exact_floor}


def _check_sq_mining64(emb, pairs, n1, n, k: int, dev) -> dict:
    """Exact sqeuclidean mining of the first 64 queries against a float64
    search: each returned id within 1e-5 of the distance scale of the
    float64 k-th nearest, and never the partner."""
    e_l = emb[pairs[:64, 0]]
    cand = emb[n1:n]
    excl = pairs[:64, 1] - n1
    got = blockwise_knn_l1(e_l, cand, excl, k, metric="sqeuclidean")
    d64 = torch.cdist(e_l.double(), cand.double()) ** 2
    d64[torch.arange(64, device=dev), excl] = float("inf")
    kth = d64.topk(k, dim=1, largest=False).values[:, -1:]
    eps = 1e-5 * d64[torch.isfinite(d64)].max()
    ok = bool((d64.gather(1, got) <= kth + eps).all()) and bool((got != excl[:, None]).all())
    if not ok:
        raise AssertionError("exact sqeuclidean mining disagrees with a float64 search")
    return {"queries": 64, "k": k, "ids_match_float64": _recall(got, d64.topk(
        k, dim=1, largest=False).indices)}


def phase_approx(task, smi: str, dev: torch.device, exact_stages: dict) -> dict:
    """Recipe v6 cut as phase 6, with approximate proposals, mining and
    history evals (every 2 epochs, shortlists of 128); the stage times
    beside phase 6's exact run; each approximate stage on the final table
    against the plain path and the exact stage, at the thresholds of the
    JAX package's tests; the serve CLI with --approx-k and --csls-k."""
    over = dict(boot_approx=True, neg_approx=True, eval_approx_k=128)
    cfg, reduced = _cut_config(task, "base", {**RECIPE_CUTS, "eval_every": 2}, RECIPE, **over)
    boundaries = (cfg.epochs - 1) // cfg.neg_every  # 2, 4, 6, 8
    evals = cfg.epochs // cfg.eval_every + 2  # 0, 2, 4, 6, 8, the last epoch, the final
    res, counts, run_s = _run_checked(cfg, task, dev, steps=cfg.epochs, forwards=boundaries,
                                      proposals=boundaries, minings=boundaries, evals=evals)
    if counts["shortlist_dist"] == 0:
        raise AssertionError("the approximate run never launched the shortlist kernel")
    t = res.timings
    hist = res.history
    final, last = res.metrics, hist[-1]
    if [r["epoch"] for r in hist] != [0, 2, 4, 6, 8, 9]:
        raise AssertionError(f"history evals at {[r['epoch'] for r in hist]}")
    stages = {**_stages(t), "history_eval_s": (t["eval_s"] - t["final_eval_s"]) / (evals - 1),
              "final_eval_s": t["final_eval_s"]}

    with torch.no_grad():
        emb = res.model.embed(res.op)
    n1, n = task.kg1.n_ent, task.n_ent
    pairs = torch.as_tensor(task.train_pairs, dtype=torch.int64, device=dev)
    mask1 = torch.ones(n1, dtype=torch.bool, device=dev)
    mask1[pairs[:, 0]] = False
    mask2 = torch.ones(n - n1, dtype=torch.bool, device=dev)
    mask2[pairs[:, 1] - n1] = False
    test = torch.as_tensor(task.test_pairs, dtype=torch.int64, device=dev)
    queries, candidates = task.test_pairs[:, 0], np.arange(n1, n)

    def mining(**kw):
        return lambda: torch.cat(sample_hard_negatives(emb, pairs, n1, n, cfg.k_neg, **kw), 1)

    def proposals(approx, csls_k):
        return lambda: propose_mutual_nn_pairs(emb, mask1, mask2, n1, n, cfg.boot_cap,
                                               csls_k=csls_k, approx=approx)

    def overlap(a, b):
        sa, sb = _pair_set(*a), _pair_set(*b)
        return len(sa & sb) / max(len(sb), 1)

    def ranks(approx_k, csls_k):
        return lambda: torch.stack(_both_direction_ranks(emb, test, csls_k=csls_k,
                                                         approx_k=approx_k))

    def metrics_gap(a, b):  # 1 − the largest gap in Hits@1/@10 and MRR
        return 1.0 - max(abs(x - y) for x, y in zip(_hits_of(a), _hits_of(b)))

    def same_ranks(a, b):  # the share of queries (both directions) with equal ranks
        return float((a == b).double().mean())

    def topk(approx_k, csls_k):
        return lambda: torch.as_tensor(topk_alignments(
            emb, queries, candidates, k=10, csls_k=csls_k, approx_k=approx_k)[1])

    # floors: the same sets (ranks, pairs) as the plain path on 99 % of rows;
    # against the exact stage, the JAX package's tests' thresholds
    # (tests/test_sparse_build.py:171, test_csls.py:75, test_bootstrap.py:107
    # and :137, test_eval_approx.py:41 (Hits@k and MRR within 0.02),
    # test_serve.py:133 and :163)
    plain_rows, plain_pairs, plain_ranks = (_same_rows, 0.99), (overlap, 0.99), (same_ranks, 0.99)
    quality = {
        "mining_cityblock": _stage(dev, "mining", mining(approx=True), mining(), plain_rows,
                                   (_recall, 0.8)),
        "mining_sqeuclidean_csls10": _stage(
            dev, "mining sq+CSLS", mining(metric="sqeuclidean", approx=True, csls_k=10),
            mining(metric="sqeuclidean", csls_k=10), plain_rows, (_recall, 0.8)),
        "proposals": _stage(dev, "proposals", proposals(True, 0), proposals(False, 0),
                            plain_pairs, (overlap, 0.7)),
        "proposals_csls10": _stage(dev, "proposals CSLS", proposals(True, 10),
                                   proposals(False, 10), plain_pairs, (overlap, 0.6)),
        "eval": _stage(dev, "eval", ranks(128, 0), ranks(0, 0), plain_ranks,
                       (metrics_gap, 0.98)),
        "eval_csls10": _stage(dev, "eval CSLS", ranks(128, 10), ranks(0, 10), plain_ranks,
                              (metrics_gap, 0.98)),
        "topk10": _stage(dev, "top-10", topk(128, 0), topk(0, 0), plain_rows, (_recall, 0.9)),
        "topk10_csls10": _stage(dev, "top-10 CSLS", topk(128, 10), topk(0, 10), plain_rows,
                                (_recall, 0.8)),
    }
    quality["sq_mining_float64"] = _check_sq_mining64(emb, pairs, n1, n, cfg.k_neg, dev)
    # where an approximate stage's time goes on the device (the run's own shapes)
    pairs_run = torch.cat([pairs, pairs[: cfg.boot_cap]])  # 7,000 rows, as the run mines
    split = {"proposal": _device_split(proposals(True, 0), dev),
             "mining": _device_split(lambda: sample_hard_negatives(
                 emb, pairs_run, n1, n, cfg.k_neg, approx=True), dev),
             "eval_csls": _device_split(ranks(cfg.eval_approx_k, cfg.eval_csls_k), dev),
             "topk10_csls": _device_split(topk(128, 10), dev)}
    # no stage holds a (4,096, C) selection tile: below one over the
    # smallest pool, the 10,500 test entities (164 MiB)
    tile_mb = 4096 * len(task.test_pairs) * 4 / 2**20
    if dev.type == "cuda" and any(v["peak_extra_mb"] >= tile_mb for v in split.values()):
        raise AssertionError(f"an approximate stage held a selection tile: {split}")

    # the serve CLI on the same table: it must print what the library call returns
    with tempfile.TemporaryDirectory() as tmp:
        save_embeddings(os.path.join(tmp, "emb.pt"), emb)
        np.savetxt(os.path.join(tmp, "q.txt"), queries, fmt="%d")
        np.savetxt(os.path.join(tmp, "c.txt"), candidates, fmt="%d")
        out = os.path.join(tmp, "al.tsv")
        cmd = [sys.executable, "-m", "tpugraph_torch.serve", "--emb", os.path.join(tmp, "emb.pt"),
               "--out", out, "--queries", os.path.join(tmp, "q.txt"), "--candidates",
               os.path.join(tmp, "c.txt"), "--k", "10", "--approx-k", "128", "--csls-k", "10",
               "--device", dev.type]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        cli_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"serve CLI failed: {proc.stderr[-2000:]}")
        lines = open(out).read().strip().splitlines()
    cli_ids = np.array([[int(cell.split(":")[0]) for cell in ln.split("\t")[1:]] for ln in lines])
    lib_ids = topk(128, 10)().numpy()
    cli_same = float((np.sort(cli_ids, 1) == np.sort(lib_ids, 1)).all(1).mean())
    if len(lines) != len(queries) or cli_same < 0.99:
        raise AssertionError(f"serve CLI: {len(lines)} rows, {cli_same} equal to the library's")

    beside = {k: {"approx": stages.get(k), "exact": exact_stages.get(k)}
              for k in ("step_median_s", "proposal_s", "mining_s")}
    beside["eval_csls_s"] = {"approx_history": stages["history_eval_s"],
                             "exact_final": stages["final_eval_s"],
                             "exact_v6_final": exact_stages["final_eval_s"]}
    beside["topk10_csls_s"] = {"approx": quality["topk10_csls10"]["approx_s"],
                               "exact": quality["topk10_csls10"]["exact_s"],
                               "exact_v6": exact_stages["topk_csls_s"]}
    emit({"phase": "approx", "recipe": RECIPE, "over": over, "epochs": cfg.epochs,
          "reduced": reduced, "losses": res.losses,
          "history": [{k: r[k] for k in ("epoch", "hits@1", "hits@10", "mrr")} for r in hist],
          "final_metrics_exact": {k: final[k] for k in ("hits@1", "hits@10", "mrr")},
          "last_history_approx": {k: last[k] for k in ("hits@1", "hits@10", "mrr")},
          "launches": counts, "timings": t, "run_s": run_s, "stages_s": stages,
          "stages_beside_exact_v6_s": beside, "quality": quality, "device_split": split,
          "serve_cli": {"rows": len(lines), "same_ids_as_library": cli_same, "wall_s": cli_s},
          "card": smi})
    return counts


# ---- the fused interval (steps_per_call = neg_every): a captured step ----

# device function names of the kernels, for counting launches in a profiler trace
KERNEL_SYMBOLS = {"gcn_fused": "gcn_fused_kernel", "spmm_ell": "spmm_ell_kernel",
                  "sinkhorn_fused": "sinkhorn_update_kernel",
                  "shortlist_dist": "shortlist_select_kernel",
                  "shortlist_gather": "shortlist_dist_kernel",
                  "spmm_sorted": "spmm_sorted_kernel", "margin_l1": "margin_l1_kernel",
                  "sinkhorn_reverse": "sinkhorn_reverse_kernel"}
# the fused phase's configs at zh-en scale: (config, recipe, overrides); v6
# with --fast's settings (steps_per_call = neg_every = 2, sqeuclidean
# approximate mining), highway with dropout 0.3 (neg_every 5), base
FUSED_CASES = {
    "v6_fast": ("base", "v6", dict(neg_metric="sqeuclidean", neg_approx=True)),
    "highway_dropout": ("highway", None, dict(dropout=0.3)),
    "base": ("base", None, {}),
    "sinkhorn": ("sinkhorn", None, {}),
    "mtl_channel": ("mtl", None, dict(use_attr_channel=True)),
    "v6_bf16": ("base", "v6", dict(param_dtype="bfloat16")),
    "base_sorted": ("base", None, dict(spmm_impl="sorted")),
}
REPLAY_TOL = 1e-6  # each step's loss (rel) and the parameters (rel L2) after an interval


def _fused_config(task, name: str) -> TrainConfig:
    config, recipe, over = FUSED_CASES[name]
    cfg = get_config(config, **(RECIPES[recipe] if recipe else {})).replace(
        syn_n_ent=task.kg1.n_ent, syn_n_rel=task.kg1.n_rel, syn_seed=ZH_EN["seed"], **over)
    return cfg.replace(steps_per_call=cfg.neg_every)


def _per_step_launches(cfg) -> dict:
    """The kernels' launches in one training step, the model the traces
    are held to (AlignGCN: two fused layers forward, two SpMMs backward;
    AlignMTL: ``_mtl_step_launches``)."""
    if uses_mtl(cfg):
        return _mtl_step_launches(cfg)
    fused, unfused = _layer_routes(cfg)
    return _sorted_launches(cfg, {"gcn_fused": fused, "spmm_ell": fused + 2 * unfused,
                                  "sinkhorn_fused": 0,
                                  "shortlist_dist": 0, "shortlist_gather": 0, **L1_NONE,
                                  **_loss_launches(cfg, 1)})


def _traced_launches(fn, dev: torch.device, what: str, warm=None) -> tuple:
    """``fn()`` under torch.profiler (CPU and CUDA activities): its result,
    each kernel's launches on the device in the trace, by device symbol,
    the device events of every kind (the padding and the step annotation
    left out), and the first device events' names.  The trace's window
    opens after a warm-up cycle, which runs ``warm()``: run after this
    script's earlier phases, a trace of a graph's first replay in its
    session lost that replay's first kernels' records (two of a replayed
    v6 interval's four ``gcn_fused``; the cause is not known), and a
    replay in the warm-up cycle keeps them.  ``fn`` starts 20 ms
    and a spinning kernel into the window.  Raises when the trace holds
    no device event or no kernel of KERNEL_SYMBOLS."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def pad():
        sync(dev)
        time.sleep(0.02)
        torch.cuda._sleep(1_000_000)  # "spin_kernel", about 0.5 ms
        sync(dev)

    with torch.profiler.profile(activities=acts, schedule=torch.profiler.schedule(
            wait=0, warmup=1, active=1)) as prof:
        pad()
        if warm is not None:
            warm()
            pad()
        prof.step()  # the warm-up cycle ends; the traced one follows
        pad()
        out = fn()
        pad()
    traced, events = {k: 0 for k in KERNEL_SYMBOLS}, []
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.name
                and not e.name.startswith("ProfilerStep")):
            events.append((e.time_range.start, e.name))
            for k, sym in KERNEL_SYMBOLS.items():
                if sym in e.name:
                    traced[k] += 1
    first = [name[:60] for _, name in sorted(events)[:8]]
    if not events or not any(traced.values()):
        raise AssertionError(f"{what}: the trace holds {len(events)} device events and no "
                             f"launch of {sorted(KERNEL_SYMBOLS)}")
    return out, traced, len(events), first


def _interval_replay(task, name: str, dev: torch.device, busy: bool) -> dict:
    """One interval of ``cfg``, from the trainer's own model, loss and
    epoch-0 batch (``driver.step_parts``, ``loop.first_batch``), three
    ways: replays of the captured step (capturable Adam), the same
    ``train_step``s eager with the same Adam, and eager with the unfused
    path's Adam.  Each step's loss and the parameters after the interval:
    the replays are held to the eager steps of the same Adam within
    REPLAY_TOL, and their distance to the unfused Adam is read.  The
    warm-up step's and the capture's launches are counted through the
    wrappers; the replays' launches on the device are read from a
    profiler trace of one more interval and must equal its steps times
    the step's launches.  With ``busy``, the device's busy share of one
    replayed interval beside that of one unfused interval."""
    cfg = _fused_config(task, name)
    steps = cfg.steps_per_call
    parts = step_parts(cfg, task, dev)
    model, batch = parts.model, first_batch(cfg, task, parts, dev)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def eager(capturable):
        model.load_state_dict(init)
        opt, sched = make_optimizer(cfg, model.parameters(), capturable=capturable)
        losses = []

        def interval():
            for e in range(steps):
                gen = step_generator(cfg, e, dev) if cfg.dropout > 0 else None
                losses.append(train_step(opt, parts.loss_fn, batch, gen)[0])
                sched.step()

        interval()
        sync(dev)
        return [float(v) for v in losses], {k: v.detach().clone() for k, v in
                                            model.state_dict().items()}, interval

    want, want_p, _ = eager(True)
    plain, plain_p, plain_interval = eager(False)
    model.load_state_dict(init)
    opt, sched = make_optimizer(cfg, model.parameters(), capturable=True)
    _reset_launch_counts()
    t0 = time.perf_counter()
    cap = CapturedStep(opt, parts.loss_fn, batch, dev, cfg.dropout > 0)
    sync(dev)
    capture_s = time.perf_counter() - t0
    capture_counts = _launch_counts()  # the warm-up step's and the capture's

    def replayed():
        out = []
        for e in range(steps):
            out.append(cap.replay(step_seed(cfg, e)))
            sched.step()
        return out

    _reset_launch_counts()
    got = [float(v) for v in replayed()]
    sync(dev)
    if any(_launch_counts().values()):
        raise AssertionError(f"a replay went through a wrapper: {_launch_counts()}")
    got_p = {k: v.detach().clone() for k, v in model.state_dict().items()}

    def rel_l2(a, b):
        return max(float((a[k] - b[k]).norm() / b[k].norm().clamp_min(1e-30)) for k in b)

    loss_rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    param_rel = rel_l2(got_p, want_p)
    if loss_rel > REPLAY_TOL or param_rel > REPLAY_TOL or not all(map(math.isfinite, got)):
        raise AssertionError(f"{name}: replayed interval against eager: losses {got} / "
                             f"{want} (rel {loss_rel}), parameters rel L2 {param_rel}")
    per_step = _per_step_launches(cfg)
    if capture_counts != {k: 2 * v for k, v in per_step.items()}:
        raise AssertionError(f"{name}: warm-up and capture launched {capture_counts}, "
                             f"expected twice {per_step}")
    # the replays' launches on the device, from a trace of one more interval
    _, traced, every, first = _traced_launches(replayed, dev, f"{name}: a replayed interval",
                                               warm=replayed)
    want_traced = {k: steps * per_step[k] for k in KERNEL_SYMBOLS}
    if traced != want_traced:
        raise AssertionError(f"{name}: the trace of a replayed interval holds {traced}, "
                             f"{steps} steps launch {want_traced}; its first events {first}")
    out = {"config": cfg.name, "dim": cfg.dim, "steps": steps, "dropout": cfg.dropout,
           "losses_replayed": got, "losses_eager": want, "losses_eager_unfused_adam": plain,
           "loss_rel_err": loss_rel, "params_rel_l2": param_rel,
           "bitwise": got == want and all(torch.equal(got_p[k], want_p[k]) for k in want_p),
           "loss_rel_vs_unfused_adam": max(abs(g - w) / abs(w) for g, w in zip(got, plain)),
           # per parameter: a bias whose gradient is 0 by construction (the
           # margin reads differences of rows) takes Adam steps of rounding
           # noise, so its relative distance is large and means nothing
           "params_rel_l2_vs_unfused_adam": {
               k: float((got_p[k] - v).norm() / v.norm().clamp_min(1e-30))
               for k, v in plain_p.items()},
           "capture_s": capture_s, "warm_up_and_capture_launches": capture_counts,
           "replayed_interval_traced": {"launches": traced,
                                        "device_events_per_step": every / steps}}
    if busy:
        model.load_state_dict(init)
        out["busy"] = {"replayed": _device_split(replayed, dev, top=4),
                       "unfused": _device_split(plain_interval, dev, top=4)}
    return out


def _steady_step(t: dict) -> float:
    """Median step wall of a run, its first interval (or step) left out."""
    return float(np.median(t["step_s"][1:]))


def _fused_run_pair(task, name: str, dev: torch.device, cuts: dict) -> dict:
    """The same run unfused and fused through driver.run: the steady step
    wall of each, and the wrappers' launches held to the model.  Then the
    fused run once more under torch.profiler: its launches on the device
    (eager, warm-up step, replays) as the trace holds them."""
    config, recipe, over = FUSED_CASES[name]
    cfg, reduced = _cut_config(task, config, cuts, recipe, **over)
    fused_cfg = cfg.replace(steps_per_call=cfg.neg_every)
    per_step = _per_step_launches(cfg)
    out = {"reduced": reduced}
    for mode, c in (("unfused", cfg), ("fused", fused_cfg)):
        _reset_launch_counts()
        t0 = time.perf_counter()
        res = run(c, task=task, device=dev)
        sync(dev)
        run_s = time.perf_counter() - t0
        counts, t = _launch_counts(), res.timings
        if mode == "fused":  # the eager launches, the warm-up step's and the capture's
            eager = _expected_launches(c, {**t, "steps": 0}, task)
            expected = {k: eager[k] + 2 * per_step[k] for k in eager}
        else:
            expected = _expected_launches(c, t, task)
        if counts != expected:
            raise AssertionError(f"{name} {mode}: launches {counts}, expected {expected}")
        if not all(map(math.isfinite, res.losses)) or not res.losses[-1] < res.losses[0]:
            raise AssertionError(f"{name} {mode}: losses not finite or not falling")
        out[mode] = {"res": res, "cfg": c, "run_s": run_s, "launches_device": counts,
                     "steady_step_s": _steady_step(t)}
    # the fused run traced: the replays pass through no wrapper, so the
    # trace counts them; the wrappers' counts of this run (eager, warm-up
    # step, capture) must account for it, each replay launching what the
    # capture recorded
    _reset_launch_counts()
    res, traced, _, first = _traced_launches(lambda: run(fused_cfg, task=task, device=dev),
                                             dev, f"{name}: the fused run")
    counts = _launch_counts()
    want = {k: counts[k] + (res.timings["steps"] - 1) * per_step[k] for k in KERNEL_SYMBOLS}
    if traced != want:
        raise AssertionError(f"{name}: the traced fused run launched {traced} on the device, "
                             f"its wrappers counted {counts}: expected {want}; its first "
                             f"events {first}")
    final = out["fused"]["res"].metrics["final_loss"]
    if abs(res.metrics["final_loss"] - final) > 1e-4 * abs(final):
        raise AssertionError(f"{name}: the traced fused run ended at loss "
                             f"{res.metrics['final_loss']}, the untraced one at {final}")
    out["fused"]["launches_device"] = traced
    return out


def _summary(pair: dict) -> dict:
    return {mode: {"losses": p["res"].losses, "run_s": p["run_s"],
                   "steady_step_s": p["steady_step_s"], "timings": p["res"].timings,
                   "launches_device": p["launches_device"],
                   "metrics": {k: p["res"].metrics[k] for k in ("hits@1", "hits@10", "mrr")}}
            for mode, p in pair.items() if mode != "reduced"}


def phase_fused(task, smi: str, dev: torch.device) -> dict:
    """The fused interval at zh-en scale: one interval of each FUSED_CASES
    config replayed against eager; recipe v6 with --fast's settings (cut as
    RECIPE_CUTS) fused against unfused through driver.run; base and
    highway with dropout likewise (the steady step wall of each); a fused
    run stopped by SIGTERM and resumed at its interval boundary, and a
    mid-interval checkpoint refused."""
    replay = {name: _interval_replay(task, name, dev, busy=name in ("v6_fast", "highway_dropout",
                                                                      "base"))
              for name in FUSED_CASES}
    v6 = _fused_run_pair(task, "v6_fast", dev, RECIPE_CUTS)
    want, got = v6["unfused"]["res"], v6["fused"]["res"]
    loss_rel = abs(got.metrics["final_loss"] - want.metrics["final_loss"]) / abs(
        want.metrics["final_loss"])
    hits_diff = abs(got.metrics["hits@1"] - want.metrics["hits@1"])
    if loss_rel > 1e-4 or hits_diff > 0.01:
        raise AssertionError(f"v6 --fast fused against unfused: final loss rel {loss_rel}, "
                             f"Hits@1 {got.metrics['hits@1']} against {want.metrics['hits@1']}")
    cuts = {"epochs": 20, "eval_every": 0}
    base, highway = (_fused_run_pair(task, n, dev, cuts) for n in ("base", "highway_dropout"))

    # resume: base fused, stopped by SIGTERM during epoch 7 (the interval
    # [5, 10)): it saves at 9 and stops; the relaunch starts at 10 and ends
    # as the uninterrupted fused run
    whole = base["fused"]["res"]
    fused_cfg = base["fused"]["cfg"]
    with tempfile.TemporaryDirectory() as tmp:
        with _sigterm_in_replay(8):
            killed = run(fused_cfg.replace(checkpoint_dir=tmp, checkpoint_every=100), task=task,
                         device=dev)
        killed_at = Checkpointer(tmp, 100).latest_step()
        resumed = run(fused_cfg.replace(checkpoint_dir=tmp, checkpoint_every=100), task=task,
                      device=dev)
        resume_rel = abs(resumed.metrics["final_loss"] - whole.metrics["final_loss"]) / abs(
            whole.metrics["final_loss"])
        if (killed.timings["steps"] != 10 or killed_at != 9
                or resumed.timings["start_epoch"] != 10 or resume_rel > 1e-4):
            raise AssertionError(f"fused resume: killed after {killed.timings['steps']} steps, "
                                 f"saved at {killed_at}, resumed at "
                                 f"{resumed.timings['start_epoch']}, final loss rel {resume_rel}")
    with tempfile.TemporaryDirectory() as tmp:
        plain_cfg = fused_cfg.replace(steps_per_call=1, checkpoint_dir=tmp, checkpoint_every=3,
                                      epochs=4)
        run(plain_cfg, task=task, device=dev)  # saves at 3: the next epoch is 4, mid-interval
        try:
            run(plain_cfg.replace(steps_per_call=5, epochs=20), task=task, device=dev)
            raise AssertionError("a mid-interval checkpoint was resumed by a fused run")
        except ValueError as e:
            if "mid-interval" not in str(e):
                raise
            refused = str(e)[:80]

    steady = {n: {"unfused_s": p["unfused"]["steady_step_s"],
                  "fused_s": p["fused"]["steady_step_s"],
                  "fused_over_unfused": p["fused"]["steady_step_s"] / p["unfused"]["steady_step_s"]}
              for n, p in (("v6_fast", v6), ("base", base), ("highway_dropout", highway))}
    emit({"phase": "fused", "n_ent": task.n_ent, "replay_tol": REPLAY_TOL,
          "interval_replay": replay, "steady_step": steady,
          "v6_fast": {"reduced": v6["reduced"], "final_loss_rel": loss_rel,
                      "hits1_diff": hits_diff, **_summary(v6)},
          "base": {"reduced": base["reduced"], **_summary(base)},
          "highway_dropout": {"reduced": highway["reduced"], **_summary(highway)},
          "resume": {"killed_after_steps": killed.timings["steps"], "saved_at": killed_at,
                     "resumed_at": resumed.timings["start_epoch"],
                     "final_loss": resumed.metrics["final_loss"],
                     "uninterrupted_final_loss": whole.metrics["final_loss"],
                     "rel_err": resume_rel, "mid_interval_refused": refused},
          "card": smi})
    return {"v6_fast": v6["fused"]["launches_device"],
            "base": base["fused"]["launches_device"],
            "highway_dropout": highway["fused"]["launches_device"],
            "replayed_interval": {n: r["replayed_interval_traced"]["launches"]
                                  for n, r in replay.items()}}


@contextlib.contextmanager
def _sigterm_in_replay(n: int):
    """Send this process SIGTERM during the n-th replay of a captured step
    (a fused run's n-th training step on the card), as a scheduler
    preempts a run."""
    real, calls = CapturedStep.replay, [0]

    def replay(self, *args, **kwargs):
        calls[0] += 1
        if calls[0] == n:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(self, *args, **kwargs)

    CapturedStep.replay = replay
    try:
        yield
    finally:
        CapturedStep.replay = real


def phase_profile(task, smi: str, dev: torch.device) -> dict:
    """``profile_dir`` on a 6-epoch base run (the trace of epochs 2-5 it
    writes, and the top device operations in it), and on a fused
    ``sinkhorn`` run through ``fit_mtl`` (``steps_per_call`` = 5, 10 epochs:
    the trace of the two intervals that hold epochs 2-5, taken around the
    captured step's replays, must hold its kernels)."""
    fused_cfg, _ = _cut_config(task, "sinkhorn", {"epochs": 10, "eval_every": 0})
    cases = (("base", *_cut_config(task, "base", {"epochs": 6, "eval_every": 0}),
              "trace-epochs-2-5.json", ("gcn_fused",)),
             ("sinkhorn_fused", fused_cfg.replace(steps_per_call=fused_cfg.neg_every),
              {"epochs": "10 (config sinkhorn: 400)"},
              f"trace-epochs-0-{2 * fused_cfg.neg_every - 1}.json",
              ("gcn_fused", "spmm_ell", "sinkhorn_fused")))
    out, top = {}, {}
    for name, cfg, reduced, want, kernels in cases:
        with tempfile.TemporaryDirectory() as tmp:
            res = run(cfg.replace(profile_dir=tmp), task=task, device=dev)
            files = sorted(os.listdir(tmp))
            if files != [want]:
                raise AssertionError(f"{name}: profile_dir holds {files}, not {want}")
            size_mb = os.path.getsize(os.path.join(tmp, files[0])) / 2**20
            with open(os.path.join(tmp, files[0])) as f:
                events = json.load(f)["traceEvents"]
        by_name: dict[str, list] = {}
        for e in events:
            if e.get("cat") == "kernel":
                by_name.setdefault(e["name"][:80], []).append(e.get("dur", 0.0))
        for k in kernels:
            if not any(KERNEL_SYMBOLS[k] in n for n in by_name):
                raise AssertionError(f"{name}: the trace holds no {k} kernel: "
                                     f"{sorted(by_name)[:10]}")
        top[name] = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]
        out[name] = {"config": cfg.name, "epochs": cfg.epochs,
                     "steps_per_call": cfg.steps_per_call, "reduced": reduced,
                     "trace": files[0], "trace_mb": size_mb, "steps": res.timings["steps"],
                     "capture_s": res.timings["capture_s"],
                     "kernel_events": sum(len(v) for v in by_name.values()),
                     "top_device_ops_ms": {k: {"ms": sum(v) / 1e3, "calls": len(v)}
                                           for k, v in top[name]}}
    emit({"phase": "profile", **out, "card": smi})
    return {k: len(v) for k, v in top["base"]}


def _write_dbp15k(task, root: str) -> None:
    """``task`` as a DBP15K directory ``<root>/zh_en``: global ids (KG2's
    after KG1's), integer triples and attributes, the seed pairs in
    ``ref_ent_ids`` and the training ones in ``sup_ent_ids``."""
    d = os.path.join(root, "zh_en")
    os.makedirs(d)
    n1 = task.kg1.n_ent

    def write(name, rows):
        with open(os.path.join(d, name), "w") as f:
            f.write("".join("\t".join(map(str, r)) + "\n" for r in rows))

    write("ent_ids_1", ((i, f"http://kg1/e{i}") for i in range(n1)))
    write("ent_ids_2", ((n1 + i, f"http://kg2/e{i}") for i in range(task.kg2.n_ent)))
    write("triples_1", task.kg1.triples.tolist())
    write("triples_2", (task.kg2.triples + [n1, 0, n1]).tolist())
    write("ref_ent_ids", np.concatenate([task.train_pairs, task.test_pairs]).tolist())
    write("sup_ent_ids", task.train_pairs.tolist())
    write("att_triples_1", task.kg1.attr_triples.tolist())
    write("att_triples_2", (task.kg2.attr_triples + [n1, 0]).tolist())


def _write_openea(task, root: str) -> None:
    """``task`` as an OpenEA directory: URI triples, property-URI
    attributes, ``ent_links`` and the split as ``721_5fold/1``."""
    n1 = task.kg1.n_ent
    fold = os.path.join(root, "721_5fold", "1")
    os.makedirs(fold)

    def write(path, rows):
        with open(os.path.join(root, path), "w") as f:
            f.write("".join("\t".join(r) + "\n" for r in rows))

    for side, kg in ((1, task.kg1), (2, task.kg2)):
        write(f"rel_triples_{side}", ((f"kg{side}/e{h}", f"kg{side}/r{r}", f"kg{side}/e{t}")
                                      for h, r, t in kg.triples.tolist()))
        write(f"attr_triples_{side}", ((f"kg{side}/e{e}", f"prop/a{a}", '"v"')
                                       for e, a in kg.attr_triples.tolist()))

    def links(pairs):
        return ((f"kg1/e{a}", f"kg2/e{b - n1}") for a, b in pairs.tolist())

    write("ent_links", links(np.concatenate([task.train_pairs, task.test_pairs])))
    write("721_5fold/1/train_links", links(task.train_pairs))
    write("721_5fold/1/test_links", links(task.test_pairs))


def _first_seen(ids) -> dict:
    return {v: i for i, v in enumerate(dict.fromkeys(ids))}


def _check_openea(task, got) -> None:
    """The OpenEA reader's arrays against ``task`` renumbered as the format
    numbers it: entities and relations in first-seen order (an entity's
    triples, then the links), attributes by frequency over both KGs, ties
    by URI."""
    n1 = task.kg1.n_ent
    ents = [_first_seen(np.concatenate([kg.triples[:, [0, 2]].reshape(-1), side]).tolist())
            for kg, side in ((task.kg1, np.concatenate([task.train_pairs, task.test_pairs])[:, 0]),
                             (task.kg2, np.concatenate([task.train_pairs,
                                                        task.test_pairs])[:, 1] - n1))]
    # attribute rows of entities the format cannot name (in no triple and
    # no link) are dropped, as the reader drops them
    attrs = [[(e, a) for e, a in kg.attr_triples.tolist() if e in ent]
             for kg, ent in ((task.kg1, ents[0]), (task.kg2, ents[1]))]
    freq = {}
    for e, a in attrs[0] + attrs[1]:
        freq[a] = freq.get(a, 0) + 1
    vocab = {a: i for i, a in enumerate(sorted(freq, key=lambda a: (-freq[a], f"prop/a{a}")))}
    for kg, have, ent, att in ((task.kg1, got.kg1, ents[0], attrs[0]),
                               (task.kg2, got.kg2, ents[1], attrs[1])):
        rel = _first_seen(kg.triples[:, 1].tolist())
        want = np.array([[ent[h], rel[r], ent[t]] for h, r, t in kg.triples.tolist()])
        np.testing.assert_array_equal(have.triples, want)
        np.testing.assert_array_equal(have.attr_triples, [[ent[e], vocab[a]] for e, a in att])
        if have.n_ent != len(ent) or have.n_attr != len(vocab):
            raise AssertionError(f"OpenEA: {have.n_ent} entities, {have.n_attr} attributes")
    m1 = len(ents[0])
    for have, pairs in ((got.train_pairs, task.train_pairs), (got.test_pairs, task.test_pairs)):
        np.testing.assert_array_equal(
            have, [[ents[0][a], ents[1][b - n1] + m1] for a, b in pairs.tolist()])


def phase_readers(task, smi: str, dev: torch.device) -> dict:
    """``task`` written as a DBP15K and as an OpenEA directory, read back by
    the port's readers and held to the task (the load timed), then the
    trainer CLI on the DBP15K directory for 2 epochs on the card."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _write_dbp15k(task, tmp)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = load_dbp15k(tmp, "zh_en")
        load_s = time.perf_counter() - t0
        rel = [np.unique(kg.triples[:, 1], return_inverse=True)[1] for kg in (task.kg1, task.kg2)]
        for kg, have, r in ((task.kg1, got.kg1, rel[0]), (task.kg2, got.kg2, rel[1])):
            np.testing.assert_array_equal(have.triples, np.column_stack(
                [kg.triples[:, 0], r, kg.triples[:, 2]]))
            np.testing.assert_array_equal(have.attr_triples, kg.attr_triples)
        for name in ("train_pairs", "test_pairs"):
            np.testing.assert_array_equal(getattr(got, name), getattr(task, name))
        out["dbp15k"] = {"write_s": write_s, "load_s": load_s, "n_ent": got.n_ent,
                         "triples": int(len(got.merged_triples)), "n_attr": got.n_attr,
                         "train_pairs": int(len(got.train_pairs)),
                         "test_pairs": int(len(got.test_pairs))}

        root = os.path.dirname(os.path.abspath(__file__))
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "tpugraph_torch.cli.main", "--dataset", "dbp15k",
             "--data-root", tmp, "--pair", "zh_en", "--epochs", "2", "--quiet",
             "--device", dev.type],
            cwd=root, env={**os.environ, "PYTHONPATH": root}, capture_output=True, text=True,
            timeout=600)
        cli_s = time.perf_counter() - t0
        if cli.returncode != 0:
            raise AssertionError(f"the CLI on the DBP15K directory failed:\n{cli.stderr[-3000:]}")
        line = json.loads(cli.stdout.strip().splitlines()[-1])
        if not math.isfinite(line["final_loss"]):
            raise AssertionError(f"the CLI printed {line}")
        out["cli"] = {"argv": "--dataset dbp15k --pair zh_en --epochs 2", "wall_s": cli_s,
                      "result": line}

        d = os.path.join(tmp, "openea")
        t0 = time.perf_counter()
        _write_openea(task, d)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = load_openea(d, fold=1)
        load_s = time.perf_counter() - t0
        _check_openea(task, got)
        out["openea"] = {"write_s": write_s, "load_s": load_s, "n_ent": got.n_ent,
                         "triples": int(len(got.merged_triples)), "n_attr": got.n_attr,
                         "train_pairs": int(len(got.train_pairs)),
                         "test_pairs": int(len(got.test_pairs))}
    emit({"phase": "readers", **out, "card": smi})
    return out


def _csr_of_edges(edges) -> torch.Tensor:
    """A sorted edge list's real edges as one CSR tensor on its device (each
    row's columns sorted: a shard's edge group is sorted by dst alone): the
    library yardstick's operand, built here only."""
    nnz = edges.nnz
    dst = edges.dst[:nnz].cpu().numpy().astype(np.int64)
    src = edges.src[:nnz].cpu().numpy().astype(np.int64)
    order = np.lexsort((src, dst))
    crow = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=edges.n_rows))])
    with warnings.catch_warnings():  # CSR support is "beta" in PyTorch
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.from_numpy(crow), torch.from_numpy(src[order]),
            edges.w[:nnz].cpu()[torch.from_numpy(order)],
            size=(edges.n_rows, edges.n_cols), check_invariants=True).to(edges.device)


# the sorted kernel against its plain version: fp32, the sums in another
# order; bf16, both sum in fp32 and round once, so one bf16 ulp apart
SORTED_TOL = {torch.float32: TOL[torch.float32],
              torch.bfloat16: dict(rtol=2 ** -7, atol=1e-3)}


def _sorted_split(edges, x, deg: np.ndarray) -> dict:
    """The kernel's device time on parts of its work table: the items of
    rows of degree ≥ 256 (only a cut row's segments hold such a row, and
    every segment of one falls on this side) and the rest (the output rows
    outside the part are left unwritten; only the time is read)."""
    plan = spmm_mod.segment_plan(edges)
    hub = torch.from_numpy(deg >= 256).to(plan.items.device)[plan.items[:, 0].long()]
    parts = {name: dataclasses.replace(plan, items=plan.items[sub].contiguous())
             for name, sub in (("deg_ge_256", hub), ("deg_lt_256", ~hub))}
    return {name: {"items": int(part.items.shape[0]),
                   "device_ms": device_ms(lambda part=part: spmm_mod._launch(edges, x, part))}
            for name, part in parts.items()}


def _sorted_case(edges, csr, x: torch.Tensor, timed: bool) -> dict:
    """The sorted kernel on one edge list and input: held to its plain
    version at SORTED_TOL and bit-identical over two launches; if
    ``timed``, its time beside the plain version, ``torch.sparse.mm`` on
    the CSR of the same matrix (or its refusal) and the bound."""
    dtype, d = x.dtype, x.shape[1]
    got = sorted_spmm(edges, x)
    sync(x.device)
    want = segment_spmm(edges, x)
    torch.testing.assert_close(got.float(), want.float(), **SORTED_TOL[dtype])
    if not torch.equal(got, sorted_spmm(edges, x)):
        raise AssertionError(f"spmm_sorted ({edges.n_rows} rows, d {d}): two launches differ")
    r = {"max_abs_err": float((got.float() - want.float()).abs().max())}
    if not timed:
        return r
    r["ms"] = time_ms(lambda: sorted_spmm(edges, x))
    r["device_ms"] = device_ms(lambda: sorted_spmm(edges, x))
    r["ms_cold_l2"] = time_cold_ms(lambda: sorted_spmm(edges, x))
    r["plain_ms"] = time_ms(lambda: segment_spmm(edges, x), iters=5)
    r["library_ms"] = r["library_device_ms"] = r["library_refused"] = None
    try:
        a_lib = csr.to(dtype)
        lib = torch.sparse.mm(a_lib, x)
    except RuntimeError as e:  # a refusal of bf16 by the library
        r["library_refused"] = str(e).splitlines()[0][:200]
    if r["library_refused"] is None:
        torch.testing.assert_close(lib.float(), want.float(), **TOL[dtype])
        r["library_ms"] = time_ms(lambda: torch.sparse.mm(a_lib, x))
        r["library_device_ms"] = device_ms(lambda: torch.sparse.mm(a_lib, x))
    # the rows of x the edges read and the output once, the real edges'
    # (src, dst, w) once; 2 operations per edge and column
    x_rows = int(torch.unique(edges.src[:edges.nnz]).numel())
    nbytes = (x_rows + edges.n_rows) * d * x.element_size() + edges.nnz * 12
    r["bound_ms"], r["bound_by"] = _bound(nbytes, 2 * edges.nnz * d)
    r["x_rows_read"] = x_rows
    r["share_of_bound_device"] = ratio(r["bound_ms"], r["device_ms"])
    return r


def _sorted_table(edges) -> tuple[dict, np.ndarray]:
    """The edge list's degrees and its work table's shape."""
    plan = spmm_mod.segment_plan(edges)
    deg = np.bincount(edges.dst[:edges.nnz].cpu().numpy(), minlength=edges.n_rows)
    items = plan.items.cpu().numpy()
    return {"rows": edges.n_rows, "cols": edges.n_cols, "nnz": edges.nnz,
            "max_degree": int(deg.max()), "rows_deg_0": int((deg == 0).sum()),
            "rows_deg_ge_256": int((deg >= 256).sum()),
            "edges_in_rows_deg_ge_256": int(deg[deg >= 256].sum()), "seg_cap": SEG_EDGES,
            "work_items": int(items.shape[0]), "cut_rows": int(plan.split_p0.shape[0] - 1),
            "partials": plan.n_partials,
            "longest_item_edges": int((items[:, 3] - items[:, 2]).max(initial=0))}, deg


def phase_sorted_kernel(task, smi: str, dev: torch.device) -> dict:
    """The sorted-segment SpMM kernel on the zh-en adjacency as
    ``spmm_impl="sorted"`` builds it (self-loops as edges): A (the layers'
    forward) and Aᵀ (their backward), fp32 and bf16 at d = 128 and 256,
    held to its plain version and bit-identical over two launches; timed at
    d = 128 (config base's width) beside its bound and ``torch.sparse.mm``
    on the CSR of the same matrix, with the device time of the work items
    of rows of degree ≥ 256 alone and of the rest (A, fp32).  Then the same
    on the attribute channel's incidence and its transpose
    (``fmt="sorted"``, where config mtl runs it under ``spmm_impl``
    sorted), timed at d = 128 and 256."""
    t0 = time.perf_counter()
    op = build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel, fmt="sorted").to(dev)
    sync(dev)
    build_s = time.perf_counter() - t0
    inc = build_attr_operator(task.merged_attr_triples, task.n_ent, task.n_attr,
                              fmt="sorted").to(dev)
    rng = np.random.default_rng(4)
    out = {"build_s": build_s, "edges": op.nnz, "padded_edges": op.fwd.e_pad}
    for name, edges in (("forward", op.fwd), ("transpose", op.bwd),
                        ("incidence", inc.fwd), ("incidence_transpose", inc.bwd)):
        t0 = time.perf_counter()
        out[name], deg = _sorted_table(edges)
        out[name]["plan_s"] = time.perf_counter() - t0
        csr = _csr_of_edges(edges)
        for d in (128, 256):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.from_numpy(rng.standard_normal((edges.n_cols, d)).astype(np.float32))
                x = x.to(dev, dtype)
                r = _sorted_case(edges, csr, x,
                                 timed=d == 128 or name.startswith("incidence"))
                if name == "forward" and d == 128 and dtype == torch.float32:
                    split = _sorted_split(edges, x, deg)
                    r["split_items"] = {k: v["items"] for k, v in split.items()}
                    r["split_device_ms"] = {k: v["device_ms"] for k, v in split.items()}
                    r["host_ms"] = host_ms(lambda: sorted_spmm(edges, x))
                out[name][f"{str(dtype).split('.')[1]}_d{d}"] = r
    emit({"phase": "kernel", "kernel": "spmm_sorted", **out, "card": smi})
    return out


def _step_ms(model, loss_fn) -> float:
    """CUDA-event time of one forward + backward of ``loss_fn(model)``."""
    def fb():
        model.zero_grad(set_to_none=True)
        loss_fn(model).backward()

    return time_ms(fb, warmup=2, iters=10)


def _step_vs_fp32(model, loss_fn, cfg, make) -> dict:
    """The forward + backward of a bf16 model against an fp32 model of the
    same parameters (``make(cfg32)`` builds it), in turns fp32, bf16, bf16,
    fp32."""
    m32 = make(cfg.replace(param_dtype="float32"))
    m32.load_state_dict(model.state_dict())
    t = [_step_ms(m, loss_fn) for m in (m32, model, model, m32)]
    return {"fp32_ms": [t[0], t[3]], "bf16_ms": [t[1], t[2]],
            "bf16_over_fp32": (t[1] + t[2]) / (t[0] + t[3])}


def phase_bf16(task, smi: str, dev: torch.device) -> dict:
    """bf16 training (``param_dtype="bfloat16"``): recipe v6 at dim 256 cut
    as phase 6 is (RECIPE_CUTS; gcn_fused bf16 (256, 256), spmm_ell bf16
    d = 256, sinkhorn_fused on the fp32 output), then config base at dim
    128 for 20 epochs as phase 12 runs it (the (128, 128) instances; its
    loss rises at the first hard-mining boundary, 5, and falls below the
    start by 20): launches, one step with
    the run's batch against the plain path at STEP_TOL[bf16], and the
    forward + backward against the same parameters in fp32."""
    cfg, reduced = _cut_config(task, "base", RECIPE_CUTS, RECIPE, param_dtype="bfloat16",
                               checkpoint_every=4)
    boundaries = (cfg.epochs - 1) // cfg.neg_every
    with tempfile.TemporaryDirectory() as tmp:
        res, counts, run_s = _run_checked(
            cfg.replace(checkpoint_dir=tmp), task, dev, steps=cfg.epochs, forwards=boundaries,
            proposals=boundaries, minings=boundaries)
        batch, n_boot = _saved_batch(tmp, cfg, task, dev)
    model = res.model
    if model.encoder.compute_dtype != torch.bfloat16 or n_boot == 0:
        raise AssertionError("the v6 run did not train in bf16 with proposals")
    step = _check_step(model, lambda: model(res.op, batch, train=True)[0],
                       _mtl_step_launches(cfg), dtype=torch.bfloat16)
    vs32 = _step_vs_fp32(model, lambda m: m(res.op, batch, train=True)[0], cfg,
                         lambda c: AlignMTL(task.n_ent, c, device=dev, n_rel=task.n_rel,
                                            n_attr=max(task.n_attr, 1)))
    v6 = {"reduced": reduced, "losses": res.losses,
          "metrics": {k: res.metrics[k] for k in ("hits@1", "hits@10", "mrr")},
          "launches": counts, "timings": res.timings, "run_s": run_s,
          "stages_s": _stages(res.timings), "step_check": step, "step_vs_fp32": vs32}

    cfg_b, reduced_b = _cut_config(task, "base", {"epochs": 20, "eval_every": 0},
                                   param_dtype="bfloat16")
    res_b, counts_b, run_b = _run_checked(cfg_b, task, dev, steps=20, forwards=3, minings=3)
    mb, op = res_b.model, res_b.op
    bb = _step_batch(res_b, cfg_b, dev)

    def base_loss(m):
        return margin_align_loss(m(op, train=True), bb["pairs"], bb["neg_l"], bb["neg_r"],
                                 cfg_b.gamma)

    step_b = _check_step(mb, lambda: base_loss(mb), _per_step_launches(cfg_b), ("gc2.b",),
                         dtype=torch.bfloat16)
    vs32_b = _step_vs_fp32(mb, base_loss, cfg_b, lambda c: build_model(c, task, device=dev))
    base = {"dim": cfg_b.dim, "reduced": reduced_b, "losses": res_b.losses,
            "metrics": {k: res_b.metrics[k] for k in ("hits@1", "hits@10", "mrr")},
            "launches": counts_b, "run_s": run_b, "stages_s": _stages(res_b.timings),
            "step_check": step_b, "step_vs_fp32": vs32_b}
    emit({"phase": "bf16", "n_ent": task.n_ent, "v6": {"dim": cfg.dim, **v6}, "base": base,
          "card": smi})
    return {"v6": counts, "base": counts_b}


def phase_sorted(task, smi: str, dev: torch.device) -> dict:
    """spmm_impl sorted at zh-en scale: config base at dim 128 for 20
    epochs (as phase 12 runs it), ell fp32 beside sorted fp32 and bf16 (launches; the final
    losses of sorted and ell fp32 within rel 1e-3, the JAX package's own
    bound, tests/test_ell.py:98), and one step of each sorted run against
    the plain path.  The layer-2 bias's gradient is 0 by construction (the
    margin reads only differences of rows) and is computed before any
    kernel of the backward: it is held as rounding noise in both types
    (``_check_step``'s ``zero_grads``), since the kernel's sums round the
    forward apart from the plain path's and the two noises differ."""
    runs, out = {}, {}
    for key, impl, dtype in (("ell_fp32", "ell", "float32"), ("sorted_fp32", "sorted", "float32"),
                             ("sorted_bf16", "sorted", "bfloat16")):
        cfg, reduced = _cut_config(task, "base", {"epochs": 20, "eval_every": 0},
                                   spmm_impl=impl, param_dtype=dtype)
        res, counts, run_s = _run_checked(cfg, task, dev, steps=20, forwards=3, minings=3)
        runs[key] = counts
        out[key] = {"reduced": reduced, "losses": res.losses, "launches": counts,
                    "metrics": {k: res.metrics[k] for k in ("hits@1", "hits@10", "mrr")},
                    "run_s": run_s, "stages_s": _stages(res.timings)}
        if impl == "sorted":
            model, op, batch = res.model, res.op, _step_batch(res, cfg, dev)
            out[key]["step_check"] = _check_step(
                model, lambda: margin_align_loss(model(op, train=True), batch["pairs"],
                                                 batch["neg_l"], batch["neg_r"], cfg.gamma),
                _per_step_launches(cfg), ("gc2.b",), dtype=getattr(torch, dtype))
    want, got = out["ell_fp32"]["losses"][-1], out["sorted_fp32"]["losses"][-1]
    rel = abs(got - want) / abs(want)
    if rel > 1e-3:
        raise AssertionError(f"sorted final loss {got} against ell's {want} (rel {rel})")
    emit({"phase": "sorted", "n_ent": task.n_ent, "final_loss_rel_sorted_vs_ell": rel, **out,
          "card": smi})
    return runs


def phase_native(task, smi: str, dev: torch.device) -> dict:
    """The native adjacency builder, which must run on this machine (it has
    a C++ compiler), against the numpy builder at zh-en scale, for config
    base's weighting (uniform, sym) and highway's (funifun, rw): the COO
    build timed (best of 3) and held equal (ids exactly, weights 1e-12),
    and ``build_adjacency``'s ELL operator through each, equal to fp32."""
    if not native.available():
        raise AssertionError("the native builder is not available on this machine")
    tri, n = task.merged_triples, task.n_ent
    out = {}
    for weighting, norm in (("uniform", "sym"), ("funifun", "rw")):
        kw = dict(n_rel=task.n_rel, weighting=weighting)

        def numpy_coo():
            s_, d_, w_ = coo_from_triples(n, tri, **kw)
            return s_, d_, coo_normalize(s_, d_, w_, n, norm=norm)

        times = {}
        for name, fn in (("native", lambda: native.native_coo_from_triples(n, tri, norm=norm,
                                                                           **kw)),
                         ("numpy", numpy_coo)):
            best = math.inf
            for _ in range(3):
                t0 = time.perf_counter()
                res = fn()
                best = min(best, time.perf_counter() - t0)
            times[name] = (best, res)
        (s1, d1, w1), (s2, d2, w2) = times["numpy"][1], times["native"][1]
        order = np.lexsort((s1, d1))
        if not (np.array_equal(s1[order], s2) and np.array_equal(d1[order], d2)):
            raise AssertionError("the native builder's edges differ from numpy's")
        np.testing.assert_allclose(w1[order], w2, rtol=1e-12, atol=1e-15)
        ops = {}
        for use_native in (True, False):
            t0 = time.perf_counter()
            ops[use_native] = build_adjacency(n, tri, norm=norm, use_native=use_native, **kw)
            ops[f"{use_native}_s"] = time.perf_counter() - t0
        a, b = ops[True], ops[False]
        np.testing.assert_allclose(a.diag.numpy(), b.diag.numpy(), rtol=1e-6)
        for x, y in zip(a.fwd.buckets + a.bwd.buckets, b.fwd.buckets + b.bwd.buckets):
            if not torch.equal(x.idx, y.idx):
                raise AssertionError("the native ELL operator's ids differ from numpy's")
            np.testing.assert_allclose(x.w.numpy(), y.w.numpy(), rtol=1e-6)
        out[f"{weighting}_{norm}"] = {
            "edges": int(len(s2)), "coo_native_s": times["native"][0],
            "coo_numpy_s": times["numpy"][0],
            "numpy_over_native": times["numpy"][0] / times["native"][0],
            "build_adjacency_native_s": ops["True_s"], "build_adjacency_numpy_s": ops["False_s"],
            "w_max_rel_diff": float(np.max(np.abs(w1[order] - w2) / np.abs(w1[order])))}
    emit({"phase": "native", "n_ent": n, "triples": int(len(tri)), **out, "card": smi})
    return out


def phase_debug_nans(task, smi: str, dev: torch.device) -> dict:
    """``debug_nans`` (the CLI's --debug-nans) on a poisoned run: config base
    with a learning rate of 1e30, whose first Adam step overflows the
    second step's forward.  Unfused, anomaly detection or the step check
    raises FloatingPointError naming epoch 1; fused (a captured step on
    the card), the interval's finite flag names epochs 0-4."""
    cfg, reduced = _cut_config(task, "base", {"epochs": 10, "eval_every": 0}, lr=1e30)
    out = {"reduced": reduced}
    for mode, c, want in (("unfused", cfg, "epoch 1"),
                          ("fused", cfg.replace(steps_per_call=cfg.neg_every),
                           f"interval of epochs 0-{cfg.neg_every - 1}")):
        t0 = time.perf_counter()
        try:
            run(c, task=task, device=dev, debug_nans=True)
        except FloatingPointError as e:
            msg = str(e)
        else:
            raise AssertionError(f"debug_nans {mode}: the poisoned run did not raise")
        if want not in msg:
            raise AssertionError(f"debug_nans {mode}: {msg!r} does not name {want!r}")
        out[mode] = {"raised": msg[:200], "wall_s": time.perf_counter() - t0}
    emit({"phase": "debug_nans", **out, "card": smi})
    return out


# config dwy100k_dist as chip_smoke.py trains it: only these are cut (of 400
# epochs: one uniform interval, then one mined by ring_knn; the exact final
# eval is the only eval)
DIST_CUTS = {"epochs": 10, "neg_every": 5, "eval_every": 0}


# the SpMM launches of one halo layer's forward at R = 1: the rank's stacked
# local group and its boundary group over the table's own rows
HALO_LAYER_LAUNCHES = 2


def _dist_launches(t: dict) -> int:
    """A distributed run's SpMM launches at R = 1: per encoder forward 2
    layers × (local + boundary), as many again in each step's backward."""
    return 2 * HALO_LAYER_LAUNCHES * (2 * t["steps"] + t["forwards"] + t["evals"])


def _dist_batch(task, cfg, dev) -> dict:
    """The seed pairs with uniform negatives from a fixed generator."""
    pairs = torch.as_tensor(task.train_pairs, dtype=torch.int64, device=dev)
    neg_l, neg_r = sample_uniform_negatives(torch.Generator().manual_seed(1), pairs,
                                            task.kg1.n_ent, task.n_ent, cfg.k_neg)
    return {"pairs": pairs, "neg_l": neg_l, "neg_r": neg_r}


def _nan_cache(rows: int, d: int, dev: torch.device,
               dtype: torch.dtype = torch.float32) -> None:
    """Free a NaN-filled block of an output's size and type to the
    allocator's cache: the next output of that size lands on it, so a row
    the kernel leaves unwritten shows as NaN."""
    torch.full((rows, d), float("nan"), dtype=dtype, device=dev)


def _dist_ell_case(m, diag, x: torch.Tensor, cold: bool = False) -> dict:
    """``spmm_ell`` on one shard operator: against its plain version (on
    NaN-prefilled output memory; a bf16 result also within half a bf16 ulp
    of the fp32 plain sums of the same input), bit-identical over two
    launches, timed (with ``cold`` also after an L2 flush) beside the plain
    version, ``torch.sparse.mm`` and the bound (bytes)."""
    d = x.shape[1]
    _nan_cache(m.n_rows, d, x.device, x.dtype)
    got = ell_spmm(m, diag, x)
    sync(x.device)
    want = apply_with_diag(m, diag, x)
    torch.testing.assert_close(got.float(), want.float(), **TOL[x.dtype])
    if x.dtype != torch.float32:
        torch.testing.assert_close(got.float(), apply_with_diag(m, diag, x.float()),
                                   rtol=2 ** -8, atol=1e-3)
    if not torch.equal(got, ell_spmm(m, diag, x)):
        raise AssertionError(f"spmm_ell ({m.n_rows} rows): two launches differ")
    csr, refused = _csr_of(m, diag).to(x.dtype), None
    try:
        torch.testing.assert_close(torch.sparse.mm(csr, x).float(), want.float(), **TOL[x.dtype])
    except RuntimeError as e:  # the library's refusal of a type is the finding
        refused = str(e).splitlines()[0][:200]
    plan = segment_plan(m)
    # the rows of x the real slots (and the diagonal) read, the output, the
    # buckets and the diagonal once
    ell_bytes = sum(b.rows.numel() * 4 + b.idx.numel() * 4 + b.w.numel() * 4 for b in m.buckets)
    read = torch.cat([b.idx[b.w != 0] for b in m.buckets]
                     + ([] if diag is None else [torch.arange(m.n_rows, device=x.device)]))
    x_rows = int(torch.unique(read).numel())
    nbytes = ((m.n_rows + x_rows) * d * x.element_size() + ell_bytes
              + (0 if diag is None else diag.numel() * 4))
    n_diag = 0 if diag is None else int(torch.count_nonzero(diag))
    r = {"rows": m.n_rows, "cols": m.n_cols, "x_rows_read": x_rows, "edges": m.nnz + n_diag,
         "dtype": str(x.dtype).removeprefix("torch."),
         "rows_in_no_bucket": plan.base.n_zero_rows, "work_items": int(plan.items.shape[0]),
         "max_abs_err": float((got.float() - want.float()).abs().max()),
         "ms": time_ms(lambda: ell_spmm(m, diag, x)),
         "ms_cold_l2": time_cold_ms(lambda: ell_spmm(m, diag, x)) if cold else None,
         "device_ms": device_ms(lambda: ell_spmm(m, diag, x)),
         "plain_ms": time_ms(lambda: apply_with_diag(m, diag, x), iters=5),
         "library_ms": None if refused else time_ms(lambda: torch.sparse.mm(csr, x)),
         "library_device_ms": None if refused else device_ms(lambda: torch.sparse.mm(csr, x)),
         "library_refused": refused}
    r["bound_ms"], r["bound_by"] = _bound(nbytes, 2 * (m.nnz + n_diag) * d)
    r["share_of_bound_device"] = ratio(r["bound_ms"], r["device_ms"])
    return r


def _dist_step(parts, batch) -> tuple[torch.Tensor, dict, dict]:
    """One distributed step's loss and gradients, with its launches."""
    _reset_launch_counts()
    loss = parts.grads(batch)
    sync(loss.device)
    return loss, {k: p.grad.clone() for k, p in parts.model.named_parameters()}, _launch_counts()


def phase_dist(smi: str, dev: torch.device) -> dict:
    """Config dwy100k_dist at full width (100,000 entities per KG, 500,000
    triples, 300 relations, 8 shards, dim 128, k_neg 25, spmm_impl ell),
    cut to DIST_CUTS, through driver.run on one card: an NCCL group of one
    rank holding the 8 shards.  Its partition, stage times, launches
    (held to ``_dist_launches``: spmm_ell does every shard's aggregation both
    ways) and losses.  Then one step with injected negatives against the
    single-device port's (``driver.step_parts``) on the same parameters, in
    ell and in sorted (spmm_sorted on the same edge groups), each step's
    time beside the single-device one's; then both kernels on the rank's
    stacked local, boundary and boundary-transpose operators at d = 128
    fp32.
    The distributed steps are held to the single-device step's plain path
    (``_plain_kernels``), the reference of every step check; their distance
    to its kernel path is read beside, with the kernel path's own distance
    to the plain one."""
    cfg = get_config("dwy100k_dist", **DIST_CUTS)
    t0 = time.perf_counter()
    task = load_task(cfg)
    task_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launch_counts()
    t0 = time.perf_counter()
    res = run(cfg, task=task, device=dev)
    sync(dev)
    run_s = time.perf_counter() - t0
    counts, t, losses = _launch_counts(), res.timings, res.losses
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    per_step = 4 * HALO_LAYER_LAUNCHES
    expected = {**{k: 0 for k in counts}, "spmm_ell": _dist_launches(t),
                **_dist_l1_launches(t, cfg), **_loss_launches(cfg, t["steps"])}
    if counts != expected or t["steps"] != cfg.epochs or t["minings"] != 1:
        raise AssertionError(f"launches {counts} (expected {expected}), timings {t}")
    nb = cfg.neg_every
    if not all(math.isfinite(v) for v in losses) or not all(
            losses[i + nb - 1] < losses[i] for i in range(0, cfg.epochs, nb)):
        raise AssertionError(f"losses not finite or not falling in each interval: {losses}")
    if not all(math.isfinite(v) for v in res.metrics.values()):
        raise AssertionError(f"non-finite metrics {res.metrics}")
    geometry = res.op.geometry
    stages = {"task_s": task_s, "build_s": t["build_s"],
              "step_median_s": float(np.median(t["step_s"])),
              "step_first_s": t["step_s"][0], "mining_forward_s": t["forward_s"],
              "mining_s": t["mine_s"], "final_eval_s": t["final_eval_s"], "run_s": run_s}
    emit({"phase": "dist", "config": cfg.name, "cuts": DIST_CUTS, "n_ent": task.n_ent,
          "train_pairs": int(len(task.train_pairs)), "test_pairs": int(len(task.test_pairs)),
          "partition": geometry, "exchange_route_buffer_mb": cfg.n_shards ** 2
          * geometry["halo_b"] * cfg.dim * 4 / 2 ** 20, "launches": counts,
          "launches_per_step": {"spmm_ell": per_step}, "losses": losses,
          "metrics": {k: res.metrics[k] for k in ("hits@1", "hits@10", "mrr")},
          "stages_s": stages, "peak_device_mb": peak_mb, "card": smi})
    run_result = {"final_loss": res.metrics["final_loss"], "hits@1": res.metrics["hits@1"],
                  "losses": losses, "stages_s": stages, "peak_device_mb": peak_mb}

    batch = _dist_batch(task, cfg, dev)
    single = step_parts(cfg.replace(n_shards=1), task, dev)

    def single_step():
        single.model.zero_grad(set_to_none=True)
        loss = single.loss_fn(batch, None)[0]
        loss.backward()
        return loss.detach(), {k: p.grad.clone() for k, p in single.model.named_parameters()}

    s_kernels = single_step()
    with _plain_kernels():
        s_plain = single_step()
    def gap(step, ref, hold=True):  # the table's gradient on its n real rows
        (loss, grads), (ref_loss, ref_grads) = step, ref
        return _step_gap(loss, {**grads, "emb": grads["emb"][:task.n_ent]}, ref_loss, ref_grads,
                         ("gc2.b",), tol=STEP_TOL[torch.float32] if hold else None)

    checks = {"single_kernels_vs_plain": gap(s_kernels, s_plain)}
    ops = {}
    with make_mesh(cfg.n_shards, dev) as mesh:
        for impl in ("ell", "sorted"):
            parts = dist_parts(cfg.replace(spmm_impl=impl), task, mesh)
            loss, grads, launched = _dist_step(parts, batch)
            kernel = "spmm_ell" if impl == "ell" else "spmm_sorted"
            if launched != {**{k: 0 for k in launched}, kernel: per_step,
                            **_loss_launches(cfg, 1)}:
                raise AssertionError(f"{impl} step launched {launched}, expected {per_step}")
            checks[impl] = {
                "vs_single_plain": gap((loss, grads), s_plain),
                "vs_single_kernels": gap((loss, grads), s_kernels, hold=False),
                "launches": launched,
                "step_ms": [time_ms(lambda: parts.grads(batch), 1, 5),
                            time_ms(single_step, 1, 5),
                            time_ms(lambda: parts.grads(batch), 1, 5)]}
            if impl == "ell":
                checks[impl]["device_split"] = _device_split(lambda: parts.grads(batch), dev,
                                                             top=10)
            ops[impl] = parts.op
            del parts
    emit({"phase": "dist_step", "checks": checks,
          "step_ms_order": ["distributed", "single-device", "distributed"], "card": smi})

    rng = np.random.default_rng(5)
    d = cfg.dim

    def x_for(n_cols):
        return torch.from_numpy(rng.standard_normal((n_cols, d)).astype(np.float32)).to(dev)

    loc, bnd = ops["ell"].loc, ops["ell"].bnd
    ell_ops = {name: _dist_ell_case(m, diag, x_for(m.n_cols)) for name, m, diag in (
        ("local", loc.fwd, loc.diag), ("boundary", bnd.fwd, None),
        ("boundary_transpose", bnd.bwd, None))}
    sorted_ops = {}
    s_loc, s_bnd = ops["sorted"].loc, ops["sorted"].bnd
    for name, edges in (("local", s_loc.fwd), ("boundary", s_bnd.fwd),
                        ("boundary_transpose", s_bnd.bwd)):
        x, table, csr = x_for(edges.n_cols), _sorted_table(edges)[0], _csr_of_edges(edges)
        _nan_cache(edges.n_rows, d, dev)
        sorted_ops[name] = {**table, **_sorted_case(edges, csr, x, timed=True)}
    emit({"phase": "kernel", "kernel": "dist_rank_operators", "shards": cfg.n_shards, "d": d,
          "dtype": "float32", "spmm_ell": ell_ops, "spmm_sorted": sorted_ops, "card": smi})
    return {"launches": counts, "per_step": per_step, "spmm_ell": ell_ops,
            "spmm_sorted": sorted_ops, "sorted_step_launches": checks["sorted"]["launches"],
            "steady_step_s": _steady_step(t), "task": task, "run": run_result,
            "step_ms": {"distributed": checks["ell"]["step_ms"][0],
                        "single_device": checks["ell"]["step_ms"][1]}}


# recipe v7r on config dwy100k_dist as chip_smoke.py trains it: only these
# are cut (of 900 epochs, proposals from epoch 200, an eval every 100: one
# uniform interval, then one with the proposals and mined negatives; the
# exact CSLS final eval is the only eval); sinkhorn_pairs 4096 is the
# reference's own cap at this seed count, not a cut
DIST_V7R_CUTS = {"epochs": 4, "boot_start": 2, "eval_every": 0}
DIST_V7R_OT_PAIRS = 4096


def _ring_ot_check(smi: str, dev: torch.device, s: int = DIST_V7R_OT_PAIRS,
                   d: int = 256) -> dict:
    """The ring OT loss alone at s pairs × d (v7r's τ 0.3, 20 iterations),
    one rank holding 8 shards: value and gradient against the plain version
    (``sinkhorn_align_loss_plain``, autograd through the unrolled solver) at
    PERF.md §2's step limits, 2·20 + 1 launches; the forward and the
    forward + backward timed beside the single-device ``sinkhorn_align_loss``
    (same kernel, same reverse sweep) and the plain version."""
    l, r, _, _ = _sinkhorn_inputs(dev, s, d)
    table = torch.cat([l, r])
    pairs = torch.stack([torch.arange(s), s + torch.arange(s)], 1).to(dev)
    kw = dict(tau=0.3, n_iters=20)
    with make_mesh(8, dev) as mesh:
        def ring_fn():
            return ring_sinkhorn_align_loss(x, pairs, mesh, **kw)

        def single_fn():
            return sinkhorn_align_loss(x, pairs, **kw)

        def plain_fn():
            return sinkhorn_align_loss_plain(x, pairs, **kw)

        def both(fn):
            def step():
                x.grad = None
                fn().backward()
            return step

        x = table.clone().requires_grad_()
        _reset_launch_counts()
        loss = ring_fn()
        loss.backward()
        sync(dev)
        launched = _launch_counts()
        if launched != {**{k: 0 for k in launched}, "sinkhorn_fused": 2 * kw["n_iters"] + 1,
                        "sinkhorn_reverse": 2 * kw["n_iters"] + 1}:
            raise AssertionError(f"the ring OT launched {launched}")
        got = x.grad.clone()
        x.grad = None
        want = plain_fn()
        want.backward()
        sync(dev)
        loss_rel = abs(loss.item() - want.item()) / abs(want.item())
        grad_rel = float((got - x.grad).norm() / x.grad.norm())
        tol = STEP_TOL[torch.float32]
        if not (loss_rel <= tol["loss_rel"] and grad_rel <= tol["grad_rel_l2"]
                and torch.isfinite(got).all()):
            raise AssertionError(f"ring OT vs plain: loss rel {loss_rel}, grad rel {grad_rel}")
        with torch.no_grad():
            fwd = {"ring_ms": time_ms(ring_fn, 1, 5), "single_ms": time_ms(single_fn, 1, 5),
                   "plain_ms": time_ms(plain_fn, 1, 3), "ring_ms_again": time_ms(ring_fn, 1, 5)}
        fwd_bwd = {"ring_ms": time_ms(both(ring_fn), 1, 5),
                   "single_ms": time_ms(both(single_fn), 1, 5),
                   "plain_ms": time_ms(both(plain_fn), 1, 3),
                   "ring_ms_again": time_ms(both(ring_fn), 1, 5)}
        dev_ms = device_ms(ring_fn, iters=3)
    out = {"pairs": s, "d": d, "launches": launched["sinkhorn_fused"],
           "reverse_launches": launched["sinkhorn_reverse"], "loss": loss.item(),
           "loss_plain": want.item(), "loss_rel_err": loss_rel, "grad_rel_l2": grad_rel,
           "tolerance": tol, "forward": fwd, "forward_backward": fwd_bwd,
           "forward_device_ms": dev_ms}
    emit({"phase": "dist_ring_ot", **out, "card": smi})
    return out


def phase_dist_v7r(smi: str, dev: torch.device) -> dict:
    """Recipe v7r on config dwy100k_dist at full width (100,000 entities per
    KG, 500,000 triples, 8 shards, dim 256, k_neg 100, the OT head on 4,096
    seed pairs, the attribute head, bootstrapping, CSLS eval), cut to
    DIST_V7R_CUTS, through driver.run on an NCCL group of one rank holding
    the 8 shards: stage times, the launches (``sinkhorn_fused`` 41 per
    step, ``spmm_ell`` 64 per step and 32 per forward, nothing else), the
    losses falling in each interval, the CSLS metrics finite.  Then one
    step on an injected batch (``mp_worker.surface_batch``: proposals,
    negatives and the interval's draws) against the single-device step's
    plain path on the same parameters, and the ring OT alone
    (``_ring_ot_check``)."""
    cfg = get_config("dwy100k_dist", **RECIPES["v7r"]).replace(
        sinkhorn_pairs=DIST_V7R_OT_PAIRS, **DIST_V7R_CUTS)
    t0 = time.perf_counter()
    task = load_task(cfg)
    task_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launch_counts()
    t0 = time.perf_counter()
    res = run(cfg, task=task, device=dev)
    sync(dev)
    run_s = time.perf_counter() - t0
    counts, t, losses = _launch_counts(), res.timings, res.losses
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    per_step = {"spmm_ell": 4 * HALO_LAYER_LAUNCHES,
                "sinkhorn_fused": 2 * cfg.sinkhorn_iters + 1, **_loss_launches(cfg, 1)}
    expected = {**{k: 0 for k in counts}, "spmm_ell": _dist_launches(t),
                "sinkhorn_fused": per_step["sinkhorn_fused"] * t["steps"],
                **_dist_l1_launches(t, cfg), **_loss_launches(cfg, t["steps"])}
    if counts != expected or (t["steps"], t["proposals"], t["minings"], t["forwards"],
                              t["draws"], t["evals"]) != (cfg.epochs, 1, 1, 1, 2, 1):
        raise AssertionError(f"launches {counts} (expected {expected}), timings {t}")
    nb = cfg.neg_every
    if not all(math.isfinite(v) for v in losses) or not all(
            losses[i + nb - 1] < losses[i] for i in range(0, cfg.epochs, nb)):
        raise AssertionError(f"losses not finite or not falling in each interval: {losses}")
    metrics = {k: res.metrics[k] for k in ("hits@1", "hits@10", "mrr")}
    if not all(math.isfinite(v) for v in res.metrics.values()):
        raise AssertionError(f"non-finite metrics {res.metrics}")
    stages = {"task_s": task_s, "build_s": t["build_s"],
              "step_median_s": float(np.median(t["step_s"])),
              "step_first_s": t["step_s"][0], "boundary_forward_s": t["forward_s"],
              "proposal_s": t["propose_s"], "mining_s": t["mine_s"],
              "draw_s": t["draw_s"], "csls_final_eval_s": t["final_eval_s"], "run_s": run_s}
    run_result = {"final_loss": res.metrics["final_loss"], "hits@1": res.metrics["hits@1"],
                  "losses": losses, "stages_s": stages, "peak_device_mb": peak_mb}
    widths = [tuple(res.model.gc1.w.shape), tuple(res.model.attr_head.w.shape)]
    if widths != [(256, 256), (256, task.n_attr)]:
        raise AssertionError(f"widths {widths}")
    emit({"phase": "dist_v7r", "config": cfg.name, "recipe": "v7r", "cuts": DIST_V7R_CUTS,
          "sinkhorn_pairs": cfg.sinkhorn_pairs, "n_ent": task.n_ent, "n_attr": task.n_attr,
          "train_pairs": int(len(task.train_pairs)), "test_pairs": int(len(task.test_pairs)),
          "dim": cfg.dim, "k_neg": cfg.k_neg, "eval_csls_k": cfg.eval_csls_k,
          "launches": counts, "launches_per_step": per_step, "losses": losses,
          "metrics_csls": metrics, "timings": {k: v for k, v in t.items() if k != "step_s"},
          "stages_s": stages, "peak_device_mb": peak_mb, "card": smi})
    del res

    surface = mp_worker.surface_batch(cfg, task, device=dev)
    batch = _with_index(surface, task.n_ent)  # the single-device table's rows
    n_boot = int((batch["w"][len(task.train_pairs):] > 0).sum())
    single = step_parts(cfg.replace(n_shards=1), task, dev)

    def single_step():
        single.model.zero_grad(set_to_none=True)
        loss = single.loss_fn(batch, None)[0]
        loss.backward()
        return loss.detach(), {k.removeprefix("encoder."): p.grad.clone()
                               for k, p in single.model.named_parameters()}

    s_kernels = single_step()
    with _plain_kernels():
        s_plain = single_step()

    def gap(step, ref, hold=True):  # the table's gradient on its n real rows
        (loss, grads), (ref_loss, ref_grads) = step, ref
        return _step_gap(loss, {**grads, "emb": grads["emb"][:task.n_ent]}, ref_loss, ref_grads,
                         tol=STEP_TOL[torch.float32] if hold else None)

    checks = {"single_kernels_vs_plain": gap(s_kernels, s_plain, hold=False)}
    with make_mesh(cfg.n_shards, dev) as mesh:
        parts = dist_parts(cfg, task, mesh)
        d_batch = _with_index(surface, parts.hg.n_loc * parts.hg.n_shards)  # its table's rows
        loss, grads, launched = _dist_step(parts, d_batch)
        if launched != {**{k: 0 for k in launched}, **per_step}:
            raise AssertionError(f"the v7r step launched {launched}, expected {per_step}")
        checks["dist"] = {"vs_single_plain": gap((loss, grads), s_plain),
                          "vs_single_kernels": gap((loss, grads), s_kernels, hold=False),
                          "launches": launched, "loss_terms": {k: v.item() for k, v in
                                                               parts.aux.items()},
                          "step_ms": [time_ms(lambda: parts.grads(d_batch), 1, 5),
                                      time_ms(single_step, 1, 5),
                                      time_ms(lambda: parts.grads(d_batch), 1, 5)],
                          "device_split": _device_split(lambda: parts.grads(d_batch), dev,
                                                        top=10)}
        # the step before and after the loss kernels, by events and by head
        checks["dist"]["step_ms_by_route"] = _in_turns(lambda: {
            "distributed": time_ms(lambda: parts.grads(d_batch), 1, 5),
            "single_device": time_ms(single_step, 1, 5)})
        checks["dist"]["head_split"] = _in_turns(
            lambda: _profile_dist_step(parts, d_batch, cfg, dev))
        del parts
    del single
    emit({"phase": "dist_v7r_step", "weighted_proposals": n_boot,
          "ot_pairs": int(batch.get("ot_pairs", batch["pairs"]).shape[0]),
          "attr_batch": int(batch["attr_triples"].shape[0]), "checks": checks,
          "step_ms_order": ["distributed", "single-device", "distributed"], "card": smi})
    ring_ot = _ring_ot_check(smi, dev)
    return {"launches": counts, "per_step": per_step, "ring_ot": ring_ot,
            "step_by_route": {k: checks["dist"][k] for k in ("step_ms_by_route", "head_split")},
            "stages_s": {"proposal_s": t["propose_s"], "mining_s": t["mine_s"],
                         "csls_final_eval_s": t["final_eval_s"], "run_s": run_s},
            "task": task, "run": run_result,
            "step_ms": {"distributed": checks["dist"]["step_ms"][0],
                        "single_device": checks["dist"]["step_ms"][1]}}


# the final loss and Hits@1 of a single-device run of a sharded config
# against the distributed run of the same config at R = 1: the JAX
# package's bound for a run through another summation order
# (tests/test_ell.py:98; PERF.md §2's sorted-vs-ELL row)
SINGLE_VS_DIST = {"final_loss_rel": 1e-3, "hits@1_abs": 0.01}


def _single_sharded_leg(trainer, cfg, task, dist: dict, smi: str, dev: torch.device) -> dict:
    """``trainer`` (``fit`` or ``fit_mtl``) on the sharded config ``cfg``
    at full width on one card, called directly: launches held to
    ``_expected_launches`` (the single-device model: two ``gcn_fused``
    launches per forward, two ``spmm_ell`` per step, no SpMM in a
    forward), the loss finite and falling in each resample interval, the
    final loss and Hits@1 against the distributed run of the same config
    at R = 1 (``dist["run"]``) at ``SINGLE_VS_DIST``; peak memory, step
    median and stage seconds beside the distributed run's."""
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launch_counts()
    t0 = time.perf_counter()
    res = trainer(cfg, task=task, device=dev)
    sync(dev)
    run_s = time.perf_counter() - t0
    counts, t, losses = _launch_counts(), res.timings, res.losses
    peak_mb = torch.cuda.max_memory_allocated(dev) / 2 ** 20
    expected = _expected_launches(cfg, t, task)
    if counts != expected or t["steps"] != cfg.epochs or t["minings"] != 1:
        raise AssertionError(f"launches {counts} (expected {expected}), timings {t}")
    nb = cfg.neg_every
    if not all(math.isfinite(v) for v in losses) or not all(
            losses[i + nb - 1] < losses[i] for i in range(0, cfg.epochs, nb)):
        raise AssertionError(f"losses not finite or not falling in each interval: {losses}")
    if not all(math.isfinite(v) for v in res.metrics.values()):
        raise AssertionError(f"non-finite metrics {res.metrics}")
    ref = dist["run"]
    gap = {"final_loss_rel": abs(res.metrics["final_loss"] - ref["final_loss"])
           / abs(ref["final_loss"]),
           "hits@1_abs": abs(res.metrics["hits@1"] - ref["hits@1"])}
    if any(gap[k] > v for k, v in SINGLE_VS_DIST.items()):
        raise AssertionError(f"single-device vs distributed: {gap} (bound {SINGLE_VS_DIST})")
    stages = {"setup_s": t["setup_s"], "step_median_s": float(np.median(t["step_s"])),
              "proposal_s": t["propose_s"] / t["proposals"] if t["proposals"] else None,
              "mining_s": t["mine_s"] / t["minings"], "final_eval_s": t["final_eval_s"],
              "run_s": run_s}
    emit({"phase": "single_sharded", "trainer": trainer.__name__, "config": cfg.name,
          "recipe": "v7r" if cfg.use_sinkhorn else None, "n_shards": cfg.n_shards,
          "n_ent": task.n_ent, "dim": cfg.dim, "k_neg": cfg.k_neg, "epochs": cfg.epochs,
          "launches": counts, "losses": losses, "losses_distributed": ref["losses"],
          "final_loss": res.metrics["final_loss"], "final_loss_distributed": ref["final_loss"],
          "hits@1": res.metrics["hits@1"], "hits@1_distributed": ref["hits@1"],
          "gap": gap, "bound": SINGLE_VS_DIST, "stages_s": stages,
          "stages_s_distributed": ref["stages_s"], "step_ms_events": dist["step_ms"],
          "peak_device_mb": peak_mb, "peak_device_mb_distributed": ref["peak_device_mb"],
          "card": smi})
    return {"res": res, "launches": counts, "gap": gap, "stages_s": stages,
            "peak_device_mb": peak_mb}


def phase_single_sharded(smi: str, dev: torch.device, dist: dict, dist_v7r: dict,
                         parent=None) -> dict:
    """The single-device trainers on config dwy100k_dist, as the JAX ``fit``
    and ``fit_mtl`` train it (one device, the whole graph; the shard fields
    unread), on the tasks of ``phase_dist`` and ``phase_dist_v7r``: leg A
    ``fit`` cut to DIST_CUTS, leg B ``fit_mtl`` under recipe v7r cut to
    DIST_V7R_CUTS with the OT head on 4,096 seed pairs
    (``_single_sharded_leg``, each against that phase's run).  Then one
    step of leg A's trained model through the kernels held against the
    plain path at PERF.md §2's step limit, and ``gcn_fused`` on the
    200,000-row operator of each leg at its width, (128, 128) and
    (256, 256) fp32, and (256, 256) bf16 (``_gcn_case``: against its plain
    version, timed beside cuSPARSE + GEMM and the bound; with ``parent``,
    (256, 256) in turns with that kernel)."""
    cfg_a = get_config("dwy100k_dist", **DIST_CUTS)
    leg_a = _single_sharded_leg(fit, cfg_a, dist["task"], dist, smi, dev)
    cfg_b = get_config("dwy100k_dist", **RECIPES["v7r"]).replace(
        sinkhorn_pairs=DIST_V7R_OT_PAIRS, **DIST_V7R_CUTS)
    leg_b = _single_sharded_leg(fit_mtl, cfg_b, dist_v7r["task"], dist_v7r, smi, dev)
    res_a, res_b = leg_a.pop("res"), leg_b.pop("res")
    batch = _dist_batch(dist["task"], cfg_a, dev)
    step = _check_step(res_a.model, lambda: margin_align_loss(
        res_a.model(res_a.op), batch["pairs"], batch["neg_l"], batch["neg_r"], cfg_a.gamma),
        _mtl_step_launches(cfg_a), zero_grads=("gc2.b",))
    emit({"phase": "single_sharded_step", "trainer": "fit", "config": cfg_a.name,
          "check": step, "card": smi})
    rng = np.random.default_rng(9)
    kernel = {}
    csr_b = _csr_of(res_b.op.fwd, res_b.op.diag)
    for res, csr, d, dtype in ((res_a, _csr_of(res_a.op.fwd, res_a.op.diag), cfg_a.dim,
                                torch.float32), (res_b, csr_b, cfg_b.dim, torch.float32),
                               (res_b, csr_b, cfg_b.dim, torch.bfloat16)):
        name = f"({d}, {d})" + ("" if dtype == torch.float32 else " bf16")
        kernel[name] = _gcn_case(res.op, csr, rng, d, dtype, smi, split=False, where="dwy100k",
                                 parent=parent)
    return {"fit": leg_a, "fit_mtl": leg_b, "step": step, "gcn_fused": kernel}


# recipe v7r on dwy100k_dist with --fast's search set (sqeuclidean mining,
# shortlisted), shortlisted proposals and a shortlisted history eval every 2
# epochs, cut as phase_dist_v7r is (DIST_V7R_CUTS)
DIST_APPROX = {"neg_metric": "sqeuclidean", "neg_approx": True, "boot_approx": True,
               "eval_approx_k": 128, "eval_every": 2}
# checkpoints of DIST_CUTS every 4 epochs; SIGTERM during the 8th step
# (epoch 7, the middle of the mined interval 5-9)
DIST_CKPT_EVERY, DIST_SIGTERM_STEP = 4, 8
DIST_OPTIONS = {"channel": dict(use_attr_channel=True), "dropout": dict(dropout=0.3),
                "l2_normalize": dict(l2_normalize=True), "bf16": dict(param_dtype="bfloat16")}
# the gradients 0 by construction: each margin reads differences of rows,
# so the last layer's bias cancels (not under l2_normalize)
DIST_OPTION_ZERO_GRADS = {"channel": ("gc2.b", "ae_encoder.gc2.b"), "dropout": ("gc2.b",),
                          "l2_normalize": (), "bf16": ("gc2.b",)}


def _dist_select_launches(t: dict, cfg) -> int:
    """A distributed run's select-and-rerank launches: one per (direction,
    shard block) of each shortlisted mining and history eval (the eval's
    CSLS hubness as many again), one per direction of each shortlisted
    proposal (on the gathered table).  A shortlist above the kernel's queue
    would take the unfused route, which these runs must not: it raises."""
    k2 = max(2 * cfg.k_neg, cfg.k_neg + 8)
    if max(k2 if cfg.neg_approx else 0, cfg.eval_approx_k) > shortlist_dist.QUEUE_MAX:
        raise NotImplementedError(f"a shortlist above the queue: {k2}, {cfg.eval_approx_k}")
    s = cfg.n_shards
    per_mining = 2 * s if cfg.neg_approx and not cfg.neg_csls_k else 0
    per_eval = 2 * s * (1 + bool(cfg.eval_csls_k)) if cfg.eval_approx_k else 0
    per_proposal = 2 * (1 + bool(cfg.boot_csls_k)) if cfg.boot_cap and cfg.boot_approx else 0
    return (per_mining * t["minings"] + per_proposal * t["proposals"]
            + per_eval * (t["evals"] - 1))  # the final eval is exact


def _counted(dev: torch.device, fn) -> tuple:
    """(fn(), its host wall seconds ended by a synchronise, the kernels it
    launched)."""
    _reset_launch_counts()
    out, sec = _timed(dev, fn)
    return out, sec, {k: v for k, v in _launch_counts().items() if v}


def _dist_approx_leg(smi: str, dev: torch.device, exact_stages: dict) -> dict:
    """Leg A: approximate v7r (``DIST_APPROX``) through ``driver.run``: the
    launches (the ring stages' select-and-rerank, ``_dist_select_launches``;
    nothing else beyond phase_dist_v7r's), the stage times beside the exact
    run's; then on the run's last table each stage alone with its launches,
    the shortlisted mining against exact ``ring_knn`` (recall ≥ 0.8), the
    shortlisted CSLS eval against the run's exact final eval (Hits@1/@10,
    MRR within 0.02), and the kernel at the ring's block shapes against its
    plain version (``_select_case``: one mining block of the last table; the
    eval's and the hubness's blocks)."""
    cfg = get_config("dwy100k_dist", **RECIPES["v7r"]).replace(
        sinkhorn_pairs=DIST_V7R_OT_PAIRS, **{**DIST_V7R_CUTS, **DIST_APPROX})
    task = load_task(cfg)
    res, run_s, counts = _counted(dev, lambda: run(cfg, task=task, device=dev))
    t, losses = res.timings, res.losses
    s = cfg.n_shards
    expected = {"spmm_ell": _dist_launches(t),
                "sinkhorn_fused": (2 * cfg.sinkhorn_iters + 1) * t["steps"],
                "shortlist_dist": _dist_select_launches(t, cfg),
                **_nonzero(_dist_l1_launches(t, cfg)),
                **_nonzero(_loss_launches(cfg, t["steps"]))}
    if counts != expected or (t["steps"], t["proposals"], t["minings"], t["forwards"],
                              t["draws"], t["evals"]) != (cfg.epochs, 1, 1, 1, 2, 4):
        raise AssertionError(f"launches {counts} (expected {expected}), timings {t}")
    nb = cfg.neg_every
    if not all(math.isfinite(v) for v in losses) or not all(
            losses[i + nb - 1] < losses[i] for i in range(0, cfg.epochs, nb)):
        raise AssertionError(f"losses not finite or not falling in each interval: {losses}")
    history_s = (t["eval_s"] - t["final_eval_s"]) / (t["evals"] - 1)
    stages = {"proposal_s": t["propose_s"], "mining_s": t["mine_s"],
              "history_eval_s_each": history_s, "csls_final_eval_s": t["final_eval_s"],
              "step_median_s": float(np.median(t["step_s"])),
              "steady_step_s": _steady_step(t), "run_s": run_s}

    n1, n = task.kg1.n_ent, task.n_ent
    pairs = torch.as_tensor(task.train_pairs, dtype=torch.int64, device=dev)
    kw = dict(metric=cfg.neg_metric)
    with make_mesh(s, dev) as mesh:
        parts = dist_parts(cfg, task, mesh)
        parts.model.load_full(res.params)
        table = parts.embed()
        del parts

        def mine(approx):
            return (ring_knn(table[pairs[:, 1]], table[:n1], pairs[:, 0], cfg.k_neg, mesh,
                             approx=approx, **kw),
                    ring_knn(table[pairs[:, 0]], table[n1:n], pairs[:, 1] - n1, cfg.k_neg,
                             mesh, approx=approx, **kw))

        approx, mine_s, mine_launched = _counted(dev, lambda: mine(True))
        exact, exact_s, _ = _counted(dev, lambda: mine(False))
        hits, eval_s, eval_launched = _counted(dev, lambda: ring_hits_at_k(
            table, task.test_pairs, mesh, csls_k=cfg.eval_csls_k, approx_k=cfg.eval_approx_k))
    make = IntervalBatch(cfg, task, dev)
    _, prop_s, prop_launched = _counted(dev, lambda: propose_mutual_nn_pairs(
        table, make.mask1, make.mask2, n1, n, cfg.boot_cap, metric=cfg.neg_metric,
        approx=True))
    recall = min(_recall(a, e) for a, e in zip(approx, exact))
    gaps = {k: abs(hits[k] - res.metrics[k]) for k in ("hits@1", "hits@10", "mrr")}
    per_stage = {"mining": mine_launched, "history_eval": eval_launched,
                 "proposal": prop_launched}
    if recall < 0.8 or max(gaps.values()) > 0.02 or per_stage != {
            "mining": {"shortlist_dist": 2 * s}, "history_eval": {"shortlist_dist": 4 * s},
            "proposal": {"shortlist_dist": 2}}:
        raise AssertionError(f"approximate stages: recall {recall}, eval gaps {gaps}, "
                             f"launches {per_stage}")

    # the kernel at the ring's block shapes, on the last table
    bc, bt = -(-(n - n1) // s), -(-len(task.test_pairs) // s)
    extra = make.mask1.nonzero()[:, 0][:cfg.boot_cap]  # as many KG1 rows as proposals
    q_mine = table[torch.cat([pairs[:, 0], extra])]
    partner = torch.cat([pairs[:, 1] - n1, torch.full_like(extra, -1)])
    k2 = min(bc, max(2 * cfg.k_neg, cfg.k_neg + 8))
    test = torch.as_tensor(task.test_pairs, dtype=torch.int64, device=dev)
    left, right = table[test[:, 0]], table[test[:, 1]]
    r_sq = negatives_mod._hubness_both_approx(left, right, cfg.eval_csls_k)[0]
    me = torch.arange(len(test), device=dev)
    cases = {
        "dist_mining_block": (q_mine, table[n1:n1 + bc], k2, dict(
            exclude=torch.where(partner < bc, partner, -1), rerank=cfg.neg_metric)),
        "dist_eval_csls_block": (left, right[:bt], cfg.eval_approx_k, dict(
            exclude=torch.where(me < bt, me, -1), a=2.0, bias=r_sq[:bt].contiguous(),
            rerank="cityblock")),
        "dist_hubness_block": (right, left[:bt], cfg.eval_csls_k, dict(rerank="cityblock"))}
    kernel = {name: _select_case(name, q.contiguous(), c.contiguous(), k, kw_,
                                 {k_: v for k_, v in kw_.items() if not torch.is_tensor(v)},
                                 smi) for name, (q, c, k, kw_) in cases.items()}
    out = {"config": cfg.name, "recipe": "v7r", "cuts": {**DIST_V7R_CUTS, **DIST_APPROX},
           "launches": counts, "timings": {k: v for k, v in t.items() if k != "step_s"},
           "losses": losses, "final_loss": res.metrics["final_loss"], "stages_s": stages,
           "exact_stages_s": exact_stages, "select_launches_per_stage": per_stage,
           "on_last_table": {"mining_recall_min": recall, "mining_s": mine_s,
                             "exact_mining_s": exact_s, "eval_gaps": gaps,
                             "history_eval_s": eval_s, "proposal_s": prop_s},
           "metrics_final_exact": {k: res.metrics[k] for k in ("hits@1", "hits@10", "mrr")},
           "metrics_shortlisted": {k: hits[k] for k in ("hits@1", "hits@10", "mrr")}}
    emit({"phase": "dist_options", "leg": "A_approximate_v7r", **out, "card": smi})
    return {**out, "kernel": kernel}


def _dist_checkpoint_leg(smi: str, dev: torch.device) -> dict:
    """Leg B: ``dwy100k_dist`` cut to DIST_CUTS with checkpoints every
    DIST_CKPT_EVERY epochs: the run; the same run stopped by SIGTERM during
    its DIST_SIGTERM_STEP-th step (mid-interval) and resumed (each loss and
    the final loss bit for bit: the step sums in a fixed order);
    ``driver.evaluate`` from the run's directory (each metric within 1e-4);
    save and load seconds, the checkpoint's size."""
    cfg = get_config("dwy100k_dist", **DIST_CUTS).replace(checkpoint_every=DIST_CKPT_EVERY)
    task = load_task(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        full_cfg, cut_cfg = (cfg.replace(checkpoint_dir=os.path.join(tmp, d))
                             for d in ("full", "cut"))
        full, full_s = _timed(dev, lambda: run(full_cfg, task=task, device=dev))
        undo = mp_worker.sigterm_at_call(DIST_SIGTERM_STEP)
        try:
            first = run(cut_cfg, task=task, device=dev)
        finally:
            undo()
        resumed = run(cut_cfg, task=task, device=dev)
        ev, ev_s = _timed(dev, lambda: evaluate(full_cfg, task=task, device=dev))
        ckpt_mb = os.path.getsize(os.path.join(full_cfg.checkpoint_dir,
                                               f"ckpt-{cfg.epochs - 1}.pt")) / 2 ** 20
    loss_rel = abs(resumed.metrics["final_loss"] / full.metrics["final_loss"] - 1)
    eval_gaps = {k: abs(ev.metrics[k] - full.metrics[k]) for k in ("hits@1", "hits@10", "mrr",
                                                                  "final_loss")}
    stopped = (first.timings["steps"], resumed.timings["start_epoch"])
    bitwise = first.losses + resumed.losses == full.losses and loss_rel == 0.0
    if stopped != (DIST_SIGTERM_STEP, DIST_SIGTERM_STEP) or not bitwise or max(
            eval_gaps.values()) > 1e-4:
        raise AssertionError(f"checkpoints: stopped/resumed at {stopped}, final loss rel "
                             f"{loss_rel}, eval-only gaps {eval_gaps}")
    out = {"cuts": DIST_CUTS, "checkpoint_every": DIST_CKPT_EVERY,
           "sigterm_step": DIST_SIGTERM_STEP, "final_loss_rel_err": loss_rel,
           "bitwise": bitwise,
           "losses_rel_err_max": float(np.max(np.abs(
               np.array(first.losses + resumed.losses) / np.array(full.losses) - 1))),
           "eval_only_gaps": eval_gaps, "checkpoint_mb": ckpt_mb,
           "save_s": full.timings["save_s"], "saves": full.timings["saves"],
           "save_s_each": full.timings["save_s"] / full.timings["saves"],
           "load_s": resumed.timings["load_s"], "eval_only_s": ev_s,
           "eval_only_load_s": ev.timings["load_s"], "run_s": full_s}
    emit({"phase": "dist_options", "leg": "B_checkpoints", **out, "card": smi})
    return out


def _dist_options_leg(smi: str, dev: torch.device) -> dict:
    """Leg C: one step of ``dwy100k_dist`` at full width with each of
    ``DIST_OPTIONS`` (the attribute channel, dropout 0.3 with epoch 1's keep
    mask, l2_normalize, bf16), its ``spmm_ell`` launches, held against the
    single-device step's plain path (``driver.step_parts`` under
    ``_plain_kernels``) on the same parameters, batch and mask at PERF.md
    §2's step limits (bf16 at its bf16 limits)."""
    base = get_config("dwy100k_dist", **DIST_CUTS)
    task = load_task(base)
    batch = _dist_batch(task, base, dev)
    n, epoch = task.n_ent, 1
    out = {}
    for name, over in DIST_OPTIONS.items():
        cfg = base.replace(**over)
        dtype = torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32
        single = step_parts(cfg.replace(n_shards=1), task, dev)
        gen = step_generator(cfg, epoch, dev) if cfg.dropout > 0 else None
        single.model.zero_grad(set_to_none=True)
        with _plain_kernels():
            ref = single.loss_fn(batch, gen)[0]
            ref.backward()
        ref_grads = {k.removeprefix("encoder."): p.grad for k, p in
                     single.model.named_parameters()}
        del single
        with make_mesh(cfg.n_shards, dev) as mesh:
            parts = dist_parts(cfg, task, mesh)
            mask = parts.drop_mask(epoch)
            loss, _, launched = _counted(dev, lambda: parts.grads(batch, mask))
            grads = {k: p.grad.clone() for k, p in parts.model.named_parameters()}
            step_ms = time_ms(lambda: parts.grads(batch, mask), 1, 5)
            if cfg.use_attr_channel:  # the operators of the kernel's callers
                inc0, loc0, bnd0 = parts.model.ae_encoder.inc[0], parts.op.loc, parts.op.bnd
            del parts
        zero_rel = 1e-5 if dtype == torch.float32 else math.sqrt(n) * 2 ** -8
        per_step = 4 * HALO_LAYER_LAUNCHES * (2 if cfg.use_attr_channel else 1) + (
            2 * cfg.n_shards if cfg.use_attr_channel else 0)
        if launched != {"spmm_ell": per_step, **_nonzero(_loss_launches(cfg, 1))}:
            raise AssertionError(f"{name}: one step launched {launched}, expected {per_step}")
        out[name] = {"launches_per_step": launched, "step_ms": step_ms,
                     **_step_gap(loss, {**grads, "emb": grads["emb"][:n]}, ref, ref_grads,
                                 DIST_OPTION_ZERO_GRADS[name], zero_rel, STEP_TOL[dtype])}
    emit({"phase": "dist_options", "leg": "C_encoder_options", "mask_epoch": epoch,
          "options": out, "card": smi})
    # spmm_ell's callers: shard 0's attribute incidence (the channel's
    # input, fp32) and the rank's halo operators in bf16 (the bf16 step)
    rng = np.random.default_rng(7)
    d = base.dim

    def x_for(n_cols, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal((n_cols, d)).astype(np.float32)).to(
            dev, dtype)

    kernel = {name: _dist_ell_case(m, diag, x_for(m.n_cols, dtype), cold=True)
              for name, m, diag, dtype in (
                  ("incidence", inc0.fwd, None, torch.float32),
                  ("incidence_transpose", inc0.bwd, None, torch.float32),
                  ("local_bf16", loc0.fwd, loc0.diag, torch.bfloat16),
                  ("boundary_bf16", bnd0.fwd, None, torch.bfloat16),
                  ("boundary_transpose_bf16", bnd0.bwd, None, torch.bfloat16))}
    emit({"phase": "kernel", "kernel": "dist_option_operators", "d": d,
          "spmm_ell": kernel, "card": smi})
    return {**out, "kernel": kernel}


def _dist_debug_nans_leg(smi: str, dev: torch.device) -> dict:
    """Leg D: ``dwy100k_dist`` at learning rate 1e30 with ``debug_nans``:
    ``FloatingPointError`` naming epoch 1, agreed over the ranks."""
    cfg = get_config("dwy100k_dist", **DIST_CUTS).replace(lr=1e30)
    task = load_task(cfg)
    t0 = time.perf_counter()
    try:
        run(cfg, task=task, device=dev, debug_nans=True)
    except FloatingPointError as e:
        msg = str(e)
    else:
        raise AssertionError("debug_nans: the poisoned distributed run did not raise")
    if "epoch 1" not in msg:
        raise AssertionError(f"debug_nans: {msg!r} does not name epoch 1")
    out = {"raised": msg[:200], "wall_s": time.perf_counter() - t0}
    emit({"phase": "dist_options", "leg": "D_debug_nans", **out, "card": smi})
    return out


def phase_dist_options(smi: str, dev: torch.device, exact_stages: dict) -> dict:
    """The distributed trainer's run options on ``dwy100k_dist`` at full
    width, through ``driver.run`` / ``driver.evaluate`` on an NCCL group of
    one rank holding the 8 shards: Leg A, the approximate ring stages
    (``_dist_approx_leg``); Leg B, checkpoints, SIGTERM and resume,
    eval-only (``_dist_checkpoint_leg``); Leg C, the encoder options
    (``_dist_options_leg``); Leg D, ``debug_nans`` (``_dist_debug_nans_leg``)."""
    return {"approx": _dist_approx_leg(smi, dev, exact_stages),
            "checkpoints": _dist_checkpoint_leg(smi, dev),
            "options": _dist_options_leg(smi, dev),
            "debug_nans": _dist_debug_nans_leg(smi, dev)}


# ---- tensor parallelism and slices on the one-rank group ----

# the grid asked for: two feature blocks and two slices; one rank of one
# card holds every block (W = 1), so its step is the F = L = 1 step
DIST_MESH = {"feature_shards": 2, "slice_shards": 2}
DIST_MESH_PANEL_DIM = 384  # each rank's column blocks 192 wide: the SpMMs' panel path


def _mesh_step_pair(task, cfg, batch, dev) -> dict:
    """One step of ``cfg`` at F = L = 1 and at ``DIST_MESH`` (each its own
    ``make_mesh`` on the one-rank group; the grid is (1, 1, 1)): the loss
    and every gradient bit for bit, the same launches; returns both parts
    with the launches."""
    with make_mesh(cfg.n_shards, dev) as flat_mesh, \
            make_mesh(cfg.n_shards, dev, DIST_MESH["feature_shards"],
                      DIST_MESH["slice_shards"]) as tp_mesh:
        if tp_mesh.grid != (1, 1, 1) or tp_mesh.groups:
            raise AssertionError(f"one rank's grid {tp_mesh.grid}, groups {tp_mesh.groups}")
        flat = dist_parts(cfg, task, flat_mesh)
        tp = dist_parts(cfg.replace(**DIST_MESH), task, tp_mesh)
        f_loss, f_grads, f_launched = _dist_step(flat, batch)
        t_loss, t_grads, t_launched = _dist_step(tp, batch)
        differ = [k for k in f_grads if not torch.equal(f_grads[k], t_grads[k])]
        if not torch.equal(f_loss, t_loss) or differ or f_launched != t_launched:
            raise AssertionError(f"F = L = 2 step against F = L = 1: loss {t_loss.item()} / "
                                 f"{f_loss.item()}, gradients differ {differ}, launches "
                                 f"{t_launched} / {f_launched}")
        return {"flat": flat, "tp": tp, "loss": float(t_loss),
                "launches": {k: v for k, v in t_launched.items() if v}}


def phase_dist_mesh(smi: str, dev: torch.device) -> dict:
    """Tensor parallelism and slices (``DIST_MESH``) on ``dwy100k_dist`` at
    full width, on the NCCL group of one rank, which holds every feature
    block and slice (the grid (1, 1, 1), no subgroup): one step at d 128
    (``DIST_CUTS``, ``_dist_batch``) and one v7r step at d 256 (phase 20's
    cuts, ``mp_worker.surface_batch``), each equal to its F = L = 1 step
    bit for bit with the same launches; a profiler trace of the d-128 step
    (no ``nccl`` event); one step at ``DIST_MESH_PANEL_DIM`` (blocks of 192
    columns, which the SpMMs run in two panels, the second masked), held the
    same way and timed by events.  Then the kernels at a tensor-parallel rank's
    width (d/F = 64) on the rank's stacked operators: ``spmm_ell`` fp32 and
    bf16, ``spmm_sorted``, against their plain versions.  (Leg A's run at
    F = L = 2 and its cut and resume, and the interleaved step timing,
    replayed phase 21 A's code on one card; they are not run.)"""
    t_leg = time.perf_counter()
    cfg = get_config("dwy100k_dist", **DIST_CUTS)
    task = load_task(cfg)
    batch = _dist_batch(task, cfg, dev)
    d128 = _mesh_step_pair(task, cfg, batch, dev)
    flat, tp = d128.pop("flat"), d128.pop("tp")
    if d128["launches"] != {"spmm_ell": 4 * HALO_LAYER_LAUNCHES,
                            **_nonzero(_loss_launches(cfg, 1))}:
        raise AssertionError(f"the d-128 step launched {d128['launches']}")
    events = _all_events_ms(lambda: tp.grads(batch), dev)["top_kernels_ms"] or {}
    found = [k for k in events if any(w in k for w in NO_EXCHANGE)]
    if not events or found:
        raise AssertionError(f"the F = L = 2 step's device events: {len(events)}, of a "
                             f"collective {found}")
    d128.update(nccl_events=found, device_events=len(events))
    ops, hg = tp.op, tp.hg
    del flat, tp

    v7r = get_config("dwy100k_dist", **RECIPES["v7r"]).replace(
        sinkhorn_pairs=DIST_V7R_OT_PAIRS, **DIST_V7R_CUTS)
    v7r_step = _mesh_step_pair(task, v7r, mp_worker.surface_batch(v7r, task, device=dev), dev)
    del v7r_step["flat"], v7r_step["tp"]
    want = {"spmm_ell": 4 * HALO_LAYER_LAUNCHES, "sinkhorn_fused": 2 * v7r.sinkhorn_iters + 1,
            **_loss_launches(v7r, 1)}
    if v7r_step["launches"] != want:
        raise AssertionError(f"the v7r step launched {v7r_step['launches']}, expected {want}")
    panel_cfg = cfg.replace(dim=DIST_MESH_PANEL_DIM)
    panel_step = _mesh_step_pair(task, panel_cfg, batch, dev)
    tp_panel = panel_step.pop("tp")
    del panel_step["flat"]
    if panel_step["launches"] != {"spmm_ell": 4 * HALO_LAYER_LAUNCHES,
                                  **_nonzero(_loss_launches(panel_cfg, 1))}:
        raise AssertionError(f"the d-{DIST_MESH_PANEL_DIM} step launched "
                             f"{panel_step['launches']}")
    panel_step.update(dim=DIST_MESH_PANEL_DIM,
                      block_width=DIST_MESH_PANEL_DIM // DIST_MESH["feature_shards"],
                      step_ms=time_ms(lambda: tp_panel.grads(batch), 1, 5))
    del tp_panel
    torch.cuda.empty_cache()
    leg_s = time.perf_counter() - t_leg
    out = {"grid_asked": DIST_MESH, "grid_held": [1, 1, 1], "d128_step": d128,
           "v7r_step": v7r_step, "panel_step": panel_step, "leg_s": leg_s}
    emit({"phase": "dist_mesh", **out, "card": smi})

    # the kernels at d/F = 64 on the rank's stacked operators (fp32, bf16)
    rng = np.random.default_rng(9)

    def x_for(n_cols, dtype=torch.float32):
        return torch.from_numpy(rng.standard_normal((n_cols, 64)).astype(np.float32)).to(
            dev, dtype)

    loc, bnd = ops.loc, ops.bnd
    ell = {name: _dist_ell_case(m, diag, x_for(m.n_cols, dtype)) for name, m, diag, dtype in (
        ("local", loc.fwd, loc.diag, torch.float32), ("boundary", bnd.fwd, None, torch.float32),
        ("boundary_transpose", bnd.bwd, None, torch.float32),
        ("local_bf16", loc.fwd, loc.diag, torch.bfloat16))}
    with make_mesh(cfg.n_shards, dev) as mesh:
        s_op = shard_operator(hg, mesh, "sorted")
    sorted_ops = {}
    for name, edges, dtype in (("local", s_op.loc.fwd, torch.float32),
                               ("boundary", s_op.bnd.fwd, torch.float32),
                               ("boundary_transpose", s_op.bnd.bwd, torch.float32),
                               ("local_bf16", s_op.loc.fwd, torch.bfloat16)):
        _nan_cache(edges.n_rows, 64, dev)
        sorted_ops[name] = _sorted_case(edges, _csr_of_edges(edges), x_for(edges.n_cols, dtype),
                                        timed=name == "local")
    phase_s = time.perf_counter() - t_leg
    emit({"phase": "kernel", "kernel": "dist_tp_operators", "d": 64, "spmm_ell": ell,
          "spmm_sorted": sorted_ops, "leg_s": leg_s, "phase_s": phase_s, "card": smi})
    return {**out, "kernel": {"spmm_ell": ell, "spmm_sorted": sorted_ops}, "phase_s": phase_s}


# ---- the grouped halo exchange (halo_grouped) on the one-rank group ----

GROUPED_SIGTERM_STEP = 3  # the cut run stops after epoch 2, in the v7r run's second interval
GROUPED_MOVED_N_ENT = 99_998  # entities a KG: r0 = 4·25,000 = 100,000, KG2 moved by 2 rows
FP32_OUT_TOL = dict(rtol=1e-4, atol=1e-4)  # PERF.md §2: 1e-4 + 1e-4·|x|


def _grouped_pair(task, cfg, dev, batches: tuple[dict, dict]) -> dict:
    """One step of ``cfg`` ungrouped and with ``halo_grouped`` (each on its
    own ``make_mesh`` of the one-rank group), each on its batch of
    ``batches`` (the grouped one in the grouped layout's rows), from the
    same parameters indexed by entity (``dist_parts`` places entity j's
    initial row at its row): the encoder outputs and the steps' losses,
    gradients and launches, with the layouts and both parts."""
    out = {}
    for grouped, batch in zip((False, True), batches):
        c = cfg.replace(halo_grouped=grouped)
        with make_mesh(c.n_shards, dev, halo_grouped=grouped) as mesh:
            parts = dist_parts(c, task, mesh)
            with torch.no_grad():
                emb = parts.embed()
            loss, grads, launched = _dist_step(parts, batch)
        out[grouped] = {"parts": parts, "emb": emb, "loss": loss, "grads": grads,
                        "launches": {k: v for k, v in launched.items() if v}}
    return out


def phase_dist_grouped(smi: str, dev: torch.device, leg_a: dict) -> dict:
    """The grouped halo exchange (``halo_grouped``) on ``dwy100k_dist`` at
    full width, on the NCCL group of one rank holding the 8 shards (both KG
    halves: no collective).  (a) The config's own task, 100,000 entities a
    KG: r0 = n1, the identity remap; one d-128 step (``DIST_CUTS``,
    ``_dist_batch``) grouped against ungrouped in ell and in sorted: the
    encoder output, the loss and every gradient bit for bit (each row keeps
    its entries in their order), the same launches, and the two steps'
    times by events, interleaved.  (b) ``GROUPED_MOVED_N_ENT`` entities a
    KG: KG2 moves by 2 rows; the two steps from the same parameters indexed
    by entity, the de-remapped output and the loss within PERF.md §2's fp32
    limit, the gradients within its step limits.  (c) Phase 21 A's
    approximate v7r run at ``halo_grouped`` through ``driver.run``: each
    loss, the final loss and the launches leg A's (the identity remap); the
    run cut by SIGTERM in its ``GROUPED_SIGTERM_STEP``-th step and resumed
    grouped, equal to it; a resume of that directory without
    ``halo_grouped`` refused by the layout stamp.  (d) ``spmm_ell`` fp32 on
    (b)'s grouped rank operators (local, boundary, its transpose) and
    ``spmm_sorted`` on its local operator against their plain versions,
    timed as phase 19's rank operators."""
    t_phase = time.perf_counter()
    cfg = get_config("dwy100k_dist", **DIST_CUTS)
    task = load_task(cfg)
    batch = _dist_batch(task, cfg, dev)
    per_step = 4 * HALO_LAYER_LAUNCHES
    identity, step_ms = {}, {}
    for impl in ("ell", "sorted"):
        pair = _grouped_pair(task, cfg.replace(spmm_impl=impl), dev, (batch, batch))
        u, g = pair[False], pair[True]
        rows = g["parts"].layout
        kernel = "spmm_ell" if impl == "ell" else "spmm_sorted"
        differ = [k for k in u["grads"] if not torch.equal(u["grads"][k], g["grads"][k])]
        if (rows.r0 != rows.n1 or not torch.equal(u["emb"], g["emb"])
                or not torch.equal(u["loss"], g["loss"]) or differ
                or u["launches"] != g["launches"]
                or g["launches"] != {kernel: per_step, **_nonzero(_loss_launches(cfg, 1))}):
            raise AssertionError(f"{impl}: the grouped step at the identity remap (r0 "
                                 f"{rows.r0}, n1 {rows.n1}): loss {g['loss'].item()} / "
                                 f"{u['loss'].item()}, gradients differ {differ}, launches "
                                 f"{g['launches']} / {u['launches']}")
        rounds = []  # ungrouped, grouped, grouped, ungrouped
        for _ in range(3):
            rounds.append([time_ms(lambda: p.grads(batch), 1, 10)
                           for p in (u["parts"], g["parts"], g["parts"], u["parts"])])
        step_ms[impl] = {"ungrouped": float(np.median([r[0] + r[3] for r in rounds])) / 2,
                         "grouped": float(np.median([r[1] + r[2] for r in rounds])) / 2,
                         "rounds": rounds}
        identity[impl] = {"loss": float(g["loss"]), "launches": g["launches"],
                          "r0": rows.r0, "geometry": g["parts"].op.geometry}
        del pair, u, g

    moved_cfg = cfg.replace(syn_n_ent=GROUPED_MOVED_N_ENT)
    moved_task = load_task(moved_cfg)
    m_batch = _dist_batch(moved_task, moved_cfg, dev)
    rows = RowLayout.of(moved_cfg.replace(halo_grouped=True), moved_task)
    g_batch = {k: rows.rows(v) for k, v in m_batch.items()}
    pair = _grouped_pair(moved_task, moved_cfg, dev, (m_batch, g_batch))
    u, g = pair[False], pair[True]
    n = moved_task.n_ent
    emb_g, emb_u = rows.entities(g["emb"]), u["emb"][:n]
    torch.testing.assert_close(emb_g, emb_u, **FP32_OUT_TOL)
    torch.testing.assert_close(g["loss"], u["loss"], **FP32_OUT_TOL)
    gap = _step_gap(g["loss"], {**g["grads"], "emb": rows.entities(g["grads"]["emb"])},
                    u["loss"], {**u["grads"], "emb": u["grads"]["emb"][:n]}, ("gc2.b",),
                    tol=STEP_TOL[torch.float32])
    if rows.r0 - rows.n1 != 2 or g["launches"] != {"spmm_ell": per_step,
                                                   **_nonzero(_loss_launches(cfg, 1))}:
        raise AssertionError(f"the moved remap: r0 {rows.r0}, n1 {rows.n1}, launches "
                             f"{g['launches']}")
    moved = {"n1": rows.n1, "r0": rows.r0, "n_rows": rows.n_rows, "launches": g["launches"],
             "max_abs_err_emb": float((emb_g - emb_u).abs().max()),
             "loss_rel_err": gap["loss_rel_err"], "step": gap,
             "geometry": {"grouped": g["parts"].op.geometry,
                          "ungrouped": u["parts"].op.geometry}}
    g_hg, g_op = g["parts"].hg, g["parts"].op
    del pair, u, g
    t_steps = time.perf_counter() - t_phase

    run_cfg = get_config("dwy100k_dist", **RECIPES["v7r"]).replace(
        sinkhorn_pairs=DIST_V7R_OT_PAIRS, **{**DIST_V7R_CUTS, **DIST_APPROX}, halo_grouped=True)
    res, run_s, counts = _counted(dev, lambda: run(run_cfg, task=task, device=dev))
    same_run = (res.losses == leg_a["losses"]
                and res.metrics["final_loss"] == leg_a["final_loss"])
    if not same_run or counts != {k: v for k, v in leg_a["launches"].items() if v}:
        raise AssertionError(f"the grouped run: losses {res.losses}, final "
                             f"{res.metrics['final_loss']}, launches {counts}; leg A's "
                             f"{leg_a['losses']}, {leg_a['final_loss']}, {leg_a['launches']}")
    with tempfile.TemporaryDirectory() as tmp:
        cut_cfg = run_cfg.replace(checkpoint_dir=tmp, checkpoint_every=run_cfg.epochs)
        undo = mp_worker.sigterm_at_call(GROUPED_SIGTERM_STEP)
        try:
            first, cut_s, cut_counts = _counted(dev, lambda: run(cut_cfg, task=task, device=dev))
        finally:
            undo()
        resumed, resume_s, resume_counts = _counted(dev, lambda: run(cut_cfg, task=task,
                                                                     device=dev))
        try:
            run(cut_cfg.replace(halo_grouped=False), task=task, device=dev)
            refused = None
        except ValueError as e:
            refused = str(e)
    stopped = (first.timings["steps"], resumed.timings["start_epoch"])
    resumed_equal = (first.losses + resumed.losses == res.losses
                     and resumed.metrics["final_loss"] == res.metrics["final_loss"])
    if (stopped != (GROUPED_SIGTERM_STEP, GROUPED_SIGTERM_STEP) or not resumed_equal
            or refused is None or f"row layout (halo_grouped, kg2_base)=(1, {task.kg1.n_ent}) "
            f"but this run uses (0, {task.kg1.n_ent})" not in refused):
        raise AssertionError(f"cut and resumed grouped: stopped/resumed at {stopped}, losses "
                             f"{first.losses} + {resumed.losses}, final "
                             f"{resumed.metrics['final_loss']}; the uncut run's {res.losses}; "
                             f"the ungrouped resume: {refused}")
    run_out = {"cuts": {**DIST_V7R_CUTS, **DIST_APPROX}, "losses": res.losses,
               "final_loss": res.metrics["final_loss"], "equal_to_leg_a": same_run,
               "launches": counts, "run_s": run_s, "steady_step_s": _steady_step(res.timings),
               "resume": {"sigterm_step": GROUPED_SIGTERM_STEP, "stopped_resumed_at": stopped,
                          "equal_to_uncut": resumed_equal, "cut_run_s": cut_s,
                          "resumed_run_s": resume_s, "load_s": resumed.timings["load_s"],
                          "cut_launches": cut_counts, "resumed_launches": resume_counts,
                          "ungrouped_resume_refused": refused[:160]}}
    t_run = time.perf_counter() - t_phase - t_steps
    out = {"identity": identity, "step_ms": step_ms,
           "step_ms_order": ["ungrouped", "grouped", "grouped", "ungrouped"], "moved": moved,
           "run": run_out, "steps_s": t_steps, "run_legs_s": t_run}
    emit({"phase": "dist_grouped", **out, "card": smi})

    # the kernels on the moved task's grouped rank operators, d 128 fp32
    rng = np.random.default_rng(11)
    d = cfg.dim

    def x_for(n_cols):
        return torch.from_numpy(rng.standard_normal((n_cols, d)).astype(np.float32)).to(dev)

    loc, bnd = g_op.loc, g_op.bnd
    ell = {name: _dist_ell_case(m, diag, x_for(m.n_cols), cold=True) for name, m, diag in (
        ("local", loc.fwd, loc.diag), ("boundary", bnd.fwd, None),
        ("boundary_transpose", bnd.bwd, None))}
    with make_mesh(cfg.n_shards, dev, halo_grouped=True) as mesh:
        s_op = shard_operator(g_hg, mesh, "sorted")
    edges = s_op.loc.fwd
    _nan_cache(edges.n_rows, d, dev)
    sorted_ops = {"local": {**_sorted_table(edges)[0],
                            **_sorted_case(edges, _csr_of_edges(edges), x_for(edges.n_cols),
                                           timed=True)}}
    phase_s = time.perf_counter() - t_phase
    emit({"phase": "kernel", "kernel": "dist_grouped_operators", "n1": rows.n1, "r0": rows.r0,
          "d": d, "dtype": "float32", "spmm_ell": ell, "spmm_sorted": sorted_ops,
          "phase_s": phase_s, "card": smi})
    return {**out, "kernel": {"spmm_ell": ell, "spmm_sorted": sorted_ops}, "phase_s": phase_s}


# ---- the distributed step at R = 1, the exchange route, the fused interval ----

# the one-step times by events at d 128 that PERF.md §5 records from before
# the boundary read the table's rows (NVIDIA H100 80GB HBM3, 700.00 W): the
# step through the exchange at R = 1, and the single-device step on the
# same parameters and batch
EARLIER_STEP_MS = {"distributed_through_the_exchange": 15.84521026611328,
                "single_device": 6.092704010009766}
DIST_FAST = {"neg_metric": "sqeuclidean", "neg_approx": True}  # --fast's search set
# device events the R = 1 step must not hold: the collective, the atomic
# index add of the exchange's old backward
NO_EXCHANGE = ("nccl", "all_to_all")
INDEX_ADD = ("indexFunc", "index_add")  # the atomic index add (read, not refused)


def _all_events_ms(fn, dev) -> dict:
    """``_device_split`` of one call of ``fn`` with every device event kept."""
    return _device_split(fn, dev, top=10_000)


def _copies_ms(events: dict) -> float:
    """The device time of the copies and fills among ``events``."""
    return sum(v for k, v in events.items()
               if any(w in k.lower() for w in ("copy", "memcpy", "memset", "fill")))


def _dist_r1_leg(smi: str, dev: torch.device, task, cfg) -> dict:
    """The R = 1 step at d 128 fp32 (``DIST_CUTS``): its launches in ell
    and in sorted, its time by events beside ``EARLIER_STEP_MS`` and a
    single-device step's, its device events (none of ``NO_EXCHANGE``), two
    calls equal bit for bit; then the same step through the exchange route at R = 1 (the
    NCCL self-copy, the fixed-order backward) held to it at PERF.md §2's
    step limits, two backward calls of the exchange bit for bit, and the
    halo SpMM's forward + backward with and without ``force_serialize``."""
    batch = _dist_batch(task, cfg, dev)
    per_step = 4 * HALO_LAYER_LAUNCHES
    out = {}
    single = step_parts(cfg.replace(n_shards=1), task, dev)

    def single_step():
        single.model.zero_grad(set_to_none=True)
        single.loss_fn(batch, None)[0].backward()

    single_ms = time_ms(single_step, 1, 5)
    del single
    with make_mesh(cfg.n_shards, dev) as mesh:
        for impl in ("sorted", "ell"):
            parts = dist_parts(cfg.replace(spmm_impl=impl), task, mesh)
            loss, grads, launched = _dist_step(parts, batch)
            kernel = "spmm_ell" if impl == "ell" else "spmm_sorted"
            if launched != {**{k: 0 for k in launched}, kernel: per_step,
                            **_loss_launches(cfg, 1)}:
                raise AssertionError(f"the R = 1 {impl} step launched {launched}")
            again, grads2, _ = _dist_step(parts, batch)
            differ = [k for k in grads if not torch.equal(grads[k], grads2[k])]
            if not torch.equal(loss, again) or differ:
                raise AssertionError(f"two R = 1 {impl} steps differ: loss {loss.item()} / "
                                     f"{again.item()}, gradients {differ}")
            out[impl] = {"launches_per_step": launched[kernel],
                         "step_ms": time_ms(lambda: parts.grads(batch), 1, 5)}
            if impl == "sorted":
                del parts
        split = _all_events_ms(lambda: parts.grads(batch), dev)
        events = split["top_kernels_ms"] or {}
        found = [k for k in events if any(w in k for w in NO_EXCHANGE)]
        if not events or found:
            raise AssertionError(f"the R = 1 step's device events: {len(events)}, of the "
                                 f"exchange {found}")
        out["ell"].update(
            index_add_events=[k for k in events if any(w in k for w in INDEX_ADD)],
            single_device_step_ms=single_ms, earlier_step_ms=EARLIER_STEP_MS,
            busy_share=split["busy_share"], wall_ms=split["wall_ms"],
            copies_ms=_copies_ms(events),
            top_device_ms=dict(sorted(events.items(), key=lambda kv: -kv[1])[:10]))

        # the exchange route at R = 1: the NCCL self-copy and its backward
        xparts = dist_parts(cfg, task, mesh, exchange=True)
        x_loss, x_grads, x_launched = _dist_step(xparts, batch)
        want = per_step + 2  # each layer's backward sums the returned rows: one launch
        if x_launched != {**{k: 0 for k in x_launched}, "spmm_ell": want,
                          **_loss_launches(cfg, 1)}:
            raise AssertionError(f"the exchange route's step launched {x_launched}")
        gap = _step_gap(x_loss, {**x_grads, "emb": x_grads["emb"][:task.n_ent]}, loss,
                        {**grads, "emb": grads["emb"][:task.n_ent]}, ("gc2.b",),
                        tol=STEP_TOL[torch.float32])
        op = xparts.op
        rng = torch.Generator(device=dev).manual_seed(3)
        x = torch.randn((op.n_rows, cfg.dim), generator=rng, device=dev)
        g = torch.randn((op.per_rank, cfg.n_shards * op.halo_b, cfg.dim), generator=rng,
                        device=dev)
        back = []
        for _ in range(2):
            xt = x.clone().requires_grad_()
            exchange(xt, op).backward(g)
            back.append(xt.grad)
        if not torch.equal(back[0], back[1]):
            raise AssertionError("two backward calls of the exchange differ")
        gh = torch.randn((op.n_rows, cfg.dim), generator=rng, device=dev)
        xt = x.clone().requires_grad_()

        def halo(serial):
            def call():
                xt.grad = None
                halo_spmm_ell(xt, op, force_serialize=serial).backward(gh)
            return call

        x_split = _all_events_ms(lambda: xparts.grads(batch), dev)
        x_events = x_split["top_kernels_ms"] or {}
        out["exchange_route"] = {
            "launches_per_step": x_launched["spmm_ell"], "vs_r1_step": gap,
            "bitwise_loss_vs_r1": bool(torch.equal(x_loss, loss)),
            "backward_bitwise_over_two_calls": True,
            "step_ms": time_ms(lambda: xparts.grads(batch), 1, 5),
            "halo_fwd_bwd_ms": {"overlapped": time_ms(halo(False), 1, 5),
                                "force_serialize": time_ms(halo(True), 1, 5),
                                "overlapped_again": time_ms(halo(False), 1, 5)},
            "nccl_ms": sum(v for k, v in x_events.items() if "nccl" in k),
            "copies_ms": _copies_ms(x_events), "wall_ms": x_split["wall_ms"],
            "top_device_ms": dict(sorted(x_events.items(), key=lambda kv: -kv[1])[:10])}
        del parts, xparts
    emit({"phase": "dist_fused", "leg": "r1_step", "d": cfg.dim, **out, "card": smi})
    return out


def _dist_interval(task, cfg, batch, dev: torch.device, what: str) -> dict:
    """One interval (``neg_every`` steps) of the distributed trainer's own
    step (``DistParts.loss_fn``, ``sum_grads``) on ``batch``, three ways
    (as ``_interval_replay``): replays of the captured step (capturable
    Adam), the same ``train_step``s eager with the same Adam, and eager
    with the unfused path's Adam.  The replays are held to the eager steps
    of the same Adam at REPLAY_TOL; the warm-up step's and the capture's
    launches counted through the wrappers, the replays' in a profiler
    trace of one more interval (the step's launches, each ``steps`` times);
    the step's time by events fused and unfused, the capture's seconds, the
    device's busy share over a replayed and an unfused interval."""
    steps = cfg.neg_every
    per_step = {"spmm_ell": 4 * HALO_LAYER_LAUNCHES,
                "sinkhorn_fused": (2 * cfg.sinkhorn_iters + 1) if cfg.use_sinkhorn else 0,
                **_loss_launches(cfg, 1)}
    with make_mesh(cfg.n_shards, dev) as mesh:
        parts = dist_parts(cfg, task, mesh)
        model = parts.model
        init = {k: v.detach().clone() for k, v in model.state_dict().items()}

        def gen(e):
            return step_generator(cfg, e, dev) if cfg.dropout > 0 else None

        def eager(capturable):
            model.load_state_dict(init)
            opt, sched = make_optimizer(cfg, model.parameters(), capturable=capturable)
            losses = []

            def interval():
                for e in range(steps):
                    losses.append(train_step(opt, parts.loss_fn, batch, gen(e),
                                             parts.sum_grads)[0])
                    sched.step()

            interval()
            sync(dev)
            return [float(v) for v in losses], {k: v.detach().clone() for k, v in
                                                model.state_dict().items()}, interval

        want, want_p, _ = eager(True)
        plain, _, unfused_interval = eager(False)
        model.load_state_dict(init)
        opt, sched = make_optimizer(cfg, model.parameters(), capturable=True)
        _reset_launch_counts()
        t0 = time.perf_counter()
        cap = CapturedStep(opt, parts.loss_fn, batch, dev, cfg.dropout > 0,
                           after_backward=parts.sum_grads)
        sync(dev)
        capture_s = time.perf_counter() - t0
        capture_counts = {k: v for k, v in _launch_counts().items() if v}

        def replayed():
            out = []
            for e in range(steps):
                out.append(cap.replay(step_seed(cfg, e)))
                sched.step()
            return out

        _reset_launch_counts()
        got = [float(v) for v in replayed()]
        sync(dev)
        if any(_launch_counts().values()):
            raise AssertionError(f"{what}: a replay went through a wrapper: {_launch_counts()}")
        got_p = {k: v.detach().clone() for k, v in model.state_dict().items()}
        loss_rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
        param_rel = max(float((got_p[k] - v).norm() / v.norm().clamp_min(1e-30))
                        for k, v in want_p.items())
        if loss_rel > REPLAY_TOL or param_rel > REPLAY_TOL or not all(map(math.isfinite, got)):
            raise AssertionError(f"{what}: replayed interval against eager: losses {got} / "
                                 f"{want} (rel {loss_rel}), parameters rel L2 {param_rel}")
        want_counts = {k: 2 * v for k, v in per_step.items() if v}
        if capture_counts != want_counts:
            raise AssertionError(f"{what}: warm-up and capture launched {capture_counts}, "
                                 f"expected {want_counts}")
        _, traced, every, first = _traced_launches(replayed, dev, f"{what}: a replayed interval",
                                                   warm=replayed)
        want_traced = {k: steps * per_step.get(k, 0) for k in KERNEL_SYMBOLS}
        if traced != want_traced:
            raise AssertionError(f"{what}: the trace of a replayed interval holds {traced}, "
                                 f"expected {want_traced}; its first events {first}")
        fused_ms = time_ms(replayed, 1, 3) / steps
        unfused_ms = time_ms(unfused_interval, 1, 3) / steps
        out = {"steps": steps, "losses_replayed": got, "losses_eager": want,
               "losses_eager_unfused_adam": plain, "loss_rel_err": loss_rel,
               "params_rel_l2": param_rel,
               "bitwise": got == want and all(torch.equal(got_p[k], v)
                                              for k, v in want_p.items()),
               "capture_s": capture_s, "warm_up_and_capture_launches": capture_counts,
               "replayed_launches_per_step": {k: v // steps for k, v in traced.items() if v},
               "device_events_per_step": every / steps,
               "step_ms": {"fused": fused_ms, "unfused": unfused_ms,
                           "fused_over_unfused": fused_ms / unfused_ms},
               "busy": {"replayed": _device_split(replayed, dev, top=4),
                        "unfused": _device_split(unfused_interval, dev, top=4)}}
        del cap, parts, model
    return out


def _dist_fused_run(cfg, dev, fn) -> dict:
    """A run of ``cfg`` (``fn()`` returns its ``TrainResult``), its
    launches held to the model: the boundary forwards and evals eager, the
    warm-up step and the capture (fused) or every step (unfused), the
    shortlisted ring stages."""
    res, run_s, counts = _counted(dev, fn)
    t = res.timings
    steps = t["steps"] if cfg.steps_per_call == 1 else 2  # the warm-up step and the capture
    expected = {"spmm_ell": 2 * HALO_LAYER_LAUNCHES * (2 * steps + t["forwards"] + t["evals"])}
    if cfg.use_sinkhorn:
        expected["sinkhorn_fused"] = (2 * cfg.sinkhorn_iters + 1) * steps
    if _dist_select_launches(t, cfg):
        expected["shortlist_dist"] = _dist_select_launches(t, cfg)
    expected.update(_nonzero(_dist_l1_launches(t, cfg)))
    expected.update(_nonzero(_loss_launches(cfg, steps)))
    losses = res.losses
    if counts != expected or t["steps"] != cfg.epochs or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{cfg.name} steps_per_call={cfg.steps_per_call}: launches "
                             f"{counts} (expected {expected}), timings {t}, losses {losses}")
    return {"steps_per_call": cfg.steps_per_call, "launches": counts, "run_s": run_s,
            "steady_step_s": _steady_step(t), "capture_s": t["capture_s"], "losses": losses,
            "metrics": {k: res.metrics[k] for k in ("hits@1", "hits@10", "mrr", "final_loss")},
            "stages_s": {k: t[k] for k in ("build_s", "forward_s", "propose_s", "mine_s",
                                           "final_eval_s")}}


@contextlib.contextmanager
def _results_of_run():
    """Keep what ``driver.run`` returns while the CLI calls it."""
    import tpugraph_torch.train.driver as driver_mod

    real, kept = driver_mod.run, []

    def keep(*args, **kwargs):
        kept.append(real(*args, **kwargs))
        return kept[-1]

    driver_mod.run = keep
    try:
        yield kept
    finally:
        driver_mod.run = real


def _dist_profile_leg(smi: str, dev: torch.device, task) -> dict:
    """``profile_dir`` on an unfused 6-epoch run (``DIST_CUTS``' interval,
    the ``--fast`` search set): the trace of epochs 2-5 it writes holds the
    halo SpMM's kernel records."""
    cfg = get_config("dwy100k_dist", **{**DIST_CUTS, "epochs": 6, **DIST_FAST})
    with tempfile.TemporaryDirectory() as tmp:
        res, run_s = _timed(dev, lambda: run(cfg.replace(profile_dir=tmp), task=task,
                                             device=dev))
        files = sorted(os.listdir(tmp))
        if files != ["trace-epochs-2-5.json"]:
            raise AssertionError(f"profile_dir holds {files}")
        size_mb = os.path.getsize(os.path.join(tmp, files[0])) / 2 ** 20
        with open(os.path.join(tmp, files[0])) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    spmm = [e for e in kernels if KERNEL_SYMBOLS["spmm_ell"] in e["name"]]
    if not spmm:
        raise AssertionError(f"the trace holds no spmm_ell record of {len(kernels)} kernels")
    out = {"trace": files[0], "trace_mb": size_mb, "kernel_records": len(kernels),
           "spmm_ell_records": len(spmm), "steps": res.timings["steps"], "run_s": run_s}
    emit({"phase": "dist_fused", "leg": "profile_dir", **out, "card": smi})
    return out


def phase_dist_fused(smi: str, dev: torch.device, dist: dict, leg_a_stages: dict) -> dict:
    """``dwy100k_dist`` at full width on an NCCL group of one rank holding
    the 8 shards: the R = 1 step (``_dist_r1_leg``); one interval replayed
    against eager at d 128 (``DIST_CUTS``) and on v7r
    (``DIST_V7R_CUTS``, ``steps_per_call = neg_every = 2``) with its
    launches, capture seconds, steady step fused and unfused and busy
    shares (``_dist_interval``); ``--config dwy100k_dist --fast`` through
    the CLI (``DIST_CUTS``) and the fused v7r run of phase 21's leg A's
    configuration, their steady steps beside the unfused runs' of phases 19
    and 21; and ``profile_dir`` (``_dist_profile_leg``)."""
    cfg = get_config("dwy100k_dist", **DIST_CUTS)
    task = load_task(cfg)
    r1 = _dist_r1_leg(smi, dev, task, cfg)
    v7r = get_config("dwy100k_dist", **RECIPES["v7r"]).replace(
        sinkhorn_pairs=DIST_V7R_OT_PAIRS, **DIST_V7R_CUTS)
    intervals = {"d128": _dist_interval(task, cfg, _dist_batch(task, cfg, dev), dev, "d128"),
                 "v7r": _dist_interval(task, v7r, mp_worker.surface_batch(v7r, task, device=dev),
                                       dev, "v7r")}
    emit({"phase": "dist_fused", "leg": "interval_replay", "replay_tol": REPLAY_TOL,
          **intervals, "card": smi})
    def cli_fast():
        with _results_of_run() as kept:
            if cli_main(["--config", "dwy100k_dist", "--fast", "--quiet", "--set",
                         *(f"{k}={v}" for k, v in DIST_CUTS.items())]) != 0:
                raise AssertionError("the CLI with --fast failed")
        return kept[0]

    d128 = _dist_fused_run(cfg.replace(steps_per_call=cfg.neg_every, **DIST_FAST), dev, cli_fast)
    v7r_cfg = v7r.replace(**DIST_APPROX, steps_per_call=v7r.neg_every)
    v7r_fast = _dist_fused_run(v7r_cfg, dev, lambda: run(v7r_cfg, task=task, device=dev))
    runs = {"d128_cli_fast": {**d128, "unfused_steady_step_s_phase19": dist["steady_step_s"]},
            "v7r_fast": {**v7r_fast,
                         "unfused_steady_step_s_phase21_leg_a": leg_a_stages["steady_step_s"]}}
    emit({"phase": "dist_fused", "leg": "fused_runs", **runs, "card": smi})
    profile = _dist_profile_leg(smi, dev, task)
    return {"r1": r1, "intervals": intervals, "runs": runs, "profile": profile}


def _hits_of(ranks: torch.Tensor) -> tuple:
    """(Hits@1, Hits@10, MRR) of both directions' ranks, as ``hits_at_k``."""
    r = ranks.double()
    return (float((r < 1).double().mean()), float((r < 10).double().mean()),
            float((1.0 / (r + 1.0)).mean()))


# ---- the training step's loss kernels: the L1 margin and the OT reverse update

# (name, table rows, pairs, k, d, γ, weighted): the margin at its callers'
# shapes (the weighted ones hold 2,500 proposals beside the seeds)
MARGIN_SHAPES = (("v6_zh_en", 38_000, 7_000, 100, 256, 15.0, True),
                 ("sinkhorn_zh_en", 38_000, 4_500, 50, 128, 10.0, False),
                 ("dwy100k_dist_d128", 200_000, 15_000, 25, 128, 10.0, False),
                 ("v7r_dwy100k_dist", 200_000, 17_500, 100, 256, 15.0, True))
# against the plain composite: on rows whose hinges lie 1e-4 clear of their
# threshold only the sums' order differs (the loss rel 1e-5, the gradient,
# exact signs times one coefficient, relative L2 1e-5); on the rows as drawn
# a hinge within rounding of its threshold may flip, held at PERF.md §2's
# step limit
MARGIN_TOL = {"loss_rel": 1e-5, "grad_rel_l2": 1e-5}
MARGIN_NEAR = 1e-4
# (name, pairs, d): the reverse update at 4,500² (configs sinkhorn and v6)
# and at the ring's block (v7r's 4,096 OT pairs, one rank); C̄ and b̄ in
# relative L2 (the same steps in the same order, exp to an ulp or two, b̄
# summed in another order)
REVERSE_SHAPES = (("zh_en_d256", 4500, 256), ("zh_en_d128", 4500, 128),
                  ("ring_block_d256", DIST_V7R_OT_PAIRS, 256))
REVERSE_TOL = 1e-5


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-300))


def _margin_inputs(n: int, s: int, k: int, d: int, gamma: float, weighted: bool,
                   dev: torch.device, seed: int = 11):
    """A table whose pair rows lie about 0.2·γ apart in L1 and other rows
    about 1.2·γ (so about half the hinges are active), pairs between the two
    halves, k uniform negatives a side from the partner's half; an entity
    in two pairs, one pair's negatives all one pair row, a hub row that
    every pair reaches once, 1 % of the rows with the pool-of-one tie;
    weighted: the last 2,500 pairs (proposals; half the pairs below 5,000)
    at 0.5·u, u uniform."""
    g = torch.Generator(device=dev).manual_seed(seed)
    sigma = 1.2 * gamma / (1.128 * d)  # E|x − y| = 1.128·σ for x, y ~ N(0, σ²)
    emb = torch.randn((n, d), generator=g, device=dev) * sigma
    half = n // 2
    left = torch.randperm(half, generator=g, device=dev)[:s]
    right = half + torch.randperm(n - half, generator=g, device=dev)[:s]
    left[1] = left[0]
    emb[right] = emb[left] + torch.randn((s, d), generator=g, device=dev) * (sigma / 6)
    pairs = torch.stack([left, right], 1)
    neg_l = torch.randint(0, half, (s, k), generator=g, device=dev)
    neg_r = torch.randint(half, n, (s, k), generator=g, device=dev)
    neg_r[: s // 100, 0] = right[: s // 100]
    neg_l[2, :] = left[3]
    neg_r[:, 1] = right[s // 2]  # a hub, as hard negatives crowd on hubs: S records
    w = None
    if weighted:
        n_prop = min(2500, s // 2)
        w = torch.ones(s, device=dev)
        w[s - n_prop:] = 0.5 * torch.rand(n_prop, generator=g, device=dev)
    return emb, pairs, neg_l, neg_r, w


def _clear_near_threshold(emb, pairs, neg_l, neg_r, gamma: float) -> int:
    """Move each negative whose hinge argument lies within MARGIN_NEAR of 0
    (in float64) to the pair's partner, whose entry has no gradient: the
    count moved."""
    e = emb.double()
    d_pos = (e[pairs[:, 0]] - e[pairs[:, 1]]).abs().sum(1, keepdim=True)
    moved = 0
    for neg, own, part in ((neg_r, 0, 1), (neg_l, 1, 0)):
        for i0 in range(0, neg.shape[0], 1024):
            blk, rows = neg[i0:i0 + 1024], pairs[i0:i0 + 1024]
            h = d_pos[i0:i0 + 1024] + gamma - (e[rows[:, own]][:, None] - e[blk]).abs().sum(2)
            near = h.abs() < MARGIN_NEAR
            moved += int(near.sum())
            blk[near] = rows[:, part:part + 1].expand_as(blk)[near]
    return moved


def _captured_equals_eager(call) -> bool:
    """``call()`` captured as a CUDA graph (after a warm-up on the capture
    stream) and replayed twice: each replay's outputs equal the eager
    call's bit for bit."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        want = call()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = call()
    same = True
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        same &= all(torch.equal(a, b) for a, b in zip(out, want))
    return same


def _reloaded_capture(call, first: list, second: list) -> bool:
    """``call(*bufs)`` captured as a CUDA graph over the static buffers
    ``bufs`` (copies of ``first``): a replay equals the eager call on
    ``first``, and after ``second`` is copied into the buffers (as
    ``CapturedStep.load`` reloads a batch) a replay equals the eager call
    on ``second``, bit for bit."""
    bufs = [t.clone() for t in first]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        want = call(*first)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = call(*bufs)
    same = True
    for src, want_src in ((first, want), (second, call(*second))):
        for buf, t in zip(bufs, src):
            buf.copy_(t)
        graph.replay()
        torch.cuda.synchronize()
        same &= all(torch.equal(a, b) for a, b in zip(out, want_src))
    return same


def _margin_turns(calls: dict, timer) -> dict:
    """Each of ``calls`` (the previous kernel first) timed by ``timer`` in turns
    (parent, this, this, parent): each one's mean."""
    names = list(calls)
    readings = {k: [] for k in names}
    for route in (*names, *names[::-1]):
        readings[route].append(timer(calls[route]))
    return {k: float(np.mean(v)) for k, v in readings.items()}


def _margin_case(name: str, n: int, s: int, k: int, d: int, gamma: float, weighted: bool,
                 smi: str, dev: torch.device) -> dict:
    """The margin kernel (forward and backward, the backward's index built
    once beforehand, as the batch carries it) against the plain composite
    at one shape: on the rows as drawn at PERF.md §2's step limit, with the
    hinge flips counted; with the hinges near their threshold moved, at
    MARGIN_TOL; every row of the gradient written (its memory prefilled
    with NaN), two calls bit for bit, a captured replay equal to eager;
    timed by events warm and with the L2 flushed, beside the gather-only
    entry, the plain version and the bound; the sign planes' size; the
    index its kernel entries build equal to the plain version's.  With
    ``--parent-margin`` also held bit for bit to the previous kernel (loss and
    gradient, on both sets of rows) and timed in turns with it: forward,
    forward + backward warm and flushed, and the index."""
    emb, pairs, neg_l, neg_r, w = _margin_inputs(n, s, k, d, gamma, weighted, dev)
    e = emb.requires_grad_(True)

    def step(fn, nl, nr):
        def call():  # the loss detached: no graph of the table outlives the call
            loss = fn(e, pairs, nl, nr, gamma, w)
            return loss.detach(), torch.autograd.grad(loss, e)[0]
        return call

    def with_index(nl, nr):
        index = margin_l1.build_index(pairs, nl, nr, n)
        if not torch.equal(index, margin_l1.build_index_plain(pairs, nl, nr, n)):
            raise AssertionError(f"margin {name}: the index kernel's index differs from the "
                                 f"plain version's")
        return lambda *a: margin_l1.margin_l1_loss(*a, index=index)

    parent = PARENT_MARGIN
    vs_parent = {}
    # the rows as drawn: PERF.md §2's step limit, the hinge flips counted
    got, want = step(with_index(neg_l, neg_r), neg_l, neg_r)(), step(margin_loss_plain, neg_l,
                                                                    neg_r)()
    flags = margin_l1._forward_cuda(emb.detach(), pairs, neg_l, neg_r, gamma, w)[1]
    flips = int((flags != margin_forward_plain(emb.detach(), pairs, neg_l, neg_r, gamma,
                                               w)[1]).sum())
    raw = {"loss_rel": abs(float(got[0]) - float(want[0])) / abs(float(want[0])),
           "grad_rel_l2": _rel_l2(got[1], want[1]), "hinge_flips": flips,
           "entries": 2 * s * k}
    if raw["loss_rel"] > STEP_TOL[torch.float32]["loss_rel"] or (
            raw["grad_rel_l2"] > STEP_TOL[torch.float32]["grad_rel_l2"]):
        raise AssertionError(f"margin {name} on the rows as drawn: {raw}")
    if parent is not None:
        old = step(parent["loss"], neg_l, neg_r)()
        vs_parent["as_drawn_bitwise"] = torch.equal(got[0], old[0]) and torch.equal(got[1],
                                                                                   old[1])
    # hinges clear of their threshold: only the sums' order differs
    nl, nr = neg_l.clone(), neg_r.clone()
    moved = _clear_near_threshold(emb.detach(), pairs, nl, nr, gamma)
    fn = with_index(nl, nr)
    kernel, plain = step(fn, nl, nr), step(margin_loss_plain, nl, nr)
    want = plain()
    runs = []
    for _ in range(2):
        torch.full((n, d), float("nan"), device=dev)  # the gradient lands on NaNs
        runs.append(kernel())
    sync(dev)
    (loss, grad), again = runs
    clean = {"loss_rel": abs(float(loss) - float(want[0])) / abs(float(want[0])),
             "grad_rel_l2": _rel_l2(grad, want[1]), "moved_near_threshold": moved}
    bitwise = torch.equal(loss, again[0]) and torch.equal(grad, again[1])
    if (clean["loss_rel"] > MARGIN_TOL["loss_rel"] or clean["grad_rel_l2"] > MARGIN_TOL[
            "grad_rel_l2"] or not bool(torch.isfinite(grad).all()) or not bitwise):
        raise AssertionError(f"margin {name}: {clean}, finite {bool(torch.isfinite(grad).all())}"
                             f", two calls bit for bit {bitwise}")
    captured = _captured_equals_eager(kernel)
    if not captured:
        raise AssertionError(f"margin {name}: a captured replay differs from eager")
    # the captured step reloaded with a second batch's negatives and index
    g2 = torch.Generator(device=dev).manual_seed(12)
    nl2 = torch.randint(0, n // 2, (s, k), generator=g2, device=dev)
    nr2 = torch.randint(n // 2, n, (s, k), generator=g2, device=dev)

    def indexed(nl_, nr_, index):
        loss = margin_l1.margin_l1_loss(e, pairs, nl_, nr_, gamma, w, index=index)
        return loss.detach(), torch.autograd.grad(loss, e)[0]

    reloaded = _reloaded_capture(
        indexed, [nl, nr, margin_l1.build_index(pairs, nl, nr, n)],
        [nl2, nr2, margin_l1.build_index(pairs, nl2, nr2, n)])
    if not reloaded:
        raise AssertionError(f"margin {name}: a captured replay after a reload of negatives "
                             f"and index differs from the second batch's eager call")
    if parent is not None:
        old_kernel = step(parent["loss"], nl, nr)
        old = old_kernel()
        vs_parent["clear_bitwise"] = torch.equal(loss, old[0]) and torch.equal(grad, old[1])
        if not (vs_parent["as_drawn_bitwise"] and vs_parent["clear_bitwise"]):
            raise AssertionError(f"margin {name}: not bit for bit the previous kernel {vs_parent}")
    # the gather alone, the forward's floor: against its plain version
    gathered = margin_l1.gather_rows_sum(e.detach(), nl, nr)
    g_plain = margin_l1.gather_rows_sum_plain(e.detach(), nl, nr)
    gather_err = float((gathered - g_plain).abs().max() / g_plain.abs().max())
    if gather_err > 1e-4:
        raise AssertionError(f"margin {name}: the gather-only entry is {gather_err} off")
    with torch.no_grad():
        fwd_ms = time_ms(lambda: fn(e, pairs, nl, nr, gamma, w))
    ms = time_ms(kernel)
    ms_cold = time_cold_ms(kernel)
    index_ms = time_ms(lambda: margin_l1.build_index(pairs, nl, nr, n))
    index_plain_ms = time_ms(lambda: margin_l1.build_index_plain(pairs, nl, nr, n))
    gather_ms = time_ms(lambda: margin_l1.gather_rows_sum(e.detach(), nl, nr))
    gather_ms_cold = time_cold_ms(lambda: margin_l1.gather_rows_sum(e.detach(), nl, nr))
    dev_ms = device_ms(kernel, iters=5)  # the device's work alone: small shapes wait on the host
    plain_ms = time_ms(plain, 1, 5)
    plain_fwd_ms = time_ms(lambda: margin_loss_plain(e.detach(), pairs, nl, nr, gamma, w), 1, 5)
    if parent is not None:
        calls = {"parent": old_kernel, "this": kernel}

        def forward_of(f):
            def call():
                with torch.no_grad():
                    return f(e, pairs, nl, nr, gamma, w)
            return call

        vs_parent.update({
            "ms": _margin_turns(calls, time_ms),
            "ms_cold_l2": _margin_turns(calls, time_cold_ms),
            "forward_ms": _margin_turns({"parent": forward_of(parent["loss"]),
                                         "this": forward_of(fn)}, time_ms),
            "index_ms": _margin_turns({"parent": lambda: parent["index"](pairs, nl, nr, n),
                                       "this": lambda: margin_l1.build_index(pairs, nl, nr, n)},
                                      time_ms),
            "device_ms": {"parent": device_ms(old_kernel, iters=5), "this": dev_ms}})
        vs_parent["backward_ms"] = {r: vs_parent["ms"][r] - vs_parent["forward_ms"][r]
                                    for r in ("parent", "this")}
    # each input read once (the table, the ids, the weights), the loss and
    # the table's gradient written once; 3 fp32 operations an element of
    # each of the 2·S·k row pairs, forward and backward
    nbytes = 2 * n * d * 4 + (2 * s * k + 2 * s) * 8 + (s * 4 if weighted else 0) + 4
    bound, bound_by = _bound(nbytes, 12 * s * k * d)
    # every gathered row read from device memory in both passes (no L2 hit):
    # an estimate for a table above the 50 MB L2, not a bound
    rows_bytes = 2 * 2 * s * k * d * 4
    plane_bytes = 32 * margin_l1.plane_bytes(d)  # a record's, all 32 lanes
    active = int((flags & 1).bool().sum() + (flags & 2).bool().sum())
    out = {"name": name, "n": n, "s": s, "k": k, "d": d, "gamma": gamma, "weighted": weighted,
           "table_mb": n * d * 4 / 2**20, "table_in_l2": n * d * 4 < 50e6,
           "as_drawn": raw, "clear": clean, "tolerance": MARGIN_TOL, "bitwise": bitwise,
           "captured_equals_eager": captured, "captured_after_reload_equals_eager": reloaded,
           "max_abs_err": float((grad - want[1]).abs().max()),
           "ms": ms, "ms_cold_l2": ms_cold, "device_ms": dev_ms, "forward_ms": fwd_ms,
           "backward_ms": ms - fwd_ms, "index_ms": index_ms, "index_plain_ms": index_plain_ms,
           "gather_ms": gather_ms, "gather_ms_cold_l2": gather_ms_cold,
           "gather_rel_err": gather_err, "plain_ms": plain_ms, "plain_forward_ms": plain_fwd_ms,
           "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
           "rows_from_hbm_ms": rows_bytes / HBM_BYTES_PER_S * 1e3,
           "active_records": active,
           "planes_mb": {"active": active * plane_bytes / 2**20,
                         # above margin_l1.SLAB the forward writes every record's
                         "written": (2 * s * k if d > margin_l1.SLAB else active) * plane_bytes
                         / 2**20,
                         "allocated": 2 * s * k * plane_bytes / 2**20,
                         "pair_vectors": 2 * s * d * 4 / 2**20,
                         "index": margin_l1.index_size(s, k, n) * 4 / 2**20},
           "vs_parent": vs_parent or None}
    emit({"phase": "step_losses", "kernel": "margin_l1", **out, "card": smi})
    return out


def _reverse_case(name: str, s: int, d: int, smi: str, dev: torch.device,
                  tau: float = 0.3) -> dict:
    """The reverse update against its plain version at one (s, s) block of
    the sqeuclidean cost of unit rows, both modes: C̄ and b̄ at REVERSE_TOL
    (b̄'s memory prefilled with NaN), two calls bit for bit, a captured
    replay equal to eager; timed by events warm and with the L2 flushed,
    beside the plain version and the bound."""
    l, r, _, _ = _sinkhorn_inputs(dev, s, d)
    cost = (sq_norms(l)[:, None] + sq_norms(r)[None, :] - 2.0 * (l @ r.t())).clamp_min(0.0)
    g = torch.Generator(device=dev).manual_seed(3)
    out = {"name": name, "s": s, "d": d, "tau": tau}
    for rows in (True, False):
        b = 0.1 * torch.randn(s, generator=g, device=dev)
        z = ((b[None, :] if rows else b[:, None]) - cost) / tau
        lse = torch.logsumexp(z, dim=1 if rows else 0)
        ob = torch.randn(s, generator=g, device=dev) / s
        cbar0 = 1e-3 * torch.randn((s, s), generator=g, device=dev)
        want_c = cbar0.clone()
        want_b = sinkhorn_reverse_plain(want_c, cost, b, lse, ob, tau, rows)
        runs = []
        for _ in range(2):
            cbar = cbar0.clone()
            torch.full((s,), float("nan"), device=dev)  # b̄ lands on NaNs
            runs.append((sinkhorn_reverse(cbar, cost, b, lse, ob, tau, rows), cbar))
        sync(dev)
        (got_b, got_c), (b2, c2) = runs
        err = {"cbar_rel_l2": _rel_l2(got_c, want_c), "bbar_rel_l2": _rel_l2(got_b, want_b)}
        bitwise = torch.equal(got_b, b2) and torch.equal(got_c, c2)
        cap = cbar0.clone()

        def call():
            cap.copy_(cbar0)
            return sinkhorn_reverse(cap, cost, b, lse, ob, tau, rows), cap

        captured = _captured_equals_eager(call)
        if (max(err.values()) > REVERSE_TOL or not bool(torch.isfinite(got_b).all())
                or not bitwise or not captured):
            raise AssertionError(f"reverse {name} rows={rows}: {err}, bit for bit {bitwise}, "
                                 f"captured {captured}")
        del runs, want_c, z
        ms = time_ms(lambda: sinkhorn_reverse(got_c, cost, b, lse, ob, tau, rows))
        dev_ms = device_ms(lambda: sinkhorn_reverse(got_c, cost, b, lse, ob, tau, rows))
        ms_cold = time_cold_ms(lambda: sinkhorn_reverse(got_c, cost, b, lse, ob, tau, rows))
        plain_ms = time_ms(lambda: sinkhorn_reverse_plain(got_c, cost, b, lse, ob, tau, rows),
                           1, 5)
        # C read once, C̄ read and written once, the three vectors and b̄;
        # an exp and five fp32 operations an entry
        bound, bound_by = _bound(12 * s * s + 4 * 4 * s, 6 * s * s)
        out["rows" if rows else "columns"] = {
            **err, "tolerance": REVERSE_TOL, "bitwise": bitwise, "captured_equals_eager": captured,
            "max_abs_err": float((got_b - want_b).abs().max()), "ms": ms, "ms_cold_l2": ms_cold,
            "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by, "library_ms": None}
    emit({"phase": "step_losses", "kernel": "sinkhorn_reverse", **out, "card": smi})
    return out


def _one_step(model, op, batch):
    def step():
        model.zero_grad(set_to_none=True)
        model(op, batch, train=True)[0].backward()
    return step


def _route_medians(turns: dict) -> dict:
    """Each route's median of its readings (numbers, or dicts of them)."""
    def med(vals):
        if isinstance(vals[0], dict):
            return {k: med([v[k] for v in vals]) for k in vals[0] if k != "shares"}
        return float(np.median(vals))
    return {route: med(vals) for route, vals in turns.items()}


def phase_step_losses(smi: str, dev: torch.device, dist_v7r: dict) -> dict:
    """The step's loss kernels on the card: ``margin_l1`` at MARGIN_SHAPES
    and ``sinkhorn_reverse`` at REVERSE_SHAPES against their plain versions
    (``_margin_case``, ``_reverse_case``); then the steps of config
    sinkhorn, recipe v6 and v7r (STEP_CASES) by events and split by head
    (``_profile_step``), on the kernels and on the parent's route (the two
    kernels' plain versions, ``_parent_loss_route``) in turns, beside the
    distributed v7r step's (``phase_dist_v7r``)."""
    t0 = time.perf_counter()
    margin = {c[0]: _margin_case(*c, smi, dev) for c in MARGIN_SHAPES}
    torch.cuda.empty_cache()
    reverse = {c[0]: _reverse_case(*c, smi, dev) for c in REVERSE_SHAPES}
    torch.cuda.empty_cache()
    steps = {}
    for name, (model, op, batch, cfg) in STEP_CASES.items():
        step = _one_step(model, op, batch)
        by_events = _in_turns(lambda: time_ms(step, 1, 5))
        split = _in_turns(lambda: _profile_step(model, op, batch, cfg, dev))
        steps[name] = {"step_ms": _route_medians(by_events), "step_ms_turns": by_events,
                       "head_split_s": _route_medians(split)}
    dist = dist_v7r["step_by_route"]
    steps["dist_v7r"] = {"step_ms": _route_medians(dist["step_ms_by_route"]),
                         "head_split_s": _route_medians(dist["head_split"])}
    emit({"phase": "step_losses", "steps": steps, "routes": list(steps["dist_v7r"]["step_ms"]),
          "phase_s": time.perf_counter() - t0, "card": smi})
    return {"margin": margin, "reverse": reverse, "steps": steps}


# Every width the JAX package takes: the changed kernels at widths with no
# instance (50 and 300 with a masked tail, the sweeps' 384 and 512; bf16 at
# 300 and 384; WIDE_DS above 512) on the zh-en task, and the repo's own runs at
# those widths (scripts/ot_sweep.py:72-73, the JAX CLI's docstring,
# scripts/v7_sweep.py:70), cut as phase 6 cuts v6: (name, config, recipe,
# overrides).  50 % 4 = 2 and 300 % 8 = 4 are chosen to hit the tails.
WIDTH_DS = (50, 300, 384, 512)
WIDTH_BF16_DS = (300, 384)
# above 512: one column past a slab and a panel (514, the margin's second
# slab 2 wide, 1 float4 past the panels), the attribute channel's table at
# dim 384 (768), and 1,030 (3 slabs, a tail no multiple of 4); the SpMMs
# also in bf16 at 768.  The searches run here too, at their mining and
# count (top-k) or CSLS-eval (select) shapes of L1_SHAPES and SELECT_SHAPES.
WIDE_DS = (514, 768, 1030)
WIDE_BF16_DS = (768,)
WIDE_L1 = ("mining", "ranks")
WIDE_SELECT = ("mining", "eval_csls")
# the GCN layer at widths without a fused instance: x·W, then spmm_ell
LAYER_DS = (384, 512, 768)
WIDTH_RUNS = (("v6_dim384", "base", "v6", dict(dim=384)),
              ("v6_dim512", "base", "v6", dict(dim=512)),
              ("base_dim64", "base", None, dict(dim=64)),
              ("base_dim50_hidden300", "base", None, dict(dim=50, hidden=300)),
              ("v6_dim384_bf16", "base", "v6", dict(dim=384, param_dtype="bfloat16")),
              ("base_dim384_sorted", "base", None, dict(dim=384, spmm_impl="sorted")),
              # the channel's table 768 wide through every search, as
              # scripts/v7_sweep.py's ae runs it at scripts/ot_sweep.py:72's dim
              ("mtl_ae_dim384", "mtl", None, dict(dim=384, use_attr_channel=True)),
              # every training kernel but gcn_fused at d 768
              ("v6_dim768", "base", "v6", dict(dim=768)))
# config base's runs: 8 intervals of its 5 epochs, so the loss ends below its
# first value after each mining's jump even at the narrow widths
WIDTH_BASE_CUTS = {"epochs": 40, "eval_every": 0}
WIDTH_MTL_CUTS = {"epochs": 10, "eval_every": 0}  # phase_mtl's
WIDTH_MARGIN = ("v6_zh_en", 38_000, 7_000, 100, 15.0, True)  # MARGIN_SHAPES' v6 row, any d
WIDTH_DIST_DIMS = (384, 768)


def _falls_per_interval(losses: list, every: int) -> bool:
    """Each resample interval's last loss below its first (an interval of
    one step has nothing to compare)."""
    ends = [(i, min(i + every, len(losses)) - 1) for i in range(0, len(losses), every)]
    return all(losses[b] < losses[a] for a, b in ends if b > a)


def _width_run(task, name: str, config: str, recipe: str | None, over: dict, dev) -> dict:
    """One run of WIDTH_RUNS through ``driver.run`` (``_run_checked``: its
    launches held to ``_expected_launches``, which knows each layer's route
    by width), the losses falling in every resample interval, and one step
    held to the plain path at ``STEP_TOL`` of the run's type: on a uniform
    batch, or with the relation and attribute heads (config mtl) on the
    run's last interval batch as its checkpoint saved it (``_saved_batch``:
    the heads' draws too)."""
    cuts = RECIPE_CUTS if recipe else WIDTH_MTL_CUTS if config == "mtl" else WIDTH_BASE_CUTS
    cfg, reduced = _cut_config(task, config, cuts, recipe, **over)
    boundaries = (cfg.epochs - 1) // cfg.neg_every
    timing = dict(steps=cfg.epochs, forwards=boundaries, minings=boundaries)
    if recipe:
        timing["proposals"] = boundaries
    heads = cfg.use_rel_head or cfg.use_attr_head  # their draws come with the saved batch
    with tempfile.TemporaryDirectory() as tmp:
        if heads:
            cfg = cfg.replace(checkpoint_dir=tmp, checkpoint_every=cfg.epochs)
        res, counts, run_s = _run_checked(cfg, task, dev, **timing)
        batch = _saved_batch(tmp, cfg, task, dev)[0] if heads else _step_batch(res, cfg, dev)
    if not _falls_per_interval(res.losses, cfg.neg_every):
        raise AssertionError(f"{name}: the loss does not fall in every interval: {res.losses}")
    model, op = res.model, res.op
    dtype = getattr(torch, cfg.param_dtype)
    if uses_mtl(cfg):
        attr_op = (build_attr_operator(task.merged_attr_triples, task.n_ent, task.n_attr).to(dev)
                   if cfg.use_attr_channel else None)
        zero = ("ae_encoder.gc2.b",) if cfg.use_attr_channel else ()
        step = _check_step(model, lambda: model(op, batch, train=True, attr_op=attr_op)[0],
                           _mtl_step_launches(cfg), zero, dtype=dtype)
    else:
        step = _check_step(model, lambda: margin_align_loss(
            model(op, train=True), batch["pairs"], batch["neg_l"], batch["neg_r"], cfg.gamma),
            _per_step_launches(cfg), ("gc2.b",), dtype=dtype)
    out = {"dim": cfg.dim, "hidden": cfg.hidden or cfg.dim, "spmm_impl": cfg.spmm_impl,
           "param_dtype": cfg.param_dtype, "config": config,
           "search_width": 2 * cfg.dim if cfg.use_attr_channel else cfg.dim,
           "layer_routes": dict(zip(("fused", "x_w_then_spmm"), _layer_routes(cfg))),
           "reduced": reduced, "losses": res.losses, "launches": counts, "run_s": run_s,
           "step_median_s": float(np.median(res.timings["step_s"])),
           "stages_s": _stages(res.timings),
           "metrics": {k: res.metrics[k] for k in ("hits@1", "hits@10", "mrr")},
           "step_check": step}
    del res, model, op, batch
    torch.cuda.empty_cache()
    return out


def _width_dist_step(task, dev: torch.device, dim: int) -> dict:
    """One ``dwy100k_dist`` step at ``dim`` (R = 1, one rank holding the 8
    shards; 4 ``spmm_ell`` launches a way) held to the single-device step's
    plain path at STEP_TOL[fp32]; the single-device step through its
    kernels (each layer x·W then ``spmm_ell``) held to it too."""
    cfg = get_config("dwy100k_dist", **DIST_CUTS, dim=dim)
    batch = _dist_batch(task, cfg, dev)
    single = step_parts(cfg.replace(n_shards=1), task, dev)

    def single_step():
        single.model.zero_grad(set_to_none=True)
        _reset_launch_counts()
        loss = single.loss_fn(batch, None)[0]
        loss.backward()
        sync(dev)
        return loss.detach(), {k: p.grad.clone() for k, p in single.model.named_parameters()}

    s_kernels = single_step()
    single_launches = _launch_counts()
    if single_launches != {**{k: 0 for k in single_launches}, "spmm_ell": 4,
                           **_loss_launches(cfg, 1)}:
        raise AssertionError(f"the single-device step at dim {cfg.dim} launched "
                             f"{single_launches}")
    with _plain_kernels():
        s_plain = single_step()

    def gap(step, ref):  # the table's gradient on its n real rows
        (loss, grads), (ref_loss, ref_grads) = step, ref
        return _step_gap(loss, {**grads, "emb": grads["emb"][:task.n_ent]}, ref_loss, ref_grads,
                         ("gc2.b",), tol=STEP_TOL[torch.float32])

    out = {"dim": cfg.dim, "single_kernels_vs_plain": gap(s_kernels, s_plain),
           "single_launches": _nonzero(single_launches)}
    del single
    with make_mesh(cfg.n_shards, dev) as mesh:
        parts = dist_parts(cfg, task, mesh)
        loss, grads, launched = _dist_step(parts, batch)
        per_step = 4 * HALO_LAYER_LAUNCHES
        if launched != {**{k: 0 for k in launched}, "spmm_ell": per_step,
                        **_loss_launches(cfg, 1)}:
            raise AssertionError(f"the distributed step launched {launched}")
        out.update(vs_single_plain=gap((loss, grads), s_plain), launches=_nonzero(launched),
                   step_ms=time_ms(lambda: parts.grads(batch), 1, 5))
        del parts
    torch.cuda.empty_cache()
    return out


def _unfused_layer_case(op, a_csr, rng, d: int, smi: str) -> dict:
    """The GCN layer at (d, d) where ``gcn_fused`` has no instance, by the
    port's route (``gcn_layer``: x·W by ``torch.matmul``, then one
    ``spmm_ell`` launch over ``op.fwd``) against its plain version
    (``gcn_layer_plain``), two calls bit for bit; timed beside it,
    cuSPARSE + GEMM and the bound: x, W, b, the ELL arrays, the diagonal
    read once and the output written once, or the product and the edges'
    operations at the fp32 SIMT rate (a fp32 ``matmul`` runs in full fp32
    here, and the ELL sums are fp32), whichever is larger."""
    dev = op.fwd.device
    x = torch.from_numpy(rng.standard_normal((op.n_rows, d)).astype(np.float32)).to(dev)
    wm = torch.from_numpy((rng.standard_normal((d, d)) / np.sqrt(d)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.standard_normal(d).astype(np.float32)).to(dev)
    if gcn_fused.fused_width(d, d):
        raise AssertionError(f"({d}, {d}) has a fused instance")

    def layer():
        with torch.no_grad():
            return gcn_fused.gcn_layer(op, x, wm, b)

    before = spmm_ell.launches
    got = layer()
    sync(dev)
    if spmm_ell.launches != before + 1:
        raise AssertionError(f"the layer at ({d}, {d}) launched {spmm_ell.launches - before} "
                             f"spmm_ell")
    want = gcn_fused.gcn_layer_plain(op, x, wm, b)
    torch.testing.assert_close(got, want, **TOL[torch.float32])
    if not torch.equal(got, layer()):
        raise AssertionError(f"the layer at ({d}, {d}): two calls differ")

    def library():
        return torch.sparse.mm(a_csr, x) @ wm + b

    torch.testing.assert_close(library(), want, **TOL[torch.float32])
    m = op.fwd
    ell_bytes = sum(bk.rows.numel() * 4 + bk.idx.numel() * 4 + bk.w.numel() * 4
                    for bk in m.buckets)
    nbytes = (2 * op.n_rows * d + d * d + d) * 4 + op.diag.numel() * 4 + ell_bytes
    bound, bound_by = _bound(nbytes, 2 * (m.nnz + op.n_diag) * d + 2 * op.n_rows * d * d)
    ms, dev_ms = time_ms(layer), device_ms(layer)
    out = dict(d_in=d, d_out=d, route="x·W by torch.matmul, then spmm_ell",
               max_abs_err=float((got - want).abs().max()), ms=ms, device_ms=dev_ms,
               ms_cold_l2=time_cold_ms(layer),
               plain_ms=time_ms(lambda: gcn_fused.gcn_layer_plain(op, x, wm, b), iters=5),
               library_ms=time_ms(library), library_device_ms=device_ms(library),
               library="cuSPARSE (torch.sparse.mm) + GEMM", bound_ms=bound, bound_by=bound_by,
               share_of_bound=bound / ms, share_of_bound_device=ratio(bound, dev_ms))
    emit({"phase": "widths", "kernel": "gcn_layer_unfused", **out, "bit_identical_runs": True,
          "card": smi})
    return out


def phase_widths(task, dist_task, smi: str, dev: torch.device) -> dict:
    """The port at widths the fused GCN layer has no instance for, on the
    card.  The ELL SpMM on the zh-en transpose and the sorted SpMM on the
    zh-en adjacency (their panel path), the L1 margin at recipe v6's shape
    (its masked instances; 384 and 512 have float4 ones; above 512 the slab
    kernels) and the Sinkhorn update at 4,500² (above 256 the strip
    streams), each at WIDTH_DS and WIDE_DS in fp32 and the SpMMs at
    WIDTH_BF16_DS and WIDE_BF16_DS in bf16; at WIDE_DS also the L1 search at
    its WIDE_L1 and the select kernel at its WIDE_SELECT shapes (above 512
    its strip streams): against the plain version at PERF.md §2's limits,
    on NaN-prefilled output memory (the SpMMs, the margin), two launches
    bit for bit, timed by events (and the profiler's device time) beside
    the plain version, the library call (cuSPARSE by ``torch.sparse.mm``;
    ``addmm`` + ``logsumexp`` for the update; ``cdist`` + ``topk`` for the
    L1 search; the replaced route for the select kernel) and the bound.
    Then the WIDTH_RUNS through ``driver.run`` (``_width_run``) and one
    ``dwy100k_dist`` step at each of WIDTH_DIST_DIMS (``_width_dist_step``)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(25)
    op = build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel).to(dev)
    sop = build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel,
                          fmt="sorted").to(dev)
    csr = _csr_of_edges(sop.fwd)
    cases = ([(d, torch.float32) for d in WIDTH_DS + WIDE_DS]
             + [(d, torch.bfloat16) for d in WIDTH_BF16_DS + WIDE_BF16_DS])
    kernels = {"spmm_ell": {}, "spmm_sorted": {}, "margin_l1": {}, "sinkhorn_fused": {},
               "l1_search": {}, "shortlist_dist": {}, "gcn_fused": {}}
    a_csr, layer_rng = _csr_of(op.fwd, op.diag), np.random.default_rng(28)
    for d in LAYER_DS:  # a width without a fused instance: x·W, then spmm_ell
        kernels["gcn_fused"][f"d{d}_unfused"] = _unfused_layer_case(op, a_csr, layer_rng, d, smi)
    del a_csr
    for d, dtype in cases:
        key = f"d{d}" + ("_bf16" if dtype == torch.bfloat16 else "")
        g = torch.from_numpy(rng.standard_normal((op.bwd.n_cols, d)).astype(np.float32))
        g = g.to(dev, dtype)
        kernels["spmm_ell"][key] = {"operator": "transpose",
                                    **_dist_ell_case(op.bwd, op.diag, g, cold=True)}
        x = torch.from_numpy(rng.standard_normal((sop.fwd.n_cols, d)).astype(np.float32))
        x = x.to(dev, dtype)
        _nan_cache(sop.fwd.n_rows, d, dev, dtype)
        kernels["spmm_sorted"][key] = {"operator": "forward",
                                       **_sorted_case(sop.fwd, csr, x, timed=True)}
        for name in ("spmm_ell", "spmm_sorted"):
            emit({"phase": "widths", "kernel": name, "d": d, "dtype": str(dtype)[6:],
                  **kernels[name][key], "card": smi})
    del op, sop, csr
    torch.cuda.empty_cache()
    name, n, s, k, gamma, weighted = WIDTH_MARGIN
    for d in WIDTH_DS + WIDE_DS:
        kernels["margin_l1"][f"d{d}"] = _margin_case(f"{name}_d{d}", n, s, k, d, gamma,
                                                     weighted, smi, dev)
        torch.cuda.empty_cache()
        kernels["sinkhorn_fused"][f"d{d}"] = phase_sinkhorn(smi, dev, d=d)
    l1_rng, select_rng = np.random.default_rng(26), np.random.default_rng(27)
    for d in WIDE_DS:
        for name, entry, s, c, _, k, opts in L1_SHAPES:
            if name in WIDE_L1:
                q, cands, kw = _l1_inputs(l1_rng, entry, s, c, d, opts, dev)
                kernels["l1_search"][f"{name}_d{d}"] = _l1_case(f"{name}_d{d}", entry, q, cands,
                                                                k, kw, smi)
                del q, cands, kw
        for name, s, k, c, _, opts in SELECT_SHAPES:
            if name in WIDE_SELECT:
                q, cands, kw = _select_inputs(select_rng, s, c, d, opts, dev)
                kernels["shortlist_dist"][f"{name}_d{d}"] = _select_case(f"{name}_d{d}", q,
                                                                         cands, k, kw, opts, smi)
                del q, cands, kw
        torch.cuda.empty_cache()
    kernel_s = time.perf_counter() - t0
    runs = {}
    for name, config, recipe, over in WIDTH_RUNS:
        runs[name] = _width_run(task, name, config, recipe, over, dev)
        emit({"phase": "widths", "run": name, **runs[name], "card": smi})
    dist_steps = {f"dim{dim}": _width_dist_step(dist_task, dev, dim) for dim in WIDTH_DIST_DIMS}
    emit({"phase": "widths", "dist_steps": dist_steps, "kernel_s": kernel_s,
          "phase_s": time.perf_counter() - t0, "card": smi})
    return {"kernels": kernels, "runs": runs, "dist_steps": dist_steps}


# the widths each kernel takes on the card, for the kernel table
WIDTHS_TAKEN = {
    "gcn_fused": f"(d_in, d_out) in {gcn_fused.WIDTHS}; a layer at any other width "
                 "runs x·W, then spmm_ell",
    "spmm_ell": "every d >= 1: instances at 64, 128, 256; 128-column panels at every other d",
    "spmm_sorted": "every d >= 1: instances at 64, 128, 256; 128-column panels at every other d",
    "sinkhorn_fused": "every d >= 1: the strip resident up to 256, streamed above; zero "
                      "columns to a multiple of 4",
    "shortlist_dist": "every d >= 1: the select kernel's strip resident up to 512, streamed "
                      "above; zero columns to a multiple of 4 (8 with bf16 products)",
    "l1_search": "every d >= 1: zero columns to a multiple of 4",
    "margin_l1": "every d >= 1: instances at 16, 32, 64, 128, 256, 384, 512; masked instances "
                 "at 32, 64, 128, 192, ..., 512 elsewhere up to 512; column slabs of 512 "
                 "above",
    "sinkhorn_reverse": "any (it works on the S x S cost)"}
WIDTH_KEYS = ("max_abs_err", "ms", "device_ms", "ms_cold_l2", "plain_ms", "bound_ms",
              "bound_by", "library_ms")


def _kernel_widths(name: str, widths: dict) -> dict:
    """A kernel's ``widths`` in the kernel table: what it takes, its
    numbers at phase_widths' widths (for the kernels that run there), and
    its launches in each of phase_widths' runs."""
    keys = ("l1_topk", "l1_count", "l1_tile") if name == "l1_search" else (name,)
    out = {"takes": WIDTHS_TAKEN[name],
           "launches_runs": {run: sum(r["launches"].get(k, 0) for k in keys)
                             for run, r in widths["runs"].items()}}
    at = widths["kernels"].get(name)
    if at:
        out["at"] = {w: {k: v.get(k) for k in WIDTH_KEYS} for w, v in at.items()}
    return out


def main(argv: list[str] | None = None) -> int:
    global PARENT_MARGIN
    import argparse
    ap = argparse.ArgumentParser(description="Chip smoke test of the PyTorch/CUDA port.")
    ap.add_argument("--parent-l1", default=None,
                    help="a directory holding another commit's l1_search.cu and "
                         "topk_queue.cuh, to hold the L1 search kernel to")
    ap.add_argument("--parent-gcn", default=None,
                    help="a directory holding another commit's gcn_fused.cu, to hold the "
                         "fused GCN layer kernel to")
    ap.add_argument("--parent-margin", default=None,
                    help="a directory holding the previous margin_l1.cu, to hold the L1 margin "
                         "kernel to (bit for bit) and time it beside, alone and in the steps")
    args = ap.parse_args(argv)
    smi = phase_device()
    phase_build()
    parent_gcn = _parent_gcn(args.parent_gcn) if args.parent_gcn is not None else None
    if args.parent_margin is not None:
        PARENT_MARGIN = _parent_margin(args.parent_margin)
    task = synthetic_align_task(**ZH_EN)
    dev = torch.device("cuda")
    k_gcn = phase_kernel(task, smi, dev, parent_gcn)
    k_spmm = {**phase_spmm(task, smi, dev, d=256, split=False),
              "at_d128": phase_spmm(task, smi, dev, d=128),
              "bf16": {**phase_spmm(task, smi, dev, d=256, split=False, dtype=torch.bfloat16),
                       "at_d128": phase_spmm(task, smi, dev, d=128, split=False,
                                             dtype=torch.bfloat16)}}
    k_sink = {**phase_sinkhorn(smi, dev, d=256), "at_d128": phase_sinkhorn(smi, dev, d=128)}
    serve_launches = phase_slice(task, smi, dev)
    train = phase_train(task, smi, dev)
    recipe, recipe_stages = phase_recipe(task, smi, dev)
    incidence = {**phase_incidence(task, smi, dev, d=128),
                 "at_d256": phase_incidence(task, smi, dev, d=256)}
    v7r = phase_recipe_v7r(task, smi, dev)
    mtl = phase_mtl(task, smi, dev)
    highway = phase_highway(task, smi, dev)
    bf16 = phase_bf16(task, smi, dev)
    k_sorted = phase_sorted_kernel(task, smi, dev)
    sorted_runs = phase_sorted(task, smi, dev)
    k_select, k_gather = phase_shortlist(smi, dev)
    k_l1 = phase_l1_search(smi, dev, args.parent_l1)
    approx = phase_approx(task, smi, dev, recipe_stages)
    fused = phase_fused(task, smi, dev)
    phase_profile(task, smi, dev)
    phase_readers(task, smi, dev)
    phase_native(task, smi, dev)
    phase_debug_nans(task, smi, dev)
    dist = phase_dist(smi, dev)
    dist_v7r = phase_dist_v7r(smi, dev)
    losses = phase_step_losses(smi, dev, dist_v7r)
    STEP_CASES.clear()
    single_sharded = phase_single_sharded(smi, dev, dist, dist_v7r, parent_gcn)
    dist_options = phase_dist_options(smi, dev, dist_v7r["stages_s"])
    dist_mesh = phase_dist_mesh(smi, dev)
    dist_grouped = phase_dist_grouped(smi, dev, dist_options["approx"])
    dist_fused = phase_dist_fused(smi, dev, dist, dist_options["approx"]["stages_s"])
    widths = phase_widths(task, dist["task"], smi, dev)
    # one potential update at the ring caller's shape: the v7r run's 4,096
    # pairs, one rank holding the 8 shards, so one launch per update
    k_sink_ring = phase_sinkhorn(smi, dev, s=DIST_V7R_OT_PAIRS, d=256)

    def single_launches(kernel: str) -> dict:
        return {leg: single_sharded[leg]["launches"][kernel] for leg in ("fit", "fit_mtl")}

    def loss_launches(kernel: str) -> dict:
        """The loss kernel's launches in each run that trains."""
        return {"launches": recipe[kernel], "launches_train": train[kernel],
                "launches_v7r": v7r[kernel], "launches_mtl": mtl[kernel],
                "launches_highway": highway[kernel], "launches_bf16_v6": bf16["v6"][kernel],
                "launches_bf16_base": bf16["base"][kernel],
                "launches_sorted": {k: v[kernel] for k, v in sorted_runs.items()},
                "launches_fused": {n: v[kernel] for n, v in fused.items()
                                   if n != "replayed_interval"},
                "launches_replayed_interval": {n: v[kernel]
                                               for n, v in fused["replayed_interval"].items()},
                "launches_dist": dist["launches"][kernel],
                "launches_dist_v7r": dist_v7r["launches"][kernel],
                "launches_dist_approx": dist_options["approx"]["launches"].get(kernel, 0),
                "launches_dist_fused_runs": {k: v["launches"].get(kernel, 0)
                                             for k, v in dist_fused["runs"].items()},
                "launches_single_sharded": single_launches(kernel)}

    # the numbers at the recipe's width (d = 256); launches of the recipe's
    # run, with those of the other runs beside (the incidence's at mtl's
    # width, d = 128, where config mtl runs it); a fused run's launches on
    # the device as a profiler trace of the run counts them (its eager
    # ones, the warm-up step's and each replay's)
    table = [
        {"name": "gcn_fused", "route": "cuda", "source": "tpugraph_torch/csrc/gcn_fused.cu",
         "replaces": "tpugraph/kernels/gcn_fused_pallas.py:40", "launches": recipe["gcn_fused"],
         "launches_train": train["gcn_fused"], "launches_serve": serve_launches,
         "launches_v7r": v7r["gcn_fused"], "launches_mtl": mtl["gcn_fused"],
         "launches_highway": highway["gcn_fused"],
         "launches_bf16_v6": bf16["v6"]["gcn_fused"], "launches_bf16_base": bf16["base"]["gcn_fused"],
         "launches_fused": {n: v["gcn_fused"] for n, v in fused.items()
                            if n != "replayed_interval"},
         "launches_replayed_interval": {n: v["gcn_fused"]
                                        for n, v in fused["replayed_interval"].items()},
         **k_gcn, "launches_single_sharded": single_launches("gcn_fused"),
         "at_dwy100k": single_sharded["gcn_fused"]},
        {"name": "spmm_ell", "route": "cuda", "source": "tpugraph_torch/csrc/spmm_ell.cu",
         "replaces": "tpugraph/kernels/spmm_ell.py:19", "launches": recipe["spmm_ell"],
         "launches_train": train["spmm_ell"], "launches_v7r": v7r["spmm_ell"],
         "launches_mtl": mtl["spmm_ell"], "launches_mtl_incidence": mtl["incidence"],
         "launches_highway": highway["spmm_ell"],
         "launches_bf16_v6": bf16["v6"]["spmm_ell"], "launches_bf16_base": bf16["base"]["spmm_ell"],
         "launches_fused": {n: v["spmm_ell"] for n, v in fused.items()
                            if n != "replayed_interval"},
         "launches_replayed_interval": {n: v["spmm_ell"]
                                        for n, v in fused["replayed_interval"].items()},
         **k_spmm, "incidence": incidence, "launches_dist": dist["launches"]["spmm_ell"],
         "launches_dist_per_step": dist["per_step"], "dist_shard_ops": dist["spmm_ell"],
         "launches_dist_v7r": dist_v7r["launches"]["spmm_ell"],
         "launches_dist_v7r_per_step": dist_v7r["per_step"]["spmm_ell"],
         "launches_dist_approx": dist_options["approx"]["launches"]["spmm_ell"],
         "launches_dist_options": {k: v["launches_per_step"]["spmm_ell"]
                                   for k, v in dist_options["options"].items() if k != "kernel"},
         "dist_option_operators": dist_options["options"]["kernel"],
         "launches_dist_fused": {
             "r1_step_per_step": dist_fused["r1"]["ell"]["launches_per_step"],
             "exchange_route_per_step": dist_fused["r1"]["exchange_route"]["launches_per_step"],
             "replayed_per_step": {k: v["replayed_launches_per_step"]["spmm_ell"]
                                   for k, v in dist_fused["intervals"].items()},
             "fused_runs": {k: v["launches"]["spmm_ell"]
                            for k, v in dist_fused["runs"].items()}},
         "launches_dist_mesh": {"d128_step": dist_mesh["d128_step"]["launches"]["spmm_ell"],
                                "d384_panel_step":
                                    dist_mesh["panel_step"]["launches"]["spmm_ell"],
                                "v7r_step": dist_mesh["v7r_step"]["launches"]["spmm_ell"]},
         "dist_tp_operators_d64": dist_mesh["kernel"]["spmm_ell"],
         "launches_dist_grouped": {
             "d128_step": dist_grouped["identity"]["ell"]["launches"]["spmm_ell"],
             "moved_step": dist_grouped["moved"]["launches"]["spmm_ell"],
             "v7r_run": dist_grouped["run"]["launches"]["spmm_ell"],
             "v7r_cut_run": dist_grouped["run"]["resume"]["cut_launches"]["spmm_ell"],
             "v7r_resumed_run": dist_grouped["run"]["resume"]["resumed_launches"]["spmm_ell"]},
         "dist_grouped_operators": dist_grouped["kernel"]["spmm_ell"],
         "launches_single_sharded": single_launches("spmm_ell")},
        {"name": "sinkhorn_fused", "route": "cuda",
         "source": "tpugraph_torch/csrc/sinkhorn_fused.cu",
         "replaces": "tpugraph/kernels/sinkhorn_pallas.py:38",
         "launches": recipe["sinkhorn_fused"], "launches_train": train["sinkhorn_fused"],
         "launches_v7r": v7r["sinkhorn_fused"], "launches_mtl": mtl["sinkhorn_fused"],
         "launches_bf16_v6": bf16["v6"]["sinkhorn_fused"],
         "launches_fused_v6": fused["v6_fast"]["sinkhorn_fused"], **k_sink,
         "launches_dist_v7r": dist_v7r["launches"]["sinkhorn_fused"],
         "launches_dist_v7r_per_step": dist_v7r["per_step"]["sinkhorn_fused"],
         "dist_ring": {"kernel_at_ring_shape": k_sink_ring, "loss": dist_v7r["ring_ot"]},
         "launches_dist_fused": {
             "replayed_per_step_v7r":
                 dist_fused["intervals"]["v7r"]["replayed_launches_per_step"]["sinkhorn_fused"],
             "fused_run_v7r": dist_fused["runs"]["v7r_fast"]["launches"]["sinkhorn_fused"]},
         "launches_dist_mesh": {
             "v7r_step": dist_mesh["v7r_step"]["launches"]["sinkhorn_fused"]},
         "launches_dist_grouped": {
             "v7r_run": dist_grouped["run"]["launches"]["sinkhorn_fused"],
             "v7r_cut_run": dist_grouped["run"]["resume"]["cut_launches"]["sinkhorn_fused"],
             "v7r_resumed_run":
                 dist_grouped["run"]["resume"]["resumed_launches"]["sinkhorn_fused"]},
         "launches_single_sharded": single_launches("sinkhorn_fused")},
        {"name": "shortlist_dist", "route": "cuda",
         "source": "tpugraph_torch/csrc/shortlist_dist.cu",
         "replaces": "tpugraph/train/negatives.py:260",
         "replaces_kind": "XLA ops and lax.approx_min_k: select, then gather and rerank",
         "launches": approx["shortlist_dist"],
         "launches_fused_v6": fused["v6_fast"]["shortlist_dist"], **k_select["mining"],
         "at_callers": {k: v for k, v in k_select.items() if k != "mining"},
         "launches_dist_approx": dist_options["approx"]["launches"]["shortlist_dist"],
         "launches_dist_approx_per_stage": dist_options["approx"]["select_launches_per_stage"],
         "launches_dist_grouped": {
             "v7r_run": dist_grouped["run"]["launches"]["shortlist_dist"],
             "v7r_cut_run": dist_grouped["run"]["resume"]["cut_launches"]["shortlist_dist"],
             "v7r_resumed_run":
                 dist_grouped["run"]["resume"]["resumed_launches"]["shortlist_dist"]},
         "at_dist_ring_callers": dist_options["approx"]["kernel"],
         "gather_entry": {"launches": approx["shortlist_gather"], "at_callers": k_gather}},
        {"name": "spmm_sorted", "route": "cuda", "source": "tpugraph_torch/csrc/spmm_sorted.cu",
         "replaces": "tpugraph/kernels/spmm.py:33",
         "replaces_kind": "XLA ops (gather, sorted segment_sum), not a Pallas kernel",
         "launches": sorted_runs["sorted_fp32"]["spmm_sorted"],
         "launches_bf16": sorted_runs["sorted_bf16"]["spmm_sorted"],
         "launches_replayed_interval": fused["replayed_interval"]["base_sorted"]["spmm_sorted"],
         **{k: k_sorted["forward"]["float32_d128"][k]
            for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                      "device_ms", "ms_cold_l2", "library_device_ms", "split_device_ms")},
         "d": 128, "dtype": "float32", "operator": "forward", "all": k_sorted,
         "launches_dist_sorted_step": dist["sorted_step_launches"]["spmm_sorted"],
         "launches_dist_r1_sorted_step": dist_fused["r1"]["sorted"]["launches_per_step"],
         "dist_shard_ops": dist["spmm_sorted"],
         "dist_tp_operators_d64": dist_mesh["kernel"]["spmm_sorted"],
         "launches_dist_grouped_sorted_step":
             dist_grouped["identity"]["sorted"]["launches"]["spmm_sorted"],
         "dist_grouped_operators": dist_grouped["kernel"]["spmm_sorted"]},
        {"name": "l1_search", "route": "cuda", "source": "tpugraph_torch/csrc/l1_search.cu",
         "replaces": "tpugraph/train/negatives.py:45",
         "replaces_kind": "XLA ops (blockwise L1 tiles, lax.top_k, argmin, rank count), "
                          "not a Pallas kernel",
         "launches": recipe["l1_topk"] + recipe["l1_count"] + recipe["l1_tile"],
         "launches_by_entry": {k: recipe[k] for k in L1_NONE},
         "launches_train": {k: train[k] for k in L1_NONE},
         "launches_v7r": {k: v7r[k] for k in L1_NONE},
         "launches_approx_v6": {k: approx[k] for k in L1_NONE},
         "launches_dist": {k: dist["launches"][k] for k in L1_NONE},
         "launches_dist_v7r": {k: dist_v7r["launches"][k] for k in L1_NONE},
         "launches_dist_approx": {k: dist_options["approx"]["launches"].get(k, 0)
                                  for k in L1_NONE},
         "launches_single_sharded": {leg: {k: single_sharded[leg]["launches"][k]
                                           for k in L1_NONE} for leg in ("fit", "fit_mtl")},
         **{k: k_l1["mining"][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms", "device_ms",
                                           "ms_cold_l2")},
         "caller": "mining", "s": k_l1["mining"]["s"], "c": k_l1["mining"]["c"],
         "d": k_l1["mining"]["d"], "k": k_l1["mining"]["k"],
         "at_callers": {k: v for k, v in k_l1.items() if k != "mining"}},
        {"name": "margin_l1", "route": "cuda", "source": "tpugraph_torch/csrc/margin_l1.cu",
         "replaces": "tpugraph/train/losses.py:22",
         "replaces_kind": "XLA ops (two (S, k, d) gathers, |a - b|, the sums) and their "
                          "autodiff, not a Pallas kernel",
         **loss_launches("margin_l1"),
         "index_builds_by_run": INDEX_BUILDS,
         **{k: losses["margin"]["v6_zh_en"][k]
            for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                      "ms_cold_l2", "device_ms", "forward_ms", "backward_ms", "index_ms",
                      "index_plain_ms", "gather_ms", "gather_ms_cold_l2", "planes_mb", "vs_parent",
                      "rows_from_hbm_ms")},
         "shape": "v6_zh_en: forward and backward", "s": 7000, "k": 100, "d": 256,
         "at_shapes": {k: v for k, v in losses["margin"].items() if k != "v6_zh_en"}},
        {"name": "sinkhorn_reverse", "route": "cuda",
         "source": "tpugraph_torch/csrc/sinkhorn_reverse.cu",
         "replaces": "tpugraph/train/ot.py:24",
         "replaces_kind": "XLA autodiff of the unrolled Sinkhorn solver (also "
                          "tpugraph/dist/ring.py:432), not a Pallas kernel",
         **loss_launches("sinkhorn_reverse"),
         **{k: losses["reverse"]["zh_en_d256"]["rows"][k]
            for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                      "ms_cold_l2", "device_ms")},
         "shape": "zh_en_d256 rows: 4,500 x 4,500", "at_shapes": losses["reverse"],
         "steps": losses["steps"]},
    ]
    for entry in table:
        entry["widths"] = _kernel_widths(entry["name"], widths)
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
