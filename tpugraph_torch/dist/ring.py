"""Ring-blockwise computations over the graph shards (counterpart of
``tpugraph/dist/ring.py``): the exact hard-negative mining (``ring_knn``),
the exact Hits@k (``ring_hits_at_k``), both raw or CSLS, and the Sinkhorn
OT head (``ring_sinkhorn_potentials``, ``ring_sinkhorn_align_loss``) of
the distributed trainer.

Every set is cut into S blocks, one per shard.  Rank r owns the query and
candidate blocks of its shards (its chunk: ``per_rank`` blocks, padded
with trailing zero rows).  At each of the R hops it folds what it holds
into a running reduction over its own rows (a top-k, a count, a
log-sum-exp), then passes the held chunk on to rank r + 1 with
``torch.distributed.batch_isend_irecv`` (``_ring_pass``); after R hops
every row has met every block.  The callers pass the full tables (every
rank holds the trainer's all-gathered output); each rank's results are
all-gathered at the end, so every rank returns the same answer.

* Mining and eval fold one distance tile (``train/eval.py::dist_tile``) per
  held block.  Ties go to the lower global candidate index, as
  ``blockwise_knn_l1`` (``train/negatives.py``) orders them: the running
  top-k keeps 64-bit keys of (the score's order-preserving bits, global
  index), so the merge is exact and the same for every R and S.
* CSLS (``csls_k > 0``) scores 2·d(q, j) − r(j), r(j) the mean distance of
  candidate j to its csls_k nearest queries: a first ring pass in which the
  candidates stay home and the query chunks travel (``_ring_hubness``),
  then r travels with its candidate chunk.
* The OT head: each potential update folds one ``sinkhorn_fused`` launch
  per (the rank's query chunk, the held chunk's real rows) into a running
  LSE (launched with log μ = 0, so LSE = −f/τ, merged with ``logaddexp``);
  the held chunk carries its rows, squared norms and potential.  At R = 1
  that is one launch per update, 2·n_iters + 1 per loss, as the
  single-device ``train/ot.py`` launches.  The loss is a
  ``torch.autograd.Function`` whose backward is the exact gradient of the
  unrolled solver (``train/ot.py::_SinkhornNLL.backward``'s reverse sweep),
  over a rank's (S/R) × S share of the cost and C̄; the reverse of each
  f-update sums b̄ over the rank's rows into an accumulator that travels
  with its chunk and comes home after the R-th pass, as r̄ does at the
  end.  Value and gradient are whole on every rank (the trainer's
  replicated loss).

Not ported yet, and refused: the approximate stages (ROADMAP.md).
"""

from __future__ import annotations

import math
from collections.abc import Callable

import numpy as np
import torch
import torch.distributed as dist

from tpugraph_torch.dist.mesh import ShardMesh
from tpugraph_torch.kernels.sinkhorn_fused import sinkhorn_potential_update, sq_norms
from tpugraph_torch.train.eval import dist_tile, rank_metrics
from tpugraph_torch.train.losses import pairwise_l1
from tpugraph_torch.train.ot import _normalized_sides

BLOCK_Q = 4096  # rows per tile: a (4,096, C_block) fp32 tile and its keys
_INF_BITS = 0x7F800000  # float32 +inf


def _refuse(what: str) -> None:
    raise NotImplementedError(f"the ring {what} is not ported yet; see ROADMAP.md")


def _rotate(held: tuple[torch.Tensor, ...], mesh: ShardMesh) -> tuple[torch.Tensor, ...]:
    """Send each tensor of ``held`` to rank r + 1 and take rank r − 1's."""
    out = tuple(torch.empty_like(t) for t in held)
    ops = []
    for tag, (t, o) in enumerate(zip(held, out)):
        ops += [dist.P2POp(dist.isend, t.contiguous(), (mesh.rank + 1) % mesh.world, tag=tag),
                dist.P2POp(dist.irecv, o, (mesh.rank - 1) % mesh.world, tag=tag)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _ring_pass(held: tuple[torch.Tensor, ...], mesh: ShardMesh,
               visit: Callable[[int, tuple], None], home: bool = False) -> tuple:
    """``visit(src, held)`` at each of the R hops, ``src`` the rank whose
    chunk is held, the chunk passed on between hops; with ``home`` once
    more after the last, so each rank ends holding its own chunk (and what
    the others added to it)."""
    for hop in range(mesh.world):
        visit((mesh.rank - hop) % mesh.world, held)
        if hop < mesh.world - 1 or (home and mesh.world > 1):
            held = _rotate(held, mesh)
    return held


def _gather(t: torch.Tensor, mesh: ShardMesh) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated in rank order."""
    if mesh.world == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts)


def _rank_rows(n: int, mesh: ShardMesh) -> tuple[int, int]:
    """(block rows b, first row) of the rank's chunk of an n-row set cut
    into S blocks of b rows; the chunk is per_rank·b rows, the last ones
    past n on the last ranks."""
    b = -(-n // mesh.n_shards)
    return b, mesh.rank * mesh.per_rank * b


def _valid(n: int, src: int, mesh: ShardMesh) -> int:
    """The real rows of rank ``src``'s chunk of an n-row set: its first
    ones (the padding trails)."""
    w = mesh.per_rank * -(-n // mesh.n_shards)
    return max(0, min(n - src * w, w))


def _chunk(t: torch.Tensor, mesh: ShardMesh) -> torch.Tensor:
    """The rank's chunk of ``t``, padded with zero rows to per_rank·b."""
    b, r0 = _rank_rows(t.shape[0], mesh)
    out = t.new_zeros((mesh.per_rank * b,) + tuple(t.shape[1:]))
    part = t[r0:r0 + mesh.per_rank * b]
    out[:part.shape[0]] = part
    return out


def _keys(dist_: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as (score, index): the float's bits mapped to an
    order-preserving int32, then the index in the low 32 bits."""
    bits = dist_.contiguous().view(torch.int32)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return (bits.to(torch.int64) << 32) | gidx


def _ring_hubness(cands: torch.Tensor, q: torch.Tensor, k: int, metric: str,
                  mesh: ShardMesh) -> torch.Tensor:
    """r(j) of the rank's chunk of ``cands``: the mean distance of each
    candidate to its k nearest of all of ``q``'s rows (the query chunks
    travel; padding never near), 0 where fewer than k real queries exist
    (the JAX package's ring convention)."""
    own = _chunk(cands, mesh)
    run = own.new_full((own.shape[0], k), float("inf"))

    def visit(src, held):
        nv = _valid(q.shape[0], src, mesh)
        for a in range(0, own.shape[0] if nv else 0, BLOCK_Q):
            d = dist_tile(own[a:a + BLOCK_Q], held[0][:nv], metric)
            run[a:a + BLOCK_Q] = torch.topk(torch.cat([run[a:a + BLOCK_Q], d], dim=1), k,
                                            dim=1, largest=False).values

    _ring_pass((_chunk(q, mesh),), mesh, visit)
    r = run.mean(dim=1)
    return torch.where(torch.isfinite(r), r, torch.zeros_like(r))


def ring_knn(q: torch.Tensor, cands: torch.Tensor, exclude: torch.Tensor, k: int,
             mesh: ShardMesh, *, metric: str = "cityblock", csls_k: int = 0,
             approx: bool = False) -> torch.Tensor:
    """(Q, k) int64 indices into ``cands`` of each query's k nearest by
    ``metric`` (cityblock or sqeuclidean; with ``csls_k > 0`` by the CSLS
    score, the hubness over all of ``q``), ``exclude[i]`` (its partner, -1
    for none) masked out; the same sets as ``blockwise_knn_l1``, with its
    fill (a column without a real candidate, or the masked partner in an
    exhausted pool, takes the row's best)."""
    if approx:
        _refuse("approximate mining")
    c = cands.shape[0]
    bc, _ = _rank_rows(c, mesh)
    qs, ex = _chunk(q, mesh), _chunk(exclude, mesh)
    held = (_chunk(cands, mesh),)
    if csls_k > 0:
        held += (_ring_hubness(cands, q, csls_k, metric, mesh),)
    init = (torch.tensor(_INF_BITS, dtype=torch.int64) << 32).to(q.device)
    keys = init.expand(qs.shape[0], k).clone()

    def visit(src, held):
        for j in range(mesh.per_rank):  # the source's shards' blocks, in order
            cb = held[0][j * bc:(j + 1) * bc]
            gidx = (src * mesh.per_rank + j) * bc + torch.arange(bc, device=q.device)
            for a in range(0, qs.shape[0], BLOCK_Q):
                d = dist_tile(qs[a:a + BLOCK_Q], cb, metric)
                if csls_k > 0:
                    d = 2.0 * d - held[1][None, j * bc:(j + 1) * bc]
                d.masked_fill_((gidx[None, :] >= c) | (gidx[None, :] == ex[a:a + BLOCK_Q, None]),
                               float("inf"))
                both = torch.cat([keys[a:a + BLOCK_Q], _keys(d, gidx.expand_as(d))], dim=1)
                keys[a:a + BLOCK_Q] = torch.topk(both, k, dim=1, largest=False,
                                                 sorted=True).values

    _ring_pass(held, mesh, visit)
    idx = keys & 0xFFFFFFFF
    bad = ((keys >> 32) == _INF_BITS) | (idx == ex[:, None])
    idx = torch.where(bad, idx[:, :1], idx)
    return _gather(idx, mesh)[:q.shape[0]]


def _ring_ranks(q: torch.Tensor, cands: torch.Tensor, d_true: torch.Tensor,
                mesh: ShardMesh, csls_k: int = 0) -> torch.Tensor:
    """The rank's queries' counts of candidates strictly closer than the
    true match (candidate i is query i's, excluded by index): in L1, or by
    the CSLS score against 2·d_true − r(true) with ``csls_k > 0``."""
    n = q.shape[0]
    b, r0 = _rank_rows(n, mesh)
    qs, th = _chunk(q, mesh), _chunk(d_true, mesh)
    held = (_chunk(cands, mesh),)
    if csls_k > 0:
        r_own = _ring_hubness(cands, q, csls_k, "cityblock", mesh)
        th = 2.0 * th - r_own  # the true match sits in the rank's own chunk
        held += (r_own,)
    qid = r0 + torch.arange(qs.shape[0], device=q.device)
    count = torch.zeros(qs.shape[0], dtype=torch.int64, device=q.device)

    def visit(src, held):
        for j in range(mesh.per_rank):
            cb = held[0][j * b:(j + 1) * b]
            gcol = (src * mesh.per_rank + j) * b + torch.arange(b, device=q.device)
            for a in range(0, qs.shape[0], BLOCK_Q):
                d = dist_tile(qs[a:a + BLOCK_Q], cb)
                if csls_k > 0:
                    d = 2.0 * d - held[1][None, j * b:(j + 1) * b]
                ok = (gcol[None, :] < n) & (gcol[None, :] != qid[a:a + BLOCK_Q, None])
                count[a:a + BLOCK_Q] += ((d < th[a:a + BLOCK_Q, None]) & ok).sum(dim=1)

    _ring_pass(held, mesh, visit)
    return _gather(count, mesh)[:n]


def ring_hits_at_k(emb: torch.Tensor, test_pairs, mesh: ShardMesh,
                   ks: tuple[int, ...] = (1, 10), csls_k: int = 0,
                   approx_k: int = 0) -> dict[str, float]:
    """Both-direction Hits@k and MRR over the test pairs, with the
    candidate blocks passed around the ring: the semantics of
    ``train/eval.py::hits_at_k`` (raw L1, or CSLS with ``csls_k``)."""
    if approx_k > 0:
        _refuse("approximate eval (approx_k > 0)")
    pairs = torch.as_tensor(np.asarray(test_pairs), dtype=torch.int64, device=emb.device)
    left, right = emb.index_select(0, pairs[:, 0]), emb.index_select(0, pairs[:, 1])
    d_true = pairwise_l1(left, right).float()
    return rank_metrics(_ring_ranks(left, right, d_true, mesh, csls_k),
                        _ring_ranks(right, left, d_true, mesh, csls_k), ks)


# ------------------------------------------------------------ ring Sinkhorn
def _ring_update(q: torch.Tensor, q_sq: torch.Tensor, nq: int, held: tuple, n: int,
                 log_m: float, tau: float, mesh: ShardMesh) -> torch.Tensor:
    """The rank's chunk of one potential update, τ(log m − LSE_j[(p_j −
    C_ij)/τ]) over every chunk of the other side; ``held`` = (rows, squared
    norms, potential p) of the rank's own chunk of it, passed around.  One
    ``sinkhorn_fused`` launch per held chunk with a real row, on its real
    rows; the padding rows of the result are 0."""
    lse = q.new_full((nq,), float("-inf"))
    zeros = q.new_zeros(nq)

    def visit(src, held):
        nonlocal lse
        nc = _valid(n, src, mesh)
        if nq and nc:
            rows, sq, pot = held
            f0 = sinkhorn_potential_update(q[:nq], rows[:nc], pot[:nc], zeros, tau, q_sq[:nq],
                                           sq[:nc])
            lse = torch.logaddexp(lse, f0 / -tau)

    _ring_pass(held, mesh, visit)
    out = q.new_zeros(q.shape[0])
    out[:nq] = tau * (log_m - lse)
    return out


def _ring_solve(lq, rq, l_sq, r_sq, n: int, tau: float, n_iters: int,
                mesh: ShardMesh) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """The rank's chunks of every iterate, ([f_1..f_n], [g_1..g_n]), from
    f = g = 0 and uniform marginals over the n real pairs."""
    nq, log_m = _valid(n, mesh.rank, mesh), -math.log(n)
    g = lq.new_zeros(lq.shape[0])
    fs, gs = [], []
    for _ in range(n_iters):
        f = _ring_update(lq, l_sq, nq, (rq, r_sq, g), n, log_m, tau, mesh)
        g = _ring_update(rq, r_sq, nq, (lq, l_sq, f), n, log_m, tau, mesh)
        fs.append(f)
        gs.append(g)
    return fs, gs


def _sum_ranks(t: torch.Tensor, mesh: ShardMesh) -> torch.Tensor:
    if mesh.world > 1:
        dist.all_reduce(t)
    return t


class _RingSinkhornNLL(torch.autograd.Function):
    """``train/ot.py::_SinkhornNLL`` over the ring: L_ot of unit rows l, r
    (S, d), whole on every rank, value and gradient whole on every rank."""

    @staticmethod
    def forward(ctx, l, r, tau, n_iters, mesh):
        n = l.shape[0]
        lq, rq = _chunk(l, mesh), _chunk(r, mesh)
        l_sq, r_sq = sq_norms(lq), sq_norms(rq)
        nq, log_m = _valid(n, mesh.rank, mesh), -math.log(n)
        fs, gs = _ring_solve(lq, rq, l_sq, r_sq, n, tau, n_iters, mesh)
        f_last = _ring_update(lq, l_sq, nq, (rq, r_sq, gs[-1]), n, log_m, tau, mesh)
        c_diag = (l_sq + r_sq - 2.0 * (lq * rq).sum(1)).clamp_min(0.0)
        part = ((f_last + gs[-1] - c_diag)[:nq] / tau).sum()
        ctx.tau, ctx.n, ctx.mesh = tau, n, mesh
        ctx.save_for_backward(lq, rq, l_sq, r_sq, *fs, *gs, f_last)
        return -_sum_ranks(part, mesh) / n - math.log(n)

    @staticmethod
    def backward(ctx, grad):
        lq, rq, l_sq, r_sq, *pots = ctx.saved_tensors
        tau, n, mesh = ctx.tau, ctx.n, ctx.mesh
        k_iters = (len(pots) - 1) // 2
        fs, gs, f_last = pots[:k_iters], pots[k_iters:2 * k_iters], pots[-1]
        w, nq, log_m = lq.shape[0], _valid(n, mesh.rank, mesh), -math.log(n)
        lv = lq[:nq]

        def cols(src):  # the share's columns of rank src's chunk (its real rows), their count
            m = _valid(n, src, mesh)
            return slice(src * w, src * w + m), m

        # the rank's rows of the cost, against every rank's chunk of r
        c_raw = lq.new_zeros((nq, mesh.world * w))

        def build(src, held):
            cs, m = cols(src)
            c_raw[:, cs] = l_sq[:nq, None] + held[1][None, :m] - 2.0 * (lv @ held[0][:m].t())

        _ring_pass((rq, r_sq), mesh, build)
        cost = c_raw.clamp_min(0.0)
        c = grad / (n * tau)
        cbar = torch.zeros_like(cost)
        cbar[:, mesh.rank * w:mesh.rank * w + nq].diagonal().add_(c)

        def rows_rev(out, out_bar, b):
            """The reverse of an f-update out = τ(log m − LSE_j((b − C)/τ))
            over the rank's rows: C̄ += ō⊙P, and the held chunk's
            accumulator gains b̄ = −Σ_i ō_i P_ij; returns the rank's b̄."""
            lse = log_m - out[:nq] / tau

            def visit(src, held):
                cs, m = cols(src)
                t = ((held[0][None, :m] - cost[:, cs]) / tau - lse[:, None]).exp_().mul_(
                    out_bar[:nq, None])
                cbar[:, cs] += t
                held[1][:m] -= t.sum(0)

            return _ring_pass((b, torch.zeros_like(b)), mesh, visit, home=True)[1]

        def cols_rev(b, out, out_bar):
            """The reverse of a g-update out = τ(log m − LSE_i((b − C)/τ)),
            seen from the rank's rows (b over them, the held chunk's out and
            ō): C̄ += ō⊙P; returns the rank's b̄ = −Σ_j ō_j P_ij."""
            b_bar = torch.zeros_like(b)

            def visit(src, held):
                cs, m = cols(src)
                lse = log_m - held[0][:m] / tau
                t = ((b[:nq, None] - cost[:, cs]) / tau - lse[None, :]).exp_().mul_(
                    held[1][None, :m])
                cbar[:, cs] += t
                b_bar[:nq] -= t.sum(1)

            _ring_pass((out, out_bar), mesh, visit)
            return b_bar

        # L = −mean((f′ + g_n − C_ii)/τ) − log S
        c_own = torch.zeros_like(gs[-1])
        c_own[:nq] = c
        g_bar = -c_own + rows_rev(f_last, -c_own, gs[-1])
        for k in range(k_iters - 1, -1, -1):
            f_bar = cols_rev(fs[k], gs[k], g_bar)
            g_bar = rows_rev(fs[k], f_bar, gs[k - 1] if k > 0 else torch.zeros_like(gs[0]))
        p = cbar.mul_(c_raw > 0)  # C̄ through the clamp at 0
        l_bar = lq.new_zeros(lq.shape)
        l_bar[:nq] = 2.0 * lv * p.sum(1)[:, None]

        def grads(src, held):
            cs, m = cols(src)
            pt, rows = p[:, cs], held[0][:m]
            l_bar[:nq] -= 2.0 * (pt @ rows)
            held[1][:m] += 2.0 * (rows * pt.sum(0)[:, None] - pt.t() @ lv)

        r_bar = _ring_pass((rq, torch.zeros_like(rq)), mesh, grads, home=True)[1]
        return _gather(l_bar, mesh)[:n], _gather(r_bar, mesh)[:n], None, None, None


def ring_sinkhorn_align_loss(emb: torch.Tensor, pairs, mesh: ShardMesh, tau: float = 0.05,
                             n_iters: int = 20) -> torch.Tensor:
    """``train/ot.py::sinkhorn_align_loss`` over the ring: the OT head's
    loss over the pairs (S, 2) of the whole table ``emb``, value and
    gradient as the single-device loss's, no S×S tensor whole on a rank."""
    if n_iters < 1:
        raise ValueError("n_iters must be >= 1")
    l, r = _normalized_sides(emb, pairs)
    return _RingSinkhornNLL.apply(l.contiguous(), r.contiguous(), tau, n_iters, mesh)


def ring_sinkhorn_potentials(l: torch.Tensor, r: torch.Tensor, mesh: ShardMesh,
                             tau: float = 0.05,
                             n_iters: int = 20) -> tuple[torch.Tensor, torch.Tensor]:
    """Log-domain Sinkhorn over the ring on the L2-normalised rows of
    l, r (S, d): the potentials (f, g) after ``n_iters`` iterations, whole
    on every rank (``kernels/sinkhorn.py::sinkhorn_potentials`` on their
    sqeuclidean cost)."""
    if n_iters < 1:
        raise ValueError("n_iters must be >= 1")
    n = l.shape[0]
    l = l / (torch.linalg.vector_norm(l, dim=-1, keepdim=True) + 1e-8)
    r = r / (torch.linalg.vector_norm(r, dim=-1, keepdim=True) + 1e-8)
    lq, rq = _chunk(l.float(), mesh), _chunk(r.float(), mesh)
    with torch.no_grad():
        fs, gs = _ring_solve(lq, rq, sq_norms(lq), sq_norms(rq), n, tau, n_iters, mesh)
    return _gather(fs[-1], mesh)[:n], _gather(gs[-1], mesh)[:n]
