"""Ring-blockwise search over the graph shards (counterpart of
``tpugraph/dist/ring.py``): the exact hard-negative mining (``ring_knn``)
and the exact Hits@k (``ring_hits_at_k``) of the distributed trainer.

Both sets are cut into S blocks, one per shard.  Rank r owns the query and
candidate blocks of its shards.  At each of the R hops it walks the
candidate blocks it holds, its shards' in order, folding one distance tile
(``train/eval.py::dist_tile``) per block into a running reduction over its
queries (a top-k, or a count), then passes its candidate chunk on to rank
r + 1 with ``torch.distributed.batch_isend_irecv``; after R hops every
query has met every candidate.  The callers pass the full tables (every
rank holds the trainer's all-gathered output); each rank's results are
all-gathered at the end, so every rank returns the same answer.

Ties go to the lower global candidate index, as ``blockwise_knn_l1``
(``train/negatives.py``) orders them: the running top-k keeps 64-bit keys
of (the distance's order-preserving bits, global index), so the merge is
exact and the same for every R and S.  Not ported yet, and refused: the
CSLS and approximate stages and the ring Sinkhorn (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from tpugraph_torch.dist.mesh import ShardMesh
from tpugraph_torch.train.eval import dist_tile, rank_metrics
from tpugraph_torch.train.losses import pairwise_l1

BLOCK_Q = 4096  # queries per tile: a (4,096, C_block) fp32 tile and its keys
_INF_BITS = 0x7F800000  # float32 +inf


def _refuse(what: str) -> None:
    raise NotImplementedError(f"the ring {what} is not ported yet; see ROADMAP.md")


def _rotate(chunk: torch.Tensor, mesh: ShardMesh) -> torch.Tensor:
    """Send ``chunk`` to rank r + 1 and take rank r − 1's."""
    out = torch.empty_like(chunk)
    ops = [dist.P2POp(dist.isend, chunk, (mesh.rank + 1) % mesh.world),
           dist.P2POp(dist.irecv, out, (mesh.rank - 1) % mesh.world)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _gather(t: torch.Tensor, mesh: ShardMesh) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated in rank order."""
    parts = [torch.empty_like(t) for _ in range(mesh.world)]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts)


def _rank_rows(n: int, mesh: ShardMesh) -> tuple[int, int]:
    """(block rows b, first row) of the rank's chunk of an n-row set cut
    into S blocks of b rows; the chunk is per_rank·b rows, the last ones
    past n on the last ranks."""
    b = -(-n // mesh.n_shards)
    return b, mesh.rank * mesh.per_rank * b


def _chunk(t: torch.Tensor, mesh: ShardMesh) -> torch.Tensor:
    """The rank's chunk of ``t``, padded with zero rows to per_rank·b."""
    b, r0 = _rank_rows(t.shape[0], mesh)
    out = t.new_zeros((mesh.per_rank * b,) + tuple(t.shape[1:]))
    part = t[r0:r0 + mesh.per_rank * b]
    out[:part.shape[0]] = part
    return out


def _keys(dist_: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as (distance, index): the float's bits mapped to
    an order-preserving int32, then the index in the low 32 bits."""
    bits = dist_.contiguous().view(torch.int32)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return (bits.to(torch.int64) << 32) | gidx


def ring_knn(q: torch.Tensor, cands: torch.Tensor, exclude: torch.Tensor, k: int,
             mesh: ShardMesh, *, metric: str = "cityblock", csls_k: int = 0,
             approx: bool = False) -> torch.Tensor:
    """(Q, k) int64 indices into ``cands`` of each query's k nearest by
    ``metric`` (cityblock or sqeuclidean), ``exclude[i]`` (its partner, -1
    for none) masked out; the same sets as ``blockwise_knn_l1``, with its
    fill (a column without a real candidate, or the masked partner in an
    exhausted pool, takes the row's best)."""
    if csls_k > 0:
        _refuse("CSLS mining (csls_k > 0)")
    if approx:
        _refuse("approximate mining")
    c = cands.shape[0]
    bc, c0 = _rank_rows(c, mesh)
    qs, ex = _chunk(q, mesh), _chunk(exclude, mesh)
    held = _chunk(cands, mesh)
    init = (torch.tensor(_INF_BITS, dtype=torch.int64) << 32).to(q.device)
    keys = init.expand(qs.shape[0], k).clone()
    for hop in range(mesh.world):
        src = (mesh.rank - hop) % mesh.world  # the rank whose chunk is held
        for j in range(mesh.per_rank):  # its shards' blocks, in order
            cb = held[j * bc:(j + 1) * bc]
            gidx = (src * mesh.per_rank + j) * bc + torch.arange(bc, device=q.device)
            for a in range(0, qs.shape[0], BLOCK_Q):
                d = dist_tile(qs[a:a + BLOCK_Q], cb, metric)
                d.masked_fill_((gidx[None, :] >= c) | (gidx[None, :] == ex[a:a + BLOCK_Q, None]),
                               float("inf"))
                both = torch.cat([keys[a:a + BLOCK_Q], _keys(d, gidx.expand_as(d))], dim=1)
                keys[a:a + BLOCK_Q] = torch.topk(both, k, dim=1, largest=False,
                                                 sorted=True).values
        if hop < mesh.world - 1:
            held = _rotate(held, mesh)
    idx = keys & 0xFFFFFFFF
    bad = ((keys >> 32) == _INF_BITS) | (idx == ex[:, None])
    idx = torch.where(bad, idx[:, :1], idx)
    return _gather(idx, mesh)[:q.shape[0]]


def _ring_ranks(q: torch.Tensor, cands: torch.Tensor, d_true: torch.Tensor,
                mesh: ShardMesh) -> torch.Tensor:
    """The rank's queries' counts of candidates strictly closer in L1 than
    the true match (candidate i is query i's, excluded by index)."""
    n = q.shape[0]
    b, r0 = _rank_rows(n, mesh)
    qs, held, th = _chunk(q, mesh), _chunk(cands, mesh), _chunk(d_true, mesh)
    qid = r0 + torch.arange(qs.shape[0], device=q.device)
    count = torch.zeros(qs.shape[0], dtype=torch.int64, device=q.device)
    for hop in range(mesh.world):
        src = (mesh.rank - hop) % mesh.world
        for j in range(mesh.per_rank):
            cb = held[j * b:(j + 1) * b]
            gcol = (src * mesh.per_rank + j) * b + torch.arange(b, device=q.device)
            for a in range(0, qs.shape[0], BLOCK_Q):
                d = dist_tile(qs[a:a + BLOCK_Q], cb)
                ok = (gcol[None, :] < n) & (gcol[None, :] != qid[a:a + BLOCK_Q, None])
                count[a:a + BLOCK_Q] += ((d < th[a:a + BLOCK_Q, None]) & ok).sum(dim=1)
        if hop < mesh.world - 1:
            held = _rotate(held, mesh)
    return _gather(count, mesh)[:n]


def ring_hits_at_k(emb: torch.Tensor, test_pairs, mesh: ShardMesh,
                   ks: tuple[int, ...] = (1, 10), csls_k: int = 0,
                   approx_k: int = 0) -> dict[str, float]:
    """Both-direction Hits@k and MRR over the test pairs, with the
    candidate blocks passed around the ring: the semantics of
    ``train/eval.py::hits_at_k`` (raw L1)."""
    if csls_k > 0:
        _refuse("CSLS eval (csls_k > 0)")
    if approx_k > 0:
        _refuse("approximate eval (approx_k > 0)")
    pairs = torch.as_tensor(np.asarray(test_pairs), dtype=torch.int64, device=emb.device)
    left, right = emb.index_select(0, pairs[:, 0]), emb.index_select(0, pairs[:, 1])
    d_true = pairwise_l1(left, right).float()
    return rank_metrics(_ring_ranks(left, right, d_true, mesh),
                        _ring_ranks(right, left, d_true, mesh), ks)


def ring_sinkhorn_align_loss(*args, **kwargs):
    _refuse("Sinkhorn loss")


def ring_sinkhorn_potentials(*args, **kwargs):
    _refuse("Sinkhorn potentials")
