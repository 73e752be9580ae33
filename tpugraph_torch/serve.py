"""Alignment serving (counterpart of ``tpugraph/serve.py``, exact raw-L1
path).

* ``topk_alignments`` — blockwise top-k candidate search with a running
  top-k, over query blocks × candidate blocks (never the full distance
  matrix);
* ``export_alignments`` — bulk predictions to a TSV of rank lists;
* ``save_embeddings`` / ``load_embeddings`` — the table via ``torch.save``.

CSLS re-scoring and the prefiltered approximate search are not ported yet.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpugraph_torch import resolve_device
from tpugraph_torch.train.losses import pairwise_l1


BLOCK_Q = 256  # queries per block: (256, 2048, 128) fp32 is 268 MB


def _topk_blockwise(q: torch.Tensor, cands: torch.Tensor, k: int,
                    block_c: int = 2048) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, candidate positions), each (Q, k), best first.

    Merges each candidate block into the running top-k with a stable sort,
    so equal scores keep the earlier candidate — the order ``lax.top_k``
    gives.  A pool smaller than k leaves inf-valued entries pointing at
    position 0, as the JAX path does."""
    s = q.shape[0]
    c = cands.shape[0]
    vals = torch.empty((s, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((s, k), dtype=torch.int64, device=q.device)
    for q0 in range(0, s, BLOCK_Q):
        qb = q[q0:q0 + BLOCK_Q]
        rv = torch.full((qb.shape[0], k), float("inf"), device=q.device)
        ri = torch.zeros((qb.shape[0], k), dtype=torch.int64, device=q.device)
        for c0 in range(0, c, block_c):
            cb = cands[c0:c0 + block_c]
            dmat = pairwise_l1(qb[:, None, :], cb[None, :, :]).float()
            cidx = torch.arange(c0, c0 + cb.shape[0], device=q.device).expand(qb.shape[0], -1)
            allv = torch.cat([rv, dmat], dim=1)
            alli = torch.cat([ri, cidx], dim=1)
            sv, pos = torch.sort(allv, dim=1, stable=True)
            rv, ri = sv[:, :k], alli.gather(1, pos[:, :k])
        vals[q0:q0 + qb.shape[0]] = rv
        idx[q0:q0 + qb.shape[0]] = ri
    return vals, idx


def topk_alignments(
    emb: torch.Tensor,
    query_ids,  # entity ids to align (global/merged ids)
    candidate_ids,  # candidate pool (e.g. all KG2 entities)
    k: int = 10,
    block_c: int = 2048,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (L1 distances (Q, k), candidate entity ids (Q, k)), best
    first, computed on ``emb``'s device."""
    dev = emb.device
    qi = torch.as_tensor(np.asarray(query_ids), dtype=torch.int64, device=dev)
    ci = torch.as_tensor(np.asarray(candidate_ids), dtype=torch.int64, device=dev)
    vals, pos = _topk_blockwise(emb.index_select(0, qi), emb.index_select(0, ci), k,
                                block_c=block_c)
    return vals.cpu().numpy(), ci[pos].cpu().numpy()


def export_alignments(path: str, emb: torch.Tensor, query_ids, candidate_ids,
                      k: int = 10) -> int:
    """Write '<query>\\t<cand1>:<d1>\\t...' per line; returns #rows written."""
    vals, ids = topk_alignments(emb, query_ids, candidate_ids, k=k)
    with open(path, "w") as f:
        for qi, (row_ids, row_d) in zip(query_ids, zip(ids, vals)):
            cells = "\t".join(f"{int(c)}:{float(d):.6f}" for c, d in zip(row_ids, row_d))
            f.write(f"{int(qi)}\t{cells}\n")
    return len(query_ids)


def save_embeddings(path: str, emb: torch.Tensor) -> None:
    """Write the embedding table (as a CPU tensor) to the file ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"emb": emb.detach().cpu()}, path)


def load_embeddings(path: str) -> torch.Tensor:
    """The table written by ``save_embeddings``, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)["emb"]


def main(argv=None) -> int:
    """Bulk-alignment CLI: ``python -m tpugraph_torch.serve --emb f.pt --out f.tsv``.

    Query/candidate sets come from id files (one int per line) or from an
    ``--n-left`` split of the merged table (ids < n_left query the rest)."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m tpugraph_torch.serve",
        description="Export top-k entity alignments from a trained embedding table.")
    ap.add_argument("--emb", required=True, help="embedding file (serve.save_embeddings)")
    ap.add_argument("--out", required=True, help="output TSV path")
    ap.add_argument("--queries", default=None, help="file of query entity ids, one per line")
    ap.add_argument("--candidates", default=None,
                    help="file of candidate entity ids, one per line")
    ap.add_argument("--n-left", type=int, default=None,
                    help="merged-id split: ids [0,n) query ids [n,N) "
                         "(default when no id files are given)")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    emb = load_embeddings(args.emb).to(resolve_device(args.device))
    n = emb.shape[0]
    if args.queries:
        query_ids = np.loadtxt(args.queries, dtype=np.int64).reshape(-1)
    elif args.n_left is not None:
        query_ids = np.arange(args.n_left)
    else:
        ap.error("need --queries or --n-left")
    if args.candidates:
        candidate_ids = np.loadtxt(args.candidates, dtype=np.int64).reshape(-1)
    elif args.n_left is not None:
        candidate_ids = np.arange(args.n_left, n)
    else:
        ap.error("need --candidates or --n-left")

    rows = export_alignments(args.out, emb, query_ids, candidate_ids, k=args.k)
    print(f"wrote {rows} rows x top-{args.k} to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
