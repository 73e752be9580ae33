"""Alignment serving (counterpart of ``tpugraph/serve.py``).

* ``topk_alignments`` — the exact top-k candidate search, one
  ``kernels/l1_search.py::l1_topk`` (on the card one kernel launch with a
  running queue per query, never the distance matrix); ``csls_k > 0``
  ranks by the CSLS score 2·d(q, j) − r(j), r the candidate's hubness over
  the query pool (``train/negatives.py``).
  ``approx_k > 0`` searches within a shortlist per query instead
  (``_topk_prefiltered``): the ``max(approx_k, k)`` nearest by the
  sqeuclidean score, selected exactly (the JAX package's ``approx_min_k``
  is approximate on the TPU) and rescored in exact L1 in the same
  select-and-rerank call (``kernels/shortlist_dist.py::select_rerank``);
* ``export_alignments`` — bulk predictions to a TSV of rank lists;
* ``save_embeddings`` / ``load_embeddings`` — the table via ``torch.save``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpugraph_torch import resolve_device
from tpugraph_torch.kernels.l1_search import l1_topk
from tpugraph_torch.kernels.shortlist_dist import select_rerank
from tpugraph_torch.train.negatives import _cand_hubness, _hubness_both_approx


def _topk_blockwise(q: torch.Tensor, cands: torch.Tensor, k: int, block_c: int = 2048,
                    csls_k: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, candidate positions), each (Q, k), best first; the values
    are L1 distances, or CSLS scores when ``csls_k > 0``.

    Equal scores keep the earlier candidate — the order ``lax.top_k``
    gives.  A pool smaller than k leaves inf-valued entries pointing at
    position 0, as the JAX path does.  ``block_c`` is kept for the JAX
    signature."""
    q, cands = q.contiguous(), cands.contiguous()
    kk = min(k, cands.shape[0])
    csls = dict(a=2.0, bias=_cand_hubness(q, cands, csls_k)) if csls_k > 0 else {}
    vals, idx = l1_topk(q, cands, kk, **csls)
    if kk < k:
        vals = torch.cat([vals, vals.new_full((vals.shape[0], k - kk), float("inf"))], 1)
        idx = torch.cat([idx, idx.new_zeros((idx.shape[0], k - kk))], 1)
    return vals, idx


def _topk_prefiltered(q: torch.Tensor, cands: torch.Tensor, k: int, approx_k: int,
                      csls_k: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, candidate positions), each (Q, k), best first, within a
    shortlist of kk = min(C, max(approx_k, k)) candidates per query,
    selected by the sqeuclidean score (2·d₂ − r₂(j) with CSLS) and scored in
    exact L1 (2·d − r(j) with CSLS, r the sqeuclidean-selected L1 hubness).
    Equal scores keep the earlier shortlist entry, the order ``lax.top_k``
    gives; a pool smaller than k pads with inf-valued entries at position 0,
    as the JAX path does."""
    q, cands = q.contiguous(), cands.contiguous()
    kk = min(cands.shape[0], max(approx_k, k))
    csls = {}
    if csls_k > 0:
        r_sel, r_score = _hubness_both_approx(q, cands, csls_k)
        csls = dict(a=2.0, bias=r_sel)
    sidx, _, score = select_rerank(q, cands, kk, rerank="cityblock", **csls)
    if csls_k > 0:
        score = 2.0 * score - r_score[sidx]
    if kk < k:
        score = torch.cat([score, score.new_full((score.shape[0], k - kk), float("inf"))], 1)
        sidx = torch.cat([sidx, sidx.new_zeros((sidx.shape[0], k - kk))], 1)
    vals, pos = torch.sort(score, dim=1, stable=True)
    return vals[:, :k], sidx.gather(1, pos[:, :k])


def topk_alignments(
    emb: torch.Tensor,
    query_ids,  # entity ids to align (global/merged ids)
    candidate_ids,  # candidate pool (e.g. all KG2 entities)
    k: int = 10,
    block_c: int = 2048,
    csls_k: int = 0,
    approx_k: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (scores (Q, k), candidate entity ids (Q, k)), best first,
    computed on ``emb``'s device.  The scores are L1 distances, or with
    ``csls_k > 0`` the CSLS scores 2·d(q, j) − r(j), r(j) the candidate's
    hubness over this query pool (the JAX package's convention).
    ``approx_k > 0`` searches within a shortlist of that many candidates
    per query (``_topk_prefiltered``; approximate)."""
    dev = emb.device
    qi = torch.as_tensor(np.asarray(query_ids), dtype=torch.int64, device=dev)
    ci = torch.as_tensor(np.asarray(candidate_ids), dtype=torch.int64, device=dev)
    q, cands = emb.index_select(0, qi), emb.index_select(0, ci)
    if approx_k > 0:
        vals, pos = _topk_prefiltered(q, cands, k, approx_k, csls_k)
    else:
        vals, pos = _topk_blockwise(q, cands, k, block_c=block_c, csls_k=csls_k)
    return vals.cpu().numpy(), ci[pos].cpu().numpy()


def export_alignments(path: str, emb: torch.Tensor, query_ids, candidate_ids,
                      k: int = 10, csls_k: int = 0, approx_k: int = 0) -> int:
    """Write '<query>\\t<cand1>:<d1>\\t...' per line; returns #rows written."""
    vals, ids = topk_alignments(emb, query_ids, candidate_ids, k=k, csls_k=csls_k,
                                approx_k=approx_k)
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
    ap.add_argument("--csls-k", type=int, default=0,
                    help=">0: CSLS hubness-corrected re-scoring")
    ap.add_argument("--approx-k", type=int, default=0,
                    help=">0: search within a sqeuclidean top-K shortlist per query "
                         "(approximate)")
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

    rows = export_alignments(args.out, emb, query_ids, candidate_ids, k=args.k,
                             csls_k=args.csls_k, approx_k=args.approx_k)
    print(f"wrote {rows} rows x top-{args.k} to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
