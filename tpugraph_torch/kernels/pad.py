"""Zero columns appended to rows, so a kernel that reads 16-byte vectors
takes rows of any width.

A zero column changes no L1 distance, no squared distance, no dot product
and no squared norm, so the L1 search (``l1_search.py``), the
select-and-rerank kernel (``shortlist_dist.py``) and the Sinkhorn update
(``sinkhorn_fused.py``) give on the padded rows what the d-wide rows give.
"""

from __future__ import annotations

import torch


def pad_columns(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """x (N, d) with zero columns appended up to the next multiple of
    ``multiple`` (a new contiguous tensor), or x itself where d is one."""
    pad = -x.shape[1] % multiple
    return x if pad == 0 else torch.nn.functional.pad(x, (0, pad))
