"""SHA-256 pins of the port's SpMM, margin and Sinkhorn kernels' outputs at
the widths they took before any width up to 512 did: the ELL and sorted
SpMMs at d 64, 128 and 256 (fp32 and bf16), the L1 margin's loss and
gradient at d 16, 32, 64, 128, 256 and 512, the Sinkhorn update at d 4,
16, 128, 192 and 256.  Inputs are made from fixed seeds with numpy.

    python3 scripts/width_pins.py [--root DIR] [--out FILE]

``--root DIR`` imports ``tpugraph_torch`` from DIR (another commit's tree,
unpacked with ``git archive``), whose kernels build there; without it from
the checkout that holds this script.  Prints one JSON object {name: sha256} and writes it to FILE.
Needs a CUDA card.  ``tests/test_torch_gpu.py::
test_existing_widths_bits_unchanged`` holds the checkout's kernels to the
pins this script printed for the commit before the widths were added.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np
import torch

SPMM_WIDTHS = (64, 128, 256)
MARGIN_WIDTHS = (16, 32, 64, 128, 256, 512)
SINKHORN_WIDTHS = (4, 16, 128, 192, 256)


def sha256_of(t: torch.Tensor) -> str:
    return hashlib.sha256(t.reshape(-1).contiguous().view(torch.uint8).cpu().numpy()).hexdigest()


def _ell_graph(rng, n=8000):
    from tpugraph_torch.sparse.ell import build_ell_operator
    src, dst = rng.integers(0, n, 4 * n), rng.integers(20, n, 4 * n)
    for row, deg in ((3, 5300), (11, 300), (17, 100)):
        src = np.concatenate([src, rng.integers(20, n, deg)])
        dst = np.concatenate([dst, np.full(deg, row)])
    loops = np.arange(n)
    src, dst = np.concatenate([src, loops]), np.concatenate([dst, loops])
    return build_ell_operator(src, dst, rng.standard_normal(len(src)).astype(np.float32), n,
                              split_diag=True)


def _sorted_graph(rng, n=8000):
    from tpugraph_torch.sparse.build import build_spmm_operator
    src, dst = rng.integers(0, n, 4 * n), rng.integers(20, n, 4 * n)
    for row, deg in ((3, 5300), (11, 700)):
        src = np.concatenate([src, rng.integers(20, n, deg)])
        dst = np.concatenate([dst, np.full(deg, row)])
    loops = np.arange(n)
    src, dst = np.concatenate([src, loops]), np.concatenate([dst, loops])
    return build_spmm_operator(src, dst, rng.standard_normal(len(src)).astype(np.float32), n,
                               bucket=4096)


def pinned_outputs(dev: torch.device) -> dict[str, torch.Tensor]:
    """{name: output} of each kernel at each pinned width, on ``dev``."""
    from tpugraph_torch.kernels import margin_l1
    from tpugraph_torch.kernels.sinkhorn_fused import sinkhorn_potential_update
    from tpugraph_torch.kernels.spmm import sorted_spmm
    from tpugraph_torch.kernels.spmm_ell import ell_spmm
    rng = np.random.default_rng(2025)
    out = {}
    ell, srt = _ell_graph(rng).to(dev), _sorted_graph(rng).to(dev)
    for d in SPMM_WIDTHS:
        x = torch.from_numpy(rng.standard_normal((8000, d)).astype(np.float32)).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            name = f"d{d} {str(dtype).split('.')[1]}"
            xt = x.to(dtype)
            out[f"spmm_ell fwd {name}"] = ell_spmm(ell.fwd, ell.diag, xt)
            out[f"spmm_ell bwd {name}"] = ell_spmm(ell.bwd, ell.diag, xt)
            out[f"spmm_sorted fwd {name}"] = sorted_spmm(srt.fwd, xt)
    for d in MARGIN_WIDTHS:
        n, s, k = 3000, 600, 20
        emb = torch.from_numpy((rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32))
        pairs = np.stack([rng.integers(0, n // 2, s), rng.integers(n // 2, n, s)], 1)
        neg_l, neg_r = rng.integers(0, n // 2, (s, k)), rng.integers(n // 2, n, (s, k))
        neg_r[:5, 0] = pairs[:5, 1]  # pool-of-one ties
        w = torch.from_numpy(rng.uniform(0, 2, s).astype(np.float32)).to(dev)
        ids = [torch.from_numpy(a).to(dev) for a in (pairs, neg_l, neg_r)]
        e = emb.to(dev).requires_grad_(True)
        loss = margin_l1.margin_l1_loss(e, *ids, 3.0, w)
        (grad,) = torch.autograd.grad(loss, e)
        out[f"margin_l1 loss d{d}"], out[f"margin_l1 grad d{d}"] = loss.detach(), grad
    for d in SINKHORN_WIDTHS:
        q, c = 300, 1000
        l = rng.standard_normal((q, d)).astype(np.float32)
        r = rng.standard_normal((c, d)).astype(np.float32)
        l = torch.from_numpy(l / np.linalg.norm(l, axis=1, keepdims=True)).to(dev)
        r = torch.from_numpy(r / np.linalg.norm(r, axis=1, keepdims=True)).to(dev)
        g = torch.from_numpy((0.2 * rng.standard_normal(c)).astype(np.float32)).to(dev)
        log_mu = torch.full((q,), -float(np.log(q)), device=dev)
        for tau in (0.05, 0.3):
            out[f"sinkhorn_fused d{d} tau{tau}"] = sinkhorn_potential_update(l, r, g, log_mu, tau)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None, help="import tpugraph_torch from this tree")
    ap.add_argument("--out", default=None, help="also write the pins to this JSON file")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root or os.path.join(os.path.dirname(__file__),
                                                                 os.pardir)))
    if not torch.cuda.is_available():
        print("width_pins needs a CUDA card", file=sys.stderr)
        return 1
    import tpugraph_torch
    pins = {k: sha256_of(v) for k, v in pinned_outputs(torch.device("cuda")).items()}
    print(json.dumps({"tree": os.path.dirname(os.path.dirname(tpugraph_torch.__file__)),
                      "card": torch.cuda.get_device_name(0), "pins": pins}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(pins, f, indent=1, sort_keys=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
