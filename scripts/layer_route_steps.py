"""A training step of config ``base`` (or of a recipe) at a width by each
route of the GCN layer, on the card: the fused kernel
(``gcn_fused.FUSED_WIDTHS`` holds the width) against x·W then ``spmm_ell``
(the width taken out of it), in turns.

For each (dim, hidden) the zh-en-scale task's model takes steps (forward
and backward; config base: the margin over uniform negatives; with
``--recipe``: the recipe's whole loss through ``driver.step_parts`` on its
first batch, ``loop.first_batch``, e.g. v6's margin and OT head) timed
three ways: CUDA events over back-to-back steps, the host's wall of one
step ended by a synchronise (median), and the first layer's forward alone
by events and by the host's enqueue time a call.  One JSON line a width and
route.  It needs a CUDA device:

    python3 scripts/layer_route_steps.py [--widths 64x64,50x300] [--rounds 3] [--recipe v6]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpugraph_torch.configs.configs import get_config  # noqa: E402
from tpugraph_torch.configs.recipes import RECIPES  # noqa: E402
from tpugraph_torch.data.synthetic import synthetic_align_task  # noqa: E402
from tpugraph_torch.kernels import gcn_fused  # noqa: E402
from tpugraph_torch.models.encoder import AlignGCN  # noqa: E402
from tpugraph_torch.sparse.build import build_adjacency  # noqa: E402
from tpugraph_torch.train.driver import step_parts  # noqa: E402
from tpugraph_torch.train.loop import first_batch  # noqa: E402
from tpugraph_torch.train.losses import margin_align_loss  # noqa: E402
from tpugraph_torch.train.negatives import sample_uniform_negatives  # noqa: E402

# the zh-en-scale synthetic task of chip_smoke.py (ZH_EN)
ZH_EN = dict(seed=7, n_ent=19000, n_rel=1200, n_triples=70000, n_pairs=15000, n_attr=1000,
             attrs_per_ent=4, name="zh_en")


def _events_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _synced_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _host_us(fn, calls: int = 200) -> float:
    """Host wall of one call while the card keeps up, in µs: the enqueue
    cost, without a synchronise inside the loop."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / calls * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", default="64x64,50x300")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--recipe", default=None, choices=sorted(RECIPES),
                    help="time this recipe's step on config base instead of the margin step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("layer_route_steps: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    task = synthetic_align_task(**ZH_EN)
    op = build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel).to(dev)
    pairs = torch.as_tensor(task.train_pairs, dtype=torch.int64, device=dev)
    table = gcn_fused.FUSED_WIDTHS
    for width in args.widths.split(","):
        dim, hidden = (int(v) for v in width.split("x"))
        if args.recipe is None:
            cfg = get_config("base", dim=dim, hidden=hidden)
            neg_l, neg_r = sample_uniform_negatives(torch.Generator().manual_seed(1), pairs,
                                                    task.kg1.n_ent, task.n_ent, cfg.k_neg)
            model = AlignGCN(n_ent=task.n_ent, dim=dim, hidden=hidden, device=dev)
            layer_op, enc = op, model
            torch.manual_seed(0)
            for p in model.parameters():
                torch.nn.init.normal_(p, std=dim ** -0.5)

            def step():
                model.zero_grad(set_to_none=True)
                margin_align_loss(model(op, train=True), pairs, neg_l, neg_r,
                                  cfg.gamma).backward()
        else:
            cfg = get_config("base", **{**RECIPES[args.recipe], "dim": dim, "hidden": hidden})
            torch.manual_seed(0)
            parts = step_parts(cfg, task, dev)
            model, batch = parts.model, first_batch(cfg, task, parts, dev)
            layer_op = parts.op
            enc = getattr(model, "encoder", model)  # AlignMTL wraps the encoder

            def step():
                model.zero_grad(set_to_none=True)
                parts.loss_fn(batch, None)[0].backward()

        def first_layer():
            with torch.no_grad():
                return gcn_fused.gcn_layer(layer_op, enc.emb, enc.gc1.w, enc.gc1.b)

        routes = {"fused": table | {(dim, hidden)}, "unfused": table - {(dim, hidden)}}
        got = {name: {"events_ms": [], "synced_ms": [], "layer1_ms": [], "layer1_host_us": []}
               for name in routes}
        for name in ("unfused", "fused", "fused", "unfused") * args.rounds:
            gcn_fused.FUSED_WIDTHS = routes[name]
            got[name]["events_ms"].append(_events_ms(step))
            got[name]["synced_ms"].append(_synced_ms(step))
            got[name]["layer1_ms"].append(_events_ms(first_layer))
            got[name]["layer1_host_us"].append(_host_us(first_layer))
        gcn_fused.FUSED_WIDTHS = table
        for name, t in got.items():
            print(json.dumps({"dim": dim, "hidden": hidden, "recipe": args.recipe, "route": name,
                              **{k: float(np.median(v)) for k, v in t.items()},
                              "turns": t, "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
