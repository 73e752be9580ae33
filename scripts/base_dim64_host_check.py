"""Config ``base`` at dim 64 on the host: the JAX trainer's and the port's
per-epoch losses over one run on the same zh-en-scale task.

Both ``fit``s train the same synthetic task (19,000 entities a KG, 70,000
triples, 15,000 pairs, seed 7: ``chip_smoke.py``'s ``ZH_EN``) at
``dim=64`` for ``--epochs`` epochs, on the CPU.  The JAX trainer records a
loss only where it evaluates, so its eval runs every epoch with the
metric call replaced by a stub (the loss is what is compared, and an
exact eval of 10,500 pairs each epoch would dominate the run); the port
records every step's loss.  The epoch-0 negatives differ (``jax.random``
against ``torch.Generator``), so the curves are compared by shape: the
jump at the first hard mining (epoch ``neg_every``) and whether each run
ends below its first loss.

    JAX_PLATFORMS=cpu python scripts/base_dim64_host_check.py [--epochs 10] [--dim 64]

Prints one JSON line: both curves and the comparison.
"""

import argparse
import json
import sys
import time

sys.path.insert(0, ".")

ZH_EN = dict(seed=7, n_ent=19000, n_rel=1200, n_triples=70000, n_pairs=15000,
             n_attr=1000, attrs_per_ent=4)


def _shape(losses: list, every: int) -> dict:
    first, last = losses[0], losses[-1]
    jump = losses[every] - losses[every - 1] if len(losses) > every else None
    return {"first": first, "last": last, "ends_below_first": last < first,
            "jump_at_first_mining": jump, "min": min(losses),
            "epoch_of_min": losses.index(min(losses))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--dim", type=int, default=64)
    args = ap.parse_args()

    import numpy as np
    import torch

    import tpugraph.train.loop as jax_loop
    from tpugraph.configs.configs import get_config as jax_get_config
    from tpugraph.data.synthetic import synthetic_align_task as jax_task
    from tpugraph_torch.configs.configs import get_config
    from tpugraph_torch.data.synthetic import synthetic_align_task
    from tpugraph_torch.train.loop import fit

    over = dict(dim=args.dim, epochs=args.epochs, syn_n_ent=ZH_EN["n_ent"],
                syn_n_rel=ZH_EN["n_rel"], syn_seed=ZH_EN["seed"])
    jtask, task = jax_task(**ZH_EN), synthetic_align_task(**ZH_EN)
    for name in ("train_pairs", "test_pairs", "merged_triples"):
        if not np.array_equal(np.asarray(getattr(jtask, name)), np.asarray(getattr(task, name))):
            raise AssertionError(f"the two packages' tasks differ in {name}")

    jax_loop.hits_at_k = lambda *a, **k: {"hits@1": 0.0, "hits@10": 0.0, "mrr": 0.0}
    t0 = time.perf_counter()
    jres = jax_loop.fit(jax_get_config("base", **over, eval_every=1), jtask)
    jax_s = time.perf_counter() - t0
    jax_losses = [float(r["loss"]) for r in jres.history]

    torch.manual_seed(0)
    t0 = time.perf_counter()
    res = fit(get_config("base", **over, eval_every=0), task, device="cpu")
    port_s = time.perf_counter() - t0
    port_losses = [float(v) for v in res.losses]

    cfg = get_config("base", **over)
    out = {"config": "base", "dim": args.dim, "epochs": args.epochs, "neg_every": cfg.neg_every,
           "k_neg": cfg.k_neg, "task": ZH_EN, "jax_losses": jax_losses,
           "port_losses": port_losses, "jax": _shape(jax_losses, cfg.neg_every),
           "port": _shape(port_losses, cfg.neg_every), "jax_s": jax_s, "port_s": port_s,
           "device": "cpu"}
    rises = [(out[k]["jump_at_first_mining"] or 0) > 0 for k in ("jax", "port")]
    out["same_shape"] = (out["jax"]["ends_below_first"] == out["port"]["ends_below_first"]
                         and rises[0] == rises[1])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
