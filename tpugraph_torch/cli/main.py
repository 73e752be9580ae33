"""Trainer CLI (counterpart of ``tpugraph/cli/main.py``).

    python -m tpugraph_torch.cli.main --config sinkhorn --epochs 10
    python -m tpugraph_torch.cli.main --recipe v6 --set checkpoint_dir=ckpt checkpoint_every=50
    python -m tpugraph_torch.cli.main --recipe v7r
    python -m tpugraph_torch.cli.main --config mtl --set use_attr_channel=true
    python -m tpugraph_torch.cli.main --config highway --set dropout=0.3
    python -m tpugraph_torch.cli.main --config base --set dim=128 neg_every=5 --device cpu
    python -m tpugraph_torch.cli.main --recipe v6 --fast
    python -m tpugraph_torch.cli.main --config base --profile-dir prof --epochs 10
    python -m tpugraph_torch.cli.main --dataset dbp15k --data-root data --pair zh_en
    python -m tpugraph_torch.cli.main --dataset openea --data-root data/D_W_15K_V1
    python -m tpugraph_torch.cli.main --config dwy100k_dist --epochs 10
    torchrun --nproc_per_node=8 -m tpugraph_torch.cli.main --config dwy100k_dist

Picks a named config, applies a tuned recipe (``--recipe``,
``configs/recipes.py``: v1–v7r), then the flags and typed ``key=value``
overrides (``--set``), trains through ``train/driver.py::run`` on the card
(``--device cuda``, the default) or the host, and prints the final metrics
as one JSON line.  ``--eval-only`` scores the parameters in
``checkpoint_dir`` instead (``driver.evaluate``).  ``--fast`` fuses each
resample interval (``steps_per_call = neg_every``: one captured step
replayed per epoch on the card, ``train/fused.py``) and mines hard
negatives approximately in sqeuclidean (``neg_metric = "sqeuclidean"``,
``neg_approx = true``); a ``--set`` of any of the three wins.
``--profile-dir`` writes a ``torch.profiler`` trace of epochs 2–5;
``--debug-nans`` raises ``FloatingPointError`` at the first non-finite
loss, gradient or parameter (the counterpart of ``jax_debug_nans``:
anomaly detection and a check per step, or per fused interval);
``--dataset``, ``--data-root`` and ``--pair`` read a DBP15K or OpenEA
directory (``data/dbp15k.py``, ``data/openea.py``).  Config
``dwy100k_dist`` trains its 8 shards in one process on one card (an NCCL
group of one rank), or one rank per card under torchrun (NCCL allows one
rank per device; ``dist/mesh.py``); rank 0 prints the line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from tpugraph_torch.configs.configs import CONFIGS, get_config
from tpugraph_torch.configs.recipes import RECIPES


def _coerce(field_type, raw: str):
    if field_type is int:
        return int(raw)
    if field_type is float:
        return float(raw)
    if field_type is bool:
        low = raw.lower()
        if low in ("1", "true", "yes"):
            return True
        if low in ("0", "false", "no"):
            return False
        raise SystemExit(f"boolean override value {raw!r} not understood "
                         f"(use true/false, 1/0, yes/no)")
    return raw


def parse_overrides(cfg, pairs: list[str]) -> dict:
    fields = {f.name: f.type for f in dataclasses.fields(cfg)}
    out = {}
    for p in pairs:
        if "=" not in p:
            raise SystemExit(f"override {p!r} must be key=value")
        k, v = p.split("=", 1)
        if k not in fields:
            raise SystemExit(f"unknown config key {k!r}; valid: {sorted(fields)}")
        t = fields[k]
        if isinstance(t, str):  # from __future__ annotations
            t = {"int": int, "float": float, "bool": bool, "str": str}.get(
                t.split("|")[0].strip(), str)
        out[k] = _coerce(t, v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpugraph_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="base", choices=sorted(CONFIGS))
    ap.add_argument("--recipe", default=None, choices=sorted(RECIPES),
                    help="tuned training recipe (configs/recipes.py), applied before --set")
    ap.add_argument("--dataset", default=None, choices=["synthetic", "dbp15k", "openea"])
    ap.add_argument("--data-root", default=None)
    ap.add_argument("--pair", default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--metrics", default=None, help="JSONL metrics path")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of epochs 2-5 here")
    ap.add_argument("--save-emb", default=None,
                    help="write the final embedding table here for "
                         "python -m tpugraph_torch.serve")
    ap.add_argument("--set", nargs="*", action="append", default=[],
                    help="key=value config overrides")
    ap.add_argument("--fast", action="store_true",
                    help="fuse each resample interval (steps_per_call=neg_every, a captured "
                         "step replayed on the card) and mine approximately in sqeuclidean; "
                         "semantically equal to the unfused path")
    ap.add_argument("--eval-only", action="store_true",
                    help="no training: score the parameters in checkpoint_dir "
                         "(--set checkpoint_dir=...)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--debug-nans", action="store_true",
                    help="dev flag: raise FloatingPointError at the first non-finite loss, "
                         "gradient or parameter (per step, or per fused interval)")
    args = ap.parse_args(argv)

    cfg = get_config(args.config)
    if args.recipe:
        cfg = cfg.replace(**RECIPES[args.recipe])
    overrides = parse_overrides(cfg, [p for grp in args.set for p in grp])
    for k, flag in (("dataset", args.dataset), ("data_root", args.data_root),
                    ("pair", args.pair), ("epochs", args.epochs),
                    ("metrics_path", args.metrics), ("profile_dir", args.profile_dir),
                    ("save_emb_path", args.save_emb)):
        if flag is not None:
            overrides[k] = flag
    if args.fast:
        overrides.setdefault("steps_per_call", overrides.get("neg_every", cfg.neg_every))
        overrides.setdefault("neg_metric", "sqeuclidean")
        overrides.setdefault("neg_approx", True)
    cfg = cfg.replace(**overrides)
    if cfg.spmm_impl == "pallas":  # the alias, resolved after the overrides
        cfg = cfg.replace(spmm_impl="ell")

    from tpugraph_torch.train.driver import evaluate, run

    if args.eval_only:
        metrics = evaluate(cfg, device=args.device).metrics
    else:
        metrics = run(cfg, device=args.device, verbose=not args.quiet,
                      debug_nans=args.debug_nans).metrics
    if int(os.environ.get("RANK", "0")) == 0:  # under torchrun, rank 0 speaks
        print(json.dumps({"config": cfg.name, **{k: round(v, 4) for k, v in metrics.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
