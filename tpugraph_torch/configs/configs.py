"""Dataclass configs (a copy of ``tpugraph/configs/configs.py``).

Kept field for field so a config means the same run in both packages; the
port reads the fields its ported paths use and refuses the options it has
not ported yet (``train/loop.py``, ``train/driver.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class TrainConfig:
    name: str = "default"

    # --- data ---
    dataset: str = "synthetic"  # 'synthetic' | 'dbp15k' | 'openea' (DWY100K)
    data_root: str = "data"  # dbp15k: directory holding <pair>/; openea: the pair dir
    pair: str = "zh_en"
    train_ratio: float = 0.3
    openea_fold: int = 1  # 721_5fold/<fold> split (1-5); 0 = ignore the
    # official folds and use a seeded train_ratio split of ent_links
    # synthetic generator knobs (ignored for dbp15k)
    syn_n_ent: int = 2000
    syn_n_rel: int = 40
    syn_n_triples: int = 8000
    syn_drop_frac: float = 0.1
    syn_noise_frac: float = 0.1
    syn_seed: int = 0

    # --- graph build ---
    weighting: str = "uniform"  # 'uniform' | 'funifun'
    norm: str = "sym"  # 'sym' | 'rw' | 'none'
    pad_bucket: int = 8192  # single-device operator padding granularity;
    # the distributed trainer's edge partitioner sizes its own per-shard
    # padding from the partition geometry and does not read this knob

    # --- model ---
    dim: int = 128
    hidden: int | None = None
    highway: bool = False
    dropout: float = 0.0
    spmm_impl: str = "ell"  # 'ell' (scatter-free, fastest) | 'sorted' | 'xla' | 'pallas' (alias of 'ell'; DESIGN.md §3)
    l2_normalize: bool = False  # L2-normalize encoder output rows
    param_dtype: str = "float32"  # compute dtype: "bfloat16" = bf16 activations, fp32 params/accumulation

    # --- margin alignment loss ---
    gamma: float = 10.0
    k_neg: int = 50
    neg_every: int = 5
    neg_mode: str = "hard"  # 'uniform' | 'hard'
    neg_approx: bool = False  # approx_min_k hard mining (fast; sampling-safe)
    boot_approx: bool = False  # MXU-prefiltered mutual-NN proposals (bf16
    # matmul shortlist + exact-L1 rerank; headline-validated — DESIGN.md §6c).
    # Composes with boot_csls_k > 0: shortlist selected by the sqeuclidean
    # CSLS score, reranked by the approx-L1 CSLS score (train/bootstrap.py)
    neg_metric: str = "cityblock"  # hard-mining metric; 'sqeuclidean' rides the MXU (use at DWY100K scale)
    neg_csls_k: int = 0  # >0: CSLS hubness-corrected hard mining (2·d − cand-hubness)

    # --- bootstrapped pair augmentation (BootEA/MRAEA-style, stateless) ---
    boot_cap: int = 0  # >0: propose up to this many mutual-NN pairs per interval
    boot_start: int = 100  # first epoch eligible for proposals
    boot_weight: float = 1.0  # loss weight of proposed pairs
    boot_csls_k: int = 0  # >0: CSLS-scored mutual-NN matching

    # --- auxiliary heads (configs 2/3) ---
    use_sinkhorn: bool = False
    sinkhorn_weight: float = 1.0
    sinkhorn_iters: int = 20
    sinkhorn_tau: float = 0.05  # entropic regularization temperature
    sinkhorn_pairs: int = 0  # >0: subsample this many seed pairs per interval
    # for the OT loss (caps the S×S transport problem at DWY100K+ seed counts)
    use_rel_head: bool = False
    rel_weight: float = 0.25
    rel_k_neg: int = 10
    use_attr_head: bool = False
    attr_weight: float = 0.25
    use_attr_channel: bool = False  # GCN-Align AE channel (attribute-feature GCN)
    attr_beta: float = 0.9  # SE/AE distance combination weight at eval
    attr_channel_weight: float = 1.0  # AE margin-loss weight during training

    # --- optimization ---
    epochs: int = 400
    eval_csls_k: int = 0  # >0: CSLS hubness-corrected ranking
    eval_approx_k: int = 0  # >0: MXU-prefiltered TRAINING-history evals —
    # ranks counted within a sqeuclidean top-k shortlist (train/eval.py);
    # the final reported metrics always use the exact full-pool path
    steps_per_call: int = 1  # >1: fuse a full resample interval (must equal
    # neg_every) into ONE jitted dispatch — resampling + neg_every train steps
    # as a lax.scan (amortizes per-dispatch latency; plain fit() path only)
    lr: float = 2e-3
    lr_schedule: str = "const"  # 'const' | 'cosine' (train/optim.py semantics)
    lr_warmup: int = 0  # linear warmup, in optimizer updates (== epochs)
    lr_final_frac: float = 0.0  # cosine floor as a fraction of lr
    seed: int = 0
    eval_every: int = 100

    # --- distribution (config 4) ---
    n_shards: int = 1  # graph-axis mesh size; 1 = single device
    feature_shards: int = 1
    slice_shards: int = 1  # DCN axis: data-parallel loss batches across pod
    # slices; grads all-reduce over 'slice' is the only DCN collective
    halo_grouped: bool = False  # component-grouped halo exchange: shard the
    # two KGs onto disjoint halves of the 'graph' axis (row-remapped ids) and
    # all_to_all within each half only — ~2x fewer padded exchange rows on the
    # block-diagonal merged graph (DESIGN.md §5 (c)); requires even n_shards.
    # The flag is part of the partition geometry: checkpoints stamp the row
    # layout and restore RAISES across a halo_grouped change (dist/trainer.py).

    # --- observability ---
    metrics_path: str | None = None  # JSONL sink
    tb_dir: str | None = None  # optional TensorBoard event-file sink
    profile_dir: str | None = None
    checkpoint_dir: str | None = None
    checkpoint_every: int = 0  # steps; 0 = disabled
    save_emb_path: str | None = None  # write the final embedding table for
    # the serving path (tpugraph.serve) after training

    def __post_init__(self):
        """Range validation for knobs whose out-of-range values previously
        produced silent nonsense (round-4b review): train_ratio=1.5 passed
        the CLI's type-only coercion, left the test split empty, and the
        run printed NaN metrics as its final JSON.  Runs on construction
        AND on every .replace()."""
        if not 0.0 < self.train_ratio < 1.0:
            raise ValueError(f"train_ratio={self.train_ratio} must be in "
                             f"(0, 1) — a 1.0 split leaves no test pairs "
                             f"and every metric would be NaN")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout={self.dropout} must be in [0, 1)")
        if not 0.0 <= self.attr_beta <= 1.0:
            raise ValueError(f"attr_beta={self.attr_beta} must be in [0, 1]")
        if self.epochs < 0:
            # epochs == 0 is the supported eval-only path (train/driver.py
            # evaluate(): restore + exact final eval, zero training steps);
            # the round-4b `>= 1` floor broke it (VERDICT r4 missing #1/#2)
            raise ValueError(f"epochs={self.epochs} must be >= 0 "
                             f"(0 = eval-only: no training steps, final "
                             f"eval only — see train/driver.evaluate)")
        if self.k_neg < 1:
            raise ValueError(f"k_neg={self.k_neg} must be >= 1")

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# The five BASELINE.json capability configs (SURVEY.md §0).
CONFIGS: dict[str, TrainConfig] = {
    # config[0]: 2-layer sparse GCN, DBP15K zh-en full-graph, margin loss (CPU-runnable)
    "base": TrainConfig(name="base", pair="zh_en"),
    # config[1]: highway/weighted GCN, degree-normalized adjacency, ja-en + fr-en
    "highway": TrainConfig(
        name="highway", pair="ja_en", weighting="funifun", norm="rw", highway=True
    ),
    # config[2]: alignment + Sinkhorn OT head (fused SDDMM distance + on-device
    # OT).  w/tau are the ot_sweep.py round 1-6 optimum (BASELINE.md v5 row):
    # the naive tau 0.05 leaves half the accuracy gain on the table.
    "sinkhorn": TrainConfig(name="sinkhorn", use_sinkhorn=True,
                            sinkhorn_weight=3.0, sinkhorn_tau=0.3),
    # config[3]: full multi-task: alignment + relation/attribute heads, joint weighting
    "mtl": TrainConfig(
        name="mtl", use_sinkhorn=True, use_rel_head=True, use_attr_head=True,
        sinkhorn_weight=3.0, sinkhorn_tau=0.3,
    ),
    # config[4]: edge-partitioned multi-host DWY100K-scale, boundary all-to-all
    "dwy100k_dist": TrainConfig(
        name="dwy100k_dist",
        syn_n_ent=100_000,
        syn_n_triples=500_000,
        syn_n_rel=300,
        n_shards=8,
        k_neg=25,
        pad_bucket=65536,
    ),
}


def get_config(name: str, **overrides) -> TrainConfig:
    cfg = CONFIGS[name].replace(**overrides)
    if cfg.spmm_impl == "pallas":
        # alias, resolved here so every trainer's fmt dispatch sees 'ell'
        # (docs/DESIGN.md §3 entry 4: every Pallas SpMM measured slower)
        cfg = cfg.replace(spmm_impl="ell")
    return cfg
