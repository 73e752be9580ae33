"""Tuned training recipes (a copy of ``tpugraph/configs/recipes.py``).

A recipe is a dict of TrainConfig overrides, applied before ``--set`` by
``python -m tpugraph_torch.cli.main --recipe <name>``:

    v1  the original pinned recipe (hard negatives)
    v2  harder negative pressure (γ15, k100, resample every 2)
    v3  v2 + bootstrapped mutual-NN pair augmentation (CSLS-scored)
    v4  v3 with raw-distance mutual-NN matching (boot_csls_k=0)
    v5  v4 + Sinkhorn OT alignment NLL (w=3.0, τ=0.3, seed pairs)
    v6  v5 at dim 256 — the adopted recipe
    v7  v6 + attribute-prediction MTL head (w=4.0) + 900 epochs
    v7r v7 at attr_weight=0.25

v7r is the reference's robust default for real-data runs: the w=4.0 win
of v7 shows only where attributes are clean.  All eight run in the port;
v5–v7r go through ``train/mtl.py::fit_mtl``.
"""

from __future__ import annotations

RECIPES: dict[str, dict] = {
    "v1": dict(dim=128, epochs=400, lr=2e-3, gamma=10.0, k_neg=50, neg_every=5,
               neg_mode="hard"),
    "v2": dict(dim=128, epochs=600, lr=2e-3, gamma=15.0, k_neg=100, neg_every=2,
               neg_mode="hard"),
    "v3": dict(dim=128, epochs=600, lr=2e-3, gamma=15.0, k_neg=100, neg_every=2,
               neg_mode="hard", eval_csls_k=10,
               boot_cap=2500, boot_start=200, boot_weight=0.5, boot_csls_k=10),
    "v4": dict(dim=128, epochs=600, lr=2e-3, gamma=15.0, k_neg=100, neg_every=2,
               neg_mode="hard", eval_csls_k=10,
               boot_cap=2500, boot_start=200, boot_weight=0.5, boot_csls_k=0),
    "v5": dict(dim=128, epochs=600, lr=2e-3, gamma=15.0, k_neg=100, neg_every=2,
               neg_mode="hard", eval_csls_k=10,
               boot_cap=2500, boot_start=200, boot_weight=0.5, boot_csls_k=0,
               use_sinkhorn=True, sinkhorn_weight=3.0, sinkhorn_tau=0.3),
    "v6": dict(dim=256, epochs=600, lr=2e-3, gamma=15.0, k_neg=100, neg_every=2,
               neg_mode="hard", eval_csls_k=10,
               boot_cap=2500, boot_start=200, boot_weight=0.5, boot_csls_k=0,
               use_sinkhorn=True, sinkhorn_weight=3.0, sinkhorn_tau=0.3),
    "v7": dict(dim=256, epochs=900, lr=2e-3, gamma=15.0, k_neg=100, neg_every=2,
               neg_mode="hard", eval_csls_k=10,
               boot_cap=2500, boot_start=200, boot_weight=0.5, boot_csls_k=0,
               use_sinkhorn=True, sinkhorn_weight=3.0, sinkhorn_tau=0.3,
               use_attr_head=True, attr_weight=4.0),
    "v7r": dict(dim=256, epochs=900, lr=2e-3, gamma=15.0, k_neg=100, neg_every=2,
                neg_mode="hard", eval_csls_k=10,
                boot_cap=2500, boot_start=200, boot_weight=0.5, boot_csls_k=0,
                use_sinkhorn=True, sinkhorn_weight=3.0, sinkhorn_tau=0.3,
                use_attr_head=True, attr_weight=0.25),
}
