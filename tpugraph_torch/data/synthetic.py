"""Deterministic synthetic DBP15K-shaped alignment tasks (counterpart of
``tpugraph/data/synthetic.py``).

The same numpy draws in the same order, so a seed gives arrays identical to
the JAX package's: two noisy-isomorphic power-law KGs, correlated attribute
triples, and seed alignment pairs split train/test.
"""

from __future__ import annotations

import numpy as np

from tpugraph_torch.sparse.graph import KG, AlignTask


def _powerlaw_targets(rng: np.random.Generator, n: int, size: int, alpha: float) -> np.ndarray:
    """Sample entity ids with a Zipf-like popularity skew."""
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    p /= p.sum()
    return rng.choice(n, size=size, p=p)


def _make_kg(
    rng: np.random.Generator,
    n_ent: int,
    n_rel: int,
    n_triples: int,
    alpha: float = 0.9,
) -> np.ndarray:
    """Random KG triples with power-law head/tail popularity."""
    h = _powerlaw_targets(rng, n_ent, n_triples, alpha)
    t = _powerlaw_targets(rng, n_ent, n_triples, alpha)
    # avoid reflexive triples
    clash = h == t
    t[clash] = (t[clash] + 1 + rng.integers(0, n_ent - 1, clash.sum())) % n_ent
    r = rng.integers(0, n_rel, n_triples)
    triples = np.stack([h, r, t], axis=1).astype(np.int32)
    return np.unique(triples, axis=0)


def synthetic_align_task(
    seed: int = 0,
    n_ent: int = 2000,
    n_rel: int = 40,
    n_triples: int = 6000,
    n_pairs: int | None = None,
    train_ratio: float = 0.3,
    drop_frac: float = 0.1,
    noise_frac: float = 0.1,
    n_attr: int = 64,
    attrs_per_ent: int = 4,
    attr_noise: float = 0.1,
    attr_coverage: float = 1.0,
    alpha: float = 0.9,
    name: str | None = None,
) -> AlignTask:
    """Two noisy-isomorphic KGs + seed alignments.

    KG2 is KG1 with entities re-labelled by a random permutation, a fraction
    ``drop_frac`` of triples dropped, and ``noise_frac`` fresh random triples
    added.  Every KG1 entity i corresponds to KG2 entity perm[i]; alignment
    pairs are a sample of those correspondences, split train/test by
    ``train_ratio``.  ``attr_noise``, ``attr_coverage`` and ``alpha`` are the
    hardness knobs documented on the JAX generator.
    """
    rng = np.random.default_rng(seed)
    t1 = _make_kg(rng, n_ent, n_rel, n_triples, alpha=alpha)

    perm = rng.permutation(n_ent).astype(np.int32)
    t2 = t1.copy()
    t2[:, 0] = perm[t2[:, 0]]
    t2[:, 2] = perm[t2[:, 2]]
    keep = rng.random(len(t2)) > drop_frac
    t2 = t2[keep]
    n_noise = int(noise_frac * len(t1))
    if n_noise:
        noise = _make_kg(rng, n_ent, n_rel, n_noise, alpha=alpha)
        t2 = np.unique(np.concatenate([t2, noise], axis=0), axis=0)

    # correlated attribute triples: aligned entities share most attributes
    a_ids = rng.integers(0, n_attr, size=(n_ent, attrs_per_ent))
    ents = np.repeat(np.arange(n_ent, dtype=np.int32), attrs_per_ent)
    attr1 = np.stack([ents, a_ids.reshape(-1).astype(np.int32)], axis=1)
    a_ids2 = a_ids.copy()
    flip = rng.random(a_ids2.shape) < attr_noise
    a_ids2[flip] = rng.integers(0, n_attr, size=flip.sum())
    ents2 = perm[np.repeat(np.arange(n_ent, dtype=np.int32), attrs_per_ent)]
    attr2 = np.stack([ents2, a_ids2.reshape(-1).astype(np.int32)], axis=1)
    if attr_coverage < 1.0:
        cov1 = rng.random(n_ent) < attr_coverage  # indexed by KG1 entity id
        cov2 = rng.random(n_ent) < attr_coverage  # indexed by KG2 entity id
        attr1 = attr1[cov1[attr1[:, 0]]]
        attr2 = attr2[cov2[attr2[:, 0]]]

    kg1 = KG(n_ent=n_ent, n_rel=n_rel, triples=t1, attr_triples=attr1, n_attr=n_attr)
    kg2 = KG(n_ent=n_ent, n_rel=n_rel, triples=t2, attr_triples=attr2, n_attr=n_attr)

    if n_pairs is None:
        n_pairs = n_ent // 2
    left = rng.choice(n_ent, size=n_pairs, replace=False).astype(np.int32)
    right_global = perm[left].astype(np.int32) + n_ent  # global (merged) id
    pairs = np.stack([left, right_global], axis=1)
    rng.shuffle(pairs)
    n_train = int(train_ratio * n_pairs)

    return AlignTask(
        kg1=kg1,
        kg2=kg2,
        train_pairs=pairs[:n_train],
        test_pairs=pairs[n_train:],
        name=name or f"synthetic-{seed}-n{n_ent}",
    )
