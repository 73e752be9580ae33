"""Reader for the OpenEA / BootEA on-disk format (a numpy-only copy of
``tpugraph/data/openea.py``: the same vocabularies, fold rule, seeded split
and attribute cap, so a directory gives arrays identical to the JAX
package's).

Directory layout (the OpenEA benchmark convention, DWY100K-family releases):

    <root>/                      e.g. D_W_15K_V1/ or DWY100K/dbp_wd/
        rel_triples_1            "<head_uri>\t<rel_uri>\t<tail_uri>" per line
        rel_triples_2
        attr_triples_1           optional "<ent_uri>\t<prop_uri>\t<literal>"
        attr_triples_2
        ent_links                "<uri1>\t<uri2>" gold alignments
        721_5fold/<k>/           optional official folds:
            train_links, valid_links, test_links   (URI pairs)

Unlike the JAPE/DBP15K release (integer ids on disk — data/dbp15k.py), this
format is URI-based: entity and relation vocabularies are built here.  The
attribute channel follows the GCN-Align convention: the attribute *property*
URI is the token, the shared vocab keeps the ``max_attr`` most frequent
properties over both KGs.
"""

from __future__ import annotations

import os

import numpy as np

from tpugraph_torch.sparse.graph import KG, AlignTask


def _read_uri_triples(path: str) -> list[tuple[str, str, str]]:
    out = []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\r\n").split("\t")
            if len(parts) >= 3 and parts[0]:
                out.append((parts[0], parts[1], parts[2]))
    return out


def _read_uri_pairs(path: str) -> list[tuple[str, str]]:
    out = []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\r\n").split("\t")
            if len(parts) >= 2 and parts[0]:
                out.append((parts[0], parts[1]))
    return out


def _index(uris) -> dict[str, int]:
    """Stable first-seen indexing of an iterable of URIs."""
    out: dict[str, int] = {}
    for u in uris:
        if u not in out:
            out[u] = len(out)
    return out


def _to_triple_arr(triples, ent2id, rel2id) -> np.ndarray:
    if not triples:
        return np.zeros((0, 3), np.int32)
    return np.asarray([(ent2id[h], rel2id[r], ent2id[t]) for h, r, t in triples],
                      np.int32)


def load_openea(root: str, fold: int | None = 1, train_ratio: float = 0.3,
                seed: int = 0, max_attr: int = 1000) -> AlignTask:
    """Load an OpenEA-format KG pair into an AlignTask.

    ``fold``: use the official ``721_5fold/<fold>/`` split when present
    (train = train_links + valid_links, test = test_links — the convention
    when no model selection runs on valid); ``fold=None`` or a missing fold
    directory falls back to a seeded ``train_ratio`` split of ``ent_links``.
    """
    tri1 = _read_uri_triples(os.path.join(root, "rel_triples_1"))
    tri2 = _read_uri_triples(os.path.join(root, "rel_triples_2"))
    links = _read_uri_pairs(os.path.join(root, "ent_links"))

    # entity vocab per KG: triples first, then link-only entities (isolated
    # nodes still need embedding rows)
    ent1 = _index([u for h, _, t in tri1 for u in (h, t)]
                  + [a for a, _ in links])
    ent2 = _index([u for h, _, t in tri2 for u in (h, t)]
                  + [b for _, b in links])
    rel1 = _index(r for _, r, _ in tri1)
    rel2 = _index(r for _, r, _ in tri2)
    n1 = len(ent1)

    t1 = _to_triple_arr(tri1, ent1, rel1)
    t2 = _to_triple_arr(tri2, ent2, rel2)

    def _pairs_arr(uri_pairs) -> np.ndarray:
        rows = [(ent1[a], ent2[b] + n1) for a, b in uri_pairs
                if a in ent1 and b in ent2]
        return np.asarray(rows, np.int32).reshape(-1, 2)

    fold_dir = None if fold is None else os.path.join(root, "721_5fold", str(fold))
    if fold_dir and os.path.isdir(fold_dir):
        train = _read_uri_pairs(os.path.join(fold_dir, "train_links"))
        vpath = os.path.join(fold_dir, "valid_links")
        if os.path.exists(vpath):
            train = train + _read_uri_pairs(vpath)
        test = _read_uri_pairs(os.path.join(fold_dir, "test_links"))
        train_pairs, test_pairs = _pairs_arr(train), _pairs_arr(test)
    else:
        pairs = _pairs_arr(links)
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(pairs))
        n_train = int(train_ratio * len(pairs))
        train_pairs = pairs[order[:n_train]]
        test_pairs = pairs[order[n_train:]]

    # attribute channel: property-URI tokens, shared top-max_attr vocab
    attr1 = attr2 = None
    n_attr = 0
    ap1, ap2 = (os.path.join(root, f"attr_triples_{i}") for i in (1, 2))
    if os.path.exists(ap1) and os.path.exists(ap2):
        at1 = [(e, p) for e, p, _ in _read_uri_triples(ap1) if e in ent1]
        at2 = [(e, p) for e, p, _ in _read_uri_triples(ap2) if e in ent2]
        from collections import Counter

        freq = Counter(p for _, p in at1)
        freq.update(p for _, p in at2)
        vocab = {p: i for i, (p, _) in enumerate(
            sorted(freq.items(), key=lambda kv: (-kv[1], kv[0]))[:max_attr])}
        n_attr = len(vocab)

        def _to_arr(ps, ent2id):
            rows = [(ent2id[e], vocab[p]) for e, p in ps if p in vocab]
            return np.asarray(rows, np.int32).reshape(-1, 2)

        attr1, attr2 = _to_arr(at1, ent1), _to_arr(at2, ent2)

    kg1 = KG(n_ent=n1, n_rel=len(rel1), triples=t1, attr_triples=attr1, n_attr=n_attr)
    kg2 = KG(n_ent=len(ent2), n_rel=len(rel2), triples=t2, attr_triples=attr2,
             n_attr=n_attr)
    return AlignTask(kg1=kg1, kg2=kg2, train_pairs=train_pairs,
                     test_pairs=test_pairs, name=os.path.basename(root.rstrip("/")))
