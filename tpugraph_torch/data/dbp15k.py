"""Reader for the DBP15K / JAPE on-disk format (a numpy-only copy of
``tpugraph/data/dbp15k.py``: the same files, the same id remapping, seeded
split and attribute vocabulary, so a directory gives arrays identical to
the JAX package's).

Directory layout:

    <root>/<pair>/             e.g. zh_en/
        ent_ids_1, ent_ids_2   "<id>\t<uri>" per line
        rel_ids_1, rel_ids_2   "<id>\t<uri>" per line (optional)
        triples_1, triples_2   "<head>\t<rel>\t<tail>" integer ids per line
        ref_ent_ids            "<id1>\t<id2>" seed alignments (ILLs)
        sup_ent_ids            optional extra training alignments
        att_triples_{1,2}      optional "<ent>\t<attr>" integer ids
        training_attrs_{1,2}   optional JAPE-release URI format:
                               "<ent_uri>\t<attr_uri>\t<attr_uri>…" — parsed
                               GCN-Align-style (top-K most frequent attribute
                               URIs over both KGs become the attribute vocab)

DBP15K's released ids are *global* across both KGs (KG1 and KG2 ids share
one namespace); this reader remaps them to the merged-id convention of
``AlignTask`` (kg2 local ids offset by kg1.n_ent).
"""

from __future__ import annotations

import os

import numpy as np

from tpugraph_torch.sparse.graph import KG, AlignTask


def _read_tsv_ints(path: str, ncols: int) -> np.ndarray:
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\r\n").split("\t")
            if len(parts) < ncols:
                continue
            rows.append([int(p) for p in parts[:ncols]])
    if not rows:
        return np.zeros((0, ncols), dtype=np.int64)
    return np.asarray(rows, dtype=np.int64)


def _read_ids(path: str) -> np.ndarray:
    """Read the id column of an ids file ('<id>\\t<uri>')."""
    ids = []
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\r\n").split("\t")
            if parts and parts[0]:
                ids.append(int(parts[0]))
    return np.asarray(sorted(ids), dtype=np.int64)


def _read_uri_map(path: str) -> dict[str, int]:
    """'<id>\\t<uri>' → {uri: global id}."""
    out = {}
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\r\n").split("\t")
            if len(parts) >= 2 and parts[0]:
                out[parts[1]] = int(parts[0])
    return out


def _read_training_attrs(path: str, uri2id: dict[str, int]) -> list[tuple[int, str]]:
    """JAPE 'training_attrs' line = entity URI then its attribute URIs.
    Returns (global entity id, attr uri) pairs for known entities."""
    out = []
    with open(path) as f:
        for line in f:
            parts = [p for p in line.rstrip("\r\n").split("\t") if p]
            if len(parts) < 2:
                continue
            eid = uri2id.get(parts[0])
            if eid is None:
                continue
            out.extend((eid, a) for a in parts[1:])
    return out


def load_dbp15k(root: str, pair: str = "zh_en", train_ratio: float = 0.3, seed: int = 0,
                max_attr: int = 1000) -> AlignTask:
    """Load a DBP15K language pair into an AlignTask.

    ``max_attr``: attribute-vocabulary cap for the URI-format attribute files
    (GCN-Align keeps the 1000 most frequent attributes; ties broken by URI)."""
    d = os.path.join(root, pair)
    ids1 = _read_ids(os.path.join(d, "ent_ids_1"))
    ids2 = _read_ids(os.path.join(d, "ent_ids_2"))
    tri1 = _read_tsv_ints(os.path.join(d, "triples_1"), 3)
    tri2 = _read_tsv_ints(os.path.join(d, "triples_2"), 3)
    ref = _read_tsv_ints(os.path.join(d, "ref_ent_ids"), 2)

    # remap global ids → local contiguous per-KG ids
    remap1 = {int(g): i for i, g in enumerate(ids1)}
    remap2 = {int(g): i for i, g in enumerate(ids2)}
    n1, n2 = len(ids1), len(ids2)

    def _remap_col(vals, remap, what: str):
        """Vector remap that names the file and the id it cannot find."""
        try:
            return [remap[int(v)] for v in vals]
        except KeyError as e:
            raise ValueError(
                f"{what} references entity id {e.args[0]} that is absent "
                f"from the corresponding ent_ids_* file under {d!r} — "
                f"malformed or truncated release?") from None

    def _map_triples(tri, remap, what):
        out = tri.copy()
        out[:, 0] = _remap_col(tri[:, 0], remap, what)
        out[:, 2] = _remap_col(tri[:, 2], remap, what)
        return out

    tri1 = _map_triples(tri1, remap1, "triples_1")
    tri2 = _map_triples(tri2, remap2, "triples_2")
    # relations: re-index per KG to contiguous
    r1_uniq, r1_inv = np.unique(tri1[:, 1], return_inverse=True)
    r2_uniq, r2_inv = np.unique(tri2[:, 1], return_inverse=True)
    tri1[:, 1] = r1_inv
    tri2[:, 1] = r2_inv

    pairs = ref.copy()
    pairs[:, 0] = _remap_col(ref[:, 0], remap1, "ref_ent_ids col 1")
    pairs[:, 1] = np.asarray(_remap_col(ref[:, 1], remap2, "ref_ent_ids col 2")) + n1

    sup_path = os.path.join(d, "sup_ent_ids")
    sup = None
    if os.path.exists(sup_path):
        sup = _read_tsv_ints(sup_path, 2)
        sup[:, 0] = _remap_col(sup[:, 0], remap1, "sup_ent_ids col 1")
        sup[:, 1] = np.asarray(_remap_col(sup[:, 1], remap2, "sup_ent_ids col 2")) + n1

    attr1 = attr2 = None
    n_attr = 0
    ap1 = os.path.join(d, "att_triples_1")
    ap2 = os.path.join(d, "att_triples_2")
    tp1 = os.path.join(d, "training_attrs_1")
    tp2 = os.path.join(d, "training_attrs_2")
    if os.path.exists(ap1) and os.path.exists(ap2):
        a1 = _read_tsv_ints(ap1, 2)
        a2 = _read_tsv_ints(ap2, 2)
        a1[:, 0] = _remap_col(a1[:, 0], remap1, "att_triples_1")
        a2[:, 0] = _remap_col(a2[:, 0], remap2, "att_triples_2")
        n_attr = int(max(a1[:, 1].max(initial=0), a2[:, 1].max(initial=0))) + 1
        attr1, attr2 = a1.astype(np.int32), a2.astype(np.int32)
    elif os.path.exists(tp1) and os.path.exists(tp2):
        # JAPE URI format: shared attribute vocab = top max_attr by frequency
        # over BOTH KGs (GCN-Align convention)
        uri1 = _read_uri_map(os.path.join(d, "ent_ids_1"))
        uri2 = _read_uri_map(os.path.join(d, "ent_ids_2"))
        pairs1 = _read_training_attrs(tp1, uri1)
        pairs2 = _read_training_attrs(tp2, uri2)
        from collections import Counter

        freq = Counter(a for _, a in pairs1)
        freq.update(a for _, a in pairs2)
        vocab = {a: i for i, (a, _) in enumerate(
            sorted(freq.items(), key=lambda kv: (-kv[1], kv[0]))[:max_attr])}
        n_attr = len(vocab)

        def _to_arr(ps, remap):
            rows = [(remap[g], vocab[a]) for g, a in ps if a in vocab and g in remap]
            if not rows:
                return np.zeros((0, 2), np.int32)
            return np.asarray(rows, np.int32)

        attr1 = _to_arr(pairs1, remap1)
        attr2 = _to_arr(pairs2, remap2)

    kg1 = KG(n_ent=n1, n_rel=len(r1_uniq), triples=tri1, attr_triples=attr1, n_attr=n_attr)
    kg2 = KG(n_ent=n2, n_rel=len(r2_uniq), triples=tri2, attr_triples=attr2, n_attr=n_attr)

    if sup is not None:
        # On-disk split takes precedence (train_ratio/seed unused).  Some
        # releases ship sup_ent_ids as a SUBSET of ref_ent_ids rather than
        # disjoint extra alignments — keeping the full ref as the test set
        # would then leak every training pair into eval; evaluate on
        # ref \ sup.
        sup_keys = set(map(tuple, sup.tolist()))
        keep = np.asarray([tuple(r) not in sup_keys for r in pairs.tolist()])
        train_pairs, test_pairs = sup, pairs[keep]
    else:
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(pairs))
        n_train = int(train_ratio * len(pairs))
        train_pairs = pairs[order[:n_train]]
        test_pairs = pairs[order[n_train:]]

    return AlignTask(kg1=kg1, kg2=kg2, train_pairs=train_pairs, test_pairs=test_pairs, name=pair)
