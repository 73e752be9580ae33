"""The port's DBP15K and OpenEA readers against the JAX package's, on the
fixture directories of tests/test_synthetic_data.py (DBP15K ids and URI
attributes, ``sup_ent_ids``, integer attributes; OpenEA with and without
the official ``721_5fold`` split, and with the ``openea_fold`` = 0 seeded
split): every array equal.  ``load_task`` dispatches as the JAX one does,
and the CLI trains two epochs on a fixture directory on the host."""

import json

import numpy as np
import pytest

from tpugraph.configs import get_config as jax_get_config
from tpugraph.data.dbp15k import load_dbp15k as jax_load_dbp15k
from tpugraph.data.openea import load_openea as jax_load_openea
from tpugraph.train.loop import load_task as jax_load_task
from tpugraph_torch.cli.main import main as cli_main
from tpugraph_torch.configs.configs import get_config
from tpugraph_torch.data import load_dbp15k, load_openea
from tpugraph_torch.train.loop import load_task


def _write(d, files: dict) -> None:
    d.mkdir(parents=True, exist_ok=True)
    for name, text in files.items():
        (d / name).write_text(text)


def _dbp15k_ids(root):
    # KG1: global ids 0,1,2 ; KG2: global ids 10,11,12 (DBP15K ids are global)
    _write(root / "zh_en", {"ent_ids_1": "0\te_a\n1\te_b\n2\te_c\n",
                            "ent_ids_2": "10\tf_a\n11\tf_b\n12\tf_c\n",
                            "triples_1": "0\t5\t1\n1\t5\t2\n",
                            "triples_2": "10\t7\t11\n11\t8\t12\n",
                            "ref_ent_ids": "0\t10\n1\t11\n2\t12\n"})
    return dict(pair="zh_en", train_ratio=0.34, seed=0)


def _dbp15k_attrs_sup(root):
    _write(root / "ja_en", {"ent_ids_1": "0\ta\n1\tb\n", "ent_ids_2": "5\tx\n6\ty\n",
                            "triples_1": "0\t9\t1\n", "triples_2": "5\t3\t6\n",
                            "ref_ent_ids": "0\t5\n1\t6\n", "sup_ent_ids": "0\t5\n",
                            "att_triples_1": "0\t2\n1\t0\n", "att_triples_2": "5\t1\n"})
    return dict(pair="ja_en")


def _dbp15k_uri_attrs(root):
    _write(root / "fr_en", {
        "ent_ids_1": "0\thttp://fr/e_a\n1\thttp://fr/e_b\n",
        "ent_ids_2": "5\thttp://en/x\n6\thttp://en/y\n",
        "triples_1": "0\t9\t1\n", "triples_2": "5\t3\t6\n", "ref_ent_ids": "0\t5\n1\t6\n",
        "training_attrs_1": "http://fr/e_a\thttp://prop/name\thttp://prop/pop\n"
                            "http://fr/e_b\thttp://prop/name\n"
                            "http://fr/unknown\thttp://prop/name\n",  # unknown entity: skipped
        "training_attrs_2": "http://en/x\thttp://prop/name\thttp://prop/area\n"})
    return dict(pair="fr_en", max_attr=2)


def _dbp15k_generated(root, n: int = 12):
    """A larger directory in the id and URI formats at once, as
    tests/test_synthetic_data.py's AE-channel fixture writes it."""
    rng = np.random.default_rng(0)
    _write(root / "zh_en", {
        "ent_ids_1": "".join(f"{i}\tfr{i}\n" for i in range(n)),
        "ent_ids_2": "".join(f"{100 + i}\ten{i}\n" for i in range(n)),
        "triples_1": "".join(f"{rng.integers(n)}\t0\t{rng.integers(n)}\n" for _ in range(30)),
        "triples_2": "".join(f"{100 + rng.integers(n)}\t0\t{100 + rng.integers(n)}\n"
                             for _ in range(30)),
        "ref_ent_ids": "".join(f"{i}\t{100 + i}\n" for i in range(n)),
        "training_attrs_1": "".join(f"fr{i}\tp{rng.integers(4)}\tp{rng.integers(4)}\n"
                                    for i in range(n)),
        "training_attrs_2": "".join(f"en{i}\tp{rng.integers(4)}\n" for i in range(n))})
    return dict(pair="zh_en", train_ratio=0.5, seed=3)


def _openea(root):
    _write(root / "d_w", {"rel_triples_1": "A\tr1\tB\nB\tr1\tC\n",
                          "rel_triples_2": "X\ts1\tY\nY\ts2\tZ\n",
                          "ent_links": "A\tX\nB\tY\nC\tZ\n",
                          "attr_triples_1": "A\tp_name\t\"foo\"\nB\tp_name\t\"bar\"\n",
                          "attr_triples_2": "X\tp_name\t\"foo\"\nZ\tp_other\t\"1\"\n"})
    return dict(root=root / "d_w", fold=None, train_ratio=0.34, seed=0)


def _openea_folds(root):
    d = root / "d_w"
    _write(d, {"rel_triples_1": "A\tr\tB\nC\tr\tA\nD\tr\tB\n",
               "rel_triples_2": "X\ts\tY\nZ\ts\tX\nW\ts\tY\n",
               "ent_links": "A\tX\nB\tY\nC\tZ\nD\tW\nE\tV\n"})  # E, V: link-only entities
    _write(d / "721_5fold" / "1", {"train_links": "A\tX\n", "valid_links": "B\tY\n",
                                   "test_links": "C\tZ\nD\tW\nE\tV\n"})
    return dict(root=d, fold=1)


FIXTURES = {"dbp15k_ids": _dbp15k_ids, "dbp15k_attrs_sup": _dbp15k_attrs_sup,
            "dbp15k_uri_attrs": _dbp15k_uri_attrs, "dbp15k_generated": _dbp15k_generated,
            "openea": _openea, "openea_folds": _openea_folds}


def _assert_same_task(got, want):
    assert got.name == want.name and got.n_ent == want.n_ent and got.n_rel == want.n_rel
    for g, w in ((got.kg1, want.kg1), (got.kg2, want.kg2)):
        assert (g.n_ent, g.n_rel, g.n_attr) == (w.n_ent, w.n_rel, w.n_attr)
        np.testing.assert_array_equal(g.triples, w.triples)
        assert g.triples.dtype == w.triples.dtype
        if w.attr_triples is None:
            assert g.attr_triples is None
        else:
            np.testing.assert_array_equal(g.attr_triples, w.attr_triples)
    for name in ("train_pairs", "test_pairs", "merged_triples"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    if want.merged_attr_triples is not None:
        np.testing.assert_array_equal(got.merged_attr_triples, want.merged_attr_triples)


@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_reader_matches_jax(fixture, tmp_path):
    kw = FIXTURES[fixture](tmp_path)
    if fixture.startswith("dbp15k"):
        got, want = load_dbp15k(str(tmp_path), **kw), jax_load_dbp15k(str(tmp_path), **kw)
    else:
        root = str(kw.pop("root"))
        got, want = load_openea(root, **kw), jax_load_openea(root, **kw)
    _assert_same_task(got, want)
    assert len(want.test_pairs)  # a fixture that reads nothing would prove nothing


@pytest.mark.parametrize("dataset, fold", [("dbp15k", 1), ("openea", 1), ("openea", 0)])
def test_load_task_dispatches_as_jax(dataset, fold, tmp_path):
    """``dataset``, ``data_root``, ``pair``, ``openea_fold`` (0: the seeded
    split even where folds exist), ``train_ratio`` and ``seed``."""
    if dataset == "dbp15k":
        _dbp15k_generated(tmp_path)
        root = tmp_path
    else:
        root = _openea_folds(tmp_path)["root"]
    kw = dict(dataset=dataset, data_root=str(root), pair="zh_en", openea_fold=fold,
              train_ratio=0.4, seed=5)
    _assert_same_task(load_task(get_config("base", **kw)),
                      jax_load_task(jax_get_config("base", **kw)))
    with pytest.raises(ValueError, match="unknown dataset"):
        load_task(get_config("base", dataset="dwy"))


def test_cli_trains_on_a_dbp15k_directory(tmp_path, capsys):
    _dbp15k_generated(tmp_path)
    argv = ["--dataset", "dbp15k", "--data-root", str(tmp_path), "--pair", "zh_en",
            "--epochs", "2", "--device", "cpu", "--quiet",
            "--set", "dim=8", "k_neg=3", "neg_every=1", "eval_every=0", "train_ratio=0.5"]
    assert cli_main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["config"] == "base" and np.isfinite(out["final_loss"])
