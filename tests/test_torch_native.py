"""The port's native graph builder (``tpugraph_torch/native``) against its
numpy builder and the JAX package's native builder, on the CPU: every
weighting, normalisation and self-loop case of tests/test_native_build.py,
empty and reflexive graphs, the out-of-range rejection, the
``build_adjacency`` route, and two processes building into one directory
at once.  The weights sum in another order than numpy's, so they agree to
1e-12 relative; the ids exactly."""

import os
import subprocess
import sys

import numpy as np
import pytest

from tpugraph import native as jax_native
from tpugraph_torch import native
from tpugraph_torch.sparse.build import build_adjacency, coo_from_triples, coo_normalize


@pytest.fixture(autouse=True)
def compiler():
    if native._compiler() is None:
        pytest.skip("no C++ compiler")


def _rand_triples(rng, n_ent, n_rel, n):
    return np.stack([rng.integers(0, n_ent, n), rng.integers(0, n_rel, n),
                     rng.integers(0, n_ent, n)], axis=1).astype(np.int32)


@pytest.mark.parametrize("weighting", ["uniform", "funifun"])
@pytest.mark.parametrize("norm", ["none", "rw", "sym"])
@pytest.mark.parametrize("self_loops", [True, False])
def test_native_equals_numpy_and_the_jax_native(weighting, norm, self_loops):
    rng = np.random.default_rng(0)
    n = 80
    tri = _rand_triples(rng, n, 7, 300)
    s1, d1, w1 = coo_from_triples(n, tri, n_rel=7, weighting=weighting, self_loops=self_loops)
    w1 = coo_normalize(s1, d1, w1, n, norm=norm)
    kw = dict(n_rel=7, weighting=weighting, self_loops=self_loops, norm=norm)
    s2, d2, w2 = native.native_coo_from_triples(n, tri, **kw)
    order = np.lexsort((s1, d1))  # the native output is (dst, src)-sorted
    np.testing.assert_array_equal(s1[order], s2)
    np.testing.assert_array_equal(d1[order], d2)
    np.testing.assert_allclose(w1[order], w2, rtol=1e-12, atol=1e-15)
    if jax_native.available():
        for got, want in zip((s2, d2, w2), jax_native.native_coo_from_triples(n, tri, **kw)):
            np.testing.assert_array_equal(got, want)


def test_native_empty_and_reflexive():
    s, d, w = native.native_coo_from_triples(5, np.zeros((0, 3), np.int32), n_rel=1)
    np.testing.assert_array_equal(s, np.arange(5))  # the self-loops alone
    np.testing.assert_array_equal(d, np.arange(5))
    s, d, w = native.native_coo_from_triples(5, np.array([[2, 0, 2]], np.int32), n_rel=1)
    assert len(s) == 5  # a reflexive triple adds nothing beyond the self-loops
    s, d, w = native.native_coo_from_triples(5, np.array([[2, 0, 2]], np.int32), n_rel=1,
                                             self_loops=False)
    assert len(s) == 0


@pytest.mark.parametrize("weighting", ["uniform", "funifun"])
def test_native_rejects_out_of_range_ids(weighting):
    for bad in (np.array([[0, 0, 5], [1, 0, 2]], np.int32), np.array([[-1, 0, 2]], np.int32)):
        with pytest.raises(ValueError, match="entity id"):
            native.native_coo_from_triples(4, bad, n_rel=1, weighting=weighting)
    if weighting == "funifun":
        with pytest.raises(ValueError, match="relation id"):
            native.native_coo_from_triples(4, np.array([[0, 3, 1]], np.int32), n_rel=2,
                                           weighting=weighting)


@pytest.mark.parametrize("fmt", ["ell", "sorted"])
def test_build_adjacency_takes_the_native_builder(fmt, monkeypatch):
    """use_native=True calls the native builder, and its operator equals
    the numpy path's (weights to fp32)."""
    rng = np.random.default_rng(1)
    tri = _rand_triples(rng, 60, 4, 240)
    calls = []
    real = native.native_coo_from_triples
    monkeypatch.setattr(native, "native_coo_from_triples",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    kw = dict(n_rel=4, weighting="funifun", norm="sym", fmt=fmt, bucket=128)
    got = build_adjacency(60, tri, **kw)
    want = build_adjacency(60, tri, use_native=False, **kw)
    assert calls == [1]
    if fmt == "sorted":
        for a, b in ((got.fwd, want.fwd), (got.bwd, want.bwd)):
            assert a.src.tolist() == b.src.tolist() and a.dst.tolist() == b.dst.tolist()
            np.testing.assert_allclose(a.w.numpy(), b.w.numpy(), rtol=1e-6)
    else:
        np.testing.assert_allclose(got.diag.numpy(), want.diag.numpy(), rtol=1e-6)
        for a, b in zip(got.fwd.buckets, want.fwd.buckets):
            assert a.idx.tolist() == b.idx.tolist()
            np.testing.assert_allclose(a.w.numpy(), b.w.numpy(), rtol=1e-6)


_CHILD = """
import sys
from pathlib import Path
import numpy as np
from tpugraph_torch import native
path = native.build(Path(sys.argv[1]))
import ctypes
ctypes.CDLL(str(path)).build_adjacency_coo  # a whole library: its symbol resolves
print(path)
"""


def test_two_processes_build_at_once(tmp_path):
    """Two processes building into one empty directory each load a whole
    library: a build writes a temporary name and renames it."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(native.__file__))),
         os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    paths = {o[0].strip() for o in outs}
    assert len(paths) == 1
    assert [p.name for p in tmp_path.iterdir()] == [os.path.basename(paths.pop())]
