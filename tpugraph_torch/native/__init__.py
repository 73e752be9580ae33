"""ctypes bindings for the native (C++) graph builder (counterpart of
``tpugraph/native``).

``graphbuild.cpp`` is compiled by the host's C++ compiler at first use into
``tpugraph_torch/_build/graphbuild-<hash>.so``, keyed by a hash of the
source and flags, written to a temporary name and renamed, so a process
never loads a half-written file while another builds.  It is a host
builder: where no C++ compiler exists, ``available()`` is False and
``sparse/build.py::build_adjacency`` takes the numpy path, as the JAX
package does; a compiler that fails on the source raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "graphbuild.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lib = None


def _compiler() -> str | None:
    return os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the builder into ``build_dir`` unless a library of the same
    source and flags is there; returns its path."""
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler (set CXX or put g++ on PATH)")
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    out = Path(build_dir) / f"graphbuild-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed on {SOURCE.name}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.build_adjacency_coo
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_double, ctypes.c_int32, ctypes.c_double,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
        ]
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the native builder runs here: a C++ compiler exists (the
    first call builds and loads the library, and raises if that fails)."""
    if _lib is None and _compiler() is None:
        return False
    _load()
    return True


_WEIGHTING = {"uniform": 0, "funifun": 1}
_NORM = {"none": 0, "rw": 1, "sym": 2}


def native_coo_from_triples(
    n_ent: int,
    triples: np.ndarray,
    n_rel: int | None = None,
    weighting: str = "uniform",
    w_min: float = 0.3,
    self_loops: bool = True,
    self_loop_w: float = 1.0,
    norm: str = "none",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full native pipeline (build + normalize + (dst, src) sort): src,
    dst (int64) and w (float64)."""
    lib = _load()
    triples = np.ascontiguousarray(triples, dtype=np.int32).reshape(-1, 3)
    if n_rel is None:
        n_rel = int(triples[:, 1].max()) + 1 if len(triples) else 1
    t_ptr = triples.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    args = (t_ptr, len(triples), n_ent, max(n_rel, 1), _WEIGHTING[weighting], w_min,
            int(self_loops), self_loop_w, _NORM[norm])
    null64 = ctypes.cast(None, ctypes.POINTER(ctypes.c_int64))
    nullf = ctypes.cast(None, ctypes.POINTER(ctypes.c_double))
    total = lib.build_adjacency_coo(*args, 0, 0, null64, null64, nullf)
    if total < 0:
        raise ValueError(
            "native build_adjacency_coo rejected inputs: an entity id is "
            "outside [0, n_ent) or a relation id outside [0, n_rel) — "
            "malformed triples would corrupt the native builder's indexed "
            "accumulators, so they are rejected up front")
    src = np.empty(total, np.int64)
    dst = np.empty(total, np.int64)
    w = np.empty(total, np.float64)
    got = lib.build_adjacency_coo(
        *args, 1, total,
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if got != total:
        raise RuntimeError(f"native builder emitted {got} edges after counting {total}")
    return src, dst, w
