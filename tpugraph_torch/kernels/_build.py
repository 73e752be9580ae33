"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled by nvcc
for ``sm_90a`` into ``tpugraph_torch/_build/<name>-<hash>.so``, keyed by a
hash of the sources and flags, so a checkout builds its kernels on its
first call and reuses them afterwards.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


@dataclass
class Built:
    path: Path
    seconds: float  # nvcc wall time; 0.0 when the library was already built
    log: str  # nvcc/ptxas output (registers, shared memory, spills) of its build


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def build(name: str, src: Path | None = None) -> Built:
    """Compile ``csrc/<name>.cu`` (or ``src``, another version of it that
    includes the same headers) unless a library of the same sources exists."""
    src = CSRC / f"{name}.cu" if src is None else Path(src)
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"
    log = out.with_suffix(".log")
    if out.exists():
        return Built(out, 0.0, log.read_text() if log.exists() else "")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stdout}\n{proc.stderr}")
    seconds = time.perf_counter() - t0
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return Built(out, seconds, proc.stdout + proc.stderr)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name).path))
        _LIBS[name] = lib
    return lib
