"""Where the fused GCN layer's fp32 error comes from, on an NVIDIA GPU.

    python scripts/mma_accuracy_probe.py

Builds ``scripts/mma_accuracy_probe.cu`` with nvcc (sm_90a) into
``tpugraph_torch/_build/``, and multiplies a real zh-en-scale aggregate
A·x (the synthetic task of ``chip_smoke.py``) by a random W at
(128, 128) and (256, 256) in each accumulation mode of the probe kernel,
with fp32 inputs and with inputs rounded to TF32 (the 3× split's small
terms are then zero, so only accumulation is left).  Prints, as JSON, each
mode's max, rms and mean error against a float64 product, beside cuBLAS
fp32 (the plain version's GEMM) and the fused layer's own error against
float64 and against the plain version.  Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tpugraph_torch.data.synthetic import synthetic_align_task  # noqa: E402
from tpugraph_torch.kernels import _build  # noqa: E402
from tpugraph_torch.kernels.gcn_fused import fused_gcn_layer  # noqa: E402
from tpugraph_torch.kernels.spmm_ell import apply_with_diag  # noqa: E402
from tpugraph_torch.sparse.build import build_adjacency  # noqa: E402

MODES = {0: "kernel_3x_one_acc", 1: "fp32_simt", 2: "3x_each_kstep_outside",
         3: "3x_big_small_separate", 4: "1x_tf32", 5: "1x_tf32_outside"}


def _probe_lib() -> ctypes.CDLL:
    so = _build.BUILD_DIR / "mma_accuracy_probe.so"
    _build.BUILD_DIR.mkdir(exist_ok=True)
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-I", str(_build.CSRC),
                    "-o", str(so), str(ROOT / "scripts" / "mma_accuracy_probe.cu")], check=True)
    lib = ctypes.CDLL(str(so))
    lib.run_probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
    return lib


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """Round fp32 to TF32 (10 mantissa bits), to nearest, ties away."""
    return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _err(got: torch.Tensor, ref: torch.Tensor) -> dict:
    e = got.double() - ref
    return {"max_abs": float(e.abs().max()), "rms": float(e.pow(2).mean().sqrt()),
            "mean": float(e.mean())}


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_accuracy_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    lib = _probe_lib()
    dev = torch.device("cuda")
    task = synthetic_align_task(seed=7, n_ent=19000, n_rel=1200, n_triples=70000,
                                n_pairs=15000, n_attr=1000, attrs_per_ent=4, name="zh_en")
    op = build_adjacency(task.n_ent, task.merged_triples, n_rel=task.n_rel).to(dev)
    rng = np.random.default_rng(0)
    out = {}
    for d_in, d_out in ((128, 128), (256, 256)):
        x = torch.from_numpy(rng.standard_normal((task.n_ent, d_in)).astype(np.float32)).to(dev)
        w = torch.from_numpy((rng.standard_normal((d_in, d_out)) / np.sqrt(d_in))
                             .astype(np.float32)).to(dev)
        agg = apply_with_diag(op.fwd, op.diag, x).contiguous()
        m = (agg.shape[0] // 16) * 16
        res = {}
        for inputs in ("fp32", "tf32_exact"):
            a = agg[:m].contiguous() if inputs == "fp32" else tf32_round(agg[:m].clone())
            b = w if inputs == "fp32" else tf32_round(w.clone())
            ref = a.double() @ b.double()
            for mode, name in MODES.items():
                c = torch.empty((m, d_out), device=dev)
                if lib.run_probe(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, d_out, d_in, mode):
                    raise RuntimeError(f"probe mode {mode} failed")
                res[f"{inputs}/{name}"] = _err(c, ref)
            res[f"{inputs}/cublas_fp32"] = _err(a @ b, ref)
            res[f"{inputs}/ref_max_abs"] = float(ref.abs().max())
        want64 = apply_with_diag(op.fwd, op.diag, x.double()) @ w.double()
        kern, plain = fused_gcn_layer(op.fwd, op.diag, x, w), agg @ w
        res["kernel_vs_f64"] = _err(kern, want64)
        res["plain_vs_f64"] = _err(plain, want64)
        res["kernel_vs_plain"] = float((kern - plain).abs().max())
        out[f"{d_in}x{d_out}"] = res
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
