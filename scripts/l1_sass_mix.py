"""The instruction mix of the exact L1 search kernel (``csrc/l1_search.cu``).

Builds the kernel (``kernels/_build.py``), prints what ptxas reported for
each instantiation (registers, spills, stack), disassembles the library
with ``cuobjdump -sass`` and, for each kernel, finds its loops (backward
branches) and prints the one with the most FADDs, the d loop, with its
FADDs against all its instructions and the shared-memory loads among them.
The bound counts two fp32 instructions a term, so that loop's share of
FADDs caps the share of the bound the kernel can reach.

Run on a machine with the CUDA toolkit (``nvcc`` and ``cuobjdump``):

    python3 scripts/l1_sass_mix.py

It prints one JSON line.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tpugraph_torch.kernels import _build  # noqa: E402

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"BRA\s+(?:`\()?(\.L_x_\d+|0x[0-9a-f]+)")


def _functions(sass: str) -> dict[str, list[tuple[int, str]]]:
    """Each function's instructions as (address, text), branch targets
    resolved to addresses (a label is the next instruction's address)."""
    funcs: dict[str, list] = {}
    name, labels, pending = None, {}, []
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            funcs[name], labels[name], pending = [], {}, []
            continue
        if name is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTR.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[name][lab] = addr
            pending = []
            funcs[name].append((addr, m.group(2)))
    out = {}
    for fn, ins in funcs.items():
        resolved = []
        for addr, text in ins:
            t = _TARGET.search(text)
            target = None
            if t:
                tok = t.group(1)
                target = labels[fn].get(tok) if tok.startswith(".L") else int(tok, 16)
            resolved.append((addr, text, target))
        out[fn] = resolved
    return out


def _opcode(text: str) -> str:
    parts = text.split()
    if parts and parts[0].startswith("@"):
        parts = parts[1:]
    return parts[0] if parts else ""


def mix(instrs) -> dict:
    """The loop (a backward branch and its target) with the most FADDs."""
    best = None
    for addr, text, target in instrs:
        if target is None or target > addr:
            continue
        body = [t for a, t, _ in instrs if target <= a <= addr]
        ops = [_opcode(t) for t in body]
        fadd = sum(o.startswith("FADD") for o in ops)
        if best is None or fadd > best["fadd"]:
            best = {"from": hex(target), "to": hex(addr), "instructions": len(ops),
                    "fadd": fadd, "fadd_share": fadd / len(ops),
                    "lds": sum(o.startswith("LDS") for o in ops),
                    "other": sorted({o for o in ops if not o.startswith(("FADD", "LDS"))})}
    ops = [_opcode(t) for _, t, _ in instrs]
    return {"kernel_instructions": len(ops), "kernel_fadd": sum(o.startswith("FADD") for o in ops),
            "d_loop": best}


def main() -> int:
    built = _build.build("l1_search")
    cuda = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    sass = subprocess.run([str(Path(cuda) / "bin" / "cuobjdump"), "-sass", str(built.path)],
                          capture_output=True, text=True, check=True).stdout
    kernels = {fn: mix(ins) for fn, ins in _functions(sass).items() if "l1_kernel" in fn}
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "l1_kernel" in ln or "registers" in ln or "spill" in ln or "stack" in ln]
    print(json.dumps({"script": "l1_sass_mix", "library": built.path.name,
                      "build_s": built.seconds, "ptxas": ptxas, "kernels": kernels}), flush=True)
    return 0 if kernels else 1


if __name__ == "__main__":
    raise SystemExit(main())
