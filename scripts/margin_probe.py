"""The L1 margin kernel on one CUDA card, beside the previous kernel and beside
copies of its own source changed as ``VARIANTS`` says.

    python3 scripts/margin_probe.py [--parent DIR] [--variants NAME,...]
                                    [--shapes NAME,...] [--sass] [--split]

DIR holds the previous design's ``margin_l1.cu`` (``git show
461a30d:tpugraph_torch/csrc/margin_l1.cu``).  At each shape of
``chip_smoke.MARGIN_SHAPES`` (default v6 and v7r), with the hinges as
drawn and with every hinge active (γ 1e4), it prints one JSON line: the
active records; the forward alone and the forward + backward (the index
built beforehand, as the batch carries it) by CUDA events, of the
checkout's kernel, of each variant and of the previous kernel, in turns; the
gather-only entry and the index build; the checkout's loss and gradient
against the previous kernel's, bit for bit.  A variant whose planes' format differs is
timed in its forward only.  ``--sass``: each version's d = 256 forward
and backward instructions by opcode (``cuobjdump -sass``).  ``--split``:
the checkout's backward's device time by kernel (``torch.profiler``).
The card's name and power limit stand in every line.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tpugraph_torch.kernels import _build, margin_l1  # noqa: E402

_PUT_BITS = """  uint32_t m = 0;
#pragma unroll
  for (int t = 0; t < kPer; ++t) {
    const bool gt = p.v[t] > n.v[t], lt = p.v[t] < n.v[t];
    m |= (static_cast<uint32_t>(gt) << t) | (static_cast<uint32_t>(lt) << (kPer + t));
    sum[t] += gt - lt;
  }
  reinterpret_cast<typename Signs<D>::Bits*>(rec)[lane] =
      static_cast<typename Signs<D>::Bits>(m);"""
_PUT_BALLOTS = """  // a ballot a slot ("e > n" words, then "e < n" words), stored by lane 0
#pragma unroll
  for (int c = 0; c < (2 * kPer + 3) / 4; ++c) {
    uint32_t q[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int j = 4 * c + h, t = j % kPer;
      if (j < 2 * kPer) q[h] = __ballot_sync(kFull, j < kPer ? p.v[t] > n.v[t] : p.v[t] < n.v[t]);
    }
    if (lane == 0) reinterpret_cast<uint4*>(rec)[c] = make_uint4(q[0], q[1], q[2], q[3]);
  }
#pragma unroll
  for (int t = 0; t < kPer; ++t) sum[t] += (p.v[t] > n.v[t]) - (p.v[t] < n.v[t]);"""
_PLANE_CALLS = """        if (act_r) put_signs(a, xr, planes + e * Signs<D>::kBytes, lane, sum_r);
        if (act_l) put_signs(b, yl, planes + (sk + e) * Signs<D>::kBytes, lane, sum_l);"""
_COMBINE_BATCH = ("constexpr int kBatch = D <= 128 ? 16 : D == 256 ? 8 : 4;  "
                  "// deeper costs every row registers")
# name -> ((old, new) replacements of csrc/margin_l1.cu's text, whether its
# planes keep the checkout's format)
VARIANTS = {
    "ballot": ([(_PUT_BITS, _PUT_BALLOTS)], False),  # the planes by __ballot_sync
    "no_planes": ([(_PLANE_CALLS, "")], False),  # neither planes nor sums: the forward's floor
    "serial_combine": ([(_COMBINE_BATCH, "constexpr int kBatch = 1;")], True),
}


def _variant(name: str, out_dir: Path) -> tuple[ctypes.CDLL, bool, str]:
    edits, same_format = VARIANTS[name]
    text = (_build.CSRC / "margin_l1.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: its edit does not match margin_l1.cu once")
        text = text.replace(old, new)
    src = out_dir / f"margin_l1_{name}.cu"
    src.write_text(text)
    built = _build.build(f"margin_l1_{name}", src)
    return ctypes.CDLL(str(built.path)), same_format, str(built.path)


def _sass(path: str) -> dict:
    """The d = 256 forward's and backward's SASS instructions by opcode."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for kernel in ("margin_l1_kernel_fwdILi256", "margin_l1_kernel_bwdILi256"):
        m = re.search(rf"Function : \S*{kernel}\S*\n(.*?)(?=\n\s*Function : |\Z)", sass, re.S)
        ops = {}
        for ln in (m.group(1).splitlines() if m else []):
            op = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", ln)
            if op:
                ops[op.group(1)] = ops.get(op.group(1), 0) + 1
        out[kernel] = {"total": sum(ops.values()),
                       "top": dict(sorted(ops.items(), key=lambda kv: -kv[1])[:12])}
    return out


def _use(lib: ctypes.CDLL) -> None:
    """Route ``margin_l1``'s wrapper to ``lib`` (the same C entries)."""
    _build._LIBS["margin_l1"] = lib


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="a directory holding the previous margin_l1.cu")
    ap.add_argument("--variants", default="", help=f"comma-separated, of {sorted(VARIANTS)}")
    ap.add_argument("--shapes", default="v6_zh_en,v7r_dwy100k_dist")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--split", action="store_true")
    args = ap.parse_args(argv)
    smi = cs.phase_device()
    dev = torch.device("cuda")
    this_lib = _build.load("margin_l1")
    libs, paths = {"this": (this_lib, True)}, {"this": str(_build.build("margin_l1").path)}
    out_dir = _build.BUILD_DIR / "margin_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    for name in filter(None, args.variants.split(",")):
        lib, same, path = _variant(name, out_dir)
        libs[name], paths[name] = (lib, same), path
    if args.sass:
        cs.emit({"sass": {name: _sass(path) for name, path in paths.items()}, "card": smi})
    parent = cs._parent_margin(args.parent) if args.parent else None
    shapes = {c[0]: c for c in cs.MARGIN_SHAPES}
    for shape in args.shapes.split(","):
        name, n, s, k, d, gamma, weighted = shapes[shape]
        emb, pairs, neg_l, neg_r, w = cs._margin_inputs(n, s, k, d, gamma, weighted, dev)
        index = margin_l1.build_index(pairs, neg_l, neg_r, n)
        for g in (gamma, 1e4):
            e = emb.clone().requires_grad_(True)

            def full(lib, loss_fn=None):
                def call():
                    if lib is not None:
                        _use(lib)
                    loss = (loss_fn or (lambda *a: margin_l1.margin_l1_loss(*a, index=index)))(
                        e, pairs, neg_l, neg_r, g, w)
                    return loss.detach(), torch.autograd.grad(loss, e)[0]
                return call

            def forward(lib, loss_fn=None):
                def call():
                    if lib is not None:
                        _use(lib)
                    with torch.no_grad():
                        return (loss_fn or margin_l1.margin_l1_loss)(e, pairs, neg_l, neg_r, g, w)
                return call

            calls = {}
            for v, (lib, same) in libs.items():
                calls[f"{v}_forward"] = forward(lib)
                if same:
                    calls[v] = full(lib)
            if parent is not None:
                calls["previous_forward"] = forward(None, parent["loss"])
                calls["previous"] = full(None, parent["loss"])
            readings = {c: [] for c in calls}
            order = list(calls)
            for rnd in range(2):  # in turns: in order, then in reverse order
                for c in (order if rnd % 2 == 0 else order[::-1]):
                    readings[c].append(cs.time_ms(calls[c], 3, 20))
            _use(this_lib)
            flags = margin_l1._forward_cuda(emb, pairs, neg_l, neg_r, g, w)[1]
            line = {"shape": name, "gamma": g,
                    "active_records": int((flags & 1).bool().sum() + (flags & 2).bool().sum()),
                    "records": 2 * s * k,
                    "ms": {c: float(np.mean(v)) for c, v in readings.items()},
                    "gather_ms": cs.time_ms(lambda: margin_l1.gather_rows_sum(emb, neg_l, neg_r)),
                    "index_ms": cs.time_ms(lambda: margin_l1.build_index(pairs, neg_l, neg_r, n)),
                    "card": smi}
            if parent is not None:
                got, old = full(this_lib)(), full(None, parent["loss"])()
                line["bitwise_previous"] = (torch.equal(got[0], old[0])
                                            and torch.equal(got[1], old[1]))
            if args.split:
                _use(this_lib)
                loss, fl, denom, planes, vecs = margin_l1._forward_cuda(emb, pairs, neg_l, neg_r,
                                                                         g, w)
                grad = torch.ones((), device=dev)

                def backward():
                    return margin_l1._backward_cuda(w, fl, denom, planes, vecs, index, grad, n)
                backward()
                torch.cuda.synchronize()
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        backward()
                    torch.cuda.synchronize()
                split = {}
                for ev in prof.events():
                    if ev.device_type == torch.autograd.DeviceType.CUDA:
                        key = (re.findall(r"margin_\w+", ev.name) or [ev.name])[0]
                        split[key] = split.get(key, 0.0) + ev.time_range.elapsed_us() / 10 / 1e3
                line["backward_device_ms_by_kernel"] = split
            cs.emit(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
