"""Time each phase of the fused decoder-layer kernel on the card.

    python -m dynamo_tpu_torch.tools.fused_layer_phases [--case LABEL] [--runs N]

The card's machine has no Nsight tools, so this builds a second copy of
csrc/fused_layer.cu in which block 0 reads the global nanosecond timer at
the kernel's start, after each grid barrier and at its end, runs the layer
case (tools/cases.py, Llama-3-8B B 16 by default) through the wrapper with
that library, and prints one JSON line per run: microseconds per phase,
each phase named after the calls before its barrier (the time to the
barrier includes the wait for the slowest block), and the grid barriers the
layer passed. The kernel that serves is never touched.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from typing import Any, Dict, List

_STAMP = "if (blockIdx.x == 0 && threadIdx.x == 0) g_stamps[{i}] = stamp_ns();"
_PRELUDE = """
__device__ unsigned long long g_stamps[64];
__device__ __forceinline__ unsigned long long stamp_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
extern "C" int read_stamps(unsigned long long* out) {
  return cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
}
extern "C" int clear_stamps() {
  static const unsigned long long zeros[64] = {};
  return cudaMemcpyToSymbol(g_stamps, zeros, sizeof(zeros));
}
"""
_INCLUDE = '#include "int8_stream.cuh"'
_KERNEL = "fused_layer_kernel(FusedLayerParams p"
# a statement that calls a phase: `name(` or `name<D>(` at the start of a line
_CALL = re.compile(r"^\s+(\w+)(?:<D>)?\((\w+)", re.M)


def _label(segment: str) -> str:
    calls = [f"{n}({a})" if n == "product_phase" else n for n, a in _CALL.findall(segment)]
    return "+".join(calls) or "-"


def stamped_source(src: str):
    """The kernel source with timer reads after its start, every grid
    barrier and its end, and the phase calls before each read."""
    head_end = src.index(_KERNEL)
    body_end = src.index("\n}\n", head_end)
    head, body, tail = src[:head_end], src[head_end:body_end], src[body_end:]
    parts = body.split("grid.sync();")
    names, out = [], [parts[0]]
    for i, part in enumerate(parts[1:], start=1):
        names.append(_label(parts[i - 1]))
        out.append(f"grid.sync();\n  {_STAMP.format(i=i)}" + part)
    names.append(_label(parts[-1]))
    body = "".join(out)
    first = body.index("{") + 1
    body = body[:first] + "\n  " + _STAMP.format(i=0) + body[first:]
    end = len(parts)
    body += f"\n  grid.sync();\n  {_STAMP.format(i=end)}"
    head = head.replace(_INCLUDE, _INCLUDE + "\n" + _PRELUDE, 1)
    return head + body + tail, names


_built: Dict[str, Any] = {}


def stamped_library():
    """(library, phase names) of the stamped copy, built once a process
    (chip_smoke.py builds it beside the other sources)."""
    from dynamo_tpu_torch.ops.cuda import build
    from dynamo_tpu_torch.ops.cuda import fused_layer as kernel

    if not _built:
        src, names = stamped_source((build.CSRC / "fused_layer.cu").read_text())
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu = build.BUILD_DIR / "fused_layer_phases.cu"
        so = build.BUILD_DIR / "libfused_layer_phases.so"
        cu.write_text(src)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
                        str(so), str(cu)], check=True, capture_output=True, text=True)
        lib = kernel.bind(ctypes.CDLL(str(so)))
        lib.read_stamps.argtypes = [ctypes.c_void_p]
        _built.update(lib=lib, names=names)
    return _built["lib"], _built["names"]


def run(case_label: str = "llama3-8b B16", runs: int = 4) -> List[Dict[str, Any]]:
    """Run the case ``runs`` times through the wrapper with the stamped
    kernel and return one record a run: µs a phase, the total and the grid
    barriers passed (the timer's own closing barrier not counted)."""
    import torch

    from dynamo_tpu_torch.ops.cuda import fused_layer as kernel
    from dynamo_tpu_torch.tools.cases import make_layer_case, run_layer

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    lib, names = stamped_library()
    served = kernel._lib
    kernel._lib = lib
    kernel.grid_for.cache_clear()
    records = []
    try:
        case, call = make_layer_case(case_label, "cuda")
        for _ in range(runs):
            stamps = (ctypes.c_ulonglong * 64)()
            lib.clear_stamps()
            run_layer(kernel.fused_decoder_layer, case, call)
            torch.cuda.synchronize()
            lib.read_stamps(stamps)
            t = list(stamps)
            phases, prev, carried = {}, t[0], ""
            for i, name in enumerate(names, start=1):
                if not t[i]:  # a barrier in a branch this case does not take
                    carried += name + "+"
                    continue
                phases[carried + name] = (t[i] - prev) / 1e3
                prev, carried = t[i], ""
            barriers = sum(1 for i in range(1, len(names)) if t[i])
            records.append({"case": case_label, "us": phases, "total_us": (prev - t[0]) / 1e3,
                            "barriers": barriers, "card": torch.cuda.get_device_name(0)})
    finally:
        kernel._lib = served
        kernel.grid_for.cache_clear()
    return records


def main() -> None:
    from dynamo_tpu_torch.tools.cases import LAYER_CASES, MODEL_LAYER_CASES

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", default="llama3-8b B16",
                    choices=list(LAYER_CASES) + list(MODEL_LAYER_CASES))
    ap.add_argument("--runs", type=int, default=4)
    args = ap.parse_args()
    for record in run(args.case, args.runs):
        print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
