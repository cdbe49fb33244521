"""What paces the int8 weight-streaming product on the card.

    python -m dynamo_tpu_torch.tools.int8_stream_probe [out.jsonl]

Card only. Each line (JSON, on stdout and in ``out.jsonl`` when given)
times one variant at one weight shape of a Llama-3-8B or a Gemma-3-1B
layer, with a warm L2 (the same weight on every call) and a cold one (the
calls rotate through copies of the weight that together exceed 100 MB,
twice the H100's 50 MB L2):

  * ``copy SEG``: tools/int8_stream_probe.cu's stream_copy, which only
    reads the codes, in 64-, 128- or 256-byte row segments, each block the
    same 64 KB; the card's streaming rate at that segment width.
  * ``old``: the 64-column kernel csrc/int8_matmul.cu replaced (kept in the
    probe's source), at its own launch plan and at one split.
  * ``new``: the wide-tile kernel (ops/cuda/int8_matmul.py) at its plan, at
    one split where x fits, and at every other split count that fits: the
    numbers that set the plan's cost model (``START_US``,
    ``SM_BYTES_PER_US``, ``TAIL_US``).
  * ``library``: torch.matmul over the bf16-dequantised weight.
  * ``host_ms_per_call``: the host's time to queue one call of the
    wrapper (same x, or a new x every call) and of torch.matmul.
  * ``lone_block``: one block of the kernel alone (M 32, N 128, one
    split) at 1 and 9 chunks, and one block of the copy kernel over 590 KB:
    what one SM does by itself.

Times are CUDA events over queued calls (tools/timing.queued_ms); every
line names the card and its power limit.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from dynamo_tpu_torch.ops.cuda import build
from dynamo_tpu_torch.ops.cuda import int8_matmul as mk
from dynamo_tpu_torch.tools.cases import GEMMA3_MATMUL_SHAPES, MATMUL_SHAPES, matmul_case
from dynamo_tpu_torch.tools.timing import queued_ms

COLD_BYTES = 100 * 2**20
ITERS = 50
# (label, M): the shapes timed; q/o also at M 64 (prof_8b's rows).
CASES = [(label, 32) for label in MATMUL_SHAPES] + [("q/o 4096x4096", 64)] + [
    (label, 32) for label in GEMMA3_MATMUL_SHAPES]

_P = ctypes.c_void_p
_I = ctypes.c_int


def _old_plan(M: int, K: int, N: int, slots: int):
    """(splits, split_k) of the 64-column kernel on a card that holds
    ``slots`` of its blocks at once, as its wrapper chose them: whole
    128-deep chunks a split, none empty, the fewest chunk-steps on the
    critical path (waves x (chunks a block + its partial-sum write) + the
    tile's last block's adds), the fewest splits on a tie."""
    chunks = -(-K // 128)
    tiles = -(-N // 64) * -(-M // 64)
    partial = min(M, 64) / 32  # a block's partial sums, in chunks of codes
    best = None
    for want in range(1, min(chunks, 64) + 1):
        per = -(-chunks // want)
        splits = -(-chunks // per)
        waves = -(-tiles * splits // slots)
        steps = waves * (per + partial) + splits * partial if splits > 1 else waves * per
        if best is None or steps < best[0]:
            best = (steps, splits, per * 128)
    return best[1], best[2]


def _library() -> ctypes.CDLL:
    lib = build.build("int8_stream_probe", Path(__file__).resolve().parent).lib
    lib.stream_copy.argtypes = [_P, _P] + [_I] * 4 + [_P]
    lib.stream_copy.restype = _I
    lib.old_int8_matmul.argtypes = [_P] * 6 + [_I] * 5 + [_P]
    lib.old_int8_matmul.restype = _I
    lib.old_int8_matmul_blocks_per_sm.argtypes = [_I, _I, ctypes.POINTER(_I)]
    lib.old_int8_matmul_blocks_per_sm.restype = _I
    return lib


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _rotating(fns: List) -> Any:
    state = {"i": 0}

    def call():
        state["i"] = (state["i"] + 1) % len(fns)
        return fns[state["i"]]()

    return call


def run(out_path: Optional[str] = None) -> List[Dict[str, Any]]:
    if not torch.cuda.is_available():
        raise RuntimeError("int8_stream_probe runs on a CUDA card only")
    lib = _library()
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smi = _smi()
    lines: List[Dict[str, Any]] = []
    sink = open(out_path, "w") if out_path else None

    def emit(obj):
        obj["card"] = smi
        lines.append(obj)
        text = json.dumps(obj)
        print(text, flush=True)
        if sink:
            sink.write(text + "\n")

    def old_call(c, splits, split_k):
        M, K = c["x"].shape
        N = c["q8"].shape[1]
        out = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
        part = torch.empty(max(splits, 1) * M * N, dtype=torch.float32, device=dev)
        counters = torch.zeros(4096, dtype=torch.int32, device=dev)

        def call():
            rc = lib.old_int8_matmul(c["x"].data_ptr(), c["q8"].data_ptr(), c["s"].data_ptr(),
                                     out.data_ptr(), part.data_ptr(), counters.data_ptr(),
                                     M, K, N, splits, split_k, stream())
            if rc:
                raise RuntimeError(f"old_int8_matmul: cudaError {rc}")
            return out

        return call

    capacity = mk._capacity_for(0)
    emit({"probe": "capacity", "sms": sms,
          "clusters": {f"{s} splits, {b} an SM": n for (s, b), n in capacity.items()}})
    for label, M in CASES:
        K, N, _ = {**MATMUL_SHAPES, **GEMMA3_MATMUL_SHAPES}[label]
        copies = max(2, -(-COLD_BYTES // (K * N)) + 1)
        cs = [matmul_case(M, K, N, device=dev, seed=i) for i in range(copies)]
        variants = {}
        splits, _ = mk.plan(M, K, N, sms, capacity)
        variants[f"new (plan: splits {splits})"] = [
            lambda c=c: mk.int8_matmul(c["x"], c["q8"], c["s"]) for c in cs]
        chunks = -(-K // mk.CHUNK_K)
        for split_k in sorted({-(-chunks // n) * mk.CHUNK_K for n in range(1, mk.MAX_SPLITS + 1)}):
            variants[f"new splits {-(-K // split_k)}"] = [
                lambda c=c, sk=split_k: mk.int8_matmul(c["x"], c["q8"], c["s"], split_k=sk)
                for c in cs]
        blocks = ctypes.c_int(0)
        lib.old_int8_matmul_blocks_per_sm(M, 1, ctypes.byref(blocks))
        old_plan = _old_plan(M, K, N, sms * blocks.value)
        variants[f"old splits {old_plan[0]} (its plan)"] = [old_call(c, *old_plan) for c in cs]
        variants["old splits 1"] = [old_call(c, 1, -(-K // 128) * 128) for c in cs]
        for name, fns in variants.items():
            warm = queued_ms(fns[0], ITERS)
            cold = queued_ms(_rotating(fns), ITERS)
            emit({"probe": "int8_matmul", "case": f"{label} M{M}", "variant": name,
                  "warm_ms": warm, "cold_ms": cold, "weight_bytes": K * N,
                  "cold_GBps": K * N / cold / 1e6})
        dqs = [(c["q8"].float() * c["s"]).to(torch.bfloat16) for c in cs[: max(2, copies // 2 + 1)]]
        lib_fns = [lambda c=c, dq=dq: torch.matmul(c["x"], dq) for c, dq in zip(cs, dqs)]
        emit({"probe": "int8_matmul", "case": f"{label} M{M}", "variant": "library torch.matmul",
              "warm_ms": queued_ms(lib_fns[0], ITERS), "cold_ms": queued_ms(_rotating(lib_fns), ITERS),
              "weight_bytes": 2 * K * N})
        del cs, dqs, variants, lib_fns
        torch.cuda.empty_cache()

    # One block alone (N 128, one split): its time a chunk, the difference of
    # 9 chunks and 1 over 8; and the copy kernel's one block over 590 KB.
    lone = {}
    for K in (128, 1152):
        c = matmul_case(32, K, 128, device=dev)
        lone[K] = queued_ms(lambda c=c, K=K: mk.int8_matmul(c["x"], c["q8"], c["s"], split_k=K),
                            ITERS)
    w1 = torch.randint(-127, 128, (4608, 128), dtype=torch.int8, device=dev)
    sink1 = torch.zeros(64, dtype=torch.int32, device=dev)
    copy_ms = queued_ms(lambda: lib.stream_copy(w1.data_ptr(), sink1.data_ptr(), 4608, 128, 128,
                                                4608, stream()), ITERS)
    emit({"probe": "lone_block", "new_1_chunk_ms": lone[128], "new_9_chunks_ms": lone[1152],
          "new_ms_per_chunk": (lone[1152] - lone[128]) / 8,
          "copy_590KB_ms": copy_ms, "copy_GBps": 4608 * 128 / copy_ms / 1e6})

    # Host time of a call (queued, not waited for): the wrapper with the same
    # x every call, with a new x every call (its tensor map is made anew
    # unless the caching allocator hands back an address seen before), and
    # torch.matmul; each over 200 calls of Gemma-3-1B's q product at M 32.
    c = matmul_case(32, 1152, 1024, device=dev)
    dq = (c["q8"].float() * c["s"]).to(torch.bfloat16)
    xs = [torch.randn(32, 1152, device=dev).to(torch.bfloat16) for _ in range(200)]
    host = {}
    for name, fn in (("same x", lambda i: mk.int8_matmul(c["x"], c["q8"], c["s"])),
                     ("new x", lambda i: mk.int8_matmul(xs[i] * 1, c["q8"], c["s"])),
                     ("torch.matmul", lambda i: torch.matmul(c["x"], dq))):
        for i in range(200):
            fn(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(200):
            fn(i)
        host[name] = (time.perf_counter() - t0) / 200 * 1e3
        torch.cuda.synchronize()
    emit({"probe": "host_ms_per_call", **host})
    del xs, dq

    for K, N in ((4096, 4096), (4096, 14336)):
        copies = max(2, -(-COLD_BYTES // (K * N)) + 1)
        ws = [torch.randint(-127, 128, (K, N), dtype=torch.int8, device=dev) for _ in range(copies)]
        sinkw = torch.zeros(1 << 16, dtype=torch.int32, device=dev)
        for seg in (64, 128, 256):
            rows = 65536 // seg  # 64 KB a block
            fns = [lambda w=w, seg=seg, rows=rows: lib.stream_copy(
                w.data_ptr(), sinkw.data_ptr(), K, N, seg, rows, stream()) for w in ws]
            warm = queued_ms(fns[0], ITERS)
            cold = queued_ms(_rotating(fns), ITERS)
            emit({"probe": "stream_copy", "case": f"{K}x{N}", "variant": f"copy {seg}",
                  "blocks": (N // seg) * -(-K // rows), "warm_ms": warm, "cold_ms": cold,
                  "cold_GBps": K * N / cold / 1e6, "warm_GBps": K * N / warm / 1e6})
        del ws
        torch.cuda.empty_cache()
    if sink:
        sink.close()
    return lines


if __name__ == "__main__":
    run(sys.argv[1] if len(sys.argv) > 1 else None)
