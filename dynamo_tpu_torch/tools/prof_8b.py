"""The Llama-3-8B int8 decode step with each decode-attention kernel: the
counterpart of _prof_8b.py's modes ``full``, ``floor``, ``v2`` and ``bf``.

    python -m dynamo_tpu_torch.tools.prof_8b [full] [floor] [v2] [bf]

Random int8 Llama-3-8B parameters (models/quantize.init_quantized_params,
seed 0) on the card; ``PB`` sequences (default 64) of bf16 KV pools at
block size ``PBS`` (128), each at context ``PCTX`` (160), decoded for
``PSTEPS`` (16) steps a call by models/llama.decode_multi (temperature 1,
top-p 0.95) with ``models.llama.paged_attention`` patched as the prototype
patches it:

  - full:  the serving decode kernel (#1, paged_attention_decode);
  - floor: no attention (the layer's query passes through);
  - v2:    decode_packed (#6), ops/cuda/decode_attention_proto.py;
  - bf:    decode_bf16 (#7), same file.

NB and the tables follow the prototype (_prof_8b.py:23-35): P = ⌈(ctx + 1)
/ BS⌉ pages a sequence, NB = max(B·P + 8, 192·128 / BS), tables a seeded
permutation of the blocks. Unlike the prototype, whose pools start at zero,
the pools are filled with N(0, 1) values from a seed, so that every
visible key moves the attention output and the first step's logits of the
modes can be compared. Each mode prints the host time a step (the best
of 3 calls after one warm-up, each ending in a synchronised read of the
tokens; the modes take turns, one call each a round, so a slow spell of the
host falls on all of them) and tokens a second, and counts its kernels'
launches. The other
modes of the prototype (xla, nowrite, nohead, mm, head, nosample, kbq, bq)
are not ported.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from dynamo_tpu_torch.device import DeviceLike, resolve_device
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.models.config import ModelConfig, llama3_8b_config
from dynamo_tpu_torch.models.quantize import init_quantized_params
from dynamo_tpu_torch.ops.cuda import decode_attention_proto, paged_attention
from dynamo_tpu_torch.tools.timing import device_name, synchronize

MODES = ("full", "floor", "v2", "bf")
# The kernel each mode's attention launches (none for floor), and every
# decode-attention kernel a mode may launch.
KERNEL = {"full": "paged_attention_decode", "floor": None, "v2": "decode_packed",
          "bf": "decode_bf16"}
ATTENTION_KERNELS = ("paged_attention_decode", "decode_packed", "decode_bf16")
CALLS = 3  # timed calls a mode


def _packed(q, k_c, v_c, bt, sp, cl, *, sm_scale, window, logit_cap):
    return decode_attention_proto.decode_packed(q, k_c, v_c, bt, sp, window, sm_scale=sm_scale,
                                                logit_cap=logit_cap)


def _bf16(q, k_c, v_c, bt, sp, cl, *, sm_scale, window, logit_cap):
    return decode_attention_proto.decode_bf16(q, k_c, v_c, bt, sp, window, sm_scale=sm_scale,
                                              logit_cap=logit_cap)


def _floor(q, *args, **kwargs):
    return q


PATCHES = {"full": None, "floor": _floor, "v2": _packed, "bf": _bf16}


@contextlib.contextmanager
def attention(mode: str) -> Iterator[None]:
    """models.llama.paged_attention patched for ``mode``, restored after."""
    real = llama.paged_attention
    if PATCHES[mode] is not None:
        llama.paged_attention = PATCHES[mode]
    try:
        yield
    finally:
        llama.paged_attention = real


def read_counts() -> Dict[str, int]:
    return {**paged_attention.launch_counts, **decode_attention_proto.launch_counts}


def reset_counts() -> None:
    paged_attention.reset_launch_counts()
    decode_attention_proto.reset_launch_counts()


def geometry(B: int, BS: int, ctx: int):
    """(pages a sequence, pool blocks), as _prof_8b.py:26-27."""
    P = (ctx + 1 + BS - 1) // BS
    return P, max(B * P + 8, 192 * 128 // BS)


class Setup:
    """The decode inputs of every mode: pools filled from a seed, tables,
    tokens, positions and the sampling settings of the prototype."""

    def __init__(self, cfg: ModelConfig, device: torch.device, B: int, BS: int, ctx: int):
        self.B, self.BS, self.ctx = B, BS, ctx
        P, NB = geometry(B, BS, ctx)
        self.k, self.v = llama.init_kv_cache(cfg, NB, BS, device)
        g = torch.Generator(device=device).manual_seed(0)
        for pool in self.k + self.v:
            pool.copy_(torch.randn(pool.shape, generator=g, device=device))
        rng = np.random.default_rng(0)
        self.tables = torch.from_numpy(
            rng.permutation(NB)[: B * P].reshape(B, P).astype(np.int32)).to(device)
        self.tok = torch.ones(B, dtype=torch.int32, device=device)
        self.pos = torch.full((B,), ctx, dtype=torch.int32, device=device)
        self.act = torch.ones(B, dtype=torch.int32, device=device)
        self.temp = torch.ones(B, dtype=torch.float32, device=device)
        self.topk = torch.zeros(B, dtype=torch.int32, device=device)
        self.topp = torch.full((B,), 0.95, dtype=torch.float32, device=device)
        self.salts = torch.arange(B, dtype=torch.int32, device=device)

    def decode(self, params, cfg, steps: int, want_logits: bool = False):
        return llama.decode_multi(
            params, cfg, self.tok, self.pos, self.act, self.tables, self.k, self.v, 1,
            self.temp, self.topk, self.topp, num_steps=steps, salts=self.salts,
            want_logits=want_logits,
        )


def run(params, cfg: ModelConfig, modes: Sequence[str] = MODES, *, device: DeviceLike = None,
        B: int = 64, BS: int = 128, ctx: int = 160, steps: int = 16) -> Dict[str, Any]:
    """Each mode: its first step's logits (a call of one step), then a
    warm-up call of ``steps`` steps, then CALLS rounds in which every
    mode runs one timed call in turn. The decode-attention launch counts
    are zeroed before the warm-ups, and each call's launches are credited
    to its mode. Returns per mode {ms_step (best call, host clock), tok_s,
    calls (warm-up included), launches, logits [B, V] float32}."""
    dev = resolve_device(device)
    for mode in modes:
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} is not ported (ported: {', '.join(MODES)})")
    setup = Setup(cfg, dev, B, BS, ctx)
    P, NB = geometry(B, BS, ctx)
    print(f"{cfg.name}: B {B} BS {BS} P {P} NB {NB} ctx {ctx}, {steps} steps a call "
          f"({device_name(dev)})", flush=True)
    out: Dict[str, Any] = {m: dict(times=[], launches={n: 0 for n in ATTENTION_KERNELS})
                           for m in modes}

    def call(mode: str, timed: bool = True) -> None:
        before = read_counts()
        with attention(mode):
            synchronize(dev)
            t0 = time.perf_counter()
            setup.decode(params, cfg, steps).tokens.cpu()
            if timed:
                out[mode]["times"].append(1e3 * (time.perf_counter() - t0))
        after = read_counts()
        for n in ATTENTION_KERNELS:
            out[mode]["launches"][n] += after[n] - before[n]

    with torch.inference_mode():
        for mode in modes:
            with attention(mode):
                out[mode]["logits"] = setup.decode(params, cfg, 1, want_logits=True).logits[:, 0]
        reset_counts()
        for mode in modes:
            call(mode, timed=False)  # warm-up
        for _ in range(CALLS):
            for mode in modes:
                call(mode)
    for mode in modes:
        r = out[mode]
        r["logits"] = r["logits"].float()
        r["calls"] = CALLS + 1
        r["ms_step"] = min(r.pop("times")) / steps
        r["tok_s"] = B * 1e3 / r["ms_step"]
        print(f"{mode}: {r['ms_step'] * steps:.1f} ms total, {r['ms_step']:.2f} ms/step -> "
              f"{r['tok_s']:.0f} tok/s; launches {r['launches']}", flush=True)
    return out


def expected_launches(mode: str, cfg: ModelConfig, steps: int, calls: int) -> Dict[str, int]:
    """The decode-attention launches of ``calls`` calls of ``steps`` steps:
    one a layer a step of the mode's kernel, none of the others."""
    want = {n: 0 for n in ATTENTION_KERNELS}
    if KERNEL[mode] is not None:
        want[KERNEL[mode]] = cfg.n_layers * steps * calls
    return want


def main(argv: Optional[List[str]] = None, *, device: DeviceLike = None,
         config: Optional[ModelConfig] = None, params=None) -> Dict[str, Any]:
    modes = (sys.argv[1:] if argv is None else argv) or list(MODES)
    cfg = config or llama3_8b_config()
    dev = resolve_device(device)
    if params is None:
        params = init_quantized_params(cfg, 0, dev)
    env = os.environ
    return run(params, cfg, modes, device=dev, B=int(env.get("PB", 64)),
               BS=int(env.get("PBS", 128)), ctx=int(env.get("PCTX", 160)),
               steps=int(env.get("PSTEPS", 16)))


if __name__ == "__main__":
    main()
