"""The int8 weight-streaming FFN at Llama-3-8B widths: the counterpart of
_prof_fused_ffn.py's ``__main__``.

    python -m dynamo_tpu_torch.tools.prof_fused_ffn

x bf16 [64, 4,096], int8 Wg, Wu [4,096, 14,336] and Wd [14,336, 4,096]
(codes in [-127, 127)), float32 scales N(0, 0.01²), made on the device from
a seed, as the prototype makes them. First the correctness gate: the
kernel (ops/cuda/ffn_int8.py) against its plain version
(ops/ffn_int8.ffn_int8_ref, the counterpart of the prototype's
``ffn_xla``), max |a - b| / max |b| < 3e-2 as the prototype's gate. Then
for the kernel and for the plain version: 16 chained calls, each output fed
back into the next input (x + 0.001·y, in bf16), the best of 5, printed as
µs an FFN and the weight bytes over that time in GB/s. On the card the
kernel runs; with ``device="cpu"`` the plain version and the host clock.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from dynamo_tpu_torch.device import DeviceLike, resolve_device
from dynamo_tpu_torch.ops.cuda import ffn_int8 as kernel
from dynamo_tpu_torch.ops.ffn_int8 import ffn_int8_ref
from dynamo_tpu_torch.tools.cases import ffn_case
from dynamo_tpu_torch.tools.timing import device_name, elapsed_ms

B, D, F = 64, 4096, 14336
CHAIN = 16
REPS = 5
GATE = 3e-2  # the prototype's relative-error gate


def run(device: DeviceLike = None, *, M: int = B, d: int = D, ff: int = F) -> Dict[str, Any]:
    """The gate, then the timing of the kernel and of the plain version at
    M rows, width d and FFN width ff (Llama-3-8B's by default)."""
    dev = resolve_device(device)
    x0, *w = ffn_case(M, d, ff, device=dev)
    a = kernel.ffn_int8(x0, *w).float()
    b = ffn_int8_ref(x0, *w).float()
    rel = float((a - b).abs().max() / (b.abs().max() + 1e-9))
    print(f"rel err: {rel:.2e}", flush=True)
    if not rel < GATE:
        raise AssertionError(f"ffn_int8 rel err {rel} >= {GATE}")
    gbytes = 3 * d * ff / 1e9  # int8 weight bytes a call
    res: Dict[str, Any] = {"rel_err": rel, "device": device_name(dev), "weight_gb": gbytes}
    for label, fn in (("kernel", kernel.ffn_int8), ("plain", ffn_int8_ref)):
        def chain(fn=fn):
            x = x0
            for _ in range(CHAIN):
                x = (x + 0.001 * fn(x, *w)).to(torch.bfloat16)
            return x

        us = 1e3 * min(elapsed_ms(chain, dev, REPS)) / CHAIN
        res[f"{label}_us"] = us
        res[f"{label}_gb_s"] = gbytes / (us * 1e-6)
        print(f"{label}: {us:.1f} us/ffn -> {gbytes / (us * 1e-6):.0f} GB/s ({res['device']})",
              flush=True)
    return res


if __name__ == "__main__":
    run()
