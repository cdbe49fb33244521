"""Decode attention at Llama-3-8B widths: the counterpart of _prof_attn.py's
``__main__``.

    python -m dynamo_tpu_torch.tools.prof_attn [B]

B sequences (default 64) of 8 KV heads x 4 query heads a group at head_dim
128, block size 128, two pages a sequence, every sequence at context 160;
q and pools N(0, 1) in bf16, made on the device from a seed. First parity:
``decode_packed`` (#6) against the float32-probability oracle
(ops/attention.paged_attention_ref), against its own plain version
(decode_attention_bf16_ref) and against the serving decode kernel (#1,
``paged_attention_decode``), and #1 against the oracle; a disagreement
beyond the stated limits raises. Then the time of 32 layer calls of #1 ("v1") and of
#6 ("v2 packed"), the median of 5 repetitions. On the card the kernels
run; with ``device="cpu"`` their plain versions and the host clock.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, Optional

import torch

from dynamo_tpu_torch.device import DeviceLike, resolve_device
from dynamo_tpu_torch.ops.attention import decode_attention_bf16_ref, paged_attention_ref
from dynamo_tpu_torch.ops.cuda import decode_attention_proto, paged_attention
from dynamo_tpu_torch.tools.cases import attention_case
from dynamo_tpu_torch.tools.timing import device_name, elapsed_ms

KH, G, D, BS, CTX = 8, 4, 128, 128, 160
LAYERS = 32
REPS = 5
# |a - r| <= ATOL + RTOL·|r|: the attention kernels' limit, against the
# plain version of the same function; bf16 probabilities against the
# float32 oracle take the looser F32_ATOL (tests/test_torch_proto_attention.py).
ATOL, RTOL, F32_ATOL = 2e-3, 1e-2, 1e-2


def _err(out: torch.Tensor, ref: torch.Tensor, atol: float):
    e = (out.float() - ref.float()).abs()
    ok = bool((e <= atol + RTOL * ref.float().abs()).all()) and bool(torch.isfinite(out).all())
    return float(e.max()), ok


def run(B: int = 64, device: DeviceLike = None) -> Dict[str, Any]:
    """Parity, then the time of LAYERS calls of #1 and of #6, for B
    sequences."""
    dev = resolve_device(device)
    # P = ⌈(CTX + 1) / BS⌉ = 2 pages a sequence and NB = B·P + 8 blocks, as
    # the prototype's
    c = attention_case(B, 1, [CTX] * B, [1] * B, 0, device=dev, H=KH * G, KH=KH, D=D, BS=BS)
    args = (c["q"], c["k"], c["v"], c["tables"], c["start"])
    oracle = paged_attention_ref(*args, c["clens"])
    plain = decode_attention_bf16_ref(*args)
    out2 = decode_attention_proto.decode_packed(*args)
    out1 = paged_attention.paged_attention_decode(*args)
    res: Dict[str, Any] = {"B": B, "device": device_name(dev)}
    checks = {"packed vs oracle": _err(out2, oracle, F32_ATOL),
              "packed vs plain": _err(out2, plain, ATOL),
              "packed vs v1": _err(out2, out1, F32_ATOL),
              "v1 vs oracle": _err(out1, oracle, ATOL)}
    for label, (err, ok) in checks.items():
        print(f"{label} max err: {err}", flush=True)
        res[label] = err
        if not ok:
            raise AssertionError(f"{label}: max err {err} beyond the limit")

    def layers(fn):
        def call():
            for _ in range(LAYERS):
                fn(*args)
        return call

    for label, fn in (("v1 kernel", paged_attention.paged_attention_decode),
                      ("v2 packed", decode_attention_proto.decode_packed)):
        times = sorted(elapsed_ms(layers(fn), dev, REPS))
        res[f"{label} ms"] = times[len(times) // 2]
        print(f"{label}: {res[f'{label} ms']:.4f} ms for {LAYERS} layers "
              f"({res['device']})", flush=True)
    return res


def main(argv: Optional[list] = None, device: DeviceLike = None) -> Dict[str, Any]:
    argv = sys.argv[1:] if argv is None else argv
    return run(int(argv[0]) if argv else 64, device)


if __name__ == "__main__":
    main()
