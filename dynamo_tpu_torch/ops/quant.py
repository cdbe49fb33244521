"""Int8 weight-only quantization and the weight products — counterpart of
dynamo_tpu/ops/quant.py.

A weight is either a plain tensor in the model's dtype or the per-output-
channel int8 pair ``{"q8": int8 codes, "s": float32 scale}``, the scale kept
with ``keepdims`` over the contracted axis (absmax / 127). The products
follow the JAX package's rounding points:

  - ``qeinsum``: the product on the codes upcast to ``x.dtype`` (so a bf16
    model rounds it to bf16), then × scale in float32, cast back to the
    product's dtype (quant.py:82-89). For CUDA tensors a bf16 product of
    at most ``INT8_MATMUL_MAX_ROWS`` rows (decode) goes to the hand-written
    weight-streaming kernel (ops/cuda/int8_matmul.py), which reads the
    codes directly and keeps these points;
  - ``lm_head``: the product rounded to x's dtype, then × scale in float32
    (quant.py:110-115). For CUDA tensors the int8 head goes to the
    hand-written kernel (ops/cuda/lm_head.py), which keeps these points;
  - ``embed_lookup``: the gathered codes × their row scale in float32.

Larger products (prefill) stay ``torch.matmul`` on the upcast codes: the
JAX package leaves them to XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

QTensor = Dict[str, Any]  # {"q8": int8, "s": float32 keepdims}
MaybeQ = Union[torch.Tensor, QTensor]

# Row counts up to which a CUDA int8 product runs the weight-streaming
# kernel. One launch reads the weights once for up to 64 rows (four 16-row
# groups share each staged chunk of codes), and at 64 rows the product does
# 2·64 = 128 flops a weight byte, under the H100's ~295 bf16 flops-a-byte
# ridge: the weight bytes bound it, and reading them as int8 instead of a
# bf16 copy is the gain. It covers every decode batch up to 64 sequences.
# Larger counts are prefill, which torch.matmul takes (as XLA in the JAX
# package).
INT8_MATMUL_MAX_ROWS = 64


def quantize_q8(w: Any, contract_axes: Sequence[int]) -> QTensor:
    """Symmetric per-output-channel int8 over the given contracted axes.
    Numpy in → numpy out; a tensor in → tensors on its device. Codes are
    round-half-to-even (``np.rint`` / ``torch.round``), as JAX's."""
    axes = tuple(contract_axes)
    if isinstance(w, np.ndarray):
        wf = np.asarray(w, dtype=np.float32)
        amax = np.max(np.abs(wf), axis=axes, keepdims=True)
        s = np.where(amax > 0, amax / np.float32(127.0), np.float32(1.0)).astype(np.float32)
        q = np.clip(np.rint(wf / s), -127, 127).astype(np.int8)
        return {"q8": q, "s": s}
    wf = w.to(torch.float32)
    amax = torch.amax(torch.abs(wf), dim=axes, keepdim=True)
    s = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return {"q8": q, "s": s.to(torch.float32)}


def is_q8(w: Any) -> bool:
    return isinstance(w, dict) and "q8" in w


def dequantize(w: MaybeQ, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if not is_q8(w):
        return w.to(dtype)
    return (w["q8"].to(torch.float32) * w["s"]).to(dtype)


@functools.lru_cache(maxsize=None)
def _is_matmul(spec: str) -> bool:
    """Whether ``spec`` contracts x's last axis with a 2-D weight's first
    and keeps every other axis in order ("...k,kn->...n")."""
    lhs, out = spec.split("->")
    xs, ws = lhs.split(",")
    return len(ws) == 2 and xs[-1] == ws[0] and out == xs[:-1] + ws[1]


def _product(spec: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # The model's specs are all plain matrix products and go to
    # torch.matmul, which skips einsum's per-call parsing and permutes:
    # host time per op bounds an eager decode step.
    if _is_matmul(spec):
        return torch.matmul(x, w)
    return torch.einsum(spec, x, w)


def int8_matmul_ref(x: torch.Tensor, q8: torch.Tensor, s: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Plain version of the int8 weight-streaming product, x [..., K] @
    codes [K, N]. Without ``s``: the TPU prototype's function
    (_prof_stream.py:38-48), float32 sums of x times the codes (every
    product is exact in float32). With per-column scales ``s`` ([1, N] or
    [N]): qeinsum's rounding points — the product in x's dtype, then ×
    scale in float32, cast back."""
    if s is None:
        return torch.matmul(x.to(torch.float32), q8.to(torch.float32))
    y = torch.matmul(x, q8.to(x.dtype))
    return (y.to(torch.float32) * s.reshape(-1)).to(y.dtype)


def qeinsum(spec: str, x: torch.Tensor, w: MaybeQ) -> torch.Tensor:
    """``einsum(spec, x, w)`` where ``w`` may be int8 (same specs as the JAX
    package: "bcd,dh->bch", ...)."""
    if not is_q8(w):
        return _product(spec, x, w)
    if (_is_matmul(spec) and x.dtype == torch.bfloat16
            and x.numel() <= INT8_MATMUL_MAX_ROWS * x.shape[-1]):
        from dynamo_tpu_torch.ops.cuda import int8_matmul as kernel

        return kernel.int8_matmul(x.contiguous(), w["q8"], w["s"])
    lhs, out = spec.split("->")
    w_labels = lhs.split(",")[1]
    q, s = w["q8"], w["s"]
    kept = [lbl for lbl in w_labels if lbl in out]
    if kept != [lbl for lbl in out if lbl in w_labels]:
        raise ValueError(f"qeinsum: weight output labels reordered in {spec!r}")
    y = _product(spec, x, q.to(x.dtype))
    # The scale in the output's layout: kept weight dims, 1 elsewhere.
    sizes = {lbl: q.shape[i] for i, lbl in enumerate(w_labels)}
    s_out = s.reshape([sizes[lbl] if lbl in kept else 1 for lbl in out])
    return (y.to(torch.float32) * s_out).to(y.dtype)


def embed_lookup(embed: MaybeQ, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Embedding-table row gather; int8 rows times their row scale."""
    if not is_q8(embed):
        return embed[tokens].to(dtype)
    rows = embed["q8"][tokens].to(torch.float32)  # [..., d]
    return (rows * embed["s"][tokens]).to(dtype)  # s[tokens]: [..., 1]


def lm_head_ref(x: torch.Tensor, w: QTensor, *, tied: bool) -> torch.Tensor:
    """Plain version of the int8 head: the product on codes upcast to x's
    dtype (rounded to it), then float32 × the per-vocab scale."""
    q, s = w["q8"], w["s"]
    if tied:
        return torch.matmul(x, q.to(x.dtype).T).to(torch.float32) * s[:, 0]
    return torch.matmul(x, q.to(x.dtype)).to(torch.float32) * s[0]


def lm_head(x: torch.Tensor, w: MaybeQ, *, tied: bool) -> torch.Tensor:
    """Project hidden states to float32 vocab logits. ``tied``: ``w`` is the
    embedding table [V, d] (int8 scale [V, 1]); otherwise the lm_head
    [d, V] (scale [1, V])."""
    if not is_q8(w):
        h = w.T if tied else w
        return (x @ h).to(torch.float32)
    from dynamo_tpu_torch.ops.cuda import lm_head as kernel

    return kernel.lm_head_int8(x, w["q8"], w["s"], tied=tied)
