"""Wrapper of the hand-written int8 lm-head kernel (csrc/lm_head_int8.cu),
counterpart of the TPU prototype ``head_fused`` (_prof_head.py:33) on the
serving path's int8 ``quant.lm_head``.

On a CPU tensor it returns the plain version (ops/quant.lm_head_ref). On a
CUDA tensor it checks device, dtype, shape, contiguity and alignment,
allocates the logits with ``torch.empty``, launches the kernel on the
current stream and raises if the launch was refused; it never falls back.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from dynamo_tpu_torch.ops.cuda import build

launch_counts: Dict[str, int] = {"lm_head_int8": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.build("lm_head_int8").lib
        lib.lm_head_int8.argtypes = [_P] * 4 + [_I] * 4 + [_P]  # x q8 s out, M K V tied, stream
        lib.lm_head_int8.restype = _I
        _lib = lib
    return _lib


def lm_head_int8(x: torch.Tensor, q8: torch.Tensor, s: torch.Tensor, *, tied: bool) -> torch.Tensor:
    """float32 logits [..., V] of x [..., d] against int8 codes — untied
    [d, V] with scales [1, V], or tied [V, d] with scales [V, 1] — rounded
    to x's dtype before the scale, as ``quant.lm_head``."""
    if x.device.type == "cpu":
        from dynamo_tpu_torch.ops.quant import lm_head_ref

        return lm_head_ref(x, {"q8": q8, "s": s}, tied=tied)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    for name, t in (("q8", q8), ("s", s)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("q8", q8), ("s", s)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype != torch.bfloat16 or q8.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"want bf16 x, int8 codes, f32 scales; got {x.dtype}, {q8.dtype}, {s.dtype}")
    K = x.shape[-1]
    V = q8.shape[0] if tied else q8.shape[1]
    if q8.dim() != 2 or q8.shape[1 if tied else 0] != K:
        raise ValueError(f"codes {tuple(q8.shape)} do not match x's width {K} (tied={tied})")
    if s.shape != ((V, 1) if tied else (1, V)):
        raise ValueError(f"scales {tuple(s.shape)} for {V} vocab rows (tied={tied})")
    # untied: 16-byte loads of 16 vocab columns and of 8 values of x; tied:
    # cp.async copies of 16 (or, when K is not a multiple of 16, 8) codes of
    # a vocab row and of 8 values of x
    if K % 8 or (not tied and V % 16):
        raise ValueError(f"d_model {K} / vocab {V} not aligned for the kernel (tied={tied})")
    if q8.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("codes and x must be 16-byte aligned")
    M = x.numel() // K
    out = torch.empty(*x.shape[:-1], V, dtype=torch.float32, device=x.device)
    if M == 0:
        return out
    rc = _library().lm_head_int8(
        x.data_ptr(), q8.data_ptr(), s.data_ptr(), out.data_ptr(), M, K, V, int(tied),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"lm_head_int8 launch failed: cudaError {rc}")
    launch_counts["lm_head_int8"] += 1
    return out
