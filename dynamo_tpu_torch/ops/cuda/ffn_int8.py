"""Wrapper of the hand-written int8 weight-streaming FFN (csrc/ffn_int8.cu),
counterpart of the TPU prototype ``ffn_pallas`` (_prof_fused_ffn.py:116).

``ffn_int8(x, wg, wu, wd, sg, su, sd)`` takes the prototype's arguments: x
bf16 [M, d] with M <= 64, int8 codes Wg, Wu [d, F] and Wd [F, d], float32
scales sg, su (F values) and sd (d values); d and F multiples of 128. On a
CPU tensor it returns the plain version (ops/ffn_int8.ffn_int8_ref). On a
CUDA tensor it checks device, dtype, shape, contiguity and alignment,
allocates the output and the h workspace with ``torch.empty``, launches the
kernel's two products on the current stream, each K split as the int8
product's plan for this card says (``plans``), and raises if a launch was
refused; it never falls back. One call counts one launch of ``ffn_int8`` in
``launch_counts``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from dynamo_tpu_torch.ops.cuda import build, int8_matmul

launch_counts: Dict[str, int] = {"ffn_int8": 0}

MAX_ROWS = 64  # rows one read of the weights serves (four 16-row groups)
ALIGN = 128  # d and F: whole 128-deep chunks and 128-column tiles

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.build("ffn_int8").lib
        # x wg wu wd sg su sd h out, M d F s1 sk1 s2 sk2, stream
        lib.ffn_int8.argtypes = [_P] * 9 + [_I] * 7 + [_P]
        lib.ffn_int8.restype = _I
        _lib = lib
    return _lib


def plans(M: int, d: int, F: int, slots: int,
          clusters: Optional[Dict[Tuple[int, int], int]] = None) -> Tuple[Tuple[int, int], ...]:
    """((splits, split_k) of the gate/up launch, of the down launch) on a
    card with ``slots`` SMs and cluster capacity ``clusters``: the int8
    product's plan (ops/cuda/int8_matmul.plan), gate/up with two matrices a
    stage (K = d, N = F), down with one (K = F, N = d)."""
    return (int8_matmul.plan(M, d, F, slots, clusters, mats=2),
            int8_matmul.plan(M, F, d, slots, clusters))


@functools.lru_cache(maxsize=256)
def _plans_for(device_index: int, M: int, d: int, F: int) -> Tuple[Tuple[int, int], ...]:
    """plans() on this card, kept per shape."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return plans(M, d, F, sms, int8_matmul._capacity_for(device_index))


def check(x, wg, wu, wd, sg, su, sd) -> None:
    """What the kernel takes (see the module docstring); raises otherwise."""
    tensors = {"x": x, "wg": wg, "wu": wu, "wd": wd, "sg": sg, "su": su, "sd": sd}
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    for name in ("wg", "wu", "wd"):
        if tensors[name].dtype != torch.int8:
            raise TypeError(f"{name} must be int8 codes, got {tensors[name].dtype}")
    for name in ("sg", "su", "sd"):
        if tensors[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {tensors[name].dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be [M, d], got {tuple(x.shape)}")
    M, d = x.shape
    F = wg.shape[-1]
    if wg.shape != (d, F) or wu.shape != (d, F) or wd.shape != (F, d):
        raise ValueError(f"weights {tuple(wg.shape)}, {tuple(wu.shape)}, {tuple(wd.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    if sg.numel() != F or su.numel() != F or sd.numel() != d:
        raise ValueError(f"scales of {sg.numel()}, {su.numel()}, {sd.numel()} values for F {F}, "
                         f"d {d}")
    if not 0 < M <= MAX_ROWS:
        raise ValueError(f"rows {M} must be 1..{MAX_ROWS}")
    if d % ALIGN or F % ALIGN:
        raise ValueError(f"d {d} and F {F} must be multiples of {ALIGN}")


def ffn_int8(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
             sg: torch.Tensor, su: torch.Tensor, sd: torch.Tensor, *,
             split_k: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """bf16 [M, d]: the prototype's FFN of x (see ops/ffn_int8.py).
    ``split_k`` forces the K range of a split of the gate/up launch and of
    the down launch (multiples of 128 that cover d and F in at most
    int8_matmul.MAX_SPLITS splits; the card tests use it), else ``plans``
    chooses."""
    if x.device.type == "cpu":
        from dynamo_tpu_torch.ops.ffn_int8 import ffn_int8_ref

        return ffn_int8_ref(x, wg, wu, wd, sg, su, sd)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    check(x, wg, wu, wd, sg, su, sd)
    M, d = x.shape
    F = wg.shape[1]
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    if split_k is None:
        (s1, k1), (s2, k2) = _plans_for(dev, M, d, F)
    else:
        k1, k2 = split_k
        if k1 <= 0 or k2 <= 0 or k1 % ALIGN or k2 % ALIGN or \
                max(-(-d // k1), -(-F // k2)) > int8_matmul.MAX_SPLITS:
            raise ValueError(f"split_k {split_k} must be positive multiples of {ALIGN} that cover "
                             f"d {d} and F {F} in at most {int8_matmul.MAX_SPLITS} splits")
        s1, s2 = -(-d // k1), -(-F // k2)
    h = torch.empty(M, F, dtype=torch.bfloat16, device=x.device)
    out = torch.empty(M, d, dtype=torch.bfloat16, device=x.device)
    rc = _library().ffn_int8(
        x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(), sg.data_ptr(), su.data_ptr(),
        sd.data_ptr(), h.data_ptr(), out.data_ptr(), M, d, F, s1, k1, s2, k2,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"ffn_int8 launch failed: cudaError {rc}")
    launch_counts["ffn_int8"] += 1
    return out
