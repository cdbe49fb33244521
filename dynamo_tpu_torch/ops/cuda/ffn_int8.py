"""Wrapper of the hand-written int8 weight-streaming FFN (csrc/ffn_int8.cu),
counterpart of the TPU prototype ``ffn_pallas`` (_prof_fused_ffn.py:116).

``ffn_int8(x, wg, wu, wd, sg, su, sd)`` takes the prototype's arguments: x
bf16 [M, d] with M <= 64, int8 codes Wg, Wu [d, F] and Wd [F, d], float32
scales sg, su (F values) and sd (d values); d and F multiples of 128. On a
CPU tensor it returns the plain version (ops/ffn_int8.ffn_int8_ref). On a
CUDA tensor it checks device, dtype, shape, contiguity and alignment,
allocates the output, the h workspace and the K-split partial sums with
``torch.empty``, launches the kernel's two phases on the current stream and
raises if a launch was refused; it never falls back. One call counts one
launch of ``ffn_int8`` in ``launch_counts``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from dynamo_tpu_torch.ops.cuda import build

launch_counts: Dict[str, int] = {"ffn_int8": 0}

MAX_ROWS = 64  # rows one read of the weights serves (four 16-row groups)
ALIGN = 128  # d and F: whole 128-deep chunks and 64-column tiles
TILE_N = 64

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib: Optional[ctypes.CDLL] = None
# (device, rows, phase weights) -> blocks the card holds at once
_slots: Dict[Tuple[int, int, int], int] = {}
# Per device: zeroed tile counters; each phase's last blocks reset theirs.
_counters: Dict[int, torch.Tensor] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.build("ffn_int8").lib
        # x wg wu wd sg su sd h out partial1 partial2 counters, M d F s1 sk1 s2 sk2, stream
        lib.ffn_int8.argtypes = [_P] * 12 + [_I] * 7 + [_P]
        lib.ffn_int8.restype = _I
        lib.ffn_int8_blocks_per_sm.argtypes = [_I, _I, ctypes.POINTER(_I)]
        lib.ffn_int8_blocks_per_sm.restype = _I
        _lib = lib
    return _lib


def plan(M: int, K: int, N: int, slots: int) -> Tuple[int, int]:
    """(splits, split_k) of one phase on a card that holds ``slots`` blocks
    at once: whole 128-deep chunks in each split, none empty. N/64 column
    tiles alone leave most SMs idle at N = 4,096, and a split that spills a
    few blocks into a second wave doubles the time, so the split minimises
    the chunk-steps on the critical path: waves × (chunks a block + its
    partial-sum write, a chunk's worth of bytes at 32 rows) + the adds of
    the tile's last block; the fewest splits win a tie."""
    chunks = -(-K // ALIGN)
    tiles = -(-N // TILE_N) * -(-M // MAX_ROWS)
    partial = min(M, MAX_ROWS) / 32  # a block's partial sums, in chunks of codes
    best = None
    for want in range(1, min(chunks, 64) + 1):
        per = -(-chunks // want)
        splits = -(-chunks // per)
        waves = -(-tiles * splits // slots)
        steps = waves * (per + partial) + splits * partial if splits > 1 else waves * per
        if best is None or steps < best[0]:
            best = (steps, splits, per * ALIGN)
    return best[1], best[2]


def _slots_for(device_index: int, M: int, nw: int) -> int:
    key = (device_index, min(M, MAX_ROWS), nw)
    if key not in _slots:
        blocks = ctypes.c_int(0)
        rc = _library().ffn_int8_blocks_per_sm(M, nw, ctypes.byref(blocks))
        if rc != 0 or blocks.value <= 0:
            raise RuntimeError(f"ffn_int8 occupancy query failed: cudaError {rc}")
        sms = torch.cuda.get_device_properties(device_index).multi_processor_count
        _slots[key] = sms * blocks.value
    return _slots[key]


def _workspace(device: torch.device, words: int) -> torch.Tensor:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    buf = _counters.get(idx)
    if buf is None or buf.numel() < words:
        buf = torch.zeros(max(words, 1024), dtype=torch.int32, device=device)
        _counters[idx] = buf
    return buf


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
             sg: torch.Tensor, su: torch.Tensor, sd: torch.Tensor) -> torch.Tensor:
    """bf16 [M, d]: the prototype's FFN of x (see ops/ffn_int8.py)."""
    if x.device.type == "cpu":
        from dynamo_tpu_torch.ops.ffn_int8 import ffn_int8_ref

        return ffn_int8_ref(x, wg, wu, wd, sg, su, sd)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    check(x, wg, wu, wd, sg, su, sd)
    M, d = x.shape
    F = wg.shape[1]
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    s1, k1 = plan(M, d, F, _slots_for(dev, M, 2))
    s2, k2 = plan(M, F, d, _slots_for(dev, M, 1))
    h = torch.empty(M, F, dtype=torch.bfloat16, device=x.device)
    out = torch.empty(M, d, dtype=torch.bfloat16, device=x.device)
    p1 = torch.empty(s1 * 2 * M * F, dtype=torch.float32, device=x.device) if s1 > 1 else None
    p2 = torch.empty(s2 * M * d, dtype=torch.float32, device=x.device) if s2 > 1 else None
    counters = _workspace(x.device, F // TILE_N + d // TILE_N)
    rc = _library().ffn_int8(
        x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(), sg.data_ptr(), su.data_ptr(),
        sd.data_ptr(), h.data_ptr(), out.data_ptr(), None if p1 is None else p1.data_ptr(),
        None if p2 is None else p2.data_ptr(), counters.data_ptr(), M, d, F, s1, k1, s2, k2,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"ffn_int8 launch failed: cudaError {rc}")
    launch_counts["ffn_int8"] += 1
    return out
