"""Wrapper of the hand-written int8 weight-streaming product
(csrc/int8_matmul.cu), counterpart of the TPU prototype ``mk_pallas(BN)``
→ ``one`` (_prof_stream.py:56), on the serving path's int8 ``qeinsum``
products of decode-sized row counts (ops/quant.py).

``int8_matmul(x, q8)`` is the prototype's function, float32 ``x @ q8``;
``int8_matmul(x, q8, s)`` applies qeinsum's rounding points in the kernel's
epilogue: the product rounded to bf16, times the float32 per-column scale,
rounded to bf16. On a CPU tensor it returns the plain version
(ops/quant.int8_matmul_ref). On a CUDA tensor it checks device, dtype,
shape, contiguity and alignment, allocates the output and the K-split
workspace with ``torch.empty``, launches the kernel on the current stream
and raises if the launch was refused; it never falls back.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from dynamo_tpu_torch.ops.cuda import build

launch_counts: Dict[str, int] = {"int8_matmul": 0}

CHUNK_K = 128  # contracted values a block stages at once (int8_gemv.cuh kChunkK)
TILE_N = 64  # output columns a block owns (kTileN)
ROWS_PER_BLOCK = 64  # rows one read of the weights serves (four 16-row groups)

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib: Optional[ctypes.CDLL] = None
# (device, row groups, scaled) -> blocks the card holds at once
_slots: Dict[Tuple[int, int, bool], int] = {}
# Per device: zeroed tile counters for K-split launches. Each launch's last
# block resets the counters it used, so the buffer stays zeroed.
_counters: Dict[int, torch.Tensor] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.build("int8_matmul").lib
        # x w scale out partial counters, M K N splits split_k, stream
        lib.int8_matmul.argtypes = [_P] * 6 + [_I] * 5 + [_P]
        lib.int8_matmul.restype = _I
        lib.int8_matmul_blocks_per_sm.argtypes = [_I, _I, ctypes.POINTER(_I)]
        lib.int8_matmul_blocks_per_sm.restype = _I
        _lib = lib
    return _lib


def plan(M: int, K: int, N: int, slots: int) -> Tuple[int, int]:
    """(splits, split_k) for a launch on a card that holds ``slots`` blocks
    at once: whole 128-deep chunks in each split, none empty. N/64 column
    tiles alone leave most SMs idle at N = 1,024, and a split that spills a
    few blocks into a second wave doubles the time, so the split minimises
    the chunk-steps on the critical path: waves × (chunks a block + its
    partial-sum write, a chunk's worth of bytes at 32 rows) + the adds of
    the tile's last block; the fewest splits win a tie."""
    chunks = -(-K // CHUNK_K)
    tiles = -(-N // TILE_N) * -(-M // ROWS_PER_BLOCK)
    partial = min(M, ROWS_PER_BLOCK) / 32  # a block's partial sums, in chunks of codes
    best = None
    for want in range(1, min(chunks, 64) + 1):
        per = -(-chunks // want)
        splits = -(-chunks // per)
        waves = -(-tiles * splits // slots)
        steps = waves * (per + partial) + splits * partial if splits > 1 else waves * per
        if best is None or steps < best[0]:
            best = (steps, splits, per * CHUNK_K)
    return best[1], best[2]


def _slots_for(device_index: int, M: int, scaled: bool) -> int:
    groups = min(ROWS_PER_BLOCK, M) // 16 + (min(ROWS_PER_BLOCK, M) % 16 > 0)
    key = (device_index, groups, scaled)
    if key not in _slots:
        blocks = ctypes.c_int(0)
        rc = _library().int8_matmul_blocks_per_sm(M, int(scaled), ctypes.byref(blocks))
        if rc != 0 or blocks.value <= 0:
            raise RuntimeError(f"int8_matmul occupancy query failed: cudaError {rc}")
        sms = torch.cuda.get_device_properties(device_index).multi_processor_count
        _slots[key] = sms * blocks.value
    return _slots[key]


def _workspace(device: torch.device, tiles: int) -> torch.Tensor:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    buf = _counters.get(idx)
    if buf is None or buf.numel() < tiles:
        buf = torch.zeros(max(tiles, 4096), dtype=torch.int32, device=device)
        _counters[idx] = buf
    return buf


def int8_matmul(x: torch.Tensor, q8: torch.Tensor, s: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [..., K] bf16 @ int8 codes [K, N]: float32 [..., N] without a
    scale; with per-column scales ``s`` (float32, N values: [1, N] or [N])
    bf16 [..., N] at qeinsum's rounding points."""
    if x.device.type == "cpu":
        from dynamo_tpu_torch.ops.quant import int8_matmul_ref

        return int8_matmul_ref(x, q8, s)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    tensors = {"x": x, "q8": q8} if s is None else {"x": x, "q8": q8, "s": s}
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype != torch.bfloat16 or q8.dtype != torch.int8:
        raise TypeError(f"want bf16 x and int8 codes; got {x.dtype}, {q8.dtype}")
    K = x.shape[-1]
    if q8.dim() != 2 or q8.shape[0] != K:
        raise ValueError(f"codes {tuple(q8.shape)} do not match x's width {K}")
    N = q8.shape[1]
    if s is not None and (s.dtype != torch.float32 or s.numel() != N):
        raise TypeError(f"scales must be {N} float32 values, got {s.dtype} {tuple(s.shape)}")
    # 16-byte loads: 8 values of x, 16 codes of a weight row
    if K % 8 or N % 16:
        raise ValueError(f"K {K} must be a multiple of 8 and N {N} of 16")
    if x.data_ptr() % 16 or q8.data_ptr() % 16:
        raise ValueError("x and the codes must be 16-byte aligned")
    M = x.numel() // K
    out = torch.empty(*x.shape[:-1], N, device=x.device,
                      dtype=torch.float32 if s is None else torch.bfloat16)
    if M == 0:
        return out
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    splits, split_k = plan(M, K, N, _slots_for(dev, M, s is not None))
    partial = counters = None
    if splits > 1:
        partial = torch.empty(splits * M * N, dtype=torch.float32, device=x.device)
        counters = _workspace(x.device, -(-N // TILE_N) * -(-M // ROWS_PER_BLOCK))
    rc = _library().int8_matmul(
        x.data_ptr(), q8.data_ptr(), None if s is None else s.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(),
        None if counters is None else counters.data_ptr(),
        M, K, N, splits, split_k, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"int8_matmul launch failed: cudaError {rc}")
    launch_counts["int8_matmul"] += 1
    return out
