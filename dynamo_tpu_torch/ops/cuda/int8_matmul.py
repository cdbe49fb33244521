"""Wrapper of the hand-written int8 weight-streaming product
(csrc/int8_matmul.cu), counterpart of the TPU prototype ``mk_pallas(BN)``
→ ``one`` (_prof_stream.py:56), on the serving path's int8 ``qeinsum``
products of decode-sized row counts (ops/quant.py).

``int8_matmul(x, q8)`` is the prototype's function, float32 ``x @ q8``;
``int8_matmul(x, q8, s)`` applies qeinsum's rounding points in the kernel's
epilogue: the product rounded to bf16, times the float32 per-column scale,
rounded to bf16. On a CPU tensor it returns the plain version
(ops/quant.int8_matmul_ref). On a CUDA tensor it checks device, dtype,
shape, contiguity and alignment, allocates the output with
``torch.empty``, launches the kernel on the current stream (with K split,
as thread block clusters) and raises if the launch was refused; it never
falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from dynamo_tpu_torch.ops.cuda import build

launch_counts: Dict[str, int] = {"int8_matmul": 0}

CHUNK_K = 128  # contracted values a staged chunk holds (csrc/int8_matmul.cu kChunkK)
TILE_N = 128  # output columns a block owns (kTileN)
ROWS_PER_BLOCK = 64  # rows one read of the weights serves (four 16-row groups)
MAX_SPLITS = 8  # the K splits of a tile are one thread block cluster (kMaxSplits)
# A block's staged x, at most, with one or two matrices a stage
# (int8_stream.cuh max_x_bytes; two: the FFN's gate and up side by side).
MAX_X_BYTES = {1: 163_840, 2: 98_304}
STAGES = 4  # the ring's stages of code chunks (kStages)
TWO_PER_SM_BYTES = 115_648  # a block's shared memory that lets two share an SM
# The launch plan's cost model, in µs and bytes a µs of an H100 SXM (the
# int8_matmul cases of tools/int8_stream_probe.py): a launch of one block
# and one chunk; a lone block's time a chunk, and what each row of x adds;
# the cluster's reduction where K is split; the rate at which all resident
# blocks together stream codes.
START_US = 3.8
CHUNK_US = 0.45
CHUNK_US_PER_ROW = 0.006
TAIL_US = 1.8
CODE_BYTES_PER_US = 2.58e6

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib: Optional[ctypes.CDLL] = None
# device -> {(S, blocks an SM): clusters of S blocks the card holds at once}
_capacity: Dict[int, Dict[Tuple[int, int], int]] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.build("int8_matmul").lib
        # x w scale out, M K N splits split_k block_rows, stream
        lib.int8_matmul.argtypes = [_P] * 4 + [_I] * 6 + [_P]
        lib.int8_matmul.restype = _I
        lib.int8_matmul_capacity.argtypes = [_I, _I, ctypes.POINTER(_I)]
        lib.int8_matmul_capacity.restype = _I
        _lib = lib
    return _lib


def block_rows(M: int) -> int:
    """The rows of x a block takes: M's 16-row groups, up to 64 (more rows,
    more row groups on the grid)."""
    return 16 * -(-min(M, ROWS_PER_BLOCK) // 16)


def smem_bytes(rows: int, chunks: int, mats: int = 1) -> int:
    """A block's shared memory (the kernel's smem_bytes): the aligned ring
    of ``mats`` matrices' chunks, then its x, whole, or in two windows of as
    many chunks as fit half of MAX_X_BYTES[mats]."""
    chunk = rows * CHUNK_K * 2
    most = MAX_X_BYTES[mats]
    x = chunks * chunk if chunks * chunk <= most else 2 * (most // 2 // chunk) * chunk
    return 1024 + STAGES * mats * CHUNK_K * TILE_N + x


def blocks_per_sm(rows: int, chunks: int, mats: int = 1) -> int:
    """Blocks an SM holds: two where their registers (up to 32 rows) and
    shared memory allow, else one."""
    return 2 if rows <= 32 and smem_bytes(rows, chunks, mats) <= TWO_PER_SM_BYTES else 1


def plan(M: int, K: int, N: int, slots: int,
         clusters: Optional[Dict[Tuple[int, int], int]] = None, mats: int = 1) -> Tuple[int, int]:
    """(splits, split_k) of a launch on a card with ``slots`` SMs whose
    capacity ``clusters[(S, b)]`` is the clusters of S blocks (blocks, for
    S = 1) it holds at once at b blocks an SM (a tile's splits run as one
    cluster, and a cluster's blocks share a GPC; by default slots·b // S):
    whole 128-deep chunks in each split, none empty, at most MAX_SPLITS.
    ``mats`` matrices share each stage (2: the FFN's gate and up), so a
    chunk brings and multiplies that many chunks of codes. Each split count
    is priced by the cost model above — each wave START_US plus its chunks
    a block, at the larger of a lone block's pace (times the blocks an SM
    runs) and the resident blocks' codes over the streaming rate, the last
    wave at its own size; TAIL_US where K is split — and the cheapest wins,
    the fewest splits on a tie. A pure function of its arguments."""
    chunks = -(-K // CHUNK_K)
    rows = block_rows(M)
    tiles = -(-N // TILE_N) * -(-M // ROWS_PER_BLOCK)
    lone_us = mats * (CHUNK_US + rows * CHUNK_US_PER_ROW)
    best = None
    for splits in range(1, min(chunks, MAX_SPLITS) + 1):
        per = -(-chunks // splits)
        if -(-chunks // per) != splits:
            continue  # the same ranges as fewer splits
        b = blocks_per_sm(rows, per, mats)
        held = max(1, (clusters or {}).get((splits, b), slots * b // splits))

        def wave_us(n):  # a wave of n tiles' clusters; blocks that share an SM share its pace
            resident = n * splits
            return START_US + per * max(lone_us * -(-resident // slots),
                                        mats * resident * CHUNK_K * TILE_N / CODE_BYTES_PER_US)

        full, rest = divmod(tiles, held)
        cost = full * wave_us(held) + (wave_us(rest) if rest else 0.0)
        cost += TAIL_US if splits > 1 else 0.0
        if best is None or cost < best[0] - 1e-9:
            best = (cost, splits, per * CHUNK_K)
    return best[1], best[2]


@functools.lru_cache(maxsize=4096)
def plan_for(device_index: int, M: int, K: int, N: int, mats: int = 1) -> Tuple[int, int]:
    """plan() on this card, kept per shape: a decode step asks for the same
    few shapes every step."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return plan(M, K, N, sms, _capacity_for(device_index), mats)


def _capacity_for(device_index: int) -> Dict[Tuple[int, int], int]:
    """The card's capacity for plan(), asked once a device: clusters of 1 ..
    MAX_SPLITS blocks at one and at two blocks an SM."""
    if device_index not in _capacity:
        held = {}
        for splits in range(1, MAX_SPLITS + 1):
            for b in (1, 2):
                n = ctypes.c_int(0)
                with torch.cuda.device(device_index):
                    rc = _library().int8_matmul_capacity(splits, int(b == 2), ctypes.byref(n))
                if rc != 0 or n.value <= 0:
                    raise RuntimeError(f"int8_matmul capacity query failed: cudaError {rc}")
                held[(splits, b)] = n.value
        _capacity[device_index] = held
    return _capacity[device_index]


def int8_matmul(x: torch.Tensor, q8: torch.Tensor, s: Optional[torch.Tensor] = None, *,
                split_k: Optional[int] = None) -> torch.Tensor:
    """x [..., K] bf16 @ int8 codes [K, N]: float32 [..., N] without a
    scale; with per-column scales ``s`` (float32, N values: [1, N] or [N])
    bf16 [..., N] at qeinsum's rounding points. ``split_k`` forces the K
    range of a split (a multiple of 128, at most MAX_SPLITS splits; the
    card tests and tools/int8_stream_probe.py use it), else ``plan``
    chooses."""
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
    if split_k is None:
        dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
        splits, split_k = plan_for(dev, M, K, N)
    else:
        splits = -(-K // split_k)
        if split_k % CHUNK_K or split_k <= 0 or splits > MAX_SPLITS:
            raise ValueError(f"split_k {split_k} must be a positive multiple of {CHUNK_K} "
                             f"that covers K {K} in at most {MAX_SPLITS} splits")
    rc = _library().int8_matmul(
        x.data_ptr(), q8.data_ptr(), None if s is None else s.data_ptr(), out.data_ptr(),
        M, K, N, splits, split_k, block_rows(M), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"int8_matmul launch failed: cudaError {rc}")
    launch_counts["int8_matmul"] += 1
    return out
