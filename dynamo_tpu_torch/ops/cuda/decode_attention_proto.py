"""Wrappers of the two hand-written decode-attention kernels with bf16
probabilities (csrc/decode_attention_proto.cu), counterparts of the TPU
prototypes ``decode_packed`` (_prof_attn.py:113) and ``decode_bf16``
(_prof_attn.py:312).

Both compute one function, ``ops/attention.decode_attention_bf16_ref``:
decode attention (one query token a sequence) over a bf16 pool with the
prototypes' rounding points. They differ in the work split: ``decode_packed``
runs one thread block a sequence over all of its KV heads, ``decode_bf16``
one a (sequence, KV head). The signature is the prototypes' (window
positional, ``sm_scale`` and ``logit_cap`` by keyword); the prototypes'
``batch_block`` only grouped sequences for the TPU's grid and does not
change the function, so it is not taken.

On a CPU tensor a wrapper returns the plain version. On a CUDA tensor it
checks device, dtype, shape and contiguity, allocates the output with
``torch.empty``, launches its kernel on the current stream and raises if
the launch was refused; it never falls back. ``launch_counts`` counts
launches per kernel: one a wrapper call, whatever kernels the call runs.

Both kernels split each block's keys over ``split_count(...)`` blocks
(flash-decoding) where the blocks of one pass (B for ``decode_packed``,
B·KH for ``decode_bf16``) would leave the card unfilled: a count from the
shapes and the kernel's occupancy alone, so a call reads nothing back from
the card. With more than one split the wrapper allocates the partials'
workspace with ``torch.empty`` and the library launches the split kernel
and its fixed-order combine. ``splits=`` forces the count (tests and
chip_smoke.py).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from dynamo_tpu_torch.ops.attention import PROTO_STEP, decode_attention_bf16_ref
from dynamo_tpu_torch.ops.cuda import build
from dynamo_tpu_torch.ops.cuda.paged_attention import H100_CAPACITY, MAX_SPLITS, check_block_size

# The widths csrc/decode_attention_proto.cu is built for.
HEAD_DIMS = (128, 256)
MAX_GROUP = 8  # query rows a KV head
MAX_ROWS = 64  # query rows of one decode_packed block (all heads of a sequence)
MAX_WIDTH = 2048  # KV heads x head_dim one decode_packed block stages a key

launch_counts: Dict[str, int] = {"decode_packed": 0, "decode_bf16": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_lib: Optional[ctypes.CDLL] = None
_capacity: Dict[tuple, int] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.build("decode_attention_proto").lib
        # q k v tables start out part, B H KH D NB BS P window, scale cap, splits, stream
        argtypes = [_P] * 7 + [_I] * 8 + [_F, _F, _I, _P]
        for fn in (lib.decode_packed, lib.decode_bf16):
            fn.argtypes = argtypes
            fn.restype = _I
        lib.decode_attention_proto_capacity.argtypes = [_I] * 3  # packed, KH, D
        lib.decode_attention_proto_capacity.restype = _I
        _lib = lib
    return _lib


def check(q, k_cache, v_cache, block_tables, start_pos, packed: bool) -> None:
    """What the kernels take: bf16 q [B, 1, H, D] and pools [NB, BS, KH, D]
    at D 128 or 256, int32 tables [B, P] and starts [B], all contiguous on
    one device; G = H / KH at most 8, and for ``decode_packed`` all of a
    sequence's rows (H <= 64) and KH x D <= 2,048 in one block; a block
    size that ``paged_attention.check_block_size`` admits; q and the pools
    starting on 16-byte boundaries."""
    tensors = {"q": q, "k_cache": k_cache, "v_cache": v_cache,
               "block_tables": block_tables, "start_pos": start_pos}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("q", "k_cache", "v_cache"):  # the copy engine takes 16-byte aligned tensors
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    for name in ("q", "k_cache", "v_cache"):
        if tensors[name].dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {tensors[name].dtype}")
    for name in ("block_tables", "start_pos"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {tensors[name].dtype}")
    B, C, H, D = q.shape
    NB, BS, KH, Dk = k_cache.shape
    if C != 1:
        raise ValueError(f"decode attention takes one query token a sequence, got C = {C}")
    if v_cache.shape != k_cache.shape or Dk != D:
        raise ValueError(f"pool shapes {tuple(k_cache.shape)}/{tuple(v_cache.shape)} vs q "
                         f"{tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if H % KH or H // KH > MAX_GROUP:
        raise ValueError(f"n_heads {H} must be a multiple of n_kv_heads {KH}, at most "
                         f"{MAX_GROUP} a KV head")
    if packed and (H > MAX_ROWS or KH * D > MAX_WIDTH):
        raise ValueError(f"decode_packed holds at most {MAX_ROWS} rows and {MAX_WIDTH} values "
                         f"a key, got H {H}, KH x D {KH * D}")
    check_block_size(BS)
    if block_tables.dim() != 2 or block_tables.shape[0] != B or start_pos.shape != (B,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / start_pos "
                         f"{tuple(start_pos.shape)} vs batch {B}")


def tile_keys(packed: bool, KH: int) -> int:
    """Keys of one tile of a block's walk, the unit its splits share out:
    PROTO_STEP (16) keys a warp's key group, max(1, 4 // NH) groups, NH = KH
    heads a block for ``decode_packed`` and 1 for ``decode_bf16`` (the csrc
    Geometry)."""
    NH = KH if packed else 1
    return PROTO_STEP * max(1, 4 // NH)


def proto_splits(blocks: int, capacity: int = H100_CAPACITY) -> int:
    """How many splits a call cuts each block's keys into: as many as fit
    the card once beside the ``blocks`` of one pass (``capacity`` // blocks,
    at most MAX_SPLITS), or 1 where fewer than two do. Unlike
    ``paged_attention.decode_splits`` it does not split a pass that nearly
    fills the card: decode_bf16's 512 blocks at B 64 run in one wave of
    528, and two splits of them in two."""
    return max(1, min(MAX_SPLITS, capacity // max(1, blocks)))


def split_count(q: torch.Tensor, k_cache: torch.Tensor, packed: bool) -> int:
    """The key splits a call takes on q's card: ``proto_splits`` over the
    blocks of one pass (B for ``decode_packed``, B·KH for ``decode_bf16``)
    at the kernel's capacity there (its blocks an SM x SMs, asked of the
    card once per geometry and cached); without a card, an H100's two
    blocks an SM. From the shapes alone, never from start_pos."""
    B, _, _, D = q.shape
    KH = k_cache.shape[2]
    blocks = B if packed else B * KH
    if q.device.type != "cuda":
        return proto_splits(blocks)
    key = (q.device.index, packed, KH if packed else 1, D)
    if key not in _capacity:
        with torch.cuda.device(q.device):
            _capacity[key] = _library().decode_attention_proto_capacity(int(packed), key[2], D)
        if _capacity[key] <= 0:
            raise RuntimeError(f"decode_attention_proto_capacity failed for {key}")
    return proto_splits(blocks, _capacity[key])


def _run(name: str, q, k_cache, v_cache, block_tables, start_pos, window, sm_scale,
         logit_cap, splits) -> torch.Tensor:
    if splits is not None and not 1 <= int(splits) <= MAX_SPLITS:
        raise ValueError(f"splits must be 1..{MAX_SPLITS}, got {splits}")
    if q.device.type == "cpu":
        return decode_attention_bf16_ref(q, k_cache, v_cache, block_tables, start_pos, window,
                                         sm_scale=sm_scale, logit_cap=logit_cap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    packed = name == "decode_packed"
    check(q, k_cache, v_cache, block_tables, start_pos, packed=packed)
    B, _, H, D = q.shape
    NB, BS, KH = k_cache.shape[:3]
    splits = split_count(q, k_cache, packed) if splits is None else int(splits)
    out = torch.empty_like(q)
    # the splits' partials: acc [splits, B*H, D], then (m, l) [splits, B*H, 2]
    part = (torch.empty(splits * B * H * (D + 2), dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    rc = getattr(_library(), name)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), block_tables.data_ptr(),
        start_pos.data_ptr(), out.data_ptr(), part.data_ptr() if part is not None else None,
        B, H, KH, D, NB, BS, block_tables.shape[1],
        int(window), float(sm_scale) if sm_scale is not None else D**-0.5, float(logit_cap),
        splits, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    launch_counts[name] += 1
    return out


def decode_packed(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                  block_tables: torch.Tensor, start_pos: torch.Tensor, window: int = 0, *,
                  sm_scale: Optional[float] = None, logit_cap: float = 0.0,
                  splits: Optional[int] = None) -> torch.Tensor:
    """[B, 1, H, D] decode attention, one thread block a sequence (and key
    split) holding all of its H rows (the counterpart of
    ``_prof_attn.decode_packed``). ``splits`` forces the number of key
    splits (1..MAX_SPLITS), else ``split_count`` chooses it."""
    return _run("decode_packed", q, k_cache, v_cache, block_tables, start_pos, window, sm_scale,
                logit_cap, splits)


def decode_bf16(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                block_tables: torch.Tensor, start_pos: torch.Tensor, window: int = 0, *,
                sm_scale: Optional[float] = None, logit_cap: float = 0.0,
                splits: Optional[int] = None) -> torch.Tensor:
    """[B, 1, H, D] decode attention, one thread block a (sequence, KV
    head) and key split holding its G rows (the counterpart of
    ``_prof_attn.decode_bf16``). ``splits`` as for ``decode_packed``."""
    return _run("decode_bf16", q, k_cache, v_cache, block_tables, start_pos, window, sm_scale,
                logit_cap, splits)
