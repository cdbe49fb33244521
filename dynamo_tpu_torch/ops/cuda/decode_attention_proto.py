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
launches per kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from dynamo_tpu_torch.ops.cuda import build
from dynamo_tpu_torch.ops.cuda.paged_attention import check_block_size

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


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.build("decode_attention_proto").lib
        # q k v tables start out, B H KH D NB BS P window, scale cap, stream
        argtypes = [_P] * 6 + [_I] * 8 + [_F, _F, _P]
        for fn in (lib.decode_packed, lib.decode_bf16):
            fn.argtypes = argtypes
            fn.restype = _I
        _lib = lib
    return _lib


def check(q, k_cache, v_cache, block_tables, start_pos, packed: bool) -> None:
    """What the kernels take: bf16 q [B, 1, H, D] and pools [NB, BS, KH, D]
    at D 128 or 256, int32 tables [B, P] and starts [B], all contiguous on
    one device; G = H / KH at most 8, and for ``decode_packed`` all of a
    sequence's rows (H <= 64) and KH x D <= 2,048 in one block; a block
    size that ``paged_attention.check_block_size`` admits."""
    tensors = {"q": q, "k_cache": k_cache, "v_cache": v_cache,
               "block_tables": block_tables, "start_pos": start_pos}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
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


def _run(name: str, q, k_cache, v_cache, block_tables, start_pos, window, sm_scale,
         logit_cap) -> torch.Tensor:
    if q.device.type == "cpu":
        from dynamo_tpu_torch.ops.attention import decode_attention_bf16_ref

        return decode_attention_bf16_ref(q, k_cache, v_cache, block_tables, start_pos, window,
                                         sm_scale=sm_scale, logit_cap=logit_cap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    check(q, k_cache, v_cache, block_tables, start_pos, packed=name == "decode_packed")
    B, _, H, D = q.shape
    NB, BS, KH = k_cache.shape[:3]
    out = torch.empty_like(q)
    rc = getattr(_library(), name)(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), block_tables.data_ptr(),
        start_pos.data_ptr(), out.data_ptr(), B, H, KH, D, NB, BS, block_tables.shape[1],
        int(window), float(sm_scale) if sm_scale is not None else D**-0.5, float(logit_cap),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    launch_counts[name] += 1
    return out


def decode_packed(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                  block_tables: torch.Tensor, start_pos: torch.Tensor, window: int = 0, *,
                  sm_scale: Optional[float] = None, logit_cap: float = 0.0) -> torch.Tensor:
    """[B, 1, H, D] decode attention, one thread block a sequence holding
    all of its H rows (the counterpart of ``_prof_attn.decode_packed``)."""
    return _run("decode_packed", q, k_cache, v_cache, block_tables, start_pos, window, sm_scale,
                logit_cap)


def decode_bf16(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                block_tables: torch.Tensor, start_pos: torch.Tensor, window: int = 0, *,
                sm_scale: Optional[float] = None, logit_cap: float = 0.0) -> torch.Tensor:
    """[B, 1, H, D] decode attention, one thread block a (sequence, KV
    head) holding its G rows (the counterpart of ``_prof_attn.decode_bf16``)."""
    return _run("decode_bf16", q, k_cache, v_cache, block_tables, start_pos, window, sm_scale,
                logit_cap)
