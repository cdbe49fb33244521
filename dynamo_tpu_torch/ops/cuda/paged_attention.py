"""Wrappers of the two hand-written paged-attention kernels
(csrc/paged_attention.cu), counterparts of the TPU kernels
``paged_attention_decode_kernel`` and ``paged_attention_kernel`` in
dynamo_tpu/ops/pallas/paged_attention.py.

On a CPU tensor each wrapper returns its plain version
(ops/attention.paged_attention_ref). On a CUDA tensor it checks device,
dtype, shape and contiguity, allocates the output with ``torch.empty``,
launches its kernel on the current stream and raises if the launch was
refused; it never falls back. ``launch_counts`` counts launches per kernel,
so a run can show that its main path went through them.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from dynamo_tpu_torch.ops.cuda import build

DECODE_MAX_ROWS = 64  # C·G query rows one decode block holds
SUPPORTED_HEAD_DIMS = (64, 128)  # the widths csrc/paged_attention.cu is built for

launch_counts: Dict[str, int] = {"paged_attention_decode": 0, "paged_attention_chunk": 0}

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
        lib = build.build("paged_attention").lib
        common = [_I] * 9 + [_F, _F, _P]  # B C H KH D NB BS P window, scale cap, stream
        lib.paged_attention_decode_bf16.argtypes = [_P] * 6 + common
        lib.paged_attention_decode_bf16.restype = _I
        lib.paged_attention_chunk_bf16.argtypes = [_P] * 7 + common
        lib.paged_attention_chunk_bf16.restype = _I
        _lib = lib
    return _lib


def _check(q, k_cache, v_cache, block_tables, start_pos, chunk_lens=None) -> None:
    dev = q.device
    tensors = {"q": q, "k_cache": k_cache, "v_cache": v_cache,
               "block_tables": block_tables, "start_pos": start_pos}
    if chunk_lens is not None:
        tensors["chunk_lens"] = chunk_lens
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("q", "k_cache", "v_cache"):
        if tensors[name].dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {tensors[name].dtype}")
    for name in ("block_tables", "start_pos", "chunk_lens"):
        if name in tensors and tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {tensors[name].dtype}")
    B, C, H, D = q.shape
    NB, BS, KH, Dk = k_cache.shape
    if v_cache.shape != k_cache.shape or Dk != D:
        raise ValueError(f"pool shapes {tuple(k_cache.shape)}/{tuple(v_cache.shape)} vs q {tuple(q.shape)}")
    if H % KH:
        raise ValueError(f"n_heads {H} is not a multiple of n_kv_heads {KH}")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {SUPPORTED_HEAD_DIMS}")
    if 64 % BS:
        raise ValueError(f"block_size {BS} must divide 64")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables shape {tuple(block_tables.shape)} vs batch {B}")
    if start_pos.shape != (B,) or (chunk_lens is not None and chunk_lens.shape != (B,)):
        raise ValueError("start_pos / chunk_lens must be [B]")


def _scale(sm_scale: Optional[float], head_dim: int) -> float:
    return float(sm_scale) if sm_scale is not None else head_dim**-0.5


def paged_attention_decode(
    q: torch.Tensor,  # [B, C, H, D], C·G <= 64
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,
    start_pos: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    window: int = 0,
    logit_cap: float = 0.0,
) -> torch.Tensor:
    """Decode / short-chunk paged attention (counterpart of
    ``paged_attention_decode_kernel``): every one of the C rows counts as
    valid, as in the Pallas decode kernel."""
    B, C, H, D = q.shape
    if q.device.type == "cpu":
        from dynamo_tpu_torch.ops.attention import paged_attention_ref

        full = torch.full((B,), C, dtype=torch.int32)
        return paged_attention_ref(
            q, k_cache, v_cache, block_tables, start_pos, full,
            sm_scale=sm_scale, window=window, logit_cap=logit_cap,
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k_cache, v_cache, block_tables, start_pos)
    KH = k_cache.shape[2]
    if C * (H // KH) > DECODE_MAX_ROWS:
        raise ValueError(f"decode kernel holds C*G <= {DECODE_MAX_ROWS} rows, got {C * (H // KH)}")
    lib = _library()
    out = torch.empty_like(q)
    rc = lib.paged_attention_decode_bf16(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        block_tables.data_ptr(), start_pos.data_ptr(), out.data_ptr(),
        B, C, H, KH, D, k_cache.shape[0], k_cache.shape[1], block_tables.shape[1],
        int(window), _scale(sm_scale, D), float(logit_cap),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged_attention_decode launch failed: cudaError {rc}")
    launch_counts["paged_attention_decode"] += 1
    return out


def paged_attention_chunk(
    q: torch.Tensor,  # [B, C, H, D]
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,
    start_pos: torch.Tensor,
    chunk_lens: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    window: int = 0,
    logit_cap: float = 0.0,
) -> torch.Tensor:
    """Chunked-prefill paged attention for any C with ragged ``chunk_lens``
    (counterpart of ``paged_attention_kernel``). Rows past a sequence's
    chunk length are padding: the kernel writes zeros or finite garbage
    there, and callers never read them."""
    if q.device.type == "cpu":
        from dynamo_tpu_torch.ops.attention import paged_attention_ref

        return paged_attention_ref(
            q, k_cache, v_cache, block_tables, start_pos, chunk_lens,
            sm_scale=sm_scale, window=window, logit_cap=logit_cap,
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k_cache, v_cache, block_tables, start_pos, chunk_lens)
    B, C, H, D = q.shape
    lib = _library()
    out = torch.empty_like(q)
    rc = lib.paged_attention_chunk_bf16(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        block_tables.data_ptr(), start_pos.data_ptr(), chunk_lens.data_ptr(),
        out.data_ptr(),
        B, C, H, k_cache.shape[2], D, k_cache.shape[0], k_cache.shape[1],
        block_tables.shape[1], int(window), _scale(sm_scale, D), float(logit_cap),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"paged_attention_chunk launch failed: cudaError {rc}")
    launch_counts["paged_attention_chunk"] += 1
    return out
