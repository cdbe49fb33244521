"""Wrappers of the two hand-written paged-attention kernels
(csrc/paged_attention.cu), counterparts of the TPU kernels
``paged_attention_decode_kernel`` and ``paged_attention_kernel`` in
dynamo_tpu/ops/pallas/paged_attention.py.

Each wrapper takes bf16 pools or int8 pools ``{"q8", "s"}``
(ops/kv_quant.py) and launches the kernel's variant for that pool type:
``paged_attention_{decode,chunk}_bf16`` or ``..._int8``. On a CPU tensor
it returns its plain version (ops/attention.paged_attention_ref). On a CUDA
tensor it checks device, dtype, shape and contiguity, allocates the output
with ``torch.empty``, launches its kernel on the current stream and raises
if the launch was refused; it never falls back. ``launch_counts`` (bf16
pools) and ``int8_launch_counts`` (int8 pools) count launches per kernel,
so a run can show which kernels its main path went through.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from dynamo_tpu_torch.ops.cuda import build
from dynamo_tpu_torch.ops.kv_quant import KVPool, is_quantized_pool, pool_values

DECODE_MAX_ROWS = 64  # C·G query rows one decode block holds
# The widths csrc/paged_attention.cu is built for, over both pool types.
HEAD_DIMS = (64, 128, 256)

launch_counts: Dict[str, int] = {"paged_attention_decode": 0, "paged_attention_chunk": 0}
int8_launch_counts: Dict[str, int] = {"paged_attention_decode_int8": 0,
                                      "paged_attention_chunk_int8": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_lib: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for counts in (launch_counts, int8_launch_counts):
        for name in counts:
            counts[name] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.build("paged_attention").lib
        common = [_I] * 9 + [_F, _F, _P]  # B C H KH D NB BS P window, scale cap, stream
        lib.paged_attention_decode_bf16.argtypes = [_P] * 6 + common
        lib.paged_attention_decode_bf16.restype = _I
        lib.paged_attention_chunk_bf16.argtypes = [_P] * 7 + common
        lib.paged_attention_chunk_bf16.restype = _I
        # int8: q, k codes, k scales, v codes, v scales, tables, start, [lens,] out
        lib.paged_attention_decode_int8.argtypes = [_P] * 8 + common
        lib.paged_attention_decode_int8.restype = _I
        lib.paged_attention_chunk_int8.argtypes = [_P] * 9 + common
        lib.paged_attention_chunk_int8.restype = _I
        _lib = lib
    return _lib


def check_block_size(block_size: int) -> None:
    """The block sizes the kernels take: those that divide 64 (a 64-key
    tile holds whole pages) and the multiples of 64 up to 256 (a page spans
    whole tiles), as the TPU kernels take both; any other raises."""
    BS = int(block_size)
    if BS <= 0 or not (64 % BS == 0 or (BS % 64 == 0 and BS <= 256)):
        raise ValueError(f"block_size {BS} must divide 64 or be a multiple of 64 up to 256")


def _check(q, k_cache: KVPool, v_cache: KVPool, block_tables, start_pos, chunk_lens=None) -> None:
    """Device, dtype, shape and contiguity of one call. A pool is bf16
    [NB, BS, KH, D], or int8 codes of that shape with float32 scales
    [NB, KH, BS]; K and V are of one kind."""
    dev = q.device
    quantized = is_quantized_pool(k_cache)
    if is_quantized_pool(v_cache) != quantized:
        raise TypeError("k_cache and v_cache must both be int8 pools or both bf16 pools")
    k, v = pool_values(k_cache), pool_values(v_cache)
    tensors = {"q": q, "k_cache": k, "v_cache": v,
               "block_tables": block_tables, "start_pos": start_pos}
    if quantized:
        tensors["k_scales"] = k_cache["s"]
        tensors["v_scales"] = v_cache["s"]
    if chunk_lens is not None:
        tensors["chunk_lens"] = chunk_lens
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"q must be bfloat16, got {q.dtype}")
    pool_dtype = torch.int8 if quantized else torch.bfloat16
    for name in ("k_cache", "v_cache"):
        if tensors[name].dtype != pool_dtype:
            raise TypeError(f"{name} must be {pool_dtype}, got {tensors[name].dtype}")
    for name in ("block_tables", "start_pos", "chunk_lens"):
        if name in tensors and tensors[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {tensors[name].dtype}")
    B, C, H, D = q.shape
    NB, BS, KH, Dk = k.shape
    if v.shape != k.shape or Dk != D:
        raise ValueError(f"pool shapes {tuple(k.shape)}/{tuple(v.shape)} vs q {tuple(q.shape)}")
    if quantized:
        for name in ("k_scales", "v_scales"):
            t = tensors[name]
            if t.dtype != torch.float32 or t.shape != (NB, KH, BS):
                raise TypeError(f"{name} must be float32 {(NB, KH, BS)}, got {t.dtype} "
                                f"{tuple(t.shape)}")
    if H % KH:
        raise ValueError(f"n_heads {H} is not a multiple of n_kv_heads {KH}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    check_block_size(BS)
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables shape {tuple(block_tables.shape)} vs batch {B}")
    if start_pos.shape != (B,) or (chunk_lens is not None and chunk_lens.shape != (B,)):
        raise ValueError("start_pos / chunk_lens must be [B]")


def _pool_pointers(k_cache: KVPool, v_cache: KVPool):
    """The pool arguments of a launch: (k, v) for bf16 pools, (k codes, k
    scales, v codes, v scales) for int8 pools."""
    if is_quantized_pool(k_cache):
        return (k_cache["q8"].data_ptr(), k_cache["s"].data_ptr(),
                v_cache["q8"].data_ptr(), v_cache["s"].data_ptr())
    return k_cache.data_ptr(), v_cache.data_ptr()


def _scale(sm_scale: Optional[float], head_dim: int) -> float:
    return float(sm_scale) if sm_scale is not None else head_dim**-0.5


def paged_attention_decode(
    q: torch.Tensor,  # [B, C, H, D], C·G <= 64
    k_cache: KVPool,
    v_cache: KVPool,
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
    quantized = is_quantized_pool(k_cache)
    NB, BS, KH = pool_values(k_cache).shape[:3]
    if C * (H // KH) > DECODE_MAX_ROWS:
        raise ValueError(f"decode kernel holds C*G <= {DECODE_MAX_ROWS} rows, got {C * (H // KH)}")
    lib = _library()
    name = "paged_attention_decode_int8" if quantized else "paged_attention_decode"
    launch = lib.paged_attention_decode_int8 if quantized else lib.paged_attention_decode_bf16
    out = torch.empty_like(q)
    rc = launch(
        q.data_ptr(), *_pool_pointers(k_cache, v_cache),
        block_tables.data_ptr(), start_pos.data_ptr(), out.data_ptr(),
        B, C, H, KH, D, NB, BS, block_tables.shape[1],
        int(window), _scale(sm_scale, D), float(logit_cap),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    (int8_launch_counts if quantized else launch_counts)[name] += 1
    return out


def paged_attention_chunk(
    q: torch.Tensor,  # [B, C, H, D]
    k_cache: KVPool,
    v_cache: KVPool,
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
    quantized = is_quantized_pool(k_cache)
    NB, BS, KH = pool_values(k_cache).shape[:3]
    lib = _library()
    name = "paged_attention_chunk_int8" if quantized else "paged_attention_chunk"
    launch = lib.paged_attention_chunk_int8 if quantized else lib.paged_attention_chunk_bf16
    out = torch.empty_like(q)
    rc = launch(
        q.data_ptr(), *_pool_pointers(k_cache, v_cache),
        block_tables.data_ptr(), start_pos.data_ptr(), chunk_lens.data_ptr(),
        out.data_ptr(),
        B, C, H, KH, D, NB, BS,
        block_tables.shape[1], int(window), _scale(sm_scale, D), float(logit_cap),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    (int8_launch_counts if quantized else launch_counts)[name] += 1
    return out
