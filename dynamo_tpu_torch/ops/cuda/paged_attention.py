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

The decode wrapper splits each sequence's keys over ``split_count(...)``
blocks (flash-decoding), a count taken from the shapes and the split
kernel's occupancy alone, so the step reads nothing back from the card.
With more than one split it allocates the partials' workspace with
``torch.empty`` and the library launches the split kernel and its combine;
that call counts once.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from dynamo_tpu_torch.ops.cuda import build
from dynamo_tpu_torch.ops.kv_quant import KVPool, is_quantized_pool, pool_values

DECODE_MAX_ROWS = 64  # C·G query rows one decode block holds
MAX_SPLITS = 16
# Split blocks an H100 holds at once when two fit an SM (132 SMs): the
# capacity decode_splits assumes where the card is not asked.
H100_CAPACITY = 2 * 132
# The widths csrc/paged_attention.cu is built for, over both pool types.
HEAD_DIMS = (64, 128, 256)

launch_counts: Dict[str, int] = {"paged_attention_decode": 0, "paged_attention_chunk": 0}
int8_launch_counts: Dict[str, int] = {"paged_attention_decode_int8": 0,
                                      "paged_attention_chunk_int8": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_lib: Optional[ctypes.CDLL] = None
_capacity: Dict[tuple, int] = {}


def reset_launch_counts() -> None:
    for counts in (launch_counts, int8_launch_counts):
        for name in counts:
            counts[name] = 0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.build("paged_attention").lib
        common = [_I] * 9 + [_F, _F, _P]  # B C H KH D NB BS P window, scale cap, stream
        decode = [_I] * 9 + [_F, _F, _I, _P]  # the same with splits before the stream
        # decode: ..., out, part (the splits' workspace, or null), B, ...
        lib.paged_attention_decode_bf16.argtypes = [_P] * 7 + decode
        lib.paged_attention_decode_bf16.restype = _I
        lib.paged_attention_chunk_bf16.argtypes = [_P] * 7 + common
        lib.paged_attention_chunk_bf16.restype = _I
        # int8: q, k codes, k scales, v codes, v scales, tables, start, [lens,] out
        lib.paged_attention_decode_int8.argtypes = [_P] * 9 + decode
        lib.paged_attention_decode_int8.restype = _I
        lib.paged_attention_chunk_int8.argtypes = [_P] * 9 + common
        lib.paged_attention_chunk_int8.restype = _I
        lib.paged_attention_decode_capacity.argtypes = [_I] * 3  # int8, small, D
        lib.paged_attention_decode_capacity.restype = _I
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


def decode_tile(rows: int, head_dim: int) -> int:
    """Keys a decode block's tile holds, the unit its splits share out: the
    decode layout's 16384 / D for C·G <= 8 rows, else the 64-row layout's
    64."""
    return 16384 // head_dim if rows <= 8 else 64


def decode_splits(B: int, KH: int, row_blocks: int = 1, capacity: int = H100_CAPACITY) -> int:
    """How many blocks a decode call splits each (sequence, KV head)'s keys
    over. While the B·KH·row_blocks blocks of one pass would leave the card
    less than full (fewer than ``capacity``, the split blocks it holds at
    once), as many splits as fill it once, at least 2 and at most
    MAX_SPLITS; otherwise 1, the one-pass kernel. From the shapes alone:
    never from start_pos, which lives on the card, so a decode step reads
    nothing back to choose it. More splits than fit at once run in waves
    and only add partials to combine."""
    blocks = max(1, B * KH * row_blocks)
    if blocks >= capacity:
        return 1
    return min(MAX_SPLITS, max(2, capacity // blocks))


def split_count(q: torch.Tensor, k_cache: KVPool) -> int:
    """The split count the decode wrapper takes for these shapes on q's
    card: decode_splits at the split kernel's capacity there (its blocks an
    SM, asked of the card once per kernel variant and cached)."""
    B, C, H, D = q.shape
    KH = pool_values(k_cache).shape[2]
    if q.device.type != "cuda":  # no card to ask: an H100's capacity
        return decode_splits(B, KH)
    key = (q.device.index, is_quantized_pool(k_cache), C * (H // KH) <= 8, D)
    if key not in _capacity:
        with torch.cuda.device(q.device):
            _capacity[key] = _library().paged_attention_decode_capacity(
                int(key[1]), int(key[2]), D)
        if _capacity[key] <= 0:
            raise RuntimeError(f"paged_attention_decode_capacity failed for {key}")
    return decode_splits(B, KH, capacity=_capacity[key])


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
    splits: Optional[int] = None,
) -> torch.Tensor:
    """Decode / short-chunk paged attention (counterpart of
    ``paged_attention_decode_kernel``): every one of the C rows counts as
    valid, as in the Pallas decode kernel. ``splits`` forces the number of
    key splits (1..MAX_SPLITS; tests and chip_smoke.py use it), else
    ``split_count`` chooses it."""
    B, C, H, D = q.shape
    if splits is not None and not 1 <= int(splits) <= MAX_SPLITS:
        raise ValueError(f"splits must be 1..{MAX_SPLITS}, got {splits}")
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
    splits = split_count(q, k_cache) if splits is None else int(splits)
    lib = _library()
    name = "paged_attention_decode_int8" if quantized else "paged_attention_decode"
    launch = lib.paged_attention_decode_int8 if quantized else lib.paged_attention_decode_bf16
    out = torch.empty_like(q)
    # the splits' partials: acc [splits, B*C*H, D], then (m, l) [splits, B*C*H, 2]
    part = (torch.empty(splits * B * C * H * (D + 2), dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    rc = launch(
        q.data_ptr(), *_pool_pointers(k_cache, v_cache),
        block_tables.data_ptr(), start_pos.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None,
        B, C, H, KH, D, NB, BS, block_tables.shape[1],
        int(window), _scale(sm_scale, D), float(logit_cap), splits,
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
    (counterpart of ``paged_attention_kernel``), on the tensor cores: its
    plain emulation is ops/attention.paged_attention_chunk_mma_ref. Rows
    past a sequence's chunk length are padding: the kernel writes zeros or
    finite garbage there, and callers never read them."""
    if q.device.type == "cpu":
        from dynamo_tpu_torch.ops.attention import paged_attention_ref

        return paged_attention_ref(
            q, k_cache, v_cache, block_tables, start_pos, chunk_lens,
            sm_scale=sm_scale, window=window, logit_cap=logit_cap,
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k_cache, v_cache, block_tables, start_pos, chunk_lens)
    if q.data_ptr() % 16 or any(t.data_ptr() % 16 for t in (pool_values(k_cache),
                                                             pool_values(v_cache))):
        raise ValueError("q and the pools must be 16-byte aligned (16-byte copies)")
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
