"""Int8 KV-cache quantization (per-token-per-head dynamic scales) —
counterpart of dynamo_tpu/ops/kv_quant.py.

A quantized pool is a dict, in the JAX package's layout exactly:

    {"q8": int8 [num_blocks, block_size, KH, D],
     "s":  float32 [num_blocks, KH, block_size]}

block_size is last in the scales (the TPU kernel reads ``s[block, h]`` as
one lane vector). Later slices move these pools over the disagg wire, so
the layout is fixed. A token's scale is its absmax over head_dim / 127,
taken when the token is written (ops/attention.write_chunk_to_cache); the
codes round half to even and clip to ±127. Against bf16 pools this halves
the bytes of every page read and doubles the tokens a pool holds.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch

KVPool = Union[torch.Tensor, Dict[str, torch.Tensor]]


def is_quantized_pool(pool: Any) -> bool:
    return isinstance(pool, dict) and "q8" in pool


def pool_values(pool: KVPool) -> torch.Tensor:
    """The [NB, BS, KH, D] tensor of a pool: the codes of an int8 pool."""
    return pool["q8"] if is_quantized_pool(pool) else pool


def quantize_kv_chunk(chunk: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., KH, D] float → (codes int8 [..., KH, D], scales float32
    [..., KH]): scale max(absmax, 1e-8) / 127 in float32, codes
    round-half-to-even of x / scale clipped to ±127 (the JAX
    ``quantize_kv_chunk``, bit for bit)."""
    xf = chunk.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1)
    s = torch.clamp_min(amax, 1e-8) / 127.0
    q8 = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q8, s


def dequantize_pages(
    q8: torch.Tensor,  # [..., BS, KH, D] int8 (gathered pages)
    s: torch.Tensor,  # [..., KH, BS] float32 (their scales)
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Dense dequantization of gathered pages: codes × their token's scale."""
    s_t = torch.swapaxes(s, -1, -2)[..., None]  # [..., BS, KH, 1]
    return (q8.to(torch.float32) * s_t).to(dtype)


def dequantize_pool(pool: KVPool, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """A whole pool as [NB, BS, KH, D] in ``dtype``."""
    if not is_quantized_pool(pool):
        return pool.to(dtype)
    return dequantize_pages(pool["q8"], pool["s"], dtype)
