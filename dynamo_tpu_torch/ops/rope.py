"""Rotary position embeddings (non-interleaved / HF "rotate_half" layout) —
counterpart of dynamo_tpu/ops/rope.py."""

from __future__ import annotations

from typing import Tuple

import torch


def rope_table(
    positions: torch.Tensor, head_dim: int, theta: float, scale: float = 1.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for integer positions: [...] → two [..., head_dim]
    float32 tensors. ``scale`` > 1 is HF linear rope_scaling."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = (positions.to(torch.float32)[..., None] / scale) * freqs
    cos = torch.cos(angles)
    sin = torch.sin(angles)
    return torch.cat([cos, cos], dim=-1), torch.cat([sin, sin], dim=-1)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [..., n_heads, head_dim]; cos/sin: [..., head_dim] (broadcast over
    heads). Rotates in float32 and rounds back to x's dtype."""
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    xf = x.to(torch.float32)
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)
