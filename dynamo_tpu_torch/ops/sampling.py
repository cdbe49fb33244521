"""Batched token sampling — counterpart of dynamo_tpu/ops/sampling.py.

Greedy / temperature / top-k / top-p / min-p with per-row parameters,
filtered inside the exact top-``SAMPLE_WIDTH`` logits (``torch.topk``): the
JAX function's CPU branch (sampling.py:75). Its TPU-only ``approx_max_k``
branch is not ported.

Noise: each row's Gumbel noise is a pure function of (engine seed, sequence
salt, token index) — the contract of the JAX ``fold_row_keys``
(sampling.py:24-41) that makes a sequence's stream independent of slot,
batch and dispatch order, and lets preemption-by-recompute redraw the same
noise. The bits come from a counter-based integer hash, not JAX's threefry,
so sampled (temperature > 0) streams differ from the JAX package's; greedy
streams are the same.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
SAMPLE_WIDTH = 64  # candidates considered by top-k/top-p filtering

_M32 = 0xFFFFFFFF


def _mix32(x):
    """32-bit avalanche hash of int64 tensors (or Python ints) holding
    uint32 values (the products stay below 2^59, so int64 arithmetic is
    exact)."""
    x = x & _M32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    return (x >> 16) ^ x


def fold_row_keys(seed: int, salts: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Per-row keys [B] (int64 holding uint32): a function of (seed, salt,
    position) only. The seed's hash is taken on the host, so the keys need
    no host-to-device copy (a decode step is captured in a CUDA graph)."""
    base = _mix32(int(seed) & _M32)
    k = _mix32(base ^ (salts.to(torch.int64) & _M32))
    return _mix32(k ^ (((positions.to(torch.int64) & _M32) * 0x7FEB352D) & _M32))


def row_gumbel(row_keys: torch.Tensor, width: int) -> torch.Tensor:
    """[B, width] float32 Gumbel noise drawn from each row's key."""
    cols = torch.arange(width, dtype=torch.int64, device=row_keys.device)
    h = _mix32(row_keys[:, None] ^ _mix32(cols * 0x85EBCA6B + 0x27D4EB2F)[None, :])
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))  # (0, 1)
    return -torch.log(-torch.log(u))


def sample_tokens(
    logits: torch.Tensor,  # [B, V]
    temperature: torch.Tensor,  # [B]; <= 0 means greedy
    top_k: torch.Tensor,  # [B]; <= 0 means off
    top_p: torch.Tensor,  # [B]; >= 1 means off
    min_p: Optional[torch.Tensor] = None,  # [B]; <= 0 means off
    *,
    row_keys: torch.Tensor,  # [B] (fold_row_keys)
) -> torch.Tensor:
    """Returns sampled token ids [B] (int64). Each row's noise comes from its
    key, so a row's sample depends only on its own (key, logits, params)."""
    W = min(SAMPLE_WIDTH, logits.shape[1])
    raw_top, top_idx = torch.topk(logits, W, dim=-1)  # [B, W] descending
    temp = torch.clamp(temperature.to(torch.float32), min=1e-6)[:, None]
    top_logits = raw_top.to(torch.float32) / temp

    ranks = torch.arange(W, device=logits.device)[None, :]
    k = torch.where(top_k > 0, torch.clamp(top_k, max=W), torch.full_like(top_k, W))
    keep = ranks < k[:, None]
    probs = torch.softmax(top_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # Keep tokens while the mass before them is < top_p (the first always).
    keep = keep & ((cum - probs) < torch.clamp(top_p.to(torch.float32), 0.0, 1.0)[:, None])
    if min_p is not None:
        floor = torch.clamp(min_p.to(torch.float32), 0.0, 1.0)[:, None] * probs[:, :1]
        keep = keep & (probs >= floor)
    masked = torch.where(keep, top_logits, torch.full_like(top_logits, NEG_INF))
    choice = torch.argmax(masked + row_gumbel(row_keys, W), dim=-1)
    sampled = torch.gather(top_idx, 1, choice[:, None])[:, 0]
    # Greedy: the FIRST maximal logit, as lax.top_k's stable order picks.
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled)


def log_softmax_f32(logits: torch.Tensor) -> torch.Tensor:
    """[B, V] float32 log-probabilities."""
    return torch.log_softmax(logits.to(torch.float32), dim=-1)


def pick_logprobs(logp: torch.Tensor, token_ids: torch.Tensor) -> torch.Tensor:
    """[B] entries of ``logp`` [B, V] at ``token_ids`` [B]."""
    return torch.gather(logp, 1, token_ids.to(torch.int64)[:, None])[:, 0]


def top_of(logp: torch.Tensor, n: int):
    """([B, n] values, [B, n] int64 ids) of ``logp``'s n largest entries,
    descending, ties to the lower id (``lax.top_k``'s order). The order is
    exact: each float32 is mapped to an order-preserving int32 and paired
    with its reversed id in one int64 key, so ``torch.topk`` (whose order
    among equal values is unspecified) meets no tie."""
    bits = logp.contiguous().view(torch.int32)
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
    V = logp.shape[-1]
    rev = (V - 1) - torch.arange(V, dtype=torch.int64, device=logp.device)
    _, ids = torch.topk(ordered * (1 << 32) + rev, n, dim=-1)
    return torch.gather(logp, 1, ids), ids


def compute_logprobs(logits: torch.Tensor, token_ids: torch.Tensor) -> torch.Tensor:
    """Log-probability [B] (float32) of the chosen tokens."""
    return pick_logprobs(log_softmax_f32(logits), token_ids)


def top_logprobs(logits: torch.Tensor, n: int):
    """Top-n (logprobs [B, n] float32, ids [B, n] int64) a row, descending."""
    return top_of(log_softmax_f32(logits), n)
