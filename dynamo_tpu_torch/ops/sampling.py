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

``spec_verify_sample`` is the speculative verify (sampling.py:130-233):
greedy rows accept the proposals that match the argmax, sampled rows run
rejection sampling with the same filtering; its noise is keyed the same
way, by the token index each position decides.
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


# Tags folded into a verify position's key so its acceptance uniform and its
# Gumbel noise are independent draws (spec_verify_sample).
SPEC_UNIFORM_TAG = 0x2545F491
SPEC_GUMBEL_TAG = 0x9E3779B9


def row_uniform(row_keys: torch.Tensor) -> torch.Tensor:
    """One float32 uniform in (0, 1) a key, any shape."""
    h = _mix32(row_keys)
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def spec_verify_sample(
    logits: torch.Tensor,  # [B, C, V]: position i decides token i + 1
    proposals: torch.Tensor,  # [B, C - 1] draft tokens (a one-hot draft)
    prop_len: torch.Tensor,  # [B] valid proposals a row
    temperature: torch.Tensor,  # [B]; <= 0 greedy
    top_k: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
    *,
    row_keys: torch.Tensor,  # [B, C] (fold_row_keys of each position's token index)
):
    """Speculative verify with rejection sampling (Leviathan/Chen), the
    counterpart of JAX's ``spec_verify_sample`` (sampling.py:130-233).

    Greedy rows (temperature <= 0) accept the run of proposals equal to the
    argmax, and the first mismatch (or the bonus position) emits the
    argmax. Sampled rows filter as ``sample_tokens`` does (temperature,
    top-k, top-p inside the top SAMPLE_WIDTH) and accept proposal x where
    u < p(x); a rejection resamples from p with x zeroed (max(p - q, 0) of
    the one-hot draft, renormalised), a full accept takes a bonus sample.

    Noise: position i's uniform and Gumbel draws come from ``row_keys[:,
    i]`` with SPEC_UNIFORM_TAG and SPEC_GUMBEL_TAG folded in, keyed by the
    token index the position decides, never by a dispatch counter (JAX
    folds a host step counter into its key, runner.py:1206-1208): the
    verify is a captured CUDA graph, and a counter baked into it would
    replay the same noise. Greedy rows equal JAX's exactly; sampled rows
    draw from the same target distribution with other bits.

    Returns (emitted [B, C] int64, counts [B] int64): a row's first
    counts[b] entries are the accepted proposals and the corrected (or
    bonus) token, the rest 0."""
    B, C, V = logits.shape
    W = min(SAMPLE_WIDTH, V)
    N = B * C
    dev = logits.device
    flat = logits.reshape(N, V)
    raw_top, top_idx = torch.topk(flat, W, dim=-1)  # [N, W] descending

    def rep(a):  # [B] -> [N]
        return a.repeat_interleave(C, dim=0)

    temp = rep(temperature.to(torch.float32))
    top_logits = raw_top.to(torch.float32) / torch.clamp(temp, min=1e-6)[:, None]
    ranks = torch.arange(W, device=dev)[None, :]
    tk = rep(top_k)
    k = torch.where(tk > 0, torch.clamp(tk, max=W), torch.full_like(tk, W))
    keep = ranks < k[:, None]
    probs = torch.softmax(top_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = keep & ((cum - probs) < torch.clamp(rep(top_p).to(torch.float32), 0.0, 1.0)[:, None])
    masked = torch.where(keep, top_logits, torch.full_like(top_logits, NEG_INF))

    # each position's draft: proposals shifted onto the logit positions
    # (the last position has none; past prop_len they are masked below)
    props = torch.cat([proposals.to(torch.int64),
                       torch.zeros((B, 1), dtype=torch.int64, device=dev)], dim=1)  # [B, C]
    prop_pos = props.reshape(N)
    match = top_idx == prop_pos[:, None]  # [N, W]
    pr = torch.softmax(masked, dim=-1)  # the filtered target, renormalised
    p_prop = torch.where(match & keep, pr, torch.zeros_like(pr)).sum(dim=-1)  # [N]

    keys = row_keys.reshape(N).to(torch.int64)
    u = row_uniform(keys ^ SPEC_UNIFORM_TAG)
    gumbel = row_gumbel(_mix32(keys ^ SPEC_GUMBEL_TAG), W)

    greedy = temp <= 0.0
    argmax_tok = torch.argmax(flat, dim=-1)  # the first maximal logit
    accept = torch.where(greedy, prop_pos == argmax_tok, u < p_prop)
    choice = torch.argmax(masked + gumbel, dim=-1)
    sample = torch.gather(top_idx, 1, choice[:, None])[:, 0]
    masked_excl = torch.where(match, torch.full_like(masked, NEG_INF), masked)
    choice_r = torch.argmax(masked_excl + gumbel, dim=-1)
    resample = torch.gather(top_idx, 1, choice_r[:, None])[:, 0]
    sample = torch.where(greedy, argmax_tok, sample).reshape(B, C)
    resample = torch.where(greedy, argmax_tok, resample).reshape(B, C)
    accept = accept.reshape(B, C)

    pl = torch.clamp(prop_len.to(torch.int64), min=0)[:, None]  # [B, 1]
    pos = torch.arange(C, device=dev)[None, :]
    run = torch.cumprod((accept & (pos < pl)).to(torch.int64), dim=1)
    n_acc = run.sum(dim=1)  # [B] accepted proposals
    at = n_acc[:, None]
    final = torch.where(n_acc < pl[:, 0], torch.gather(resample, 1, at)[:, 0],
                        torch.gather(sample, 1, at)[:, 0])
    emitted = torch.where(pos < at, props,
                          torch.where(pos == at, final[:, None], torch.zeros_like(props)))
    return emitted, n_acc + 1


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
