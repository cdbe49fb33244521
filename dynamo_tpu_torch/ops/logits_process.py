"""Logits processors (penalties, bias, bans) — counterpart of
dynamo_tpu/ops/logits_process.py.

Every processor is batched and gated by per-row parameters, so one decode
program serves a mixed batch: a row that asked for none carries neutral
parameters (rep 1, pres = freq = 0, empty bias), under which ``apply`` is
the identity for that row. The token bookkeeping ([B, V] output counts and
a prompt-membership mask) lives on the device and is updated in place
inside the decode burst (``record_tokens``), so the same code runs eagerly
and under CUDA graph capture: every op has a fixed shape and reads nothing
back to the host.

``logit_bias`` is a fixed number of (token, bias) slots a row
(MAX_BIAS_SLOTS); an empty slot (id -1) adds into a spare column past the
vocabulary that is sliced off, where the JAX scatter drops it. Banned
tokens are bias slots of BAN_BIAS.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

# The OpenAI API's 300 logit_bias entries at most, as the JAX module.
MAX_BIAS_SLOTS = 300
BAN_BIAS = -1e9  # effectively -inf but safe in float32 arithmetic


class ProcParams(NamedTuple):
    """Per-row processor parameters ([B] unless noted)."""

    rep: torch.Tensor  # repetition penalty; 1.0 = off
    pres: torch.Tensor  # presence penalty; 0.0 = off
    freq: torch.Tensor  # frequency penalty; 0.0 = off
    bias_ids: torch.Tensor  # [B, MAX_BIAS_SLOTS] int; -1 = empty slot
    bias_vals: torch.Tensor  # [B, MAX_BIAS_SLOTS] float32


class ProcState(NamedTuple):
    """Per-row device bookkeeping of the penalties, updated in place."""

    out_counts: torch.Tensor  # [B, V] int32: generated-token counts
    prompt_mask: torch.Tensor  # [B, V] bool: the token is in the prompt


def neutral_params(batch: int, device=None) -> ProcParams:
    return ProcParams(
        rep=torch.ones(batch, dtype=torch.float32, device=device),
        pres=torch.zeros(batch, dtype=torch.float32, device=device),
        freq=torch.zeros(batch, dtype=torch.float32, device=device),
        bias_ids=torch.full((batch, MAX_BIAS_SLOTS), -1, dtype=torch.int64, device=device),
        bias_vals=torch.zeros(batch, MAX_BIAS_SLOTS, dtype=torch.float32, device=device),
    )


def init_state(batch: int, vocab: int, device=None) -> ProcState:
    return ProcState(
        out_counts=torch.zeros(batch, vocab, dtype=torch.int32, device=device),
        prompt_mask=torch.zeros(batch, vocab, dtype=torch.bool, device=device),
    )


def _repetition(logits: torch.Tensor, seen: torch.Tensor, rep: torch.Tensor) -> torch.Tensor:
    """HF repetition penalty on the seen tokens: positive logits divided,
    the others multiplied."""
    rp = rep.to(torch.float32)[:, None]
    return torch.where(seen, torch.where(logits > 0, logits / rp, logits * rp), logits)


def apply(logits: torch.Tensor, params: ProcParams, state: Optional[ProcState]) -> torch.Tensor:
    """Penalties, then bias; float32 [B, V]. Neutral parameters leave a
    row as it was (cast to float32)."""
    logits = logits.to(torch.float32)
    if state is not None:
        counts = state.out_counts
        generated = counts > 0
        # repetition penalty over prompt and output tokens (HF semantics)
        logits = _repetition(logits, generated | state.prompt_mask, params.rep)
        # OpenAI additive penalties, output tokens only
        logits = logits - params.freq.to(torch.float32)[:, None] * counts.to(torch.float32)
        logits = logits - params.pres.to(torch.float32)[:, None] * generated.to(torch.float32)
    return _add_bias(logits, params)


def apply_prompt_only(logits: torch.Tensor, prompt_mask: torch.Tensor,
                      params: ProcParams) -> torch.Tensor:
    """The prefill step's form: at the first sampled token no output token
    exists yet, so presence and frequency penalties are zero; only the
    repetition penalty over the prompt and the bias apply."""
    logits = _repetition(logits.to(torch.float32), prompt_mask, params.rep)
    return _add_bias(logits, params)


def _add_bias(logits: torch.Tensor, params: ProcParams) -> torch.Tensor:
    """Per-row sparse bias. Empty slots (-1) land in a spare column past
    the vocabulary, which is sliced off: a fixed-shape drop."""
    B, V = logits.shape
    ids = params.bias_ids.to(torch.int64)
    idx = torch.where(ids >= 0, ids, torch.full_like(ids, V))
    vals = torch.where(ids >= 0, params.bias_vals.to(torch.float32),
                       torch.zeros_like(params.bias_vals, dtype=torch.float32))
    ext = torch.nn.functional.pad(logits, (0, 1))
    ext.scatter_add_(1, idx, vals)
    return ext[:, :V]


def record_tokens(state: ProcState, tokens: torch.Tensor, active: torch.Tensor) -> ProcState:
    """Count one generated token a row, in place: inactive rows add 0."""
    state.out_counts.scatter_add_(1, tokens.to(torch.int64)[:, None],
                                  active.to(torch.int32)[:, None])
    return state


def prompt_hot(tokens, vocab: int) -> np.ndarray:
    """[V] bool membership mask of a token list (ids outside the vocabulary
    dropped)."""
    hot = np.zeros((vocab,), dtype=np.bool_)
    toks = np.asarray(tokens, dtype=np.int64)
    hot[toks[(toks >= 0) & (toks < vocab)]] = True
    return hot


def _valid_ids(tokens, vocab: int, device) -> torch.Tensor:
    toks = np.asarray(tokens, dtype=np.int64).reshape(-1)
    return torch.from_numpy(toks[(toks >= 0) & (toks < vocab)]).to(device)


def reset_slot(state: ProcState, slot: int, prompt_tokens, generated_tokens=()) -> ProcState:
    """Set one row's bookkeeping at admission, in place: the prompt's
    membership mask, and the output counts of ``generated_tokens`` (a
    preempted sequence re-admitted keeps its history, so presence and
    frequency penalties keep applying to it)."""
    vocab = state.prompt_mask.shape[1]
    dev = state.out_counts.device
    gen = _valid_ids(generated_tokens, vocab, dev)
    row = state.out_counts[slot]
    row.zero_()
    row.index_add_(0, gen, torch.ones(gen.shape, dtype=torch.int32, device=dev))
    mask = state.prompt_mask[slot]
    mask.zero_()
    mask.index_fill_(0, _valid_ids(prompt_tokens, vocab, dev), True)
    return state


def count_token(state: ProcState, slot: int, token: int) -> ProcState:
    """Count one generated token of a row (the prefill's first token), in
    place; an id outside the vocabulary is dropped."""
    if 0 <= int(token) < state.out_counts.shape[1]:
        state.out_counts[int(slot), int(token)] += 1
    return state


def pack_bias(logit_bias, vocab: int):
    """An OpenAI ``logit_bias`` dict as fixed (ids, vals) slot arrays
    (numpy): ±100 map to ±BAN_BIAS (ban / force), ids outside the
    vocabulary are dropped, and past MAX_BIAS_SLOTS the most extreme biases
    are kept."""
    ids = np.full((MAX_BIAS_SLOTS,), -1, dtype=np.int32)
    vals = np.zeros((MAX_BIAS_SLOTS,), dtype=np.float32)
    if not logit_bias:
        return ids, vals
    items = []
    for k, v in logit_bias.items():
        t = int(k)
        if 0 <= t < vocab:
            b = float(v)
            if b <= -100.0:
                b = BAN_BIAS
            elif b >= 100.0:
                b = -BAN_BIAS
            items.append((t, b))
    items.sort(key=lambda tv: -abs(tv[1]))  # stable: equal magnitudes keep dict order
    for i, (t, b) in enumerate(items[:MAX_BIAS_SLOTS]):
        ids[i] = t
        vals[i] = b
    return ids, vals
