"""Weight products — the plain-dtype branches of dynamo_tpu/ops/quant.py.

The JAX functions also take int8 ``{"q8", "s"}`` weights; those branches
come with the int8-weight (megakernel) slice. Here a weight is a plain
tensor in the model's dtype and a dict raises.
"""

from __future__ import annotations

import functools
from typing import Any

import torch


def _plain(w: Any) -> torch.Tensor:
    if isinstance(w, dict):
        raise NotImplementedError("int8 weights are not ported yet")
    return w


@functools.lru_cache(maxsize=None)
def _is_matmul(spec: str) -> bool:
    """Whether ``spec`` contracts x's last axis with a 2-D weight's first
    and keeps every other axis in order ("...k,kn->...n")."""
    lhs, out = spec.split("->")
    xs, ws = lhs.split(",")
    return len(ws) == 2 and xs[-1] == ws[0] and out == xs[:-1] + ws[1]


def qeinsum(spec: str, x: torch.Tensor, w: Any) -> torch.Tensor:
    """``einsum(spec, x, w)`` for a plain weight (same specs as the JAX
    package: "bcd,dh->bch", ...). The model's specs are all plain matrix
    products and go to ``torch.matmul``, which skips einsum's per-call
    parsing and permutes: host time per op bounds an eager decode step."""
    w = _plain(w)
    if _is_matmul(spec):
        return torch.matmul(x, w)
    return torch.einsum(spec, x, w)


def embed_lookup(embed: Any, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Embedding-table row gather."""
    return _plain(embed)[tokens].to(dtype)


def lm_head(x: torch.Tensor, w: Any, *, tied: bool) -> torch.Tensor:
    """Project hidden states to float32 vocab logits. ``tied``: ``w`` is the
    embedding table [V, d]; otherwise the lm_head [d, V]."""
    w = _plain(w)
    h = w.T if tied else w
    return (x @ h).to(torch.float32)
