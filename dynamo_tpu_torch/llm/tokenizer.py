"""Tokenizer abstraction + incremental detokenization — the port's
counterpart of dynamo_tpu/llm/tokenizer.py.

Reference parity: lib/llm/src/tokenizers.rs (HF tokenizer with a
DecodeStream). The JAX package wraps the HuggingFace ``tokenizers`` runtime,
which the card's machine does not have; here ``HFTokenizer`` reads the same
``tokenizer.json`` through ``llm/bpe.py`` (byte-level BPE in pure Python;
the forms it takes are listed there, anything else raises) with the same
API and results. ``DecodeStream`` is a copy. ``tiny_tokenizer()`` loads the
JAX package's trained test tokenizer from ``data/tiny_tokenizer.json``.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Protocol, Sequence

from dynamo_tpu_torch.llm.bpe import BpeTokenizer

_REPLACEMENT = "�"


class Tokenizer(Protocol):
    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]: ...
    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str: ...
    @property
    def vocab_size(self) -> int: ...
    @property
    def eos_token_ids(self) -> List[int]: ...
    @property
    def bos_token_id(self) -> Optional[int]: ...


class HFTokenizer:
    """Wraps a HuggingFace tokenizer.json (ref: tokenizers.rs), read by
    ``llm/bpe.BpeTokenizer``."""

    def __init__(self, tok, eos_token_ids: Optional[List[int]] = None, bos_token_id: Optional[int] = None) -> None:
        self._tok = tok
        self._eos = list(eos_token_ids or [])
        self._bos = bos_token_id

    @classmethod
    def from_file(cls, path: str) -> "HFTokenizer":
        tok = BpeTokenizer.from_file(path)
        eos, bos = _special_ids_from_config(os.path.dirname(path), tok)
        return cls(tok, eos_token_ids=eos, bos_token_id=bos)

    @classmethod
    def from_pretrained_dir(cls, model_dir: str) -> "HFTokenizer":
        path = os.path.join(model_dir, "tokenizer.json")
        if not os.path.exists(path):
            raise FileNotFoundError(f"no tokenizer.json under {model_dir}")
        return cls.from_file(path)

    def encode(self, text: str, add_special_tokens: bool = False) -> List[int]:
        return self._tok.encode(text, add_special_tokens=add_special_tokens)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=skip_special_tokens)

    def token_to_id(self, token: str) -> Optional[int]:
        return self._tok.token_to_id(token)

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()

    @property
    def eos_token_ids(self) -> List[int]:
        return self._eos

    @property
    def bos_token_id(self) -> Optional[int]:
        return self._bos


def _special_ids_from_config(model_dir: str, tok) -> tuple:
    """Pull eos/bos ids from config.json / generation_config.json /
    tokenizer_config.json when present (ref: model_card.rs special-token
    resolution)."""
    eos: List[int] = []
    bos: Optional[int] = None
    for name in ("generation_config.json", "config.json"):
        path = os.path.join(model_dir, name)
        if not os.path.exists(path):
            continue
        try:
            with open(path) as f:
                cfg = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        raw_eos = cfg.get("eos_token_id")
        if raw_eos is not None and not eos:
            eos = [raw_eos] if isinstance(raw_eos, int) else list(raw_eos)
        if bos is None and isinstance(cfg.get("bos_token_id"), int):
            bos = cfg["bos_token_id"]
    cfg_path = os.path.join(model_dir, "tokenizer_config.json")
    if not eos and os.path.exists(cfg_path):
        try:
            with open(cfg_path) as f:
                tcfg = json.load(f)
            eos_tok = tcfg.get("eos_token")
            if isinstance(eos_tok, dict):
                eos_tok = eos_tok.get("content")
            if isinstance(eos_tok, str):
                tid = tok.token_to_id(eos_tok)
                if tid is not None:
                    eos = [tid]
        except (OSError, json.JSONDecodeError):
            pass
    return eos, bos


class DecodeStream:
    """Incremental detokenizer: feed token ids, get printable text deltas.

    Handles multi-token unicode (holds back text ending in U+FFFD until the
    codepoint completes) and tokenizers whose decode needs left context
    (sentencepiece-style leading-space semantics). Algorithm matches the
    reference's tokenizers.rs DecodeStream / vLLM's incremental decode.
    """

    def __init__(self, tokenizer: Tokenizer, skip_special_tokens: bool = True) -> None:
        self._tok = tokenizer
        self._skip_special = skip_special_tokens
        self._ids: List[int] = []
        self._prefix_offset = 0
        self._read_offset = 0

    def step(self, token_ids: Sequence[int]) -> str:
        """Append new token ids; return newly-finalized text (may be '')."""
        self._ids.extend(token_ids)
        prefix_text = self._tok.decode(
            self._ids[self._prefix_offset : self._read_offset],
            skip_special_tokens=self._skip_special,
        )
        full_text = self._tok.decode(
            self._ids[self._prefix_offset :], skip_special_tokens=self._skip_special
        )
        if len(full_text) > len(prefix_text) and not full_text.endswith(_REPLACEMENT):
            delta = full_text[len(prefix_text) :]
            self._prefix_offset = self._read_offset
            self._read_offset = len(self._ids)
            return delta
        return ""

    @property
    def token_count(self) -> int:
        return len(self._ids)

    def flush(self) -> str:
        """Emit whatever is held back (end of stream)."""
        prefix_text = self._tok.decode(
            self._ids[self._prefix_offset : self._read_offset],
            skip_special_tokens=self._skip_special,
        )
        full_text = self._tok.decode(
            self._ids[self._prefix_offset :], skip_special_tokens=self._skip_special
        )
        delta = full_text[len(prefix_text) :]
        self._prefix_offset = len(self._ids)
        self._read_offset = len(self._ids)
        return delta.rstrip(_REPLACEMENT)


# ---------------------------------------------------------------------------
# Test tokenizer (the JAX package's, trained once and saved with the package)
# ---------------------------------------------------------------------------

TINY_TOKENIZER_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                                   "tiny_tokenizer.json")
_TINY: Optional[HFTokenizer] = None


def tiny_tokenizer() -> HFTokenizer:
    """The small byte-level BPE of the JAX package's ``tiny_tokenizer()``
    at its default ``vocab_size=512`` (trained there with ``tokenizers`` on
    a synthetic corpus; its saved ``tokenizer.json`` is
    ``data/tiny_tokenizer.json``); cached per process."""
    global _TINY
    if _TINY is None:
        tok = BpeTokenizer.from_file(TINY_TOKENIZER_PATH)
        _TINY = HFTokenizer(
            tok,
            eos_token_ids=[tok.token_to_id("<|endoftext|>")],
            bos_token_id=None,
        )
    return _TINY
