"""Backend operator: incremental detokenization + stop conditions — the
port's copy of dynamo_tpu/llm/backend.py.

Reference parity: lib/llm/src/backend.rs (Backend::from_tokenizer :56 —
turns BackendOutput token streams into text deltas, applying stop-sequence
detection that needs text visibility the engine doesn't have).
"""

from __future__ import annotations

import logging
from typing import Any, AsyncIterator, Dict, List, Optional, Union

from dynamo_tpu_torch.llm.protocols.common import (
    BackendOutput,
    FinishReason,
    PostprocessedOutput,
    PreprocessedRequest,
)
from dynamo_tpu_torch.llm.tokenizer import DecodeStream, Tokenizer
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.engine import AsyncEngine

logger = logging.getLogger(__name__)


class Backend:
    """Pipeline operator placed between preprocessor and router."""

    def __init__(self, tokenizer: Tokenizer) -> None:
        self.tokenizer = tokenizer

    @classmethod
    def from_tokenizer(cls, tokenizer: Tokenizer) -> "Backend":
        return cls(tokenizer)

    async def generate(
        self, request: PreprocessedRequest, context: Context, next: AsyncEngine
    ) -> AsyncIterator[Union[PostprocessedOutput, dict]]:
        stop_strings: List[str] = list(request.stop.stop) if request.stop else []
        # A stop string may straddle text deltas; hold back a tail of
        # len(longest_stop)-1 chars until we know it can't complete a match.
        holdback = max((len(s) for s in stop_strings), default=0) - 1
        decode = DecodeStream(self.tokenizer)
        pending = ""  # decoded but held back
        cumulative = 0
        decoded_memo: Dict[int, str] = {}  # logprob token id → string

        async for item in next.generate(request, context):
            if isinstance(item, dict) and "annotation" in item:
                yield item
                continue
            out = item if isinstance(item, BackendOutput) else BackendOutput.from_dict(item)
            if out.error:
                yield PostprocessedOutput(
                    error=out.error,
                    error_kind=getattr(out, "error_kind", None),
                    finish_reason=FinishReason.ERROR,
                    cumulative_tokens=cumulative,
                )
                return
            if out.logprobs:
                # Fill each entry's token string here — the detokenizer is
                # the one pipeline stage that owns the tokenizer (the HTTP
                # layer renders OpenAI logprob objects from `decoded`).
                # Memoized per stream: top-N alternatives repeat the same
                # ids constantly (up to cap+1 decodes per generated token
                # otherwise).
                for step_entries in out.logprobs:
                    for tl in step_entries:
                        if tl.decoded is None:
                            s = decoded_memo.get(tl.token_id)
                            if s is None:
                                s = self.tokenizer.decode([tl.token_id])
                                decoded_memo[tl.token_id] = s
                            tl.decoded = s
            cumulative += len(out.token_ids)
            pending += decode.step(out.token_ids)
            if out.finish_reason is not None:
                pending += decode.flush()

            text_out, stop_hit = self._scan_stop(pending, stop_strings)
            if stop_hit:
                # Truncate at the stop string and end the stream.
                context.stop_generating(reason="stop-string")
                yield PostprocessedOutput(
                    text=text_out,
                    token_ids=out.token_ids,
                    finish_reason=FinishReason.STOP,
                    cumulative_tokens=cumulative,
                    logprobs=out.logprobs,
                )
                return

            if out.finish_reason is not None:
                yield PostprocessedOutput(
                    text=pending,
                    token_ids=out.token_ids,
                    finish_reason=out.finish_reason,
                    cumulative_tokens=cumulative,
                    logprobs=out.logprobs,
                )
                return

            emit = pending[: max(0, len(pending) - holdback)] if holdback > 0 else pending
            pending = pending[len(emit) :]
            if emit or out.token_ids:
                yield PostprocessedOutput(
                    text=emit,
                    token_ids=out.token_ids,
                    cumulative_tokens=cumulative,
                    logprobs=out.logprobs,
                )

        # Engine stream ended without a finish reason (e.g. cancelled).
        tail = pending + decode.flush()
        reason = (
            FinishReason.CANCELLED if context.stopped else FinishReason.ERROR
        )
        yield PostprocessedOutput(
            text=tail, finish_reason=reason, cumulative_tokens=cumulative
        )

    @staticmethod
    def _scan_stop(pending: str, stop_strings: List[str]):
        """Return (text_before_stop, hit?) scanning earliest stop match."""
        if not stop_strings:
            return pending, False
        earliest = -1
        for s in stop_strings:
            idx = pending.find(s)
            if idx != -1 and (earliest == -1 or idx < earliest):
                earliest = idx
        if earliest == -1:
            return pending, False
        return pending[:earliest], True
