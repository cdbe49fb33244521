"""Internal wire protocols between pipeline stages — the port's copy of
dynamo_tpu/llm/protocols/common.py (same types, same dict forms).

Reference parity: lib/llm/src/protocols/common/llm_backend.rs
(PreprocessedRequest, BackendOutput, LLMEngineOutput) and common/timing.rs
(RequestPhase). These are the framework's *internal* types — the OpenAI wire
types live in protocols/openai.py; the preprocessor converts between them.

Everything serializes to plain dicts (msgpack-able) because these cross the
request plane between processes.
"""

from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional


class FinishReason(str, Enum):
    EOS = "eos"
    STOP = "stop"
    LENGTH = "length"
    CANCELLED = "cancelled"
    ERROR = "error"

    def to_openai(self) -> str:
        return {
            FinishReason.EOS: "stop",
            FinishReason.STOP: "stop",
            FinishReason.LENGTH: "length",
            FinishReason.CANCELLED: "stop",
            FinishReason.ERROR: "error",
        }[self]


@dataclass
class StopConditions:
    """(ref: llm_backend.rs StopConditions)"""

    max_tokens: Optional[int] = None
    stop: List[str] = field(default_factory=list)  # stop strings
    stop_token_ids: List[int] = field(default_factory=list)
    min_tokens: Optional[int] = None
    ignore_eos: bool = False


@dataclass
class SamplingOptions:
    """(ref: llm_backend.rs SamplingOptions)"""

    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    repetition_penalty: Optional[float] = None
    min_p: Optional[float] = None  # drop candidates below min_p × max-prob
    logit_bias: Optional[Dict[int, float]] = None  # token id → additive bias
    seed: Optional[int] = None
    logprobs: Optional[int] = None  # top-N logprobs to return, None = off


@dataclass
class DisaggregatedParams:
    """Bootstrap metadata carried from prefill worker to decode worker
    (ref: kv_router/prefill_router.rs:267–318, SGLang bootstrap rooms)."""

    worker_id: Optional[int] = None
    dp_rank: Optional[int] = None
    kv_transfer: Dict[str, Any] = field(default_factory=dict)  # engine-specific
    prefilled_tokens: Optional[int] = None


@dataclass
class PreprocessedRequest:
    """Tokenized, template-rendered request flowing router → worker
    (ref: llm_backend.rs PreprocessedRequest)."""

    token_ids: List[int]
    model: str = ""
    request_id: str = ""
    sampling: SamplingOptions = field(default_factory=SamplingOptions)
    stop: StopConditions = field(default_factory=StopConditions)
    eos_token_ids: List[int] = field(default_factory=list)
    annotations: List[str] = field(default_factory=list)
    lora_name: Optional[str] = None
    disaggregated_params: Optional[DisaggregatedParams] = None
    # Router hints
    estimated_prefix_hit_blocks: int = 0
    dp_rank: Optional[int] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PreprocessedRequest":
        d = dict(d)
        d["sampling"] = SamplingOptions(**d.get("sampling", {}) or {})
        d["stop"] = StopConditions(**d.get("stop", {}) or {})
        dp = d.get("disaggregated_params")
        d["disaggregated_params"] = DisaggregatedParams(**dp) if dp else None
        return cls(**d)


@dataclass
class TokenLogprob:
    token_id: int
    logprob: float
    decoded: Optional[str] = None


@dataclass
class BackendOutput:
    """One streamed step from an engine: new token ids + bookkeeping
    (ref: llm_backend.rs BackendOutput)."""

    token_ids: List[int] = field(default_factory=list)
    finish_reason: Optional[FinishReason] = None
    cumulative_tokens: Optional[int] = None
    logprobs: Optional[List[List[TokenLogprob]]] = None  # per new token, top-N
    disaggregated_params: Optional[DisaggregatedParams] = None
    error: Optional[str] = None
    # Structured failure taxonomy riding with ``error``: the PR 7
    # classify_failure labels (timeout | connection | decode | other) plus
    # the migration reasons (disagg | no_instances). The frontend maps it
    # to a typed HTTP status / terminal SSE error event instead of a bare
    # 500 (docs/design_docs/overload_control.md, error taxonomy section).
    error_kind: Optional[str] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        if self.finish_reason is not None:
            d["finish_reason"] = self.finish_reason.value
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BackendOutput":
        d = dict(d)
        fr = d.get("finish_reason")
        d["finish_reason"] = FinishReason(fr) if fr else None
        lps = d.get("logprobs")
        if lps:
            d["logprobs"] = [[TokenLogprob(**t) for t in step] for step in lps]
        dp = d.get("disaggregated_params")
        d["disaggregated_params"] = DisaggregatedParams(**dp) if dp else None
        return cls(**d)


@dataclass
class PostprocessedOutput:
    """Detokenized delta emitted by the Backend operator toward the frontend."""

    text: str = ""
    token_ids: List[int] = field(default_factory=list)
    finish_reason: Optional[FinishReason] = None
    cumulative_tokens: int = 0
    logprobs: Optional[List[List[TokenLogprob]]] = None
    error: Optional[str] = None
    error_kind: Optional[str] = None  # see BackendOutput.error_kind


class RequestPhase(str, Enum):
    """(ref: protocols/common/timing.rs)"""

    RECEIVED = "received"
    PREPROCESSED = "preprocessed"
    ROUTED = "routed"
    PREFILLING = "prefilling"
    FIRST_TOKEN = "first_token"
    DECODING = "decoding"
    COMPLETE = "complete"


@dataclass
class RequestTiming:
    phases: Dict[str, float] = field(default_factory=dict)

    def mark(self, phase: RequestPhase) -> None:
        self.phases.setdefault(phase.value, time.monotonic())

    def ttft(self) -> Optional[float]:
        t0 = self.phases.get(RequestPhase.RECEIVED.value)
        t1 = self.phases.get(RequestPhase.FIRST_TOKEN.value)
        return (t1 - t0) if (t0 is not None and t1 is not None) else None
