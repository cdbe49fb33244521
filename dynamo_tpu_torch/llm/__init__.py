"""LLM serving layer (ref: dynamo-llm crate, lib/llm) — the port's counterpart of
dynamo_tpu/llm/, with the same exports. Its protocols, preprocessor, backend
and pipeline entry points are copies; the tokenizer reads tokenizer.json in
pure Python (llm/bpe.py) and the default chat template renders without
jinja2."""

from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.chat_template import ChatTemplate, DEFAULT_CHAT_TEMPLATE
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard, RuntimeConfig, slugify
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.llm.protocols.common import (
    BackendOutput,
    DisaggregatedParams,
    FinishReason,
    PostprocessedOutput,
    PreprocessedRequest,
    RequestPhase,
    RequestTiming,
    SamplingOptions,
    StopConditions,
    TokenLogprob,
)
from dynamo_tpu_torch.llm.protocols.openai import OpenAIError, parse_chat_request, parse_completion_request
from dynamo_tpu_torch.llm.tokenizer import DecodeStream, HFTokenizer, Tokenizer, tiny_tokenizer

__all__ = [
    "Backend",
    "BackendOutput",
    "ChatTemplate",
    "DEFAULT_CHAT_TEMPLATE",
    "DecodeStream",
    "DisaggregatedParams",
    "FinishReason",
    "HFTokenizer",
    "ModelDeploymentCard",
    "OpenAIError",
    "OpenAIPreprocessor",
    "PostprocessedOutput",
    "PreprocessedRequest",
    "RequestPhase",
    "RequestTiming",
    "RuntimeConfig",
    "SamplingOptions",
    "StopConditions",
    "TokenLogprob",
    "Tokenizer",
    "parse_chat_request",
    "parse_completion_request",
    "slugify",
    "tiny_tokenizer",
]
