"""OpenAI-compatible wire types: validation + response constructors — the
port's copy of dynamo_tpu/llm/protocols/openai.py.

Reference parity: lib/async-openai (vendored request/response types),
lib/llm/src/protocols/openai/{validate.rs,nvext.rs} and the
chat_completions aggregator. The reference vendors a full typed API surface;
here requests stay as validated dicts (the frontend is schemaless JSON in →
JSON out) with typed accessors, and responses are built by constructor
functions guaranteeing OpenAI-shaped output.

The ``nvext`` extension namespace is honored (per-request annotations,
ignore_eos, greedy sampling) under the ``nvext`` key, matching nvext.rs.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from dynamo_tpu_torch.llm.protocols.common import (
    FinishReason,
    SamplingOptions,
    StopConditions,
)


class OpenAIError(Exception):
    """Maps to an OpenAI-style error JSON body with an HTTP status.

    ``kind`` carries the structured failure taxonomy (the
    classify_failure labels plus migration reasons) into the body as
    ``error_kind`` — a client distinguishing "worker link died" from
    "payload was garbage" retries differently."""

    def __init__(
        self, message: str, status: int = 400,
        err_type: str = "invalid_request_error",
        kind: Optional[str] = None,
    ) -> None:
        super().__init__(message)
        self.status = status
        self.err_type = err_type
        self.kind = kind

    def to_body(self) -> Dict[str, Any]:
        body: Dict[str, Any] = {
            "error": {
                "message": str(self),
                "type": self.err_type,
                "param": None,
                "code": None,
            }
        }
        if self.kind:
            body["error"]["error_kind"] = self.kind
        return body


def parse_n(req: Dict[str, Any]) -> int:
    """Validated 'n' (choice count) — the ONE source of truth for both the
    HTTP service gate and request preprocessing. None → 1; bools, non-ints
    and out-of-range values 400 (int('two') must never surface as a 500)."""
    raw = req.get("n", 1)
    if raw is None:
        return 1
    if isinstance(raw, bool) or not isinstance(raw, int) or not 1 <= raw <= 8:
        raise OpenAIError("'n' must be an integer in [1, 8]")
    return raw


def _require(cond: bool, message: str) -> None:
    if not cond:
        raise OpenAIError(message)


def _opt_number(req: Dict[str, Any], key: str, lo: float, hi: float) -> Optional[float]:
    value = req.get(key)
    if value is None:
        return None
    _require(isinstance(value, (int, float)) and not isinstance(value, bool), f"'{key}' must be a number")
    _require(lo <= value <= hi, f"'{key}' must be in [{lo}, {hi}]")
    return float(value)


@dataclass
class ParsedRequest:
    """Normalized view over a chat-completion or completion request."""

    kind: str  # "chat" | "completion"
    model: str
    messages: List[Dict[str, Any]] = field(default_factory=list)  # chat
    prompt: Optional[Any] = None  # completion: str | [str] | [int]
    stream: bool = False
    stream_usage: bool = False
    n: int = 1
    sampling: SamplingOptions = field(default_factory=SamplingOptions)
    stop: StopConditions = field(default_factory=StopConditions)
    tools: Optional[List[Dict[str, Any]]] = None
    tool_choice: Optional[Any] = None
    response_format: Optional[Dict[str, Any]] = None
    annotations: List[str] = field(default_factory=list)
    lora_name: Optional[str] = None
    raw: Dict[str, Any] = field(default_factory=dict)


_CHAT_ROLES = {"system", "user", "assistant", "tool", "developer"}


def parse_chat_request(req: Dict[str, Any]) -> ParsedRequest:
    """Validate /v1/chat/completions body (ref: validate.rs + openai.rs:865)."""
    _require(isinstance(req, dict), "request body must be a JSON object")
    model = req.get("model")
    _require(isinstance(model, str) and bool(model), "'model' is required")
    messages = req.get("messages")
    _require(isinstance(messages, list) and len(messages) > 0, "'messages' must be a non-empty array")
    for i, msg in enumerate(messages):
        _require(isinstance(msg, dict), f"messages[{i}] must be an object")
        role = msg.get("role")
        _require(role in _CHAT_ROLES, f"messages[{i}].role must be one of {sorted(_CHAT_ROLES)}")
        content = msg.get("content")
        if content is not None:
            _require(
                isinstance(content, (str, list)),
                f"messages[{i}].content must be a string or content-part array",
            )
    return _parse_shared(req, ParsedRequest(kind="chat", model=model, messages=messages, raw=req))


def parse_completion_request(req: Dict[str, Any]) -> ParsedRequest:
    """Validate /v1/completions body (ref: openai.rs:327)."""
    _require(isinstance(req, dict), "request body must be a JSON object")
    model = req.get("model")
    _require(isinstance(model, str) and bool(model), "'model' is required")
    prompt = req.get("prompt")
    _require(prompt is not None, "'prompt' is required")
    _require(
        isinstance(prompt, str)
        or (isinstance(prompt, list) and all(isinstance(x, (str, int)) for x in prompt)),
        "'prompt' must be a string, array of strings, or array of token ids",
    )
    return _parse_shared(req, ParsedRequest(kind="completion", model=model, prompt=prompt, raw=req))


def _parse_shared(req: Dict[str, Any], parsed: ParsedRequest) -> ParsedRequest:
    parsed.stream = bool(req.get("stream", False))
    stream_options = req.get("stream_options") or {}
    parsed.stream_usage = bool(stream_options.get("include_usage", False))
    parsed.n = parse_n(req)

    sampling = SamplingOptions(
        temperature=_opt_number(req, "temperature", 0.0, 2.0),
        top_p=_opt_number(req, "top_p", 0.0, 1.0),
        frequency_penalty=_opt_number(req, "frequency_penalty", -2.0, 2.0),
        presence_penalty=_opt_number(req, "presence_penalty", -2.0, 2.0),
        repetition_penalty=_opt_number(req, "repetition_penalty", 0.001, 10.0),
        min_p=_opt_number(req, "min_p", 0.0, 1.0),
        seed=req.get("seed"),
    )
    top_k = req.get("top_k")
    if top_k is not None:
        _require(isinstance(top_k, int) and top_k >= -1, "'top_k' must be an integer >= -1")
        sampling.top_k = top_k
    logit_bias = req.get("logit_bias")
    if logit_bias is not None:
        _require(
            isinstance(logit_bias, dict)
            and all(
                isinstance(k, (str, int)) and str(k).lstrip("-").isdigit()
                and isinstance(v, (int, float))
                for k, v in logit_bias.items()
            ),
            "'logit_bias' must map token ids to numbers",
        )
        _require(len(logit_bias) <= 300, "'logit_bias' supports at most 300 entries")
        sampling.logit_bias = {int(k): float(v) for k, v in logit_bias.items()}
    logprobs = req.get("logprobs")
    if parsed.kind == "chat":
        if logprobs:
            top_logprobs = req.get("top_logprobs", 0) or 0
            _require(
                isinstance(top_logprobs, int) and 0 <= top_logprobs <= 20,
                "'top_logprobs' must be in [0, 20]",
            )
            # 0 alternatives is valid: sampled-token logprob only (OpenAI
            # returns empty top_logprobs lists when none were requested).
            sampling.logprobs = top_logprobs
    elif logprobs is not None:
        _require(isinstance(logprobs, int) and 0 <= logprobs <= 20, "'logprobs' must be in [0, 20]")
        sampling.logprobs = logprobs
    parsed.sampling = sampling

    stop = req.get("stop")
    stop_list: List[str] = []
    if isinstance(stop, str):
        stop_list = [stop]
    elif isinstance(stop, list):
        _require(all(isinstance(s, str) for s in stop) and len(stop) <= 4, "'stop' must be up to 4 strings")
        stop_list = list(stop)
    elif stop is not None:
        raise OpenAIError("'stop' must be a string or array of strings")

    max_tokens = req.get("max_completion_tokens", req.get("max_tokens"))
    if max_tokens is not None:
        _require(isinstance(max_tokens, int) and max_tokens >= 1, "'max_tokens' must be a positive integer")

    nvext = req.get("nvext") or {}
    _require(isinstance(nvext, dict), "'nvext' must be an object")
    parsed.annotations = list(nvext.get("annotations", []) or [])
    ignore_eos = bool(nvext.get("ignore_eos", False))

    parsed.stop = StopConditions(
        max_tokens=max_tokens,
        stop=stop_list,
        stop_token_ids=list(req.get("stop_token_ids", []) or []),
        min_tokens=req.get("min_tokens"),
        ignore_eos=ignore_eos,
    )

    tools = req.get("tools")
    if tools is not None:
        _require(isinstance(tools, list), "'tools' must be an array")
        parsed.tools = tools
        parsed.tool_choice = req.get("tool_choice")
    rf = req.get("response_format")
    if rf is not None:
        _require(isinstance(rf, dict) and "type" in rf, "'response_format' must be an object with 'type'")
        parsed.response_format = rf

    # LoRA selection: model name "base:adapter" or explicit nvext field
    lora = nvext.get("lora_name")
    if isinstance(lora, str) and lora:
        parsed.lora_name = lora
    return parsed


# ---------------------------------------------------------------------------
# Response constructors
# ---------------------------------------------------------------------------


def gen_id(prefix: str = "chatcmpl") -> str:
    return f"{prefix}-{uuid.uuid4().hex[:24]}"


def usage_block(prompt_tokens: int, completion_tokens: int) -> Dict[str, Any]:
    return {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "total_tokens": prompt_tokens + completion_tokens,
    }


def chat_chunk(
    id: str,
    model: str,
    *,
    delta: Dict[str, Any],
    index: int = 0,
    finish_reason: Optional[str] = None,
    created: Optional[int] = None,
    usage: Optional[Dict[str, Any]] = None,
    logprobs: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    chunk: Dict[str, Any] = {
        "id": id,
        "object": "chat.completion.chunk",
        "created": created or int(time.time()),
        "model": model,
        "choices": [
            {
                "index": index,
                "delta": delta,
                "logprobs": logprobs,
                "finish_reason": finish_reason,
            }
        ],
    }
    if usage is not None:
        chunk["usage"] = usage
    return chunk


def chat_logprobs_block(entries) -> Dict[str, Any]:
    """OpenAI chat `choice.logprobs` from TokenLogprob step lists
    (entry 0 = sampled token, entries 1.. = top-N alternatives)."""

    def item(tl) -> Dict[str, Any]:
        s = tl.decoded if tl.decoded is not None else ""
        return {
            "token": s,
            "logprob": tl.logprob,
            "bytes": list(s.encode("utf-8")),
        }

    content = []
    for step in entries:
        head = item(step[0])
        head["top_logprobs"] = [item(tl) for tl in step[1:]]
        content.append(head)
    return {"content": content}


def completion_logprobs_block(entries, text_offset: int = 0) -> Dict[str, Any]:
    """Legacy text-completions `choice.logprobs` (tokens / token_logprobs /
    top_logprobs / text_offset arrays)."""
    tokens: List[str] = []
    token_logprobs: List[float] = []
    top: List[Dict[str, float]] = []
    offsets: List[int] = []
    off = text_offset
    for step in entries:
        s = step[0].decoded if step[0].decoded is not None else ""
        tokens.append(s)
        token_logprobs.append(step[0].logprob)
        top.append(
            {
                (tl.decoded if tl.decoded is not None else str(tl.token_id)): tl.logprob
                for tl in step[1:]
            }
            or None  # OpenAI uses null when no alternatives were requested
        )
        offsets.append(off)
        off += len(s)
    return {
        "tokens": tokens,
        "token_logprobs": token_logprobs,
        "top_logprobs": top,
        "text_offset": offsets,
    }


def completion_envelope(
    id: str,
    model: str,
    *,
    object_: str,  # "chat.completion" | "text_completion"
    choices: List[Dict[str, Any]],
    usage: Dict[str, Any],
    created: Optional[int] = None,
) -> Dict[str, Any]:
    """The unary response envelope — the ONE place its shape is defined
    (HTTP unary handlers pass 1..n pre-built choice entries)."""
    return {
        "id": id,
        "object": object_,
        "created": created or int(time.time()),
        "model": model,
        "choices": choices,
        "usage": usage,
    }


def chat_completion(
    id: str,
    model: str,
    *,
    content: Optional[str],
    finish_reason: str,
    usage: Dict[str, Any],
    role: str = "assistant",
    tool_calls: Optional[List[Dict[str, Any]]] = None,
    reasoning_content: Optional[str] = None,
    logprobs: Optional[Dict[str, Any]] = None,
    created: Optional[int] = None,
) -> Dict[str, Any]:
    message: Dict[str, Any] = {"role": role, "content": content}
    if tool_calls:
        message["tool_calls"] = tool_calls
    if reasoning_content:
        message["reasoning_content"] = reasoning_content
    return completion_envelope(
        id, model, object_="chat.completion", created=created,
        choices=[
            {
                "index": 0,
                "message": message,
                "logprobs": logprobs,
                "finish_reason": finish_reason,
            }
        ],
        usage=usage,
    )


def completion_chunk(
    id: str,
    model: str,
    *,
    text: str,
    index: int = 0,
    finish_reason: Optional[str] = None,
    created: Optional[int] = None,
    usage: Optional[Dict[str, Any]] = None,
    logprobs: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    chunk: Dict[str, Any] = {
        "id": id,
        "object": "text_completion",
        "created": created or int(time.time()),
        "model": model,
        "choices": [
            {"index": index, "text": text, "logprobs": logprobs, "finish_reason": finish_reason}
        ],
    }
    if usage is not None:
        chunk["usage"] = usage
    return chunk


def completion_response(
    id: str,
    model: str,
    *,
    text: str,
    finish_reason: str,
    usage: Dict[str, Any],
    created: Optional[int] = None,
) -> Dict[str, Any]:
    return completion_envelope(
        id, model, object_="text_completion", created=created,
        choices=[
            {"index": 0, "text": text, "logprobs": None, "finish_reason": finish_reason}
        ],
        usage=usage,
    )


def embedding_response(model: str, embeddings: List[List[float]], prompt_tokens: int) -> Dict[str, Any]:
    return {
        "object": "list",
        "data": [
            {"object": "embedding", "index": i, "embedding": e} for i, e in enumerate(embeddings)
        ],
        "model": model,
        "usage": {"prompt_tokens": prompt_tokens, "total_tokens": prompt_tokens},
    }


def model_list(models: List[Dict[str, Any]]) -> Dict[str, Any]:
    return {"object": "list", "data": models}


def model_entry(name: str, created: Optional[int] = None, owned_by: str = "dynamo_tpu") -> Dict[str, Any]:
    return {"id": name, "object": "model", "created": created or int(time.time()), "owned_by": owned_by}
