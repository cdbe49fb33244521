"""Tool-call and reasoning-content parsers — the port's copy of
dynamo_tpu/parsers/__init__.py.

Reference parity: lib/parsers (SURVEY §2.1 dynamo-parsers row) — tool-call
dialects (JSON / hermes-XML / mistral / pythonic / harmony / dsml,
src/tool_calling/) and reasoning extraction (<think> family,
src/reasoning/). One-shot parsers are pure functions over text; streaming
runs through small state machines — the reasoning splitter and the
incremental tool-call jail (parsers/jail.py + parsers/incremental.py),
which emits OpenAI ``tool_calls`` argument deltas while the model is
still generating the call.
"""

from dynamo_tpu_torch.parsers.incremental import (
    DIALECTS,
    ArgsDelta,
    CallEnd,
    CallStart,
    ContentDelta,
    ToolCallParseError,
)
from dynamo_tpu_torch.parsers.jail import ToolCallJail
from dynamo_tpu_torch.parsers.reasoning import ReasoningParser, split_reasoning
from dynamo_tpu_torch.parsers.tool_calling import ToolCall, detect_and_parse_tool_calls

__all__ = [
    "ArgsDelta",
    "CallEnd",
    "CallStart",
    "ContentDelta",
    "DIALECTS",
    "ReasoningParser",
    "split_reasoning",
    "ToolCall",
    "ToolCallJail",
    "ToolCallParseError",
    "detect_and_parse_tool_calls",
]
