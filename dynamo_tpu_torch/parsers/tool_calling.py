"""Tool-call parsing across model dialects — the port's copy of
dynamo_tpu/parsers/tool_calling.py.

Reference parity: lib/parsers/src/tool_calling/{json,pythonic,xml,harmony,
dsml} — normalize whatever the model emitted into OpenAI tool_calls entries.
Dialects:
  json     — bare {"name": ..., "arguments"|"parameters": {...}} or a list
  hermes   — <tool_call>{json}</tool_call> (Qwen/Hermes templates)
  mistral  — [TOOL_CALLS]{json list}
  pythonic — [fn(a=1, b="x"), ...] python-literal calls (llama-3.2 style)
  harmony  — gpt-oss channel format: <|channel|>commentary
             to=functions.NAME <|constrain|>json<|message|>{...}
  dsml     — DeepSeek markup: <｜DSML｜invoke name=...> with typed
             <｜DSML｜parameter> children
  xml      — <tool_call><function=NAME><parameter=K>V</parameter>... form
"""

from __future__ import annotations

import ast
import json
import re
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class ToolCall:
    name: str
    arguments: Dict[str, Any] = field(default_factory=dict)
    call_id: str = ""
    # True when the argument string was unparseable and shipped as a
    # lossy {"__raw__": ...} wrap — surfaced on the emitted call (and
    # counted per dialect) so clients and the SLO plane can see lossy
    # parses instead of silently acting on mangled arguments.
    degraded: bool = False

    def to_openai(self) -> Dict[str, Any]:
        entry: Dict[str, Any] = {
            "id": self.call_id or f"call-{uuid.uuid4().hex[:24]}",
            "type": "function",
            "function": {
                "name": self.name,
                "arguments": json.dumps(self.arguments, separators=(",", ":")),
            },
        }
        if self.degraded:
            entry["degraded"] = True
        return entry


def _normalize(obj: Any) -> Optional[ToolCall]:
    if not isinstance(obj, dict):
        return None
    name = obj.get("name")
    if not name and isinstance(obj.get("function"), dict):
        inner = obj["function"]
        name = inner.get("name")
        obj = inner
    if not isinstance(name, str) or not name:
        return None
    args = obj.get("arguments", obj.get("parameters", {}))
    degraded = False
    if isinstance(args, str):
        try:
            args = json.loads(args)
        except json.JSONDecodeError:
            args = {"__raw__": args}
            degraded = True
    if not isinstance(args, dict):
        args = {"value": args}
    return ToolCall(name=name, arguments=args, degraded=degraded)


def _parse_json_calls(text: str) -> List[ToolCall]:
    text = text.strip()
    try:
        obj = json.loads(text)
    except json.JSONDecodeError:
        return []
    items = obj if isinstance(obj, list) else [obj]
    calls = [c for c in (_normalize(i) for i in items) if c is not None]
    return calls


_HERMES_RE = re.compile(r"<tool_call>\s*(.*?)\s*</tool_call>", re.DOTALL)
_MISTRAL_RE = re.compile(r"\[TOOL_CALLS\]\s*(\[.*\]|\{.*\})", re.DOTALL)


def _parse_hermes(text: str) -> Tuple[List[ToolCall], str]:
    calls: List[ToolCall] = []
    for m in _HERMES_RE.finditer(text):
        calls.extend(_parse_json_calls(m.group(1)))
    remainder = _HERMES_RE.sub("", text).strip()
    return calls, remainder


def _parse_mistral(text: str) -> Tuple[List[ToolCall], str]:
    m = _MISTRAL_RE.search(text)
    if not m:
        return [], text
    calls = _parse_json_calls(m.group(1))
    remainder = (text[: m.start()] + text[m.end():]).strip()
    return calls, remainder


def _parse_pythonic(text: str) -> List[ToolCall]:
    text = text.strip()
    if not (text.startswith("[") and text.endswith("]")):
        return []
    try:
        tree = ast.parse(text, mode="eval")
    except SyntaxError:
        return []
    if not isinstance(tree.body, ast.List):
        return []
    calls: List[ToolCall] = []
    for node in tree.body.elts:
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)):
            return []
        args: Dict[str, Any] = {}
        try:
            for kw in node.keywords:
                if kw.arg is None:
                    return []
                args[kw.arg] = ast.literal_eval(kw.value)
        except (ValueError, SyntaxError):
            return []
        calls.append(ToolCall(name=node.func.id, arguments=args))
    return calls


_HARMONY_CALL_RE = re.compile(
    r"<\|channel\|>commentary\s+to=functions\.([\w.-]+)\s*"
    r"(?:<\|constrain\|>\w+)?<\|message\|>(.*?)(?=<\|call\|>|<\|end\|>|<\|channel\|>|<\|start\|>|$)",
    re.DOTALL,
)
_HARMONY_ANALYSIS_RE = re.compile(
    r"<\|channel\|>analysis<\|message\|>(.*?)(?=<\|end\|>|<\|channel\|>|<\|start\|>|$)",
    re.DOTALL,
)
_HARMONY_FINAL_RE = re.compile(
    r"<\|channel\|>final<\|message\|>(.*?)(?=<\|end\|>|<\|channel\|>|<\|start\|>|$)",
    re.DOTALL,
)


def _parse_harmony(text: str) -> Tuple[List[ToolCall], str]:
    """gpt-oss harmony channels (ref: harmony/harmony_parser.rs:33-86):
    tool calls ride the commentary channel addressed to functions.*; user
    text rides the final channel (analysis is reasoning, dropped here)."""
    if "<|channel|>" not in text:
        return [], text
    calls: List[ToolCall] = []
    for m in _HARMONY_CALL_RE.finditer(text):
        name, payload = m.group(1), m.group(2).strip()
        degraded = False
        try:
            args = json.loads(payload)
        except json.JSONDecodeError:
            args = {"__raw__": payload}
            degraded = True
        if not isinstance(args, dict):
            args = {"value": args}
        calls.append(ToolCall(name=name, arguments=args, degraded=degraded))
    finals = _HARMONY_FINAL_RE.findall(text)
    remainder = "".join(f.strip() for f in finals)
    return calls, remainder


_DSML_MARK = "<｜DSML｜"  # fullwidth vertical bars (DeepSeek tokens)
_DSML_INVOKE_RE = re.compile(
    r"<｜DSML｜invoke\s+name=\"([^\"]+)\">(.*?)</｜DSML｜invoke>",
    re.DOTALL,
)
_DSML_PARAM_RE = re.compile(
    r"<｜DSML｜parameter\s+name=\"([^\"]+)\"(?:\s+string=\"(true|false)\")?\s*>"
    r"(.*?)</｜DSML｜parameter>",
    re.DOTALL,
)
_DSML_BLOCK_RE = re.compile(
    r"<｜DSML｜function_calls>.*?</｜DSML｜function_calls>",
    re.DOTALL,
)


def _parse_dsml(text: str) -> Tuple[List[ToolCall], str]:
    """DeepSeek DSML (ref: dsml/parser.rs:13-21). Non-string parameter
    values are JSON-decoded (string="false" marks typed values)."""
    if _DSML_MARK not in text:
        return [], text
    calls: List[ToolCall] = []
    for m in _DSML_INVOKE_RE.finditer(text):
        name, body = m.group(1), m.group(2)
        args: Dict[str, Any] = {}
        for pm in _DSML_PARAM_RE.finditer(body):
            pname, is_string, value = pm.group(1), pm.group(2), pm.group(3).strip()
            if is_string == "false":
                try:
                    args[pname] = json.loads(value)
                except json.JSONDecodeError:
                    args[pname] = value
            else:
                args[pname] = value
        calls.append(ToolCall(name=name, arguments=args))
    remainder = _DSML_BLOCK_RE.sub("", text)
    # strip orphan DSML fragments outside a complete block
    remainder = re.sub(r"<｜DSML｜[^>]*>", "", remainder).strip()
    return calls, remainder


_XML_FN_RE = re.compile(
    r"<tool_call>\s*<function=([\w.-]+)>(.*?)</function>\s*</tool_call>",
    re.DOTALL,
)
_XML_PARAM_RE = re.compile(
    r"<parameter=([\w.-]+)>(.*?)</parameter>", re.DOTALL
)


def _parse_xml(text: str) -> Tuple[List[ToolCall], str]:
    """<tool_call><function=NAME><parameter=K>V</parameter>... form
    (ref: xml/parser.rs:30)."""
    calls: List[ToolCall] = []
    for m in _XML_FN_RE.finditer(text):
        args: Dict[str, Any] = {}
        for pm in _XML_PARAM_RE.finditer(m.group(2)):
            value = pm.group(2).strip()
            try:
                args[pm.group(1)] = json.loads(value)
            except json.JSONDecodeError:
                args[pm.group(1)] = value
        calls.append(ToolCall(name=m.group(1), arguments=args))
    remainder = _XML_FN_RE.sub("", text).strip()
    return calls, remainder


def _count_degraded(calls: List[ToolCall], dialect: str) -> None:
    """Lossy {"__raw__": ...} argument wraps are an SLO-visible event:
    counted per dialect (parser_degraded_args_total) next to the
    ``degraded: true`` marker already on the emitted call."""
    n = sum(1 for c in calls if c.degraded)
    if not n:
        return
    from dynamo_tpu_torch.parsers.observe import parser_plane

    plane = parser_plane()
    for _ in range(n):
        plane.note_degraded_args(dialect)


def detect_and_parse_tool_calls(
    text: str, dialect: Optional[str] = None
) -> Tuple[List[ToolCall], str]:
    """Returns (tool_calls, remaining_content). ``dialect`` pins a format;
    None auto-detects (hermes → mistral → json → pythonic)."""
    if dialect == "hermes":
        calls, remainder = _parse_hermes(text)
        _count_degraded(calls, "hermes")
        return calls, remainder
    if dialect == "mistral":
        calls, remainder = _parse_mistral(text)
        _count_degraded(calls, "mistral")
        return calls, remainder
    if dialect == "json":
        calls = _parse_json_calls(text)
        _count_degraded(calls, "json")
        return calls, "" if calls else text
    if dialect == "pythonic":
        calls = _parse_pythonic(text)
        return calls, "" if calls else text
    if dialect == "harmony":
        calls, remainder = _parse_harmony(text)
        _count_degraded(calls, "harmony")
        return calls, remainder
    if dialect == "dsml":
        calls, remainder = _parse_dsml(text)
        _count_degraded(calls, "dsml")
        return calls, remainder
    if dialect == "xml":
        calls, remainder = _parse_xml(text)
        _count_degraded(calls, "xml")
        return calls, remainder

    for name, parser in (("harmony", _parse_harmony), ("dsml", _parse_dsml),
                         ("xml", _parse_xml), ("hermes", _parse_hermes),
                         ("mistral", _parse_mistral)):
        calls, remainder = parser(text)
        if calls:
            _count_degraded(calls, name)
            return calls, remainder
    calls = _parse_json_calls(text)
    if calls:
        _count_degraded(calls, "json")
        return calls, ""
    calls = _parse_pythonic(text)
    if calls:
        return calls, ""
    return [], text
