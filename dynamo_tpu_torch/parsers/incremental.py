"""Incremental tool-call parsing: per-dialect streaming state machines —
the port's copy of dynamo_tpu/parsers/incremental.py.

Reference parity: the reference's ~1.2k-LoC incremental jail
(lib/llm/src/protocols/openai/chat_completions/jail.rs + lib/parsers
streaming modes) — once a dialect's opening marker commits, the parser
emits OpenAI ``tool_calls`` ARGUMENT DELTAS as the model generates them
instead of buffering the whole call to stream end:

  * json / hermes / mistral / harmony — partial-JSON streaming: the call
    name is emitted as soon as its string literal completes, and the raw
    text of the ``arguments`` object streams through as argument deltas
    while the model is still generating it;
  * pythonic / dsml / xml — element-wise streaming: each completed
    keyword argument / ``<parameter>`` element appends one JSON fragment
    to the arguments string (the fragments concatenate to a valid JSON
    object, closed when the call's structure closes).

Event model (what the jail in parsers/jail.py returns to the SSE
assembler): ``ContentDelta`` (safe to stream as content), ``CallStart``
(index + name + call id — the first ``tool_calls`` delta), ``ArgsDelta``
(raw argument text for one call), ``CallEnd`` (the call closed; carries
``error`` when the degradation ladder sealed it and ``degraded`` when
the arguments needed a lossy ``__raw__`` wrap).

Malformed input NEVER raises out of a machine as a plain exception:
structured failures raise ``_MachineDegrade(reason)`` which the jail
turns into the typed degradation ladder (seal emitted calls, return
un-emitted jailed text to content). Anything else escaping ``feed`` is
a parser BUG and is wrapped by the jail into ``ToolCallParseError`` so
the HTTP layer can ship a terminal typed SSE error frame
(``error_kind=tool_call_parse``) instead of dropping the stream.

Machines never buffer without bound: every machine tracks the raw text
it has consumed since the last emitted event (``raw_len``), and the jail
degrades the stream when that exceeds its buffer cap — a dialect that
never closes cannot grow host memory without limit.
"""

from __future__ import annotations

import ast
import json
import re
import uuid
from dataclasses import dataclass
from typing import Callable, List, Optional

from dynamo_tpu_torch.parsers.holdback import find_first, holdback_split

_WS = " \t\r\n"
_SCALAR_END = frozenset(" \t\r\n,}]")
_NAME_RE = re.compile(r"^[\w.-]+$")

# Every dialect a jail can be pinned to (None = auto-detect by marker).
DIALECTS = (
    "json", "hermes", "mistral", "pythonic", "harmony", "dsml", "xml",
)


# ---------------------------------------------------------------------------
# Events
# ---------------------------------------------------------------------------


@dataclass
class ContentDelta:
    """Text that is safe to stream to the client as content."""

    text: str


@dataclass
class CallStart:
    """A tool call's name parsed — the first ``tool_calls`` delta."""

    index: int
    name: str
    call_id: str


@dataclass
class ArgsDelta:
    """Raw argument text for call ``index`` (concatenates to JSON)."""

    index: int
    text: str


@dataclass
class CallEnd:
    """Call ``index`` closed. ``error`` set when the degradation ladder
    sealed a malformed/truncated call; ``degraded`` when the arguments
    needed a lossy wrap (``__raw__``) or the seal was lossy."""

    index: int
    error: Optional[str] = None
    degraded: bool = False


class ToolCallParseError(RuntimeError):
    """A parser BUG (not malformed model output): surfaces as a terminal
    typed SSE error frame (``error_kind=tool_call_parse``) — never a
    dropped stream."""


class _MachineDegrade(Exception):
    """Structured malformed-input failure. The jail catches this and runs
    the degradation ladder; ``events`` carries whatever the machine had
    already emitted in the feed that raised."""

    def __init__(self, reason: str) -> None:
        super().__init__(reason)
        self.reason = reason
        self.events: List[object] = []


class _JailCtx:
    """Shared per-stream identity: global call indices + call ids (call
    index keeps counting across back-to-back jailed segments)."""

    def __init__(
        self, call_id_factory: Optional[Callable[[], str]] = None
    ) -> None:
        self._next = 0
        self._mk_id = call_id_factory or (
            lambda: f"call-{uuid.uuid4().hex[:24]}"
        )

    def alloc_index(self) -> int:
        i = self._next
        self._next = i + 1
        return i

    def new_call_id(self) -> str:
        return self._mk_id()


# ---------------------------------------------------------------------------
# Incremental JSON consumers (shared by json / hermes / mistral / harmony)
# ---------------------------------------------------------------------------


class _JsonString:
    """One JSON string literal, opening quote already consumed.
    ``feed`` returns consumed chars; ``raw`` excludes both quotes."""

    def __init__(self) -> None:
        self.raw: List[str] = []
        self.done = False
        self._esc = False

    def feed(self, text: str) -> int:
        i, n = 0, len(text)
        start = 0
        while i < n:
            c = text[i]
            i += 1
            if self._esc:
                self._esc = False
            elif c == "\\":
                self._esc = True
            elif c == '"':
                self.done = True
                self.raw.append(text[start:i - 1])
                return i
        self.raw.append(text[start:i])
        return i

    def value(self) -> str:
        raw = "".join(self.raw)
        try:
            return json.loads('"' + raw + '"')
        except json.JSONDecodeError:
            return raw


class _JsonValue:
    """One JSON value of any kind, consumed incrementally. ``kind`` is
    set at the first non-ws char (object | array | string | scalar);
    scalar values stop BEFORE their terminator (",", "}", "]", ws).
    ``sink(span, kind)`` receives every consumed value char (used to
    stream object arguments raw); ``keep`` retains raw for decoding.
    Mismatched brackets raise ``_MachineDegrade("bad_nesting")``."""

    def __init__(self, sink=None, keep: bool = False) -> None:
        self.kind: Optional[str] = None
        self.done = False
        self.keep = keep
        self.sink = sink
        self.raw: List[str] = []
        self._stack: List[str] = []
        self._in_str = False
        self._esc = False

    def feed(self, text: str) -> int:
        i, n = 0, len(text)
        v0 = 0 if self.kind is not None else None
        while i < n and not self.done:
            c = text[i]
            if self.kind is None:
                if c in _WS:
                    i += 1
                    continue
                v0 = i
                if c == "{" or c == "[":
                    self.kind = "object" if c == "{" else "array"
                    self._stack.append(c)
                elif c == '"':
                    self.kind = "string"
                    self._in_str = True
                else:
                    self.kind = "scalar"
                i += 1
                continue
            if self.kind == "scalar":
                if c in _SCALAR_END:
                    self.done = True
                    break
                i += 1
                continue
            if self.kind == "string":
                i += 1
                if self._esc:
                    self._esc = False
                elif c == "\\":
                    self._esc = True
                elif c == '"':
                    self.done = True
                continue
            # object | array
            i += 1
            if self._in_str:
                if self._esc:
                    self._esc = False
                elif c == "\\":
                    self._esc = True
                elif c == '"':
                    self._in_str = False
            elif c == '"':
                self._in_str = True
            elif c == "{" or c == "[":
                self._stack.append(c)
            elif c == "}" or c == "]":
                opener = self._stack.pop() if self._stack else None
                if opener is None or (c == "}") != (opener == "{"):
                    raise _MachineDegrade("bad_nesting")
                if not self._stack:
                    self.done = True
        if v0 is not None and i > v0:
            span = text[v0:i]
            if self.keep:
                self.raw.append(span)
            if self.sink is not None:
                self.sink(span, self.kind)
        return i

    def raw_text(self) -> str:
        return "".join(self.raw)

    def decode_string(self) -> str:
        raw = self.raw_text()
        if raw.startswith('"'):
            raw = raw[1:]
        if raw.endswith('"') and not raw.endswith('\\"'):
            raw = raw[:-1]
        try:
            return json.loads('"' + raw + '"')
        except json.JSONDecodeError:
            return raw


class _ArgsValue:
    """The ``arguments`` value of a call, streamed per the OpenAI wire
    contract: an OBJECT value streams its raw text as argument deltas
    while it is still being generated; a string value is decoded at its
    close (emitted verbatim when it parses as a JSON object, wrapped as
    ``{"__raw__": ...}`` + degraded when it doesn't — the streaming twin
    of tool_calling._normalize); arrays and scalars buffer and emit one
    ``{"value": ...}`` wrap at completion.

    ``string_embedded_json=False`` (harmony payloads) switches the
    string rule: there a top-level string IS the argument value
    (``{"value": s}``, matching the one-shot harmony parser), not an
    embedded-JSON arguments string."""

    def __init__(
        self, emit: Callable[[str], None],
        string_embedded_json: bool = True,
    ) -> None:
        self._emit = emit
        self._string_embedded_json = string_embedded_json
        self.degraded = False
        self.done = False
        self.any_text = False
        self._stream = False
        self._val = _JsonValue(sink=self._on_span, keep=True)

    def _on_span(self, span: str, kind: Optional[str]) -> None:
        if kind == "object":
            if not self._stream:
                self._stream = True
                self._val.keep = False
            self._val.raw = []
            self.any_text = True
            self._emit(span)

    def feed(self, text: str) -> int:
        i = self._val.feed(text)
        if self._val.done:
            self.done = True
            if not self._stream:
                self._finalize()
        return i

    def close(self) -> str:
        """End-of-payload (a dialect terminator or EOF closed the value's
        surrounding construct): ``done`` | ``empty`` | ``truncated``.
        A scalar is terminated by the construct end itself (JSON scalars
        only complete on a delimiter char, which a dialect terminator
        eats before the scanner sees it) — finalize it; an unterminated
        string/object/array is genuinely truncated."""
        if self.done:
            return "done"
        v = self._val
        if v.kind is None:
            return "empty"
        if v.kind == "scalar":
            self.done = True
            self._finalize()
            return "done"
        return "truncated"

    def _finalize(self) -> None:
        raw = self._val.raw_text()
        kind = self._val.kind
        self.any_text = True
        if kind == "string":
            s = self._val.decode_string()
            if not self._string_embedded_json:
                self._emit(json.dumps({"value": s}, separators=(",", ":")))
                return
            try:
                parsed = json.loads(s)
            except json.JSONDecodeError:
                self.degraded = True
                self._emit(json.dumps({"__raw__": s}, separators=(",", ":")))
                return
            if isinstance(parsed, dict):
                self._emit(s)
            else:
                self._emit(
                    json.dumps({"value": parsed}, separators=(",", ":"))
                )
            return
        try:
            parsed = json.loads(raw)
        except json.JSONDecodeError:
            self.degraded = True
            self._emit(json.dumps({"__raw__": raw}, separators=(",", ":")))
            return
        self._emit(json.dumps({"value": parsed}, separators=(",", ":")))


class _CallObject:
    """One streamed ``{"name": ..., "arguments": {...}}`` call object.

    Emits ``CallStart`` as soon as the name string completes (arguments
    that arrived first are buffered and flushed right after), argument
    deltas as the arguments value streams, ``CallEnd`` at the closing
    brace. The ``{"function": {...}}`` wrapper form is descended into
    transparently (same key loop, one depth deeper); unknown keys (id,
    type, ...) have their values skipped raw."""

    def __init__(self, m: "_Machine") -> None:
        self.m = m
        self.state = "start"
        self.depth = 0
        self.started = False
        self.done = False
        self.degraded = False
        self.index: Optional[int] = None
        self.call_id: Optional[str] = None
        self.name: Optional[str] = None
        self._key: Optional[str] = None
        self._str: Optional[_JsonString] = None
        self._val: Optional[_JsonValue] = None
        self._args: Optional[_ArgsValue] = None
        self._args_seen = False
        self._args_emitted = False
        self._args_buf: List[str] = []

    # -- emission ----------------------------------------------------------

    def _emit_args(self, text: str) -> None:
        if not text:
            return
        self._args_emitted = True
        if self.started:
            self.m._emit(ArgsDelta(self.index, text))
        else:
            self._args_buf.append(text)

    def _set_name(self, name: str) -> None:
        if not isinstance(name, str) or not name:
            raise _MachineDegrade("bad_name")
        self.name = name
        if not self.started:
            self.started = True
            self.index = self.m.ctx.alloc_index()
            self.call_id = self.m.ctx.new_call_id()
            self.m._emit(CallStart(self.index, name, self.call_id))
            if self._args_buf:
                buffered, self._args_buf = "".join(self._args_buf), []
                self.m._emit(ArgsDelta(self.index, buffered))

    def _close(self) -> None:
        if not self.started:
            raise _MachineDegrade("no_name")
        if not self._args_emitted:
            self.m._emit(ArgsDelta(self.index, "{}"))
        if self._args is not None and self._args.degraded:
            self.degraded = True
        self.m._emit(CallEnd(self.index, degraded=self.degraded))
        self.done = True

    # -- consumption -------------------------------------------------------

    def feed(self, text: str) -> int:
        i, n = 0, len(text)
        while i < n and not self.done:
            st = self.state
            if st == "key_str":
                i += self._str.feed(text[i:])
                if self._str.done:
                    self._key = self._str.value()
                    self._str = None
                    self.state = "colon"
                continue
            if st == "value_args":
                i += self._args.feed(text[i:])
                if self._args.done:
                    self.state = "key"
                continue
            if st == "value_name":
                i += self._val.feed(text[i:])
                if self._val.done:
                    if self._val.kind != "string":
                        raise _MachineDegrade("bad_name")
                    self._set_name(self._val.decode_string())
                    self._val = None
                    self.state = "key"
                continue
            if st == "value_skip":
                i += self._val.feed(text[i:])
                if self._val.done:
                    self._val = None
                    self.state = "key"
                continue
            c = text[i]
            if st == "start":
                if c in _WS:
                    i += 1
                    continue
                if c == "{":
                    self.depth = 1
                    self.state = "key"
                    i += 1
                    continue
                raise _MachineDegrade("not_object")
            if st == "key":
                if c in _WS or c == ",":
                    i += 1
                    continue
                if c == '"':
                    self._str = _JsonString()
                    self.state = "key_str"
                    i += 1
                    continue
                if c == "}":
                    i += 1
                    self.depth -= 1
                    if self.depth == 0:
                        self._close()
                    continue
                raise _MachineDegrade("bad_token")
            if st == "colon":
                if c in _WS:
                    i += 1
                    continue
                if c == ":":
                    self.state = "value_start"
                    i += 1
                    continue
                raise _MachineDegrade("bad_token")
            if st == "value_start":
                if c in _WS:
                    i += 1
                    continue
                key = self._key
                if key in ("arguments", "parameters") and not self._args_seen:
                    self._args_seen = True
                    self._args = _ArgsValue(self._emit_args)
                    self.state = "value_args"
                    continue
                if key == "name":
                    self._val = _JsonValue(keep=True)
                    self.state = "value_name"
                    continue
                if key == "function" and c == "{":
                    self.depth += 1
                    self.state = "key"
                    i += 1
                    continue
                self._val = _JsonValue()
                self.state = "value_skip"
                continue
            raise _MachineDegrade("bad_token")  # pragma: no cover
        return i


class _CallsValue:
    """One call object OR a JSON list of call objects (the shared inner
    engine of the json dialect, hermes payloads, and mistral)."""

    def __init__(self, m: "_Machine") -> None:
        self.m = m
        self.state = "start"
        self.done = False
        self._list = False
        self._call: Optional[_CallObject] = None

    def feed(self, text: str) -> int:
        i, n = 0, len(text)
        while i < n and not self.done:
            if self.state == "call":
                k = self._call.feed(text[i:])
                i += k
                if self._call.done:
                    self._call = None
                    if self._list:
                        self.state = "sep"
                    else:
                        self.done = True
                elif k == 0:
                    break
                continue
            c = text[i]
            if c in _WS:
                i += 1
                continue
            if self.state == "start":
                if c == "{":
                    self._call = _CallObject(self.m)
                    self.state = "call"
                    continue
                if c == "[":
                    self._list = True
                    self.state = "item"
                    i += 1
                    continue
                raise _MachineDegrade("not_call")
            if self.state == "item":
                if c == "{":
                    self._call = _CallObject(self.m)
                    self.state = "call"
                    continue
                if c == "]":
                    i += 1
                    self.done = True
                    continue
                raise _MachineDegrade("bad_list")
            if self.state == "sep":
                if c == ",":
                    self.state = "item"
                    i += 1
                    continue
                if c == "]":
                    i += 1
                    self.done = True
                    continue
                raise _MachineDegrade("bad_list")
        return i

    @property
    def open_call(self) -> Optional[_CallObject]:
        return self._call


# ---------------------------------------------------------------------------
# Machine base
# ---------------------------------------------------------------------------


class _Machine:
    """Base plumbing for one jailed segment: ``feed`` appends to the
    unprocessed tail (``_pend``) and steps the state machine; ``_raw``
    tracks raw text consumed since the last emitted event (the
    degrade-to-content replay buffer AND the jail's buffer-cap
    accounting); ``done`` + ``trailing`` hand unconsumed text back to the
    jail's detector (back-to-back calls with content between them)."""

    dialect = "?"

    def __init__(self, ctx: _JailCtx) -> None:
        self.ctx = ctx
        self.done = False
        self.trailing = ""
        self.open_index: Optional[int] = None
        self.calls_done = 0
        # True once ANY event left this machine. Gates degrade-to-content:
        # the raw tail is only an exact replay while nothing was emitted
        # (events can land mid-_step, before the between-step raw trim, so
        # replaying raw after an emission would duplicate the call's text
        # on the wire as content).
        self.emitted_any = False
        self._pend = ""
        self._raw: List[str] = []
        self._raw_len = 0
        self._out: List[object] = []
        self._resolved = False

    # -- event plumbing ----------------------------------------------------

    def _emit(self, ev: object) -> None:
        self._out.append(ev)
        self.emitted_any = True
        if isinstance(ev, CallStart):
            self.open_index = ev.index
        elif isinstance(ev, CallEnd):
            self.open_index = None
            self.calls_done += 1
        self._resolved = True

    def _discard(self) -> None:
        """Mark consumed raw as structurally resolved (dropped segments,
        e.g. harmony analysis) so it neither replays nor counts toward
        the buffer cap."""
        self._resolved = True

    def feed(self, text: str) -> List[object]:
        self._out = []
        self._pend += text
        self._raw.append(text)
        self._raw_len += len(text)
        try:
            while not self.done:
                self._resolved = False
                progressed = self._step()
                if self._resolved:
                    # Everything up to the unprocessed tail is resolved
                    # into events (or dropped); only the tail can still
                    # degrade to content.
                    self._raw = [self._pend]
                    self._raw_len = len(self._pend)
                if not progressed:
                    break
        except _MachineDegrade as exc:
            exc.events = self._out
            raise
        return self._out

    def _step(self) -> bool:
        raise NotImplementedError

    # -- degrade / finish --------------------------------------------------

    def raw_text(self) -> str:
        return "".join(self._raw)

    def raw_len(self) -> int:
        return self._raw_len

    def finish(self) -> List[object]:
        """Stream ended mid-construct: seal an open call as truncated;
        otherwise un-emitted jailed text degrades to content (exact
        replay — only while nothing was emitted, see ``emitted_any``)."""
        self._out = []
        if self.open_index is not None:
            self._emit(CallEnd(self.open_index, error="truncated",
                               degraded=True))
        elif not self.emitted_any:
            raw = self.raw_text()
            if raw.strip():
                self._out.append(ContentDelta(raw))
        self._pend = ""
        self._raw = []
        self._raw_len = 0
        return self._out

    def _finish_done(self) -> None:
        self.done = True
        self.trailing, self._pend = self._pend, ""
        self._resolved = True


class _JsonMachine(_Machine):
    """Dialect ``json``: the stream itself is a call object or a list of
    them (jailed from the first ``{`` / ``[``)."""

    dialect = "json"

    def __init__(self, ctx: _JailCtx) -> None:
        super().__init__(ctx)
        self._calls = _CallsValue(self)

    def _step(self) -> bool:
        if not self._pend:
            return False
        k = self._calls.feed(self._pend)
        self._pend = self._pend[k:]
        if self._calls.done:
            self._finish_done()
            return True
        return False


class _MistralMachine(_Machine):
    """Dialect ``mistral``: ``[TOOL_CALLS]`` then a JSON call list."""

    dialect = "mistral"
    MARKER = "[TOOL_CALLS]"

    def __init__(self, ctx: _JailCtx) -> None:
        super().__init__(ctx)
        self._skip = len(self.MARKER)
        self._calls = _CallsValue(self)

    def _step(self) -> bool:
        if self._skip:
            if len(self._pend) < self._skip:
                return False
            self._pend = self._pend[self._skip:]
            self._skip = 0
            return True
        if not self._pend:
            return False
        k = self._calls.feed(self._pend)
        self._pend = self._pend[k:]
        if self._calls.done:
            self._finish_done()
            return True
        return False


class _TagBlockMachine(_Machine):
    """``<tool_call>`` block: sniffs hermes (JSON payload) vs xml
    (``<function=NAME><parameter=K>V</parameter>...</function>``).
    XML parameters stream element-wise: each completed element appends
    one JSON fragment to the arguments string."""

    MARKER = "<tool_call>"
    CLOSE = "</tool_call>"
    FN_OPEN = "<function="
    FN_CLOSE = "</function>"
    P_OPEN = "<parameter="
    P_CLOSE = "</parameter>"

    def __init__(self, ctx: _JailCtx, force: Optional[str] = None) -> None:
        super().__init__(ctx)
        self._force = force
        self.dialect = force or "hermes"
        self.state = "marker"
        self._skip = len(self.MARKER)
        self._calls: Optional[_CallsValue] = None
        self._buf = ""  # tag-name / parameter-value capture
        self._pkey: Optional[str] = None
        self._nparams = 0
        self._call_index: Optional[int] = None

    def _step(self) -> bool:
        st = self.state
        if st == "marker":
            if len(self._pend) < self._skip:
                return False
            self._pend = self._pend[self._skip:]
            self._skip = 0
            self.state = "sniff"
            return True
        if st == "sniff":
            p = self._pend.lstrip(_WS)
            self._pend = p
            if not p:
                return False
            c = p[0]
            if c == "<":
                if self._force == "hermes":
                    raise _MachineDegrade("drift")
                if p.startswith(self.FN_OPEN):
                    self.dialect = "xml"
                    self._pend = p[len(self.FN_OPEN):]
                    self.state = "xml_name"
                    return True
                if self.FN_OPEN.startswith(p):
                    return False
                raise _MachineDegrade("drift")
            if c in "{[":
                if self._force == "xml":
                    raise _MachineDegrade("drift")
                self.dialect = "hermes"
                self._calls = _CallsValue(self)
                self.state = "payload"
                return True
            raise _MachineDegrade("drift")
        if st == "payload":
            if not self._pend:
                return False
            k = self._calls.feed(self._pend)
            self._pend = self._pend[k:]
            if self._calls.done:
                self.state = "close"
                return True
            return False
        if st == "close":
            p = self._pend.lstrip(_WS)
            self._pend = p
            if not p:
                return False
            if p.startswith(self.CLOSE):
                self._pend = p[len(self.CLOSE):]
                if self.dialect == "xml":
                    self._xml_end_call()
                self._finish_done()
                return True
            if self.CLOSE.startswith(p):
                return False
            raise _MachineDegrade("missing_close")
        if st == "xml_name":
            idx = self._pend.find(">")
            if idx == -1:
                self._buf += self._pend
                self._pend = ""
                return False
            name = self._buf + self._pend[:idx]
            self._pend = self._pend[idx + 1:]
            self._buf = ""
            if not _NAME_RE.match(name):
                raise _MachineDegrade("bad_name")
            self._call_index = self.ctx.alloc_index()
            self._emit(
                CallStart(self._call_index, name, self.ctx.new_call_id())
            )
            self.state = "xml_params"
            return True
        if st == "xml_params":
            p = self._pend.lstrip(_WS)
            self._pend = p
            if not p:
                return False
            if p.startswith(self.P_OPEN):
                self._pend = p[len(self.P_OPEN):]
                self.state = "xml_pkey"
                return True
            if p.startswith(self.FN_CLOSE):
                self._pend = p[len(self.FN_CLOSE):]
                self._emit(ArgsDelta(
                    self._call_index, "}" if self._nparams else "{}"
                ))
                self.state = "close"
                return True
            if self.P_OPEN.startswith(p) or self.FN_CLOSE.startswith(p):
                return False
            raise _MachineDegrade("drift")
        if st == "xml_pkey":
            idx = self._pend.find(">")
            if idx == -1:
                self._buf += self._pend
                self._pend = ""
                return False
            self._pkey = self._buf + self._pend[:idx]
            self._pend = self._pend[idx + 1:]
            self._buf = ""
            if not _NAME_RE.match(self._pkey):
                raise _MachineDegrade("bad_name")
            self.state = "xml_pval"
            return True
        if st == "xml_pval":
            self._buf += self._pend
            self._pend = ""
            idx = self._buf.find(self.P_CLOSE)
            if idx == -1:
                return False
            value = self._buf[:idx].strip()
            self._pend = self._buf[idx + len(self.P_CLOSE):]
            self._buf = ""
            try:
                parsed = json.loads(value)
            except json.JSONDecodeError:
                parsed = value
            frag = (
                ("{" if self._nparams == 0 else ",")
                + json.dumps(self._pkey)
                + ":"
                + json.dumps(parsed, separators=(",", ":"))
            )
            self._nparams += 1
            self._emit(ArgsDelta(self._call_index, frag))
            self.state = "xml_params"
            return True
        raise _MachineDegrade("drift")  # pragma: no cover

    def _xml_end_call(self) -> None:
        self._emit(CallEnd(self._call_index))


class _HarmonyMachine(_Machine):
    """gpt-oss harmony channels. Routing: ``analysis`` is reasoning and
    is dropped; ``commentary to=functions.NAME`` is a tool call whose
    JSON payload streams as argument deltas; ``final`` streams to
    content (whitespace-trimmed per segment, matching the one-shot
    parser). The machine owns the stream to its end — harmony formats
    the whole response once a channel marker appears."""

    dialect = "harmony"
    CHANNEL = "<|channel|>"
    MESSAGE = "<|message|>"
    TERMS = ("<|call|>", "<|end|>", "<|channel|>", "<|start|>")

    def __init__(self, ctx: _JailCtx) -> None:
        super().__init__(ctx)
        self.state = "marker"
        self._skip = len(self.CHANNEL)
        self._hbuf = ""
        self._mode: Optional[str] = None
        self._args: Optional[_ArgsValue] = None
        self._call_index: Optional[int] = None
        self._lead = False
        self._ws_hold = ""

    def _step(self) -> bool:
        st = self.state
        if st == "marker":
            if len(self._pend) < self._skip:
                return False
            self._pend = self._pend[self._skip:]
            self._skip = 0
            self.state = "header"
            return True
        if st == "header":
            self._hbuf += self._pend
            self._pend = ""
            idx = self._hbuf.find(self.MESSAGE)
            if idx == -1:
                return False
            header = self._hbuf[:idx]
            self._pend = self._hbuf[idx + len(self.MESSAGE):]
            self._hbuf = ""
            self._begin_segment(header.strip())
            self.state = "body"
            return True
        if st == "body":
            if not self._pend:
                return False
            idx, term = find_first(self._pend, self.TERMS)
            if idx == -1:
                part, self._pend = holdback_split(self._pend, self.TERMS)
                if part:
                    self._route(part)
                return False
            part = self._pend[:idx]
            self._pend = self._pend[idx + len(term):]
            if part:
                self._route(part)
            self._end_segment()
            if term == self.CHANNEL:
                self.state = "header"
            else:
                self.state = "filler"
            return True
        if st == "filler":
            idx = self._pend.find(self.CHANNEL)
            if idx == -1:
                _, self._pend = holdback_split(self._pend, (self.CHANNEL,))
                self._discard()
                return False
            self._pend = self._pend[idx + len(self.CHANNEL):]
            self._discard()
            self.state = "header"
            return True
        raise _MachineDegrade("drift")  # pragma: no cover

    def _begin_segment(self, header: str) -> None:
        if header.startswith("analysis"):
            self._mode = "analysis"
        elif header.startswith("final"):
            self._mode = "final"
            self._lead = True
            self._ws_hold = ""
        elif header.startswith("commentary"):
            m = re.search(r"to=functions\.([\w.-]+)", header)
            if m is None:
                self._mode = "drop"
            else:
                self._mode = "call"
                self._call_index = self.ctx.alloc_index()
                self._emit(CallStart(
                    self._call_index, m.group(1), self.ctx.new_call_id()
                ))
                self._args = _ArgsValue(
                    self._emit_args, string_embedded_json=False
                )
        else:
            raise _MachineDegrade("drift")

    def _emit_args(self, text: str) -> None:
        if text:
            self._emit(ArgsDelta(self._call_index, text))

    def _route(self, part: str) -> None:
        mode = self._mode
        if mode == "call":
            self._args.feed(part)
            # Trailing text after a complete payload (usually ws) is
            # structural filler.
            self._discard()
            return
        if mode == "final":
            if self._lead:
                part = part.lstrip()
                if not part:
                    self._discard()
                    return
                self._lead = False
            s = self._ws_hold + part
            emit_part = s.rstrip()
            self._ws_hold = s[len(emit_part):]
            if emit_part:
                self._emit(ContentDelta(emit_part))
            else:
                self._discard()
            return
        # analysis / drop: reasoning or non-function commentary — dropped
        # as it arrives (an endless analysis channel must not grow the
        # jail buffer).
        self._discard()

    def _end_segment(self) -> None:
        if self._mode == "call":
            self._seal_call()
        elif self._mode == "final":
            self._ws_hold = ""
        self._mode = None

    def _seal_call(self) -> None:
        args = self._args
        status = args.close() if args is not None else "empty"
        if status == "done":
            # Scalar/string payloads finalize at the terminator (the
            # one-shot parser's {"value": ...} / verbatim-object shapes).
            self._emit(CallEnd(self._call_index, degraded=args.degraded))
        elif status == "empty":
            self._emit(ArgsDelta(self._call_index, "{}"))
            self._emit(CallEnd(self._call_index))
        else:
            # Payload ended (terminator / EOF) mid-JSON: the emitted
            # deltas are sealed as a truncated call.
            self._emit(CallEnd(self._call_index, error="truncated",
                               degraded=True))
        self._args = None
        self._call_index = None

    def finish(self) -> List[object]:
        self._out = []
        if self.state == "body":
            # A body running to EOF is complete by the harmony grammar
            # (the one-shot regexes accept ``$`` as a terminator).
            self._end_segment()
        elif self.open_index is not None:
            self._emit(CallEnd(self.open_index, error="truncated",
                               degraded=True))
        elif self.state == "header" and not self.emitted_any:
            raw = self.raw_text()
            if raw.strip():
                self._out.append(ContentDelta(raw))
        self._pend = ""
        self._raw = []
        self._raw_len = 0
        return self._out


class _DsmlMachine(_Machine):
    """DeepSeek DSML: ``<｜DSML｜function_calls>`` block of invokes with
    typed parameter elements. Element-wise streaming: each completed
    ``<｜DSML｜parameter ...>`` appends one JSON fragment."""

    dialect = "dsml"
    MARK = "<｜DSML｜"
    OPEN_TAIL = "function_calls>"
    P_CLOSE = "</｜DSML｜parameter>"
    INVOKE_RE = re.compile(r'^<｜DSML｜invoke\s+name="([^"]+)"\s*>$')
    PARAM_RE = re.compile(
        r'^<｜DSML｜parameter\s+name="([^"]+)"'
        r'(?:\s+string="(true|false)")?\s*>$'
    )
    BLOCK_CLOSE = "</｜DSML｜function_calls>"
    INVOKE_CLOSE = "</｜DSML｜invoke>"

    def __init__(self, ctx: _JailCtx) -> None:
        super().__init__(ctx)
        self.state = "marker"
        self._skip = len(self.MARK)
        self._tbuf = ""
        self._vbuf = ""
        self._pkey: Optional[str] = None
        self._pstring: Optional[str] = None
        self._nparams = 0
        self._call_index: Optional[int] = None

    def _take_tag(self) -> Optional[str]:
        """Accumulate ``self._pend`` until a ``>`` closes the tag."""
        self._tbuf += self._pend
        self._pend = ""
        idx = self._tbuf.find(">")
        if idx == -1:
            return None
        tag = self._tbuf[: idx + 1]
        self._pend = self._tbuf[idx + 1:]
        self._tbuf = ""
        return tag

    def _step(self) -> bool:
        st = self.state
        if st == "marker":
            if len(self._pend) < self._skip:
                return False
            self._pend = self._pend[self._skip:]
            self._skip = 0
            self.state = "open"
            return True
        if st == "open":
            p = self._pend
            if p.startswith(self.OPEN_TAIL):
                self._pend = p[len(self.OPEN_TAIL):]
                self.state = "body"
                return True
            if self.OPEN_TAIL.startswith(p):
                return False
            raise _MachineDegrade("drift")
        if st in ("body", "params"):
            if not self._tbuf:
                p = self._pend.lstrip(_WS)
                self._pend = p
                if not p:
                    return False
                if p[0] != "<":
                    raise _MachineDegrade("drift")
            tag = self._take_tag()
            if tag is None:
                return False
            if st == "body":
                m = self.INVOKE_RE.match(tag)
                if m is not None:
                    self._call_index = self.ctx.alloc_index()
                    self._nparams = 0
                    self._emit(CallStart(
                        self._call_index, m.group(1), self.ctx.new_call_id()
                    ))
                    self.state = "params"
                    return True
                if tag == self.BLOCK_CLOSE:
                    self._finish_done()
                    return True
                raise _MachineDegrade("drift")
            m = self.PARAM_RE.match(tag)
            if m is not None:
                self._pkey, self._pstring = m.group(1), m.group(2)
                self._vbuf = ""
                self.state = "pvalue"
                return True
            if tag == self.INVOKE_CLOSE:
                self._emit(ArgsDelta(
                    self._call_index, "}" if self._nparams else "{}"
                ))
                self._emit(CallEnd(self._call_index))
                self.state = "body"
                return True
            raise _MachineDegrade("drift")
        if st == "pvalue":
            self._vbuf += self._pend
            self._pend = ""
            idx = self._vbuf.find(self.P_CLOSE)
            if idx == -1:
                return False
            value = self._vbuf[:idx].strip()
            self._pend = self._vbuf[idx + len(self.P_CLOSE):]
            self._vbuf = ""
            if self._pstring == "false":
                try:
                    parsed = json.loads(value)
                except json.JSONDecodeError:
                    parsed = value
            else:
                parsed = value
            frag = (
                ("{" if self._nparams == 0 else ",")
                + json.dumps(self._pkey)
                + ":"
                + json.dumps(parsed, separators=(",", ":"))
            )
            self._nparams += 1
            self._emit(ArgsDelta(self._call_index, frag))
            self.state = "params"
            return True
        raise _MachineDegrade("drift")  # pragma: no cover


class _PyLiteral:
    """One Python literal expression consumed up to a top-level ``,`` or
    ``)`` — quote-aware (single/double, escapes) and bracket-aware, so
    nested JSON text inside a string argument never splits early."""

    def __init__(self) -> None:
        self.text: List[str] = []
        self.done = False
        self.term: Optional[str] = None
        self._depth = 0
        self._quote: Optional[str] = None
        self._esc = False

    def feed(self, text: str) -> int:
        i, n = 0, len(text)
        start = 0
        while i < n:
            c = text[i]
            if self._quote is not None:
                i += 1
                if self._esc:
                    self._esc = False
                elif c == "\\":
                    self._esc = True
                elif c == self._quote:
                    self._quote = None
                continue
            if c in "'\"":
                self._quote = c
                i += 1
                continue
            if c in "([{":
                self._depth += 1
                i += 1
                continue
            if c in ")]}":
                if self._depth == 0:
                    if c == ")":
                        self.done = True
                        self.term = c
                        break
                    raise _MachineDegrade("bad_nesting")
                self._depth -= 1
                i += 1
                continue
            if c == "," and self._depth == 0:
                self.done = True
                self.term = c
                break
            i += 1
        self.text.append(text[start:i])
        return i

    def raw(self) -> str:
        return "".join(self.text)


_IDENT_CHARS = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_."
)
_IDENT_RE = re.compile(r"^[A-Za-z_][\w.]*$")


class _PythonicMachine(_Machine):
    """Pinned ``pythonic`` dialect: ``[fn(a=1, b="x"), g()]``.
    Element-wise streaming: each completed keyword argument appends one
    JSON fragment; positional arguments are malformed by the dialect and
    degrade (the one-shot parser rejects them too)."""

    dialect = "pythonic"

    def __init__(self, ctx: _JailCtx) -> None:
        super().__init__(ctx)
        self.state = "openbr"
        self._ibuf = ""
        self._lit: Optional[_PyLiteral] = None
        self._key: Optional[str] = None
        self._nargs = 0
        self._call_index: Optional[int] = None

    def _ident_split(self) -> Optional[str]:
        """Take leading identifier chars from ``_pend`` into ``_ibuf``;
        returns the first non-identifier char (unconsumed) or None when
        more input is needed."""
        p = self._pend
        k = 0
        while k < len(p) and p[k] in _IDENT_CHARS:
            k += 1
        self._ibuf += p[:k]
        self._pend = p[k:]
        if not self._pend:
            return None
        return self._pend[0]

    def _close_call(self) -> None:
        self._emit(ArgsDelta(
            self._call_index, "}" if self._nargs else "{}"
        ))
        self._emit(CallEnd(self._call_index))
        self.state = "sep"

    def _step(self) -> bool:
        st = self.state
        if st == "openbr":
            if not self._pend:
                return False
            if self._pend[0] != "[":
                raise _MachineDegrade("not_call")
            self._pend = self._pend[1:]
            self.state = "call_or_end"
            return True
        if st == "aval":
            if not self._pend:
                return False
            k = self._lit.feed(self._pend)
            self._pend = self._pend[k:]
            if not self._lit.done:
                return False
            raw = self._lit.raw().strip()
            try:
                v = ast.literal_eval(raw)
                frag_v = json.dumps(v, separators=(",", ":"))
            except (ValueError, SyntaxError, TypeError,
                    MemoryError, RecursionError):
                raise _MachineDegrade("bad_literal")
            frag = (
                ("{" if self._nargs == 0 else ",")
                + json.dumps(self._key) + ":" + frag_v
            )
            self._nargs += 1
            self._emit(ArgsDelta(self._call_index, frag))
            term, self._pend = self._pend[0], self._pend[1:]
            self._lit = None
            if term == ",":
                self.state = "arg_or_close"
            else:
                self._close_call()
            return True
        p = self._pend.lstrip(_WS) if not self._ibuf else self._pend
        self._pend = p
        if st == "call_or_end":
            if not p and not self._ibuf:
                return False
            if not self._ibuf and p[0] == "]":
                self._pend = p[1:]
                self._finish_done()
                return True
            nxt = self._ident_split()
            if nxt is None:
                return False
            name, self._ibuf = self._ibuf, ""
            if nxt != "(" or not _IDENT_RE.match(name):
                raise _MachineDegrade("drift")
            self._pend = self._pend[1:]
            self._call_index = self.ctx.alloc_index()
            self._nargs = 0
            self._emit(CallStart(
                self._call_index, name, self.ctx.new_call_id()
            ))
            self.state = "arg_or_close"
            return True
        if st == "arg_or_close":
            if not p and not self._ibuf:
                return False
            if not self._ibuf and p[0] == ")":
                self._pend = p[1:]
                self._close_call()
                return True
            if not self._ibuf and p[0] not in _IDENT_CHARS:
                raise _MachineDegrade("positional")
            nxt = self._ident_split()
            if nxt is None:
                return False
            key, self._ibuf = self._ibuf, ""
            if nxt != "=" or not _IDENT_RE.match(key):
                raise _MachineDegrade("positional")
            self._pend = self._pend[1:]
            self._key = key
            self._lit = _PyLiteral()
            self.state = "aval"
            return True
        if st == "sep":
            if not p:
                return False
            if p[0] == ",":
                self._pend = p[1:]
                self.state = "call_or_end"
                return True
            if p[0] == "]":
                self._pend = p[1:]
                self._finish_done()
                return True
            raise _MachineDegrade("drift")
        raise _MachineDegrade("drift")  # pragma: no cover


# ---------------------------------------------------------------------------
# Dialect registry (the jail's detector uses this)
# ---------------------------------------------------------------------------

# Auto-detect markers → machine factory. hermes and xml share the
# <tool_call> marker; _TagBlockMachine sniffs which one it is.
AUTO_MARKERS = (
    ("<tool_call>", lambda ctx: _TagBlockMachine(ctx)),
    ("[TOOL_CALLS]", lambda ctx: _MistralMachine(ctx)),
    ("<|channel|>", lambda ctx: _HarmonyMachine(ctx)),
    ("<｜DSML｜", lambda ctx: _DsmlMachine(ctx)),
)

# Pinned dialect → (markers, machine factory).
PINNED = {
    "json": (("{", "["), _JsonMachine),
    "pythonic": (("[",), _PythonicMachine),
    "hermes": (
        ("<tool_call>",), lambda ctx: _TagBlockMachine(ctx, force="hermes")
    ),
    "xml": (
        ("<tool_call>",), lambda ctx: _TagBlockMachine(ctx, force="xml")
    ),
    "mistral": (("[TOOL_CALLS]",), _MistralMachine),
    "harmony": (("<|channel|>",), _HarmonyMachine),
    "dsml": (("<｜DSML｜",), _DsmlMachine),
}
