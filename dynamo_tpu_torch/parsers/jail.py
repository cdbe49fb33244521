"""Streaming tool-call jail: incremental, dialect-aware, never drops —
the port's copy of dynamo_tpu/parsers/jail.py.

Reference parity: the reference's ~1.2k-LoC incremental jail
(lib/llm/src/protocols/openai/chat_completions/jail.rs). The old jail
buffered a tool call from first marker to ``flush()`` at stream end —
time-to-first-tool-call-byte was O(call length) and a malformed call had
no degradation path. This jail is the orchestrator over the per-dialect
streaming machines in parsers/incremental.py:

  * DETECT — content streams through; a suffix that might be a partial
    opening marker is held back one delta (parsers/holdback.py, the same
    scheme the reasoning parser uses). A complete marker commits the
    matching dialect machine.
  * STREAM — the machine emits ``CallStart`` as soon as the call name is
    parseable, ``ArgsDelta`` raw argument text as the model generates it
    (partial-JSON for json/hermes/mistral/harmony, element-wise for
    pythonic/dsml/xml), ``CallEnd`` when the call closes. A machine that
    finishes its construct hands trailing text back to DETECT, so two
    back-to-back calls with content between them stream naturally.
  * Degradation ladder — malformed input (truncated JSON, bad nesting,
    dialect drift mid-call, buffer-cap overflow) NEVER kills the stream:
    a call that already emitted deltas is sealed with ``CallEnd(error=
    reason)``; un-emitted jailed text degrades to content deltas; the
    buffer-cap rung additionally stops jailing for the rest of the
    stream (PASSTHROUGH). A parser exception anywhere (a BUG, not bad
    input — exercised deterministically via the ``parser.jail.feed``
    fault seam) is wrapped in ``ToolCallParseError`` so the HTTP layer
    ships a terminal typed SSE error frame (``error_kind=
    tool_call_parse``).
  * Bounded memory — the jail degrades when a machine's unresolved raw
    tail exceeds ``buffer_cap``: a dialect that never closes cannot grow
    host memory without limit.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from dynamo_tpu_torch import config
from dynamo_tpu_torch.parsers.holdback import find_first, holdback_split
from dynamo_tpu_torch.parsers.incremental import (
    AUTO_MARKERS,
    PINNED,
    ArgsDelta,
    CallEnd,
    CallStart,
    ContentDelta,
    ToolCallParseError,
    _JailCtx,
    _MachineDegrade,
)
from dynamo_tpu_torch.runtime.fault_names import PARSER_JAIL_FEED
from dynamo_tpu_torch.runtime.faults import fault_point

# Default unresolved-buffer cap (chars). Generous for real calls (most
# argument payloads stream out incrementally and never sit in the
# buffer) yet small enough that a marker bomb cannot balloon host RSS.
DEFAULT_BUFFER_CAP = config.TOOL_JAIL_CAP_CHARS.get()

_DETECT, _STREAM, _PASSTHROUGH = 0, 1, 2


class ToolCallJail:
    """Feed content deltas; get back typed streaming events
    (parsers/incremental.py ContentDelta / CallStart / ArgsDelta /
    CallEnd). Call ``finish()`` exactly once at stream end."""

    def __init__(
        self,
        dialect: Optional[str] = None,
        *,
        buffer_cap: int = DEFAULT_BUFFER_CAP,
        call_id_factory: Optional[Callable[[], str]] = None,
        plane=None,
    ) -> None:
        if dialect is not None and dialect not in PINNED:
            raise ValueError(
                f"unknown tool-call dialect {dialect!r}; "
                f"known: {sorted(PINNED)}"
            )
        self.dialect = dialect
        self.buffer_cap = int(buffer_cap)
        self._ctx = _JailCtx(call_id_factory)
        if plane is None:
            from dynamo_tpu_torch.parsers.observe import parser_plane

            plane = parser_plane()
        self._plane = plane
        self._mode = _DETECT
        self._machine = None
        self._last_dialect: Optional[str] = None
        self._buf = ""  # DETECT holdback buffer
        self._finished = False
        if dialect is None:
            self._markers = tuple(m for m, _mk in AUTO_MARKERS)
            self._factories = dict(AUTO_MARKERS)
        else:
            markers, factory = PINNED[dialect]
            self._markers = markers
            self._factories = {m: factory for m in markers}
        # Stream-level accounting (the SSE assembler reads these).
        self.calls_started = 0
        self.calls_done = 0
        self.open_calls: set = set()
        self.degrade_reasons: List[str] = []
        self.args_chars = 0

    # -- public surface ----------------------------------------------------

    @property
    def jailed(self) -> bool:
        """True while a dialect machine holds the stream."""
        return self._mode == _STREAM

    def outcome(self) -> str:
        """clean | degraded — one word per stream for ALL_PARSER's
        streams counter (the error outcome is recorded by the HTTP layer
        when a ToolCallParseError reaches it)."""
        return "degraded" if self.degrade_reasons else "clean"

    def feed(self, delta: str) -> List[object]:
        """Process one content delta → events. Malformed input degrades
        (typed ladder); only a parser BUG raises, and it raises
        ``ToolCallParseError``."""
        return self._guard(self._feed_inner, delta)

    def finish(self) -> List[object]:
        """End of stream: close the active machine (sealing a truncated
        call / degrading its un-emitted text) and release any held-back
        detection suffix as content."""
        return self._guard(self._finish_inner)

    # -- internals ---------------------------------------------------------

    def _guard(self, fn, *args) -> List[object]:
        try:
            fault_point(PARSER_JAIL_FEED)
            events = fn(*args)
        except _MachineDegrade as exc:
            events = list(exc.events)
            events.extend(self._ladder(exc.reason))
        except ToolCallParseError:
            raise
        except Exception as exc:
            self._plane.note_exception(self._machine_dialect())
            # The stream is NOT lost: the HTTP layer maps this to a
            # terminal typed SSE error frame (error_kind=tool_call_parse).
            raise ToolCallParseError(
                f"tool-call parser failed: {type(exc).__name__}: {exc}"
            ) from exc
        self._account(events)
        return events

    def _machine_dialect(self) -> str:
        if self._machine is not None:
            return self._machine.dialect
        return self._last_dialect or self.dialect or "auto"

    def _feed_inner(self, delta: str) -> List[object]:
        events: List[object] = []
        text = delta
        while True:
            if self._mode == _PASSTHROUGH:
                if text:
                    events.append(ContentDelta(text))
                break
            if self._mode == _DETECT:
                text = self._buf + text
                self._buf = ""
                idx, marker = find_first(text, self._markers)
                if idx == -1:
                    emit, self._buf = holdback_split(text, self._markers)
                    if emit:
                        events.append(ContentDelta(emit))
                    break
                if text[:idx]:
                    events.append(ContentDelta(text[:idx]))
                self._machine = self._factories[marker](self._ctx)
                self._plane.note_commit(self._machine.dialect)
                self._mode = _STREAM
                text = text[idx:]
                continue
            # _STREAM
            try:
                evs = self._machine.feed(text)
            except _MachineDegrade as exc:
                events.extend(exc.events)
                events.extend(self._ladder(exc.reason))
                break
            events.extend(evs)
            buffered = self._machine.raw_len() + len(self._buf)
            self._plane.note_buffered(buffered)
            if buffered > self.buffer_cap:
                events.extend(self._ladder("buffer_cap"))
                break
            if self._machine.done:
                text = self._machine.trailing
                self._last_dialect = self._machine.dialect
                self._machine = None
                self._mode = _DETECT
                if text:
                    continue
                break
            break
        return events

    def _finish_inner(self) -> List[object]:
        if self._finished:
            return []
        self._finished = True
        events: List[object] = []
        if self._machine is not None:
            self._last_dialect = self._machine.dialect
            try:
                events.extend(self._machine.finish())
            except _MachineDegrade as exc:
                events.extend(exc.events)
                events.extend(self._ladder(exc.reason))
            self._machine = None
        if self._buf:
            # Held-back partial marker that never completed: released
            # verbatim (the old jail's false-alarm flush).
            events.append(ContentDelta(self._buf))
            self._buf = ""
        return events

    def _ladder(self, reason: str) -> List[object]:
        """The typed degradation ladder: seal the open call (its deltas
        already reached the client), return un-emitted jailed text to
        content, and — on buffer-cap overflow — stop jailing entirely."""
        events: List[object] = []
        m = self._machine
        dialect = self._machine_dialect()
        if m is not None:
            if m.open_index is not None:
                # The sealing CallEnd carries the reason; _account counts
                # it (every CallEnd.error is exactly one ladder rung).
                events.append(
                    CallEnd(m.open_index, error=reason, degraded=True)
                )
            else:
                self.degrade_reasons.append(reason)
                self._plane.note_degrade(dialect, reason)
            # Exact-replay guard: the raw tail degrades to content ONLY
            # while the machine emitted nothing (after an emission the
            # tail can overlap already-delivered call text — replaying
            # it would duplicate the call on the wire as content).
            pending = "" if m.emitted_any else m.raw_text()
            if pending:
                events.append(ContentDelta(pending))
        else:
            self.degrade_reasons.append(reason)
            self._plane.note_degrade(dialect, reason)
        if m is not None:
            self._last_dialect = m.dialect
        self._machine = None
        self._mode = _PASSTHROUGH if reason == "buffer_cap" else _DETECT
        return events

    def _account(self, events: List[object]) -> None:
        dialect = self._machine_dialect()
        for ev in events:
            if isinstance(ev, CallStart):
                self.calls_started += 1
                self.open_calls.add(ev.index)
                self._plane.note_call(dialect, ev.name)
            elif isinstance(ev, ArgsDelta):
                self.args_chars += len(ev.text)
                self._plane.note_args_chars(dialect, len(ev.text))
            elif isinstance(ev, CallEnd):
                self.open_calls.discard(ev.index)
                self.calls_done += 1
                if ev.error is not None:
                    # A sealed malformed call (ladder rung 1) — whether
                    # sealed by the ladder, a machine's mid-stream seal
                    # (harmony payload ending mid-JSON), or truncation
                    # at finish().
                    self.degrade_reasons.append(ev.error)
                    self._plane.note_degrade(dialect, ev.error)
                elif ev.degraded:
                    self._plane.note_degraded_args(dialect)
