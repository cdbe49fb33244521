"""Parser-plane observability: the parser metric families and the
``parser`` flight ring — the port's copy of dynamo_tpu/parsers/observe.py.

One process-global ``ParserPlane`` (the frontend's event loop is the
single writer — every ``ToolCallJail`` lives inside an SSE handler on
that loop). The jail reports commits, completed
calls, argument-delta volume, degradation-ladder activations, lossy
``__raw__`` argument wraps (the ``tool_calling._normalize`` counter),
parser exceptions (each one is a terminal typed SSE
error frame downstream), and the peak jailed-buffer size. The frontend's
``/metrics`` and ``/debug/parser`` routes read it.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from dynamo_tpu_torch.runtime import metric_names as mn
from dynamo_tpu_torch.runtime.device_observe import FlightRecorder
from dynamo_tpu_torch.runtime.faults import note_activity
from dynamo_tpu_torch.runtime.metrics_core import MetricsRegistry


class ParserMetrics:
    """Canonical parser families (runtime/metric_names.py) on a private
    registry; ``render`` plugs into the frontend's ``/metrics`` route."""

    def __init__(self) -> None:
        self.registry = MetricsRegistry()
        self.tool_calls = self.registry.counter(
            mn.PARSER_TOOL_CALLS_TOTAL,
            "Tool calls fully streamed (CallStart..CallEnd), by dialect",
            ["dialect"],
        )
        self.args_delta_chars = self.registry.counter(
            mn.PARSER_ARGS_DELTA_CHARS_TOTAL,
            "Argument-delta characters emitted mid-generation, by dialect "
            "(the incremental jail's reason to exist: nonzero here means "
            "argument bytes reached clients before the call closed)",
            ["dialect"],
        )
        self.degraded_calls = self.registry.counter(
            mn.PARSER_DEGRADED_CALLS_TOTAL,
            "Degradation-ladder activations, by dialect and reason "
            "(truncated | bad_nesting | drift | buffer_cap | ...): the "
            "malformed call was sealed / returned to content — never a "
            "dropped stream",
            ["dialect", "reason"],
        )
        self.degraded_args = self.registry.counter(
            mn.PARSER_DEGRADED_ARGS_TOTAL,
            "Calls whose argument string was unparseable and shipped as a "
            "lossy {\"__raw__\": ...} wrap (tool_calling._normalize and "
            "its streaming twin) — clients see degraded=true",
            ["dialect"],
        )
        self.exceptions = self.registry.counter(
            mn.PARSER_EXCEPTIONS_TOTAL,
            "Parser BUGS (not malformed model output): each one surfaced "
            "as a terminal typed SSE error frame "
            "(error_kind=tool_call_parse)",
        )
        self.streams = self.registry.counter(
            mn.PARSER_STREAMS_TOTAL,
            "Tool-enabled streams through the jail, by outcome "
            "(clean | degraded | error)",
            ["outcome"],
        )
        self.buffered_peak = self.registry.gauge(
            mn.PARSER_JAIL_BUFFERED_PEAK_CHARS,
            "Peak jailed-buffer size (chars) across streams — bounded by "
            "the jail's buffer cap by construction",
        )

    def render(self, openmetrics: bool = False) -> str:
        return self.registry.render(openmetrics=openmetrics)


class ParserPlane:
    """Process-global parser observability. Threading contract: mutating
    notes run on the frontend's event loop (single-writer flight ring);
    render/snapshot may run anywhere."""

    def __init__(self) -> None:
        self.flight = FlightRecorder("parser", capacity=1024)
        self.metrics = ParserMetrics()
        self.peak_buffered = 0
        # Lifetime counters (/debug/parser snapshots read these;
        # the metric families are their scrapeable form).
        self.calls = 0
        self.degrades: Dict[str, int] = {}
        self.exceptions = 0
        self.streams: Dict[str, int] = {}
        self.metrics.registry.on_render(self._refresh)

    def _refresh(self) -> None:
        self.metrics.buffered_peak.set(self.peak_buffered)

    # -- jail reporting ----------------------------------------------------

    def note_commit(self, dialect: str) -> None:
        self.flight.record("jail_commit", dialect=dialect)

    def note_call(self, dialect: str, name: str) -> None:
        self.calls += 1
        self.metrics.tool_calls.inc(dialect=dialect)
        self.flight.record("call", dialect=dialect, name=name)

    def note_args_chars(self, dialect: str, n: int) -> None:
        self.metrics.args_delta_chars.inc(n, dialect=dialect)

    def note_degrade(self, dialect: str, reason: str) -> None:
        self.degrades[reason] = self.degrades.get(reason, 0) + 1
        self.metrics.degraded_calls.inc(dialect=dialect, reason=reason)
        self.flight.record("degrade", dialect=dialect, reason=reason)
        note_activity("parser_degraded")

    def note_degraded_args(self, dialect: str) -> None:
        self.metrics.degraded_args.inc(dialect=dialect)

    def note_exception(self, dialect: str) -> None:
        self.exceptions += 1
        self.metrics.exceptions.inc()
        self.flight.record("exception", dialect=dialect)
        note_activity("parser_exceptions")

    def note_stream(self, outcome: str) -> None:
        self.streams[outcome] = self.streams.get(outcome, 0) + 1
        self.metrics.streams.inc(outcome=outcome)

    def note_buffered(self, chars: int) -> None:
        if chars > self.peak_buffered:
            self.peak_buffered = chars

    # -- surfaces ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        return {
            "calls": self.calls,
            "degrades": dict(self.degrades),
            "exceptions": self.exceptions,
            "streams": dict(self.streams),
            "peak_buffered_chars": self.peak_buffered,
        }


_PLANE: Optional[ParserPlane] = None
_PLANE_LOCK = threading.Lock()


def parser_plane() -> ParserPlane:
    """The process-global plane (created on first use)."""
    global _PLANE
    if _PLANE is None:
        with _PLANE_LOCK:
            if _PLANE is None:
                _PLANE = ParserPlane()
    return _PLANE
