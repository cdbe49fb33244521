"""Distributed tracing: W3C traceparent propagation + span export — the
port's copy of dynamo_tpu/utils/tracing.py.

Reference parity: lib/runtime/src/logging.rs:72-97 (traceparent parse /
propagate so distributed request flows correlate across frontend → router →
worker) and the OTel span layer the reference hangs off tracing-subscriber.
Dependency-free by design (no otel SDK in the image): spans are recorded to
an in-process ring + optional JSONL file (``DYN_TPU_TRACE_FILE``), one JSON
object per span — the OTLP-friendly shape an exporter can ship later.

Propagation rides Context baggage (runtime/context.py), which the request
plane already serializes: the HTTP/gRPC frontends extract ``traceparent``
into baggage; every hop's spans join the same trace; workers see the parent
span id of the frontend span that dispatched to them.
"""

from __future__ import annotations

import json
import os
import re
import secrets
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional

from dynamo_tpu_torch import config

TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)

# Declared in the canonical registry (config.py).
TRACE_FILE = config.TRACE_FILE
OTLP_ENDPOINT = config.OTLP_ENDPOINT
OTLP_SERVICE = config.OTLP_SERVICE


@dataclass
class TraceContext:
    trace_id: str  # 32 hex
    span_id: str  # 16 hex — the CURRENT span (parent of children)
    sampled: bool = True

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{'01' if self.sampled else '00'}"


def parse_traceparent(header: Optional[str]) -> Optional[TraceContext]:
    """(ref: logging.rs:72 parse_traceparent)"""
    if not header:
        return None
    m = TRACEPARENT_RE.match(header.strip().lower())
    if not m:
        return None
    _, trace_id, span_id, flags = m.groups()
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return TraceContext(trace_id, span_id, sampled=flags != "00")


def new_trace_context() -> TraceContext:
    return TraceContext(secrets.token_hex(16), secrets.token_hex(8))


# -- process/service identity -------------------------------------------------
# Every exported span is stamped with the emitting process's label so the
# frontend's trajectory stitcher (runtime/trajectory.py) knows which spans
# share a clock domain — durations from one proc are comparable, wall
# clocks across procs are NOT (the liveness.py local-clock-only rule).
# Worker/frontend mains set an explicit label; the pid default keeps
# distinct processes distinguishable even unlabeled.

_SERVICE: Optional[str] = None


def set_service(name: str) -> None:
    """Name this process for span attribution (e.g. ``worker-0x1a2b``)."""
    global _SERVICE
    _SERVICE = name


def service_label() -> str:
    return _SERVICE or f"proc-{os.getpid()}"


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_span_id: Optional[str]
    start_s: float
    end_s: float = 0.0
    attributes: Dict[str, Any] = field(default_factory=dict)
    events: List[Dict[str, Any]] = field(default_factory=list)
    status: str = "ok"
    # Clock-domain tag (service_label() at export) + local-monotonic start
    # anchor: the trajectory stitcher uses proc to decide which spans share
    # a clock and start_mono_s for exact same-process offsets.
    proc: Optional[str] = None
    start_mono_s: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "proc": self.proc,
            "start_unix_s": round(self.start_s, 6),
            "start_mono_s": (
                round(self.start_mono_s, 6)
                if self.start_mono_s is not None else None
            ),
            "duration_ms": round((self.end_s - self.start_s) * 1000, 3),
            "attributes": self.attributes,
            "events": self.events,
            "status": self.status,
        }


def _otlp_value(v: Any) -> Dict[str, Any]:
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def _otlp_span(s: Span) -> Dict[str, Any]:
    """One span in OTLP/HTTP JSON encoding (hex ids per the OTLP JSON
    mapping). Ref: lib/runtime/src/logging.rs:72-97 ships the reference's
    spans to a collector via the otel exporter; this is the wire-format
    equivalent without an SDK dependency."""
    out: Dict[str, Any] = {
        "traceId": s.trace_id,
        "spanId": s.span_id,
        "name": s.name,
        "kind": 1,  # SPAN_KIND_INTERNAL
        "startTimeUnixNano": str(int(s.start_s * 1e9)),
        "endTimeUnixNano": str(int(s.end_s * 1e9)),
        "attributes": [
            {"key": k, "value": _otlp_value(v)}
            for k, v in s.attributes.items()
        ],
        "status": (
            {"code": 1}
            if s.status == "ok"
            else {"code": 2, "message": s.status}
        ),
    }
    if s.parent_span_id:
        out["parentSpanId"] = s.parent_span_id
    if s.events:
        out["events"] = [
            {
                "name": e.get("name", "event"),
                "timeUnixNano": str(int(e.get("time_s", s.start_s) * 1e9)),
            }
            for e in s.events
        ]
    return out


class OtlpHttpExporter:
    """Minimal OTLP/HTTP JSON trace exporter (no otel SDK in the image).

    Spans are queued by the tracer's export() and shipped in batches from
    one daemon thread — span-producing paths never block on the network.
    Failures drop the batch after a bounded retry (telemetry must never
    take down serving)."""

    def __init__(
        self,
        endpoint: str,
        *,
        service_name: str = "dynamo-tpu",
        flush_interval_s: float = 2.0,
        max_batch: int = 256,
        max_queue: int = 8192,
    ) -> None:
        self.endpoint = endpoint
        self.service_name = service_name
        self.flush_interval_s = flush_interval_s
        self.max_batch = max_batch
        self._queue: Deque[Span] = deque(maxlen=max_queue)
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self.sent = 0
        self.dropped = 0
        self._thread = threading.Thread(
            target=self._run, name="otlp-exporter", daemon=True
        )
        self._thread.start()

    def offer(self, span: Span) -> None:
        """Enqueue a span; when the bounded queue is full the OLDEST span is
        evicted (deque maxlen semantics) and counted as dropped."""
        with self._lock:
            if len(self._queue) == self._queue.maxlen:
                self.dropped += 1
            self._queue.append(span)
            # Decide the wake inside the lock: the post-append length is
            # only stable here, and a racy read could miss the batch edge.
            wake = len(self._queue) >= self.max_batch
        if wake:
            self._wake.set()

    def _drain(self) -> List[Span]:
        with self._lock:
            batch = list(self._queue)[: self.max_batch]
            for _ in batch:
                self._queue.popleft()
        return batch

    def _post(self, batch: List[Span]) -> None:
        import urllib.request

        body = json.dumps(
            {
                "resourceSpans": [
                    {
                        "resource": {
                            "attributes": [
                                {
                                    "key": "service.name",
                                    "value": {"stringValue": self.service_name},
                                }
                            ]
                        },
                        "scopeSpans": [
                            {
                                "scope": {"name": "dynamo_tpu"},
                                "spans": [_otlp_span(s) for s in batch],
                            }
                        ],
                    }
                ]
            }
        ).encode()
        req = urllib.request.Request(
            self.endpoint, data=body,
            headers={"Content-Type": "application/json"}, method="POST",
        )
        with urllib.request.urlopen(req, timeout=5.0):
            pass

    def _run(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.flush_interval_s)
            self._wake.clear()
            self.flush_once()

    def flush_once(self) -> None:
        while True:
            batch = self._drain()
            if not batch:
                return
            try:
                self._post(batch)
                # Accounted HERE (not inside _post) so success/drop
                # bookkeeping is transport-independent.
                self.sent += len(batch)
            except Exception:
                self.dropped += len(batch)
                return

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=2.0)
        self.flush_once()


class Tracer:
    """Process-wide span recorder: ring buffer + optional JSONL file +
    optional OTLP/HTTP wire exporter (DYN_TPU_OTLP_ENDPOINT).

    ``otlp=False`` disables the wire exporter even when the env endpoint
    is set — micro-benchmarks and tests that pump synthetic spans through
    a private tracer must never ship them to a real collector."""

    def __init__(
        self, *, max_spans: int = 2048, path: Optional[str] = None,
        otlp: Any = None,
    ) -> None:
        self._ring: Deque[Span] = deque(maxlen=max_spans)
        self._lock = threading.Lock()
        self._path = path if path is not None else (TRACE_FILE.get() or None)
        if otlp is None and OTLP_ENDPOINT.get():
            otlp = OtlpHttpExporter(
                OTLP_ENDPOINT.get(), service_name=OTLP_SERVICE.get()
            )
        self.otlp = otlp or None
        # Finished-span taps (the trajectory shipper/store subscribe here).
        # A listener must never take down a span-producing path.
        self._listeners: List[Callable[[Span], None]] = []

    def add_listener(self, fn: Callable[[Span], None]) -> None:
        """``fn(span)`` on every export — used by the trajectory plane to
        ship finished spans frontend-ward (runtime/trajectory.py)."""
        self._listeners.append(fn)

    def remove_listener(self, fn: Callable[[Span], None]) -> None:
        if fn in self._listeners:
            self._listeners.remove(fn)

    def export(self, span: Span) -> None:
        if span.proc is None:
            span.proc = service_label()
        with self._lock:
            self._ring.append(span)
            if self._path:
                try:
                    with open(self._path, "a") as f:
                        f.write(json.dumps(span.to_dict()) + "\n")
                except OSError:
                    self._path = None  # disable after first failure
        if self.otlp is not None:
            self.otlp.offer(span)
        for fn in self._listeners:
            try:
                fn(span)
            except Exception:
                import logging

                logging.getLogger(__name__).debug(
                    "span listener failed", exc_info=True
                )

    def finished_spans(self) -> List[Span]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    @contextmanager
    def span(
        self,
        name: str,
        context: Any = None,  # runtime Context (baggage carrier) or None
        **attributes: Any,
    ):
        """Start a child span of the context's trace (creating a fresh trace
        when none is active) and advance the context's traceparent so
        downstream hops parent under this span. On exit the PREVIOUS
        traceparent is restored: a closed span's later siblings must parent
        under the same parent, not chain under the closed leaf (a remote
        hop parented under a tiny finished decision span would be clamped
        into its bounds by the trajectory stitcher)."""
        parent = None
        prev_traceparent: Optional[str] = None
        if context is not None:
            prev_traceparent = context.baggage.get("traceparent")
            parent = parse_traceparent(prev_traceparent)
        if parent is None:
            parent = new_trace_context()
            parent_span_id: Optional[str] = None
        else:
            parent_span_id = parent.span_id
        span = Span(
            name=name,
            trace_id=parent.trace_id,
            span_id=secrets.token_hex(8),
            parent_span_id=parent_span_id,
            start_s=time.time(),
            attributes=dict(attributes),
        )
        # Monotonic anchor for the duration: an NTP step between start and
        # end must not produce negative (or inflated) span durations. The
        # wall-clock start_s stays as the export timestamp; end_s is derived
        # as start + monotonic elapsed so duration_ms is always honest.
        # time.monotonic (not perf_counter) so start_mono_s is directly
        # comparable with the engine/lifecycle monotonic stamps.
        start_mono = time.monotonic()
        span.start_mono_s = start_mono
        if context is not None:
            context.baggage["traceparent"] = TraceContext(
                span.trace_id, span.span_id, parent.sampled
            ).to_traceparent()
        try:
            yield span
        except BaseException as exc:
            span.status = f"error: {type(exc).__name__}"
            raise
        finally:
            span.end_s = span.start_s + (time.monotonic() - start_mono)
            if context is not None:
                if prev_traceparent is None:
                    context.baggage.pop("traceparent", None)
                else:
                    context.baggage["traceparent"] = prev_traceparent
            self.export(span)


_GLOBAL: Optional[Tracer] = None


def global_tracer() -> Tracer:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = Tracer()
    return _GLOBAL


def span(name: str, context: Any = None, **attributes: Any):
    """Convenience: a span on the process-global tracer."""
    return global_tracer().span(name, context, **attributes)


def export_span(
    name: str,
    context: Any = None,
    *,
    start_mono: float,
    end_mono: Optional[float] = None,
    tracer: Optional[Tracer] = None,
    proc: Optional[str] = None,
    status: str = "ok",
    events: Optional[List[Dict[str, Any]]] = None,
    **attributes: Any,
) -> Span:
    """Export a RETROSPECTIVE span from monotonic timestamps.

    Hot paths (the engine's per-request phases, the drain handoff stall)
    stamp ``time.monotonic()`` boundaries as they pass and build the span
    object once, at stream end — a live context manager per phase would put
    span bookkeeping inside the decode loop. Parents under the context's
    CURRENT traceparent without advancing it (these are leaves), and
    anchors the wall-clock start as ``now_wall - (now_mono - start_mono)``
    so the duration stays monotonic-honest."""
    parent = None
    if context is not None:
        baggage = getattr(context, "baggage", None)
        if isinstance(baggage, dict):
            parent = parse_traceparent(baggage.get("traceparent"))
    if parent is None:
        parent = new_trace_context()
        parent_span_id: Optional[str] = None
    else:
        parent_span_id = parent.span_id
    now_mono = time.monotonic()
    if end_mono is None:
        end_mono = now_mono
    start_s = time.time() - (now_mono - start_mono)
    sp = Span(
        name=name,
        trace_id=parent.trace_id,
        span_id=secrets.token_hex(8),
        parent_span_id=parent_span_id,
        start_s=start_s,
        end_s=start_s + max(end_mono - start_mono, 0.0),
        attributes={k: v for k, v in attributes.items() if v is not None},
        events=list(events or ()),
        status=status,
        proc=proc,
        start_mono_s=start_mono,
    )
    (tracer or global_tracer()).export(sp)
    return sp
