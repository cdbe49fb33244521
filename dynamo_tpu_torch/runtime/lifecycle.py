"""Per-request lifecycle timelines with a slow-request capture ring — the
port's copy of dynamo_tpu/runtime/lifecycle.py.

Reference parity: the reference hangs OTel spans off every hop so one
request's path (frontend → router → prefill → transfer → decode) is
reconstructable; this module is the always-on, bounded-memory version of
that: every layer stamps named events onto a timeline keyed by request id
(received → tokenized → routed(worker, overlap) → prefill_start →
first_token → kv_transfer → done), bound to the utils/tracing.py trace id
so a metrics exemplar or an exported span resolves to the full timeline.

Two rings:
  - a recent ring (LRU by request id) holding the last N timelines;
  - a slow ring retaining ONLY timelines whose total duration exceeded the
    SLA threshold (``DYN_TPU_SLOW_REQUEST_S``) — a tail-latency incident
    stays inspectable long after the recent ring has churned past it.

Exposed via the system status server:
  GET /debug/requests       recent + slow timeline summaries
  GET /debug/requests/{id}  one ordered event timeline
  GET /debug/traces         the process tracer's finished-span ring
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from dynamo_tpu_torch import config
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# Declared in the canonical registry (config.py).
SLOW_REQUEST_S = config.SLOW_REQUEST_S
LIFECYCLE_RECENT = config.LIFECYCLE_RECENT
LIFECYCLE_SLOW = config.LIFECYCLE_SLOW


@dataclass
class LifecycleEvent:
    name: str
    t_wall: float  # unix seconds (export/display)
    t_mono: float  # monotonic seconds (durations; NTP-step-proof)
    attrs: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self, start_mono: float) -> Dict[str, Any]:
        return {
            "event": self.name,
            "t_unix_s": round(self.t_wall, 6),
            "offset_ms": round((self.t_mono - start_mono) * 1000, 3),
            **({"attrs": self.attrs} if self.attrs else {}),
        }


@dataclass
class RequestTimeline:
    request_id: str
    trace_id: Optional[str] = None
    events: List[LifecycleEvent] = field(default_factory=list)
    done: bool = False

    @property
    def start_mono(self) -> float:
        return self.events[0].t_mono if self.events else 0.0

    @property
    def duration_s(self) -> float:
        if not self.events:
            return 0.0
        return self.events[-1].t_mono - self.events[0].t_mono

    def to_dict(self) -> Dict[str, Any]:
        start = self.start_mono
        return {
            "request_id": self.request_id,
            "trace_id": self.trace_id,
            "done": self.done,
            "duration_ms": round(self.duration_s * 1000, 3),
            "events": [e.to_dict(start) for e in self.events],
        }

    def summary(self) -> Dict[str, Any]:
        return {
            "request_id": self.request_id,
            "trace_id": self.trace_id,
            "done": self.done,
            "duration_ms": round(self.duration_s * 1000, 3),
            "events": [e.name for e in self.events],
        }


def trace_id_of(context: Any) -> Optional[str]:
    """Pull the trace id from a runtime Context's traceparent baggage."""
    if context is None:
        return None
    baggage = getattr(context, "baggage", None)
    if not isinstance(baggage, dict):
        return None
    header = baggage.get("traceparent")
    if not header:
        return None
    from dynamo_tpu_torch.utils.tracing import parse_traceparent

    tc = parse_traceparent(header)
    return tc.trace_id if tc else None


class RequestLifecycle:
    """Bounded recorder. Thread-safe: stamps arrive from the event loop,
    the engine's device threads, and disagg worker handlers."""

    def __init__(
        self,
        *,
        max_recent: Optional[int] = None,
        max_slow: Optional[int] = None,
        slow_threshold_s: Optional[float] = None,
    ) -> None:
        self.max_recent = max_recent if max_recent is not None else LIFECYCLE_RECENT.get()
        self.max_slow = max_slow if max_slow is not None else LIFECYCLE_SLOW.get()
        self.slow_threshold_s = (
            slow_threshold_s if slow_threshold_s is not None else SLOW_REQUEST_S.get()
        )
        self._recent: "OrderedDict[str, RequestTimeline]" = OrderedDict()
        self._slow: "OrderedDict[str, RequestTimeline]" = OrderedDict()
        self._lock = threading.Lock()

    def record(
        self,
        request_id: Optional[str],
        event: str,
        *,
        context: Any = None,
        trace_id: Optional[str] = None,
        **attrs: Any,
    ) -> None:
        """Stamp one event. Unknown request ids start a new timeline (layers
        stamp independently — whichever runs first creates it). Never raises:
        observability must not take down serving."""
        if not request_id:
            return
        try:
            tid = trace_id or trace_id_of(context)
            ev = LifecycleEvent(
                name=event,
                t_wall=time.time(),
                t_mono=time.monotonic(),
                attrs={k: v for k, v in attrs.items() if v is not None},
            )
            with self._lock:
                tl = self._recent.get(request_id)
                if tl is None:
                    tl = self._slow.get(request_id)
                if tl is None:
                    tl = RequestTimeline(request_id=request_id)
                    self._recent[request_id] = tl
                    while len(self._recent) > self.max_recent:
                        # Evict finished timelines first: an in-flight
                        # long-tail request must still be present when its
                        # "done" arrives, or it can never reach the slow
                        # ring. Only when every entry is in flight does
                        # bounded memory win over capture.
                        victim = next(
                            (r for r, t in self._recent.items() if t.done),
                            None,
                        )
                        if victim is None:
                            self._recent.popitem(last=False)
                        else:
                            del self._recent[victim]
                else:
                    if request_id in self._recent:
                        self._recent.move_to_end(request_id)
                if tid and not tl.trace_id:
                    tl.trace_id = tid
                tl.events.append(ev)
                if event == "done":
                    tl.done = True
                    if tl.duration_s >= self.slow_threshold_s:
                        self._slow[request_id] = tl
                        self._slow.move_to_end(request_id)
                        while len(self._slow) > self.max_slow:
                            self._slow.popitem(last=False)
        except Exception:
            # Timeline capture must never break serving — but a capture
            # bug must not be invisible either.
            logger.debug("request-timeline capture failed", exc_info=True)

    def get(self, request_id: str) -> Optional[RequestTimeline]:
        with self._lock:
            return self._recent.get(request_id) or self._slow.get(request_id)

    def timelines(self) -> List[RequestTimeline]:
        """Recent first, then slow-only (evicted from recent but retained)."""
        with self._lock:
            out = list(self._recent.values())
            out.extend(
                tl for rid, tl in self._slow.items() if rid not in self._recent
            )
        return out

    def slow_timelines(self) -> List[RequestTimeline]:
        with self._lock:
            return list(self._slow.values())

    def clear(self) -> None:
        with self._lock:
            self._recent.clear()
            self._slow.clear()


_GLOBAL: Optional[RequestLifecycle] = None


def global_lifecycle() -> RequestLifecycle:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = RequestLifecycle()
    return _GLOBAL


def record(request_id: Optional[str], event: str, **kwargs: Any) -> None:
    """Convenience: stamp on the process-global recorder."""
    global_lifecycle().record(request_id, event, **kwargs)
