"""Fleet-wide request trajectory plane: cross-worker span stitching,
per-request phase attribution, and SLO goodput/burn-rate gauges — the
port's copy of dynamo_tpu/runtime/trajectory.py, whole.

Every per-process diagnostic surface shows one worker's slice of a
request. This module is the fleet-level joint view: workers ship their
finished spans (plus trace-tagged flight events) over the event plane to a
bounded frontend-side :class:`TrajectoryStore`, and ``GET
/debug/trajectory/{trace_id}`` answers "why was THIS request slow" with one
stitched, phase-attributed timeline covering frontend → router → worker.

Three parts:

  * **Shipping** (:class:`TrajectoryShipper` worker-side,
    :class:`TrajectoryCollector` frontend-side): a tracer listener batches
    finished spans onto the ``<namespace>.trajectory`` topic from a pump
    task — span-producing paths never block, a full queue drops-and-counts,
    and the ``trajectory.ship`` fault seam (runtime/fault_names.py) proves
    a dying telemetry path never touches serving. The batches ride the
    port's ZMTP event plane (runtime/events/zmq_plane.py), whose publisher
    never waits on a peer.
  * **Stitching** (:func:`stitch`): each process's spans carry its
    ``proc`` label (utils/tracing.py ``service_label``), a local-monotonic
    start anchor, and a monotonic-derived duration. Within one proc,
    offsets come from the monotonic deltas (exact). Across procs, remote
    wall clocks are NEVER compared directly (the liveness.py rule):
    a child is positioned by the wall delta to its remote parent, then
    RE-ANCHORED — clamped inside the parent span's bounds — and any
    residual is reported as ``skew_ms`` + ``skew_flagged`` instead of
    being silently believed. Durations always come from each proc's own
    clock, so phase sums stay honest under arbitrary wall skew.
  * **Attribution + SLO** (:func:`attribute_phases`, :class:`SloTracker`):
    the span catalog maps onto six phases (queue / prefill / kv_transfer
    incl. retries / decode / handoff_stall / overhead = root − attributed);
    every completed trajectory feeds per-phase p99-contribution gauges, and
    the frontend's stream verdicts (TTFT+ITL vs SLA) feed goodput and
    multi-window error-budget burn rate — the ``SLO_*`` families
    (runtime/metric_names.py).

One divergence from JAX's collector: ``TrajectoryCollector.start()`` waits
for its subscription's ``ready`` (set when the SUBSCRIBE has reached the
broker), as ``KvRouter.start()`` does, so that a batch a worker ships
right after the frontend starts is not dropped by the broker.
"""

from __future__ import annotations

import asyncio
import collections
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from dynamo_tpu_torch import config
from dynamo_tpu_torch.runtime import fault_names
from dynamo_tpu_torch.runtime import metric_names as mn
from dynamo_tpu_torch.runtime.device_observe import FlightRecorder
from dynamo_tpu_torch.runtime.faults import fault_point
from dynamo_tpu_torch.runtime.metrics_core import MetricsRegistry
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# -- phase catalog ------------------------------------------------------------

PHASE_QUEUE = "queue"
PHASE_PREFILL = "prefill"
PHASE_KV_TRANSFER = "kv_transfer"
PHASE_DECODE = "decode"
PHASE_HANDOFF_STALL = "handoff_stall"
PHASE_OVERHEAD = "overhead"

PHASES = (
    PHASE_QUEUE,
    PHASE_PREFILL,
    PHASE_KV_TRANSFER,
    PHASE_DECODE,
    PHASE_HANDOFF_STALL,
    PHASE_OVERHEAD,
)

# Span name → phase. Spans not in the catalog (transport envelopes like
# endpoint.serve, the http root, router decisions) are structure, not
# phases — their time lands in whichever catalog span they contain, or in
# overhead. The catalog spans are non-overlapping by construction: queue
# ends at prefill start, the disagg pull completes before admission, a
# handoff stall is exactly the token gap between the source's decode end
# and the peer's decode start.
SPAN_PHASES = {
    "overload.queue": PHASE_QUEUE,
    "engine.queue": PHASE_QUEUE,
    "engine.prefill": PHASE_PREFILL,
    "disagg.pull": PHASE_KV_TRANSFER,
    "engine.decode": PHASE_DECODE,
    "drain.handoff": PHASE_HANDOFF_STALL,
    "migration.redispatch": PHASE_HANDOFF_STALL,
}

# Residual cross-proc skew below this is noise, not a flag.
SKEW_FLAG_MS = 0.001

# How long TrajectoryCollector.start() waits for its subscription to reach
# the broker (router/router.py's SUBSCRIBE_TIMEOUT_S).
SUBSCRIBE_TIMEOUT_S = 10.0

# Service-entry span names: these are trajectory ROOTS even when they
# carry a parent_span_id — a traced CLIENT's traceparent makes the
# frontend span a child of a span that lives outside this fleet and will
# never ship here. Without this, any externally-traced request would
# read as a forever-incomplete orphan.
ROOT_SPAN_PREFIXES = ("http.", "grpc.")


def is_root_span(rec: Dict[str, Any]) -> bool:
    return not rec.get("parent_span_id") or str(
        rec.get("name", "")
    ).startswith(ROOT_SPAN_PREFIXES)


def trajectory_topic(namespace: str) -> str:
    return f"{namespace}.trajectory"


def span_record(span: Any) -> Dict[str, Any]:
    """Span → the wire/store record (Span.to_dict is already that shape)."""
    return span.to_dict()


def _proc_of(rec: Dict[str, Any]) -> str:
    attrs = rec.get("attributes") or {}
    return str(attrs.get("proc") or rec.get("proc") or "?")


# -- stitching ----------------------------------------------------------------


def stitch(
    spans: List[Dict[str, Any]],
    events: Optional[List[Dict[str, Any]]] = None,
    *,
    trace_id: Optional[str] = None,
    complete: bool = False,
) -> Dict[str, Any]:
    """Join one trace's span records into a single placed timeline.

    Offsets are milliseconds from the trajectory start. Same-proc children
    use monotonic deltas against their parent (exact); cross-proc children
    use the wall delta but are clamped inside the parent span's bounds
    (local durations are trusted, remote wall clocks are not) with the
    residual reported per span as ``skew_ms``/``skew_flagged``."""
    recs = [dict(s) for s in spans]
    by_id: Dict[str, Dict[str, Any]] = {}
    for s in recs:
        sid = s.get("span_id")
        if sid:
            by_id[sid] = s
    children: Dict[str, List[Dict[str, Any]]] = {}
    roots: List[Dict[str, Any]] = []
    orphans: List[Dict[str, Any]] = []
    for s in by_id.values():
        pid = s.get("parent_span_id")
        if pid and pid in by_id:
            children.setdefault(pid, []).append(s)
        elif pid and not is_root_span(s):
            orphans.append(s)
        else:
            # True roots plus service-entry spans whose parent lives in
            # the CLIENT's tracing system (never shipped here).
            roots.append(s)
    heads = roots + orphans
    if not heads:
        return {
            "trace_id": trace_id,
            "spans": [],
            "events": list(events or ()),
            "processes": [],
            "total_ms": 0.0,
            "phases": {p: 0.0 for p in PHASES},
            "dominant_phase": PHASE_OVERHEAD,
            "kv_reuse": _kv_reuse_rollup(events or ()),
            "skew_flagged": False,
            "complete": complete,
        }
    # Primary anchor: the earliest true root (the frontend's http span),
    # falling back to the earliest orphan when the root never arrived.
    primary = min(
        roots or orphans, key=lambda s: s.get("start_unix_s", 0.0)
    )
    anchor_wall = primary.get("start_unix_s", 0.0)
    any_skew = False

    def place(s: Dict[str, Any], offset: float, skew: float) -> None:
        nonlocal any_skew
        s["offset_ms"] = round(max(offset, 0.0), 3)
        if abs(skew) > SKEW_FLAG_MS:
            s["skew_ms"] = round(skew, 3)
            s["skew_flagged"] = True
            any_skew = True

    for head in heads:
        base = (head.get("start_unix_s", anchor_wall) - anchor_wall) * 1000.0
        if head in orphans:
            # Parent span missing (not yet shipped / ring-evicted): place
            # by wall against the primary anchor and say so.
            head["orphan"] = True
        place(head, base, 0.0)
        stack = [head]
        while stack:
            parent = stack.pop()
            p_off = parent["offset_ms"]
            p_dur = float(parent.get("duration_ms") or 0.0)
            for child in children.get(parent.get("span_id"), ()):  # type: ignore[arg-type]
                same_proc = _proc_of(child) == _proc_of(parent)
                c_mono = child.get("start_mono_s")
                p_mono = parent.get("start_mono_s")
                if same_proc and c_mono is not None and p_mono is not None:
                    d_ms = (c_mono - p_mono) * 1000.0
                else:
                    d_ms = (
                        child.get("start_unix_s", 0.0)
                        - parent.get("start_unix_s", 0.0)
                    ) * 1000.0
                raw = p_off + d_ms
                if same_proc:
                    place(child, raw, 0.0)
                else:
                    # Re-anchor inside the parent's bounds: the child's
                    # LOCAL duration is trusted, its remote wall position
                    # is not. Residual skew is surfaced, never applied.
                    c_dur = float(child.get("duration_ms") or 0.0)
                    lo = p_off
                    hi = max(lo, p_off + p_dur - c_dur)
                    clamped = min(max(raw, lo), hi)
                    place(child, clamped, raw - clamped)
                stack.append(child)
    placed = sorted(by_id.values(), key=lambda s: s.get("offset_ms", 0.0))
    total_ms = max(
        (s["offset_ms"] + float(s.get("duration_ms") or 0.0) for s in placed),
        default=0.0,
    )
    root_ms = (
        float(primary.get("duration_ms") or 0.0)
        if primary in roots else total_ms
    )
    phases, dominant = attribute_phases(placed, root_ms)
    procs: List[str] = []
    for s in placed:
        p = _proc_of(s)
        if p not in procs:
            procs.append(p)
    out_events: List[Dict[str, Any]] = []
    for ev in events or ():
        ev = dict(ev)
        t_wall = ev.get("t_wall")
        if t_wall is not None:
            off = (float(t_wall) - anchor_wall) * 1000.0
            ev["offset_ms"] = round(min(max(off, 0.0), total_ms), 3)
        out_events.append(ev)
    out_events.sort(key=lambda e: e.get("offset_ms", 0.0))
    return {
        "trace_id": trace_id or primary.get("trace_id"),
        "spans": placed,
        "events": out_events,
        "processes": procs,
        "total_ms": round(total_ms, 3),
        "root_ms": round(root_ms, 3),
        "phases": phases,
        "dominant_phase": dominant,
        "kv_reuse": _kv_reuse_rollup(out_events),
        "skew_flagged": any_skew,
        "complete": complete,
    }


def _kv_reuse_rollup(
    events: Iterable[Dict[str, Any]],
) -> Optional[Dict[str, Any]]:
    """Aggregate the KV-reuse plane's per-request ROI events (ring
    ``kvcache``, kind ``roi``) into one cache-ROI line for the trajectory:
    how much prefill this request skipped, and from which tiers. None when
    the request carried no ROI event (engine predates the plane, or the
    event ring evicted it) — consumers must treat absent and None alike."""
    total: Optional[Dict[str, Any]] = None
    for ev in events:
        if ev.get("ring") != "kvcache" or ev.get("kind") != "roi":
            continue
        if total is None:
            total = {
                "cached_tokens": 0,
                "recomputed_tokens": 0,
                "seconds_saved": 0.0,
                "tiers": [],
            }
        total["cached_tokens"] += int(ev.get("cached_tokens") or 0)
        total["recomputed_tokens"] += int(ev.get("recomputed_tokens") or 0)
        total["seconds_saved"] += float(ev.get("seconds_saved") or 0.0)
        tier = ev.get("tier")
        if tier and tier not in total["tiers"]:
            total["tiers"].append(tier)
    if total is not None:
        total["seconds_saved"] = round(total["seconds_saved"], 6)
    return total


def attribute_phases(
    spans: List[Dict[str, Any]], total_ms: float
) -> Tuple[Dict[str, float], str]:
    """Per-phase milliseconds from the span catalog + the overhead rest.

    ``total_ms`` is the root span's duration (the client-observed wall);
    overhead = total − attributed, floored at 0 (phase spans from
    processes whose request work outlived the root — relays cut at a
    deadline — must not produce negative overhead)."""
    phases = {p: 0.0 for p in PHASES}
    for s in spans:
        phase = SPAN_PHASES.get(s.get("name"))  # type: ignore[arg-type]
        if phase is not None:
            phases[phase] += float(s.get("duration_ms") or 0.0)
    attributed = sum(phases.values())
    phases = {p: round(v, 3) for p, v in phases.items()}
    phases[PHASE_OVERHEAD] = round(max(total_ms - attributed, 0.0), 3)
    if total_ms <= 0:
        return phases, PHASE_OVERHEAD
    dominant = max(PHASES, key=lambda p: phases[p])
    return phases, dominant


# -- SLO tracker --------------------------------------------------------------


def _window_label(seconds: float) -> str:
    return f"{int(round(seconds / 60.0))}m"


class SloTracker:
    """Goodput / burn-rate / phase-p99 gauges (lint-pinned ``ALL_SLO``).

    Fed from two sides: the frontend's RequestTimer verdicts (one per
    finished stream — did TTFT and mean ITL meet the SLA) and the
    trajectory store's phase attributions (one per completed trajectory,
    REPLACED when late worker spans refine it). Disabled (no SLA
    configured) it is a no-op whose families still exist, so the metric
    closure holds on every deployment."""

    def __init__(
        self,
        *,
        ttft_sla_s: Optional[float] = None,
        itl_sla_s: Optional[float] = None,
        target: Optional[float] = None,
        windows: Tuple[float, ...] = (300.0, 3600.0),
        max_phase_traces: int = 1024,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if ttft_sla_s is None:
            ms = config.SLO_TTFT_MS.get()
            ttft_sla_s = ms / 1000.0 if ms > 0 else None
        if itl_sla_s is None:
            ms = config.SLO_ITL_MS.get()
            itl_sla_s = ms / 1000.0 if ms > 0 else None
        self.ttft_sla_s = ttft_sla_s
        self.itl_sla_s = itl_sla_s
        self.target = target if target is not None else config.SLO_TARGET.get()
        self.windows = tuple(windows)
        self.max_phase_traces = max_phase_traces
        self._clock = clock
        self._lock = threading.Lock()
        # (verdict time, good) pairs; pruned to the longest window.
        self._verdicts: "collections.deque" = collections.deque()
        # trace_id → (t, phases) — keyed so a late-arriving worker batch
        # REPLACES the trace's attribution instead of double-counting it.
        self._phases: "OrderedDict[str, Tuple[float, Dict[str, float]]]" = (
            OrderedDict()
        )
        self.good_streams = 0
        self.breached_streams = 0
        self.registry = MetricsRegistry()
        self.goodput = self.registry.gauge(
            mn.SLO_GOODPUT,
            "Fraction of finished streams meeting BOTH the TTFT and mean-"
            "ITL SLAs, per rolling window (1.0 with no traffic)",
            ["window"],
        )
        self.streams = self.registry.counter(
            mn.SLO_STREAMS_TOTAL,
            "Finished streams by SLO verdict (good | breach)",
            ["verdict"],
        )
        self.burn_rate = self.registry.gauge(
            mn.SLO_BURN_RATE,
            "Error-budget burn rate per window: breach fraction / "
            "(1 - slo_target); 1.0 = burning exactly the budget",
            ["window"],
        )
        self.phase_p99 = self.registry.gauge(
            mn.SLO_PHASE_P99_MS,
            "p99 of each request phase's duration over the trajectory "
            "window — the phase that dominates the latency tail",
            ["phase"],
        )
        self.registry.on_render(self._refresh)

    @property
    def enabled(self) -> bool:
        return self.ttft_sla_s is not None or self.itl_sla_s is not None

    def note_stream(
        self,
        trace_id: Optional[str],
        *,
        ttft_s: Optional[float],
        mean_itl_s: Optional[float],
        status: int = 200,
    ) -> None:
        """One finished stream's latency verdict (RequestTimer.done).
        Typed refusals (429/503/504) and server errors are breaches by
        definition — a refused stream did not meet the SLA."""
        if not self.enabled:
            return
        good = status < 429
        if ttft_s is None and mean_itl_s is None:
            # Token-less stream: only failures are fed here (the timer
            # skips token-less 2xx), and a failure met no SLA.
            good = False
        if self.ttft_sla_s is not None and (
            ttft_s is None or ttft_s > self.ttft_sla_s
        ):
            good = False
        if (
            self.itl_sla_s is not None
            and mean_itl_s is not None
            and mean_itl_s > self.itl_sla_s
        ):
            good = False
        now = self._clock()
        with self._lock:
            self._verdicts.append((now, good))
            horizon = now - max(self.windows)
            while self._verdicts and self._verdicts[0][0] < horizon:
                self._verdicts.popleft()
        if good:
            self.good_streams += 1
        else:
            self.breached_streams += 1
        self.streams.inc(verdict="good" if good else "breach")

    def note_phases(self, trace_id: str, phases: Dict[str, float]) -> None:
        """One trajectory's phase attribution; re-noting the same trace id
        (late worker spans refined the stitch) replaces the entry."""
        if not trace_id:
            return
        now = self._clock()
        with self._lock:
            self._phases[trace_id] = (now, dict(phases))
            self._phases.move_to_end(trace_id)
            while len(self._phases) > self.max_phase_traces:
                self._phases.popitem(last=False)

    def _refresh(self) -> None:
        now = self._clock()
        with self._lock:
            verdicts = list(self._verdicts)
            phase_rows = [
                ph for t, ph in self._phases.values()
                if now - t <= max(self.windows)
            ]
        budget = max(1.0 - self.target, 1e-9)
        for w in self.windows:
            in_window = [g for t, g in verdicts if now - t <= w]
            label = _window_label(w)
            if not in_window:
                self.goodput.set(1.0, window=label)
                self.burn_rate.set(0.0, window=label)
                continue
            frac_good = sum(1 for g in in_window if g) / len(in_window)
            self.goodput.set(round(frac_good, 6), window=label)
            self.burn_rate.set(
                round((1.0 - frac_good) / budget, 4), window=label
            )
        for phase in PHASES:
            vals = sorted(float(ph.get(phase, 0.0)) for ph in phase_rows)
            # Nearest-rank p99 (ceil(0.99 n) - 1); few samples → the max.
            p99 = vals[(99 * len(vals) + 99) // 100 - 1] if vals else 0.0
            self.phase_p99.set(round(p99, 3), phase=phase)

    def snapshot(self) -> Dict[str, Any]:
        """SLO state for bench legs / debug surfaces."""
        self._refresh()
        labels = [_window_label(w) for w in self.windows]
        return {
            "enabled": self.enabled,
            "ttft_sla_ms": (
                round(1000 * self.ttft_sla_s, 3)
                if self.ttft_sla_s is not None else None
            ),
            "itl_sla_ms": (
                round(1000 * self.itl_sla_s, 3)
                if self.itl_sla_s is not None else None
            ),
            "target": self.target,
            "good_streams": self.good_streams,
            "breached_streams": self.breached_streams,
            "goodput": {
                lab: self.goodput.value(window=lab) for lab in labels
            },
            "burn_rate": {
                lab: self.burn_rate.value(window=lab) for lab in labels
            },
            "phase_p99_ms": {
                p: self.phase_p99.value(phase=p) for p in PHASES
            },
        }

    def render(self, openmetrics: bool = False) -> str:
        return self.registry.render(openmetrics=openmetrics)


# -- the frontend-side store --------------------------------------------------


class TrajectoryStore:
    """Bounded per-trace span/event accumulator + stitcher.

    Ring discipline mirrors runtime/lifecycle.py: a recent ring (LRU by
    trace id, incomplete traces evicted last-resort only) plus a slow/error
    capture ring retaining stitched SUMMARIES of trajectories whose root
    exceeded the SLA threshold or errored — a tail-latency incident stays
    inspectable (with its dominant phase named) long after the recent ring
    churned past it. Writes happen on the frontend's event loop (collector
    pump + local tracer listener), the single writer of the ``trajectory``
    flight ring."""

    def __init__(
        self,
        *,
        max_recent: Optional[int] = None,
        max_slow: Optional[int] = None,
        slow_threshold_s: Optional[float] = None,
        slo: Optional[SloTracker] = None,
        max_spans_per_trace: int = 512,
    ) -> None:
        from dynamo_tpu_torch.runtime.lifecycle import SLOW_REQUEST_S

        self.max_recent = (
            max_recent if max_recent is not None
            else config.TRAJECTORY_RECENT.get()
        )
        self.max_slow = (
            max_slow if max_slow is not None else config.TRAJECTORY_SLOW.get()
        )
        self.slow_threshold_s = (
            slow_threshold_s if slow_threshold_s is not None
            else SLOW_REQUEST_S.get()
        )
        self.max_spans_per_trace = max_spans_per_trace
        self.slo = slo if slo is not None else SloTracker()
        self._recent: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._slow: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
        self._lock = threading.Lock()
        self.flight = FlightRecorder("trajectory", capacity=512)
        self.spans_ingested = 0
        self.spans_dropped = 0

    # -- ingestion ---------------------------------------------------------

    def attach_tracer(self, tracer: Any) -> None:
        """Feed this process's own finished spans (the frontend's http
        root, router decisions, overload queue waits) without a network
        hop."""
        self._tracer_listener = lambda span: self.add_span(span_record(span))
        tracer.add_listener(self._tracer_listener)

    def detach_tracer(self, tracer: Any) -> None:
        listener = getattr(self, "_tracer_listener", None)
        if listener is not None:
            tracer.remove_listener(listener)
            self._tracer_listener = None

    def ingest(self, payload: Dict[str, Any]) -> None:
        """One shipped batch from a worker (TrajectoryCollector pump).
        Completed traces are refreshed ONCE per batch, not per span — a
        worker batch landing after the root (the normal ship-cadence
        ordering) must not restitch the whole trace per late span on the
        event loop that is also serving requests."""
        proc = payload.get("proc")
        completed: Dict[str, Dict[str, Any]] = {}
        for rec in payload.get("spans") or ():
            if isinstance(rec, dict):
                if proc and not rec.get("proc"):
                    rec["proc"] = proc
                entry = self.add_span(rec, refresh=False)
                if entry is not None:
                    completed[entry["trace_id"]] = entry
        for ev in payload.get("events") or ():
            if isinstance(ev, dict):
                self.add_event(ev)
        for entry in completed.values():
            try:
                self._on_complete(entry)
            except Exception:
                logger.debug("trajectory refresh failed", exc_info=True)

    def _entry(self, trace_id: str) -> Dict[str, Any]:
        entry = self._recent.get(trace_id)
        if entry is None:
            entry = {
                "trace_id": trace_id,
                "spans": [],
                "events": [],
                "complete": False,
                "root": None,
                "t_first": time.monotonic(),
            }
            self._recent[trace_id] = entry
            while len(self._recent) > self.max_recent:
                # Evict completed trajectories first: an in-flight
                # long-tail request must still be collecting when its
                # root arrives, or it can never reach the slow ring.
                victim = next(
                    (t for t, e in self._recent.items() if e["complete"]),
                    None,
                )
                if victim is None:
                    self._recent.popitem(last=False)
                else:
                    del self._recent[victim]
        else:
            self._recent.move_to_end(trace_id)
        return entry

    def add_span(
        self, rec: Dict[str, Any], *, refresh: bool = True
    ) -> Optional[Dict[str, Any]]:
        """Never raises: observability must not take down serving. With
        ``refresh=False`` (batch ingest) the completed entry is returned
        instead of refreshed inline, so the caller refreshes once."""
        try:
            trace_id = rec.get("trace_id")
            if not trace_id:
                return None
            completed = None
            with self._lock:
                entry = self._entry(trace_id)
                if len(entry["spans"]) >= self.max_spans_per_trace:
                    self.spans_dropped += 1
                    return None
                entry["spans"].append(rec)
                self.spans_ingested += 1
                if is_root_span(rec):
                    entry["root"] = rec
                    entry["complete"] = True
                if entry["complete"]:
                    completed = entry
            self.flight.record(
                "ingest", trace_id=trace_id, name=rec.get("name"),
                proc=_proc_of(rec),
            )
            if completed is not None and refresh:
                self._on_complete(completed)
                return None
            return completed
        except Exception:
            logger.debug("trajectory span ingest failed", exc_info=True)
            return None

    def add_event(self, ev: Dict[str, Any]) -> None:
        try:
            trace_id = ev.get("trace_id")
            if not trace_id:
                return
            with self._lock:
                entry = self._entry(trace_id)
                if len(entry["events"]) < self.max_spans_per_trace:
                    entry["events"].append(ev)
        except Exception:
            logger.debug("trajectory event ingest failed", exc_info=True)

    def _on_complete(self, entry: Dict[str, Any]) -> None:
        """Root span present (or a late span refined a completed trace):
        refresh the phase feed + slow/error ring from a fresh stitch."""
        stitched = stitch(
            entry["spans"], entry["events"],
            trace_id=entry["trace_id"], complete=True,
        )
        self.slo.note_phases(entry["trace_id"], stitched["phases"])
        root = entry.get("root") or {}
        errored = any(
            str(s.get("status", "ok")) != "ok" for s in entry["spans"]
        )
        slow = (
            float(root.get("duration_ms") or 0.0)
            >= self.slow_threshold_s * 1000.0
        )
        if not (slow or errored):
            return
        summary = self._summary_of(stitched)
        summary["retained"] = "slow" if slow else "error"
        with self._lock:
            fresh = entry["trace_id"] not in self._slow
            self._slow[entry["trace_id"]] = summary
            self._slow.move_to_end(entry["trace_id"])
            while len(self._slow) > self.max_slow:
                self._slow.popitem(last=False)
        if fresh:
            self.flight.record(
                "slow_capture", trace_id=entry["trace_id"],
                dominant_phase=summary["dominant_phase"],
                total_ms=summary["total_ms"],
            )

    # -- reads -------------------------------------------------------------

    @staticmethod
    def _summary_of(stitched: Dict[str, Any]) -> Dict[str, Any]:
        # ``summary: True`` + span COUNT under a distinct key: a consumer
        # of GET /debug/trajectory/{id} iterating ``spans`` must get a
        # list or nothing, never an int (slow-ring hits serve this shape
        # after the full span set aged out of the recent ring).
        return {
            "trace_id": stitched["trace_id"],
            "summary": True,
            "total_ms": stitched["total_ms"],
            "processes": stitched["processes"],
            "span_count": len(stitched["spans"]),
            "phases": stitched["phases"],
            # The one-GET bottleneck answer: a slow request names the
            # phase that dominated it.
            "dominant_phase": stitched["dominant_phase"],
            "kv_reuse": stitched.get("kv_reuse"),
            "skew_flagged": stitched["skew_flagged"],
            "complete": stitched["complete"],
        }

    def get(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """Stitch one trajectory on demand (off the ingest path)."""
        with self._lock:
            entry = self._recent.get(trace_id)
            if entry is not None:
                spans = list(entry["spans"])
                events = list(entry["events"])
                complete = entry["complete"]
            else:
                slow = self._slow.get(trace_id)
                if slow is not None:
                    return dict(slow)
                return None
        return stitch(spans, events, trace_id=trace_id, complete=complete)

    def summaries(self) -> List[Dict[str, Any]]:
        with self._lock:
            entries = [
                (t, list(e["spans"]), list(e["events"]), e["complete"])
                for t, e in self._recent.items()
            ]
        return [
            self._summary_of(
                stitch(spans, events, trace_id=t, complete=complete)
            )
            for t, spans, events, complete in entries
        ]

    def slow_summaries(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(v) for v in self._slow.values()]

    def register_metrics(self, server: Any) -> None:
        server.register_metrics(self.slo.render)
        server.register_flight(self.flight.name, self.flight.snapshot)


# -- worker-side shipping -----------------------------------------------------


class TrajectoryShipper:
    """Batch finished spans + trace-tagged events onto the event plane.

    The tracer listener may fire from any thread, so the queue is a plain
    bounded deque (thread-safe appends; overflow evicts-and-counts like the
    OTLP exporter). A pump task drains it on a flush cadence and publishes
    one ``{proc, spans, events}`` message per batch; a failed publish (or
    an injected ``trajectory.ship`` fault) drops the batch and counts it —
    telemetry must never take down serving."""

    def __init__(
        self,
        event_plane: Any,
        namespace: str,
        *,
        proc: Optional[str] = None,
        flush_interval_s: Optional[float] = None,
        max_batch: int = 128,
        max_queue: int = 4096,
    ) -> None:
        from dynamo_tpu_torch.utils.tracing import service_label

        self._plane = event_plane
        self._topic = trajectory_topic(namespace)
        self.proc = proc or service_label()
        self.flush_interval_s = (
            flush_interval_s if flush_interval_s is not None
            else config.TRAJECTORY_SHIP_INTERVAL_S.get()
        )
        self.max_batch = max_batch
        self._spans: "collections.deque" = collections.deque(maxlen=max_queue)
        self._events: "collections.deque" = collections.deque(maxlen=max_queue)
        self.shipped = 0
        self.dropped = 0
        self._task: Optional[asyncio.Task] = None
        self._stop = asyncio.Event()

    def attach(self, tracer: Any) -> None:
        tracer.add_listener(self._on_span)

    def _on_span(self, span: Any) -> None:
        if not getattr(span, "trace_id", None):
            return
        if len(self._spans) == self._spans.maxlen:
            self.dropped += 1
        self._spans.append(span_record(span))

    def offer_event(
        self, trace_id: Optional[str], ring: str, kind: str, **fields: Any
    ) -> None:
        """One trace-tagged flight event (retries, breaker trips, handoff
        progress) to ride the next batch."""
        if not trace_id:
            return
        if len(self._events) == self._events.maxlen:
            self.dropped += 1
        self._events.append({
            "trace_id": trace_id, "ring": ring, "kind": kind,
            "t_wall": time.time(), **fields,
        })

    def start(self) -> None:
        # get_running_loop, not get_event_loop: starting outside a loop
        # must raise loudly instead of binding the pump to a dead loop.
        if self._task is None:
            self._stop.clear()
            self._task = asyncio.get_running_loop().create_task(
                self._run(), name="trajectory-ship"
            )

    def _drain(self) -> Tuple[List[dict], List[dict]]:
        spans: List[dict] = []
        events: List[dict] = []
        while self._spans and len(spans) < self.max_batch:
            spans.append(self._spans.popleft())
        while self._events and len(events) < self.max_batch:
            events.append(self._events.popleft())
        return spans, events

    async def flush_once(self) -> None:
        while self._spans or self._events:
            spans, events = self._drain()
            if not spans and not events:
                return
            try:
                # Chaos seam: the telemetry path dying must cost exactly
                # this batch, never the serving path that produced it.
                fault_point(fault_names.TRAJECTORY_SHIP, batch=len(spans))
                await self._plane.publish(
                    self._topic,
                    {"proc": self.proc, "spans": spans, "events": events},
                )
                self.shipped += len(spans) + len(events)
            except Exception:
                self.dropped += len(spans) + len(events)
                logger.debug(
                    "trajectory batch dropped (%d spans)", len(spans),
                    exc_info=True,
                )
                return

    async def _run(self) -> None:
        while not self._stop.is_set():
            try:
                await asyncio.wait_for(
                    self._stop.wait(), timeout=self.flush_interval_s
                )
            except asyncio.TimeoutError:
                pass
            await self.flush_once()

    async def close(self) -> None:
        self._stop.set()
        if self._task is not None:
            await self._task
            self._task = None
        await self.flush_once()


class TrajectoryCollector:
    """Frontend-side subscription pump: event plane → TrajectoryStore."""

    def __init__(
        self, event_plane: Any, namespace: str,
        store: Optional[TrajectoryStore] = None,
    ) -> None:
        self._plane = event_plane
        self._topic = trajectory_topic(namespace)
        self.store = store if store is not None else global_store()
        self._sub = None
        self._task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        self._sub = self._plane.subscribe(self._topic)
        self._task = asyncio.get_running_loop().create_task(
            self._pump(), name=f"trajectory-collect:{self._topic}"
        )
        # The port's planes say when a subscription reaches its broker:
        # count on receiving only then (the module docstring's divergence).
        await asyncio.wait_for(self._sub.ready.wait(), SUBSCRIBE_TIMEOUT_S)

    async def _pump(self) -> None:
        async for _topic, payload in self._sub:
            try:
                if isinstance(payload, dict):
                    self.store.ingest(payload)
            except Exception:
                logger.exception("bad trajectory batch")

    async def stop(self) -> None:
        from dynamo_tpu_torch.runtime.tasks import reap_task

        if self._sub is not None:
            await self._sub.aclose()
            self._sub = None
        if self._task is not None:
            self._task.cancel()
            await reap_task(self._task, "trajectory collector pump", logger)
            self._task = None


# -- process globals ----------------------------------------------------------

_STORE: Optional[TrajectoryStore] = None
_SHIPPER: Optional[TrajectoryShipper] = None


def global_store() -> TrajectoryStore:
    """The process-global store, lazily attached to the global tracer so
    every process (frontend, worker, test harness) can serve
    ``/debug/trajectory`` over at least its own spans."""
    global _STORE
    if _STORE is None:
        from dynamo_tpu_torch.utils.tracing import global_tracer

        _STORE = TrajectoryStore()
        _STORE.attach_tracer(global_tracer())
    return _STORE


def set_global_shipper(shipper: Optional[TrajectoryShipper]) -> None:
    """Install the worker's shipper for ``note_event`` call sites."""
    global _SHIPPER
    _SHIPPER = shipper


def note_event(
    trace_id: Optional[str], ring: str, kind: str, **fields: Any
) -> None:
    """Trace-tag one flight event into the trajectory plane: queued on the
    worker's shipper when one is installed, and fed to the local store when
    this process holds one (the frontend). One None-check each when the
    plane is idle — safe at any call site."""
    if not trace_id:
        return
    if _SHIPPER is not None:
        _SHIPPER.offer_event(trace_id, ring, kind, **fields)
    if _STORE is not None:
        _STORE.add_event({
            "trace_id": trace_id, "ring": ring, "kind": kind,
            "t_wall": time.time(), **fields,
        })


def global_slo() -> SloTracker:
    return global_store().slo


def trajectory_index(store: Optional[TrajectoryStore] = None) -> Dict[str, Any]:
    """The GET /debug/trajectory response body — ONE shape shared by the
    system server and the frontend HttpService."""
    store = store if store is not None else global_store()
    return {
        "slow_threshold_s": store.slow_threshold_s,
        "traces": store.summaries(),
        "slow": store.slow_summaries(),
        "slo": store.slo.snapshot(),
    }


def trajectory_view(
    trace_id: str, store: Optional[TrajectoryStore] = None
) -> Optional[Dict[str, Any]]:
    """The GET /debug/trajectory/{trace_id} body (None = 404)."""
    store = store if store is not None else global_store()
    return store.get(trace_id)


def render_trajectory_metrics(openmetrics: bool = False) -> str:
    """ALL_SLO exposition for every SystemStatusServer (the trajectory
    analog of render_runtime_metrics): goodput/burn-rate/phase gauges are
    process-global, armed wherever streams finish."""
    return global_store().slo.render(openmetrics=openmetrics)
