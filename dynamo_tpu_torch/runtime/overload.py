"""Overload armor: deadline-aware admission control + graceful brownout —
the port's copy of dynamo_tpu/runtime/overload.py, whole: the same grants,
sheds, statuses, ``Retry-After`` values and transitions for the same call
sequence. It has no device code.

The serving stack is SLA-driven end to end (planner sizing, KV-aware
routing, disagg placement) — but SLAs are only meaningful if the system
refuses work it cannot serve inside them. Without an overload plane a
saturating burst queues unboundedly at the frontend, admits work whose
deadline has already expired, and blows every TTFT/ITL SLA at once — for
every client, not just the excess.

One :class:`OverloadController` per frontend owns three cooperating
mechanisms:

  * **Bounded EDF admission.** In-flight streams are capped at
    ``max_concurrency``; excess waits in an earliest-deadline-first queue
    bounded by ``max_queue_depth``. Requests without a deadline sort after
    every deadline-carrying request, FIFO among themselves. A full queue
    or a predicted queue delay (EWMA service time × queue position ÷
    concurrency) beyond ``max_queue_delay_s`` sheds with a typed 429 +
    ``Retry-After`` instead of queueing forever.
  * **Deadline enforcement.** A request whose ``Context`` deadline is
    already past sheds immediately (never admitted); a queued request
    whose budget expires mid-wait is shed at that moment — before any
    prefill work — and a granted waiter is re-checked at grant time, so
    expired work can never reach an engine through this gate.
  * **Brownout state machine.** ``healthy → brownout → shed`` driven by
    observed p50 ITL vs the SLA and (optionally) KV-pool occupancy, with
    consecutive-evaluation hysteresis in BOTH directions so a single
    noisy sample can neither trip nor clear a state (no flapping).
    Brownout clamps ``max_tokens`` (``clamp_max_tokens``) and disables
    speculative decode (``spec_enabled`` / the transition callbacks, wired
    to ``TorchEngine.set_spec_suspended``); shed refuses new admissions
    with 503 while admitted streams run to completion.

Every shed, admission, and state transition lands on the ``"overload"``
flight ring and the ``OVERLOAD_*`` metric families, and the
``overload.admit`` fault seam (runtime/fault_names.py) lets a chaos plan
expire a specific queued request's budget DETERMINISTICALLY — the
saturation tests replay bit-identically instead of racing wall clocks.

Process-wide ``note_activity`` counters (``sheds``,
``brownout_transitions``, ``deadline_expired``) extend the
zero-spurious-activation contract: a chaos-free under-capacity run PROVES
the overload plane sat idle (``faults.activity_snapshot``).
"""

from __future__ import annotations

import asyncio
import collections
import heapq
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from dynamo_tpu_torch.runtime import fault_names
from dynamo_tpu_torch.runtime import metric_names as mn
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.device_observe import FlightRecorder
from dynamo_tpu_torch.runtime.faults import fault_point, note_activity
from dynamo_tpu_torch.runtime.metrics_core import MetricsRegistry
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# Brownout states, ordered by severity. Gauge values ARE the wire form
# (dashboards alert on state >= 1).
HEALTHY = 0
BROWNOUT = 1
SHED = 2

STATE_NAMES = {HEALTHY: "healthy", BROWNOUT: "brownout", SHED: "shed"}


@dataclass(frozen=True)
class OverloadConfig:
    """Admission + brownout knobs (JAX's
    docs/design_docs/overload_control.md has the full table). Defaults are
    deliberately permissive: the caps exist but only bite under genuine
    saturation, and the brownout machine is inert until an ITL SLA (or
    occupancy source) is set."""

    # -- admission ---------------------------------------------------------
    # Streams generating concurrently; excess queues.
    max_concurrency: int = 256
    # Waiters beyond the concurrency cap; the (N+1)th sheds queue_full.
    max_queue_depth: int = 1024
    # Shed when the PREDICTED wait (EWMA service time × position ÷
    # concurrency) exceeds this — a queue that cannot drain inside the
    # bound is already failing its SLA, admitting more only spreads it.
    max_queue_delay_s: float = 30.0
    # Deadline stamped on requests that carry none (None = unbounded).
    default_deadline_s: Optional[float] = None
    # Retry-After floor on shed responses (predicted drain time wins
    # when larger).
    retry_after_s: float = 1.0
    # EWMA weight for observed per-request service seconds.
    service_ewma_alpha: float = 0.25
    # -- brownout ----------------------------------------------------------
    # p50 ITL SLA driving the state machine; None = brownout disabled
    # (admission caps still enforce).
    itl_sla_s: Optional[float] = None
    # Escalate brownout → shed when p50 ITL exceeds factor × SLA.
    shed_itl_factor: float = 3.0
    # Sliding ITL sample window for the p50, and how many samples the
    # p50 needs before it is trusted at all.
    itl_window: int = 128
    min_itl_samples: int = 16
    # Samples older than this are dropped before every p50 — otherwise a
    # SHED controller that stops admitting (so no tokens flow and no new
    # samples arrive) would re-read its congested-era window forever and
    # never gather recovery evidence: a permanent lockout.
    itl_sample_ttl_s: float = 60.0
    # Hysteresis time floor: evaluations closer together than this don't
    # advance the streaks, so brownout_after/recover_after denominate
    # TIME (≥ brownout_after × this much evidence), not request rate — at
    # 1000 rps per-admission evaluation would otherwise turn "3
    # consecutive evaluations" into 3 ms of evidence and flap at
    # millisecond granularity.
    min_eval_interval_s: float = 0.25
    # KV-pool occupancy triggers (require an occupancy_source).
    occupancy_high: float = 0.95
    occupancy_critical: float = 0.995
    # Hysteresis: consecutive breached evaluations before stepping UP one
    # state, consecutive healthy evaluations before stepping DOWN one —
    # recovery resets the streak per step, so shed → healthy takes
    # 2 × recover_after clean evaluations (no flapping).
    brownout_after: int = 3
    recover_after: int = 6
    # max_tokens clamp applied while state >= brownout.
    brownout_max_tokens: int = 256


def config_from_env() -> OverloadConfig:
    """OverloadConfig from the DYN_TPU_OVERLOAD_* env knobs (config.py)
    — what the frontend entrypoint arms by default."""
    from dynamo_tpu_torch import config as cfg

    itl_sla_ms = cfg.OVERLOAD_ITL_SLA_MS.get()
    default_deadline = cfg.OVERLOAD_DEFAULT_DEADLINE_S.get()
    return OverloadConfig(
        max_concurrency=cfg.OVERLOAD_MAX_CONCURRENCY.get(),
        max_queue_depth=cfg.OVERLOAD_MAX_QUEUE.get(),
        max_queue_delay_s=cfg.OVERLOAD_MAX_QUEUE_DELAY_S.get(),
        default_deadline_s=default_deadline or None,
        itl_sla_s=(itl_sla_ms / 1000.0) if itl_sla_ms > 0 else None,
        brownout_max_tokens=cfg.OVERLOAD_BROWNOUT_MAX_TOKENS.get(),
    )


class OverloadShedError(Exception):
    """One admission refused. ``reason`` is the shed_total label
    (queue_full | predicted_delay | deadline_expired | brownout_shed),
    ``status`` the HTTP mapping (429 load shed, 503 brownout shed, 504
    dead-on-arrival deadline), ``retry_after`` the drain estimate the
    Retry-After header carries (None on deadline sheds — retrying an
    expired budget is the client's call, not a pacing hint)."""

    def __init__(
        self, reason: str, status: int, retry_after: Optional[float] = None
    ) -> None:
        super().__init__(f"request shed ({reason})")
        self.reason = reason
        self.status = status
        self.retry_after = retry_after


@dataclass
class AdmissionTicket:
    """One granted admission; hand it back to ``release``."""

    request_id: str
    t_enqueue: float
    t_admit: float = 0.0
    released: bool = False

    @property
    def queue_delay_s(self) -> float:
        return max(0.0, self.t_admit - self.t_enqueue)


@dataclass
class _Waiter:
    """One queued admission. ``key`` orders the EDF heap: (deadline or
    +inf, arrival seq) — deadline-carrying requests first, FIFO among
    equals. ``abandoned`` marks a waiter whose admit() call already
    resolved (shed/cancelled); the heap entry is skipped lazily at grant
    (cheaper than heap surgery on every shed)."""

    deadline: Optional[float]
    seq: int
    context: Context
    future: "asyncio.Future[float]"  # resolves to t_admit
    t_enqueue: float = 0.0
    abandoned: bool = False

    @property
    def key(self):
        return (self.deadline if self.deadline is not None else float("inf"), self.seq)

    def __lt__(self, other: "_Waiter") -> bool:
        return self.key < other.key


class OverloadMetrics:
    """Canonical overload families (runtime/metric_names.py ALL_OVERLOAD)
    on a private registry; ``render`` plugs into the system server's
    ``register_metrics`` seam like every other subsystem."""

    def __init__(self) -> None:
        self.registry = MetricsRegistry()
        self.state = self.registry.gauge(
            mn.OVERLOAD_STATE,
            "Brownout state machine: 0 healthy, 1 brownout (max_tokens "
            "clamped, speculative decode off), 2 shed (new admissions "
            "refused 503)",
        )
        self.transitions = self.registry.counter(
            mn.OVERLOAD_TRANSITIONS_TOTAL,
            "Brownout state transitions, labeled by the state entered",
            ["to"],
        )
        self.shed = self.registry.counter(
            mn.OVERLOAD_SHED_TOTAL,
            "Admissions refused, by reason (queue_full | predicted_delay "
            "| deadline_expired | brownout_shed). Every shed is a typed "
            "429/503/504 the client saw — nonzero under nominal load is "
            "an incident",
            ["reason"],
        )
        self.admitted = self.registry.counter(
            mn.OVERLOAD_ADMITTED_TOTAL,
            "Admissions granted (immediately or after queueing)",
        )
        self.queue_depth = self.registry.gauge(
            mn.OVERLOAD_QUEUE_DEPTH,
            "Requests waiting in the EDF admission queue right now",
        )
        self.queue_delay = self.registry.histogram(
            mn.OVERLOAD_QUEUE_DELAY,
            "Seconds a granted request waited in the admission queue",
        )
        self.deadline_expired = self.registry.counter(
            mn.OVERLOAD_DEADLINE_EXPIRED_TOTAL,
            "Requests whose deadline expired before admission (arrived "
            "dead or expired mid-queue) — shed before any prefill work",
        )

    def render(self, openmetrics: bool = False) -> str:
        return self.registry.render(openmetrics=openmetrics)


class OverloadController:
    """The frontend's overload plane: bounded EDF admission + brownout.

    Threading contract: every method runs on the frontend's event loop
    (the same single-writer discipline as the other flight rings).
    ``clock`` is injectable so the brownout tests drive the hysteresis
    with a fake clock; asyncio waits still use loop time (only the state
    machine's decisions are clocked).
    """

    def __init__(
        self,
        config: Optional[OverloadConfig] = None,
        *,
        clock: Callable[[], float] = time.monotonic,
        occupancy_source: Optional[Callable[[], Optional[float]]] = None,
    ) -> None:
        self.config = config or OverloadConfig()
        self._clock = clock
        # () -> current KV-pool occupancy in [0, 1] (None = unknown);
        # worker-side deployments wire engine stats here, frontend-only
        # deployments leave it unset and brownout runs on ITL alone.
        self._occupancy_source = occupancy_source
        self._state = HEALTHY
        self._breach_streak = 0
        self._critical_streak = 0
        self._ok_streak = 0
        # (observed-at, itl_s) pairs; maxlen bounds memory, the TTL prune
        # in _itl_p50 bounds staleness.
        self._itl_samples: "collections.deque" = collections.deque(
            maxlen=self.config.itl_window
        )
        self._last_eval_at: Optional[float] = None
        self._active = 0
        self._heap: List[_Waiter] = []
        self._queued = 0  # live (non-abandoned) waiters — len(heap) lies
        self._seq = 0
        self._svc_ewma: Optional[float] = None  # observed service seconds
        self._transition_cbs: List[Callable[[int, int], None]] = []
        # Budget-squeeze rung (the JAX engine's tick budget,
        # engines/tpu/tick_budget.py): levers registered by worker wiring.
        # The port has no tick budget yet, so its workers register none.
        # With levers present, the FIRST filled breach streak squeezes the
        # prefill budget instead of transitioning — brownout (and its
        # max_tokens clamp) needs a fresh filled streak on top of the
        # squeeze, so the cheapest lever always fires first. No levers =
        # the pre-budgeter ladder, unchanged.
        self._budget_levers: List[Callable[[bool], None]] = []
        self._budget_squeezed = False
        self.budget_squeezes = 0
        # Lifetime counters (bench + /debug snapshots; the metric
        # families are their scrapeable form).
        self.sheds: Dict[str, int] = {}
        self.admitted = 0
        self.transitions: Dict[str, int] = {}
        self.peak_queue_depth = 0
        self.flight = FlightRecorder("overload", capacity=512)
        self.metrics = OverloadMetrics()
        self.metrics.registry.on_render(self._refresh_gauges)

    # -- observability ------------------------------------------------------

    def _refresh_gauges(self) -> None:
        self.metrics.state.set(self._state)
        self.metrics.queue_depth.set(self._queued)

    def register_metrics(self, server: Any) -> None:
        server.register_metrics(self.metrics.render)
        server.register_flight(self.flight.name, self.flight.snapshot)

    def snapshot(self) -> Dict[str, Any]:
        """Controller state for bench legs / debug surfaces."""
        return {
            "state": STATE_NAMES[self._state],
            "active": self._active,
            "queue_depth": self._queued,
            "peak_queue_depth": self.peak_queue_depth,
            "admitted": self.admitted,
            "sheds": dict(self.sheds),
            "deadline_expired": self.sheds.get("deadline_expired", 0),
            "transitions": dict(self.transitions),
            "budget_squeezed": self._budget_squeezed,
            "budget_squeezes": self.budget_squeezes,
            "itl_p50_ms": (
                round(1000 * p50, 3)
                if (p50 := self._itl_p50()) is not None
                else None
            ),
            "service_ewma_ms": (
                round(1000 * self._svc_ewma, 3)
                if self._svc_ewma is not None
                else None
            ),
        }

    # -- state machine ------------------------------------------------------

    @property
    def state(self) -> int:
        return self._state

    def on_transition(self, cb: Callable[[int, int], None]) -> None:
        """``cb(old_state, new_state)`` on every transition — the seam
        worker wiring uses to suspend speculative decode on brownout."""
        self._transition_cbs.append(cb)

    def on_budget_pressure(self, cb: Callable[[bool], None]) -> None:
        """Register a budget-squeeze lever: ``cb(True)`` pins the
        engine's per-tick prefill budget at its starvation floor,
        ``cb(False)`` releases it back to the control law. Registering a
        lever INSERTS the rung below brownout: the squeeze fires one
        filled breach streak before any max_tokens clamp, and releases
        one filled recovery streak after every state stepped down —
        first lever pulled, last lever released."""
        self._budget_levers.append(cb)

    def observe_itl(self, itl_s: float) -> None:
        """One inter-token latency observation (the frontend's
        RequestTimer feeds this from the same deltas the ITL histogram
        observes). Sliding window, O(1) per token."""
        self._itl_samples.append((self._clock(), itl_s))

    def _itl_p50(self) -> Optional[float]:
        # Age out stale samples FIRST: once traffic stops (e.g. the shed
        # state refusing admissions), the congested-era window must decay
        # to "unknown" rather than testify against recovery forever.
        horizon = self._clock() - self.config.itl_sample_ttl_s
        while self._itl_samples and self._itl_samples[0][0] < horizon:
            self._itl_samples.popleft()
        if len(self._itl_samples) < self.config.min_itl_samples:
            return None
        s = sorted(v for _, v in self._itl_samples)
        return s[len(s) // 2]

    def _occupancy(self) -> Optional[float]:
        if self._occupancy_source is None:
            return None
        try:
            return self._occupancy_source()
        except Exception:
            logger.exception("overload occupancy source failed")
            return None

    def evaluate(self) -> int:
        """Run one state-machine evaluation; returns the (possibly new)
        state. Called on every admission and by the worker's load-report
        cadence loop. Calls closer together than min_eval_interval_s are
        no-ops (state returned, streaks untouched): a hysteresis step is
        a unit of TIME, not a unit of request rate."""
        cfg = self.config
        now = self._clock()
        if (
            self._last_eval_at is not None
            and now - self._last_eval_at < cfg.min_eval_interval_s
        ):
            return self._state
        self._last_eval_at = now
        p50 = self._itl_p50() if cfg.itl_sla_s is not None else None
        occ = self._occupancy()
        breach = False
        critical = False
        if p50 is not None and cfg.itl_sla_s is not None:
            breach = p50 > cfg.itl_sla_s
            critical = p50 > cfg.shed_itl_factor * cfg.itl_sla_s
        if occ is not None:
            breach = breach or occ >= cfg.occupancy_high
            critical = critical or occ >= cfg.occupancy_critical
        if breach:
            self._breach_streak += 1
            # Escalation keeps its own streak: brownout → shed needs
            # brownout_after CONSECUTIVE critical evaluations, not one
            # noisy critical sample on top of an old breach streak.
            self._critical_streak = self._critical_streak + 1 if critical else 0
            self._ok_streak = 0
        else:
            self._ok_streak += 1
            self._breach_streak = 0
            self._critical_streak = 0
        if self._state == HEALTHY and self._breach_streak >= cfg.brownout_after:
            if self._budget_levers and not self._budget_squeezed:
                # First rung: shrink the prefill budget BEFORE clamping
                # max_tokens or shedding. Brownout needs a FRESH filled
                # streak on top of the squeeze — the flight ring's event
                # order (budget_squeeze, then state healthy→brownout)
                # proves the lever ordering.
                self._squeeze_budget(True, p50, occ)
            else:
                self._transition(BROWNOUT, p50, occ)
            self._breach_streak = 0
            self._critical_streak = 0
        elif (
            self._state == BROWNOUT
            and self._critical_streak >= cfg.brownout_after
        ):
            self._transition(SHED, p50, occ)
            self._breach_streak = 0
            self._critical_streak = 0
        elif self._ok_streak >= cfg.recover_after and (
            self._state != HEALTHY or self._budget_squeezed
        ):
            # Step DOWN one state per filled recovery streak: shed →
            # brownout → healthy needs two clean streaks, so recovery
            # re-arms gradually instead of slamming the floodgates open.
            # The budget squeeze outlives every state step-down — it was
            # the first lever pulled, so it is the LAST one released.
            if self._state != HEALTHY:
                self._transition(self._state - 1, p50, occ)
            else:
                self._squeeze_budget(False, p50, occ)
            self._ok_streak = 0
        return self._state

    def _squeeze_budget(
        self, on: bool, p50: Optional[float], occ: Optional[float]
    ) -> None:
        self._budget_squeezed = on
        if on:
            self.budget_squeezes += 1
        self.flight.record(
            "budget_squeeze" if on else "budget_release",
            itl_p50_ms=round(1000 * p50, 3) if p50 is not None else None,
            occupancy=round(occ, 4) if occ is not None else None,
        )
        logger.warning(
            "overload budget %s (p50 ITL %s, occupancy %s)",
            "squeeze" if on else "release",
            f"{1000 * p50:.1f}ms" if p50 is not None else "n/a",
            f"{occ:.3f}" if occ is not None else "n/a",
        )
        for cb in self._budget_levers:
            try:
                cb(on)
            except Exception:
                logger.exception("overload budget lever failed")

    def _transition(self, new_state: int, p50: Optional[float], occ: Optional[float]) -> None:
        old, self._state = self._state, new_state
        name = STATE_NAMES[new_state]
        self.transitions[name] = self.transitions.get(name, 0) + 1
        self.metrics.transitions.inc(to=name)
        if new_state > HEALTHY:
            note_activity("brownout_transitions")
        self.flight.record(
            "state",
            frm=STATE_NAMES[old],
            to=name,
            itl_p50_ms=round(1000 * p50, 3) if p50 is not None else None,
            occupancy=round(occ, 4) if occ is not None else None,
        )
        logger.warning(
            "overload state %s -> %s (p50 ITL %s, occupancy %s)",
            STATE_NAMES[old], name,
            f"{1000 * p50:.1f}ms" if p50 is not None else "n/a",
            f"{occ:.3f}" if occ is not None else "n/a",
        )
        for cb in self._transition_cbs:
            try:
                cb(old, new_state)
            except Exception:
                logger.exception("overload transition callback failed")

    # -- brownout actions ---------------------------------------------------

    def clamp_max_tokens(self, requested: Optional[int]) -> Optional[int]:
        """Brownout's output clamp: while degraded, no request may ask
        for more than ``brownout_max_tokens``; healthy passes through.
        Non-integer junk also passes through — downstream validation owns
        rejecting it with a 400 (a clamp must never be the thing that
        500s a request, or leaks its admission slot by raising)."""
        if self._state < BROWNOUT:
            return requested
        cap = self.config.brownout_max_tokens
        if requested is None:
            return cap
        if isinstance(requested, bool) or not isinstance(requested, int):
            return requested
        return min(requested, cap)

    def spec_enabled(self) -> bool:
        """Speculative decode is a throughput-for-latency gamble that
        loses under pressure (rejected proposals burn decode ticks) —
        off in every degraded state."""
        return self._state == HEALTHY

    # -- admission ----------------------------------------------------------

    def apply_default_deadline(self, context: Context) -> None:
        """Stamp ``default_deadline_s`` on a deadline-less context (the
        frontend calls this after header parsing so a client-supplied
        deadline always wins)."""
        if (
            self.config.default_deadline_s is not None
            and context.deadline is None
        ):
            context.set_deadline(
                time.monotonic() + self.config.default_deadline_s
            )

    def _shed(
        self, reason: str, status: int, request_id: str,
        retry_after: Optional[float] = None,
    ) -> OverloadShedError:
        self.sheds[reason] = self.sheds.get(reason, 0) + 1
        self.metrics.shed.inc(reason=reason)
        note_activity("sheds")
        if reason == "deadline_expired":
            self.metrics.deadline_expired.inc()
            note_activity("deadline_expired")
        self.flight.record(
            "shed", request_id=request_id, reason=reason,
            queue_depth=self._queued, active=self._active,
        )
        return OverloadShedError(reason, status, retry_after)

    def _predicted_queue_delay(self, position: int) -> Optional[float]:
        """Expected wait at queue ``position`` (0-based): every request
        ahead plus this one must each clear a service slot, at the EWMA
        service time over ``max_concurrency`` parallel servers. None
        until a service time has been observed (never shed on a guess)."""
        if self._svc_ewma is None:
            return None
        return (
            (position + 1)
            * self._svc_ewma
            / max(self.config.max_concurrency, 1)
        )

    def _retry_after(self, predicted: Optional[float]) -> float:
        return max(self.config.retry_after_s, predicted or 0.0)

    async def admit(
        self, context: Context, *, request_id: Optional[str] = None
    ) -> AdmissionTicket:
        """Admit one request or raise :class:`OverloadShedError`.

        The ``overload.admit`` fault seam fires once per attempt, BEFORE
        the queue wait: a chaos rule injecting a timeout at hit N expires
        exactly the Nth request's queue budget — the deterministic
        mid-queue-expiry schedule the saturation tests replay.
        """
        rid = request_id or context.id
        self.evaluate()
        if self._state >= SHED:
            raise self._shed(
                "brownout_shed", 503, rid,
                self._retry_after(self._predicted_queue_delay(self._queued)),
            )
        remaining = context.time_remaining()
        if remaining is not None and remaining <= 0:
            raise self._shed("deadline_expired", 504, rid)
        now = self._clock()
        if self._active < self.config.max_concurrency and self._queued == 0:
            self._active += 1
            self.admitted += 1
            self.metrics.admitted.inc()
            self.metrics.queue_delay.observe(0.0)
            self.flight.record("admit", request_id=rid, queued_s=0.0)
            return AdmissionTicket(request_id=rid, t_enqueue=now, t_admit=now)
        if self._queued >= self.config.max_queue_depth:
            raise self._shed(
                "queue_full", 429, rid,
                self._retry_after(
                    self._predicted_queue_delay(self._queued)
                ),
            )
        predicted = self._predicted_queue_delay(self._queued)
        budget = self.config.max_queue_delay_s
        if remaining is not None:
            budget = min(budget, remaining)
        if predicted is not None and predicted > budget:
            raise self._shed(
                "predicted_delay", 429, rid, self._retry_after(predicted)
            )
        waiter = _Waiter(
            deadline=context.deadline,
            seq=self._seq,
            context=context,
            future=asyncio.get_running_loop().create_future(),
            t_enqueue=now,
        )
        self._seq += 1
        heapq.heappush(self._heap, waiter)
        self._queued += 1
        self.peak_queue_depth = max(self.peak_queue_depth, self._queued)
        # Abandoned waiters (deadline timeouts, disconnects) are skipped
        # lazily at grant — but grants only happen on release, and long
        # streams can hold every slot for minutes while short-deadline
        # arrivals churn the heap. Compact when dead entries dominate so
        # the heap is bounded by LIVE waiters, not arrival history.
        if len(self._heap) > 64 and len(self._heap) > 2 * self._queued:
            self._heap = [
                w for w in self._heap
                if not w.abandoned and not w.future.done()
            ]
            heapq.heapify(self._heap)
        self.flight.record(
            "enqueue", request_id=rid, queue_depth=self._queued,
            deadline_in_s=(
                round(remaining, 3) if remaining is not None else None
            ),
        )
        try:
            # Chaos seam (see docstring): an injected timeout here is the
            # queued request's budget expiring, deterministically.
            fault_point(fault_names.OVERLOAD_ADMIT, request_id=rid)
            if remaining is not None:
                t_admit = await asyncio.wait_for(waiter.future, remaining)
            else:
                t_admit = await waiter.future
        except (TimeoutError, asyncio.TimeoutError):
            # A cancelled future is the NORMAL timeout shape (wait_for
            # cancels it before raising): never granted, still queued. A
            # RESOLVED future means the grant raced the expiry (3.12+
            # wait_for can raise over a completed future) — decrementing
            # _queued again there would double-count and leak the _active
            # slot _grant_next just took.
            if not waiter.future.done() or waiter.future.cancelled():
                waiter.abandoned = True
                self._queued -= 1
                raise self._shed("deadline_expired", 504, rid) from None
            exc = waiter.future.exception()
            if exc is not None:
                # Grant-time shed raced the timeout: _grant_next already
                # dequeued and counted it.
                raise exc
            # A real grant raced the expiry: the budget is spent either
            # way — return the capacity, then shed.
            self._active -= 1
            self._grant_next()
            raise self._shed("deadline_expired", 504, rid) from None
        except OverloadShedError:
            # Grant-time shed: _grant_next already dequeued and counted it.
            raise
        except BaseException:
            # Cancellation (client gone mid-queue) or an injected
            # error-kind fault: vacate the slot either way. Not a shed —
            # grant skips abandoned waiters lazily. A CANCELLED future is
            # the normal cancellation shape (the task machinery cancels
            # the awaited future): never granted, still queued.
            if not waiter.future.done() or waiter.future.cancelled():
                waiter.abandoned = True
                self._queued -= 1
            elif waiter.future.exception() is None:
                # A real GRANT raced the failure: give the capacity back.
                # (A grant-time shed exception on the future took no slot
                # and was already dequeued/counted by _grant_next; the
                # exception() call above also marks it retrieved.)
                self._active -= 1
                self._grant_next()
            raise
        ticket = AdmissionTicket(
            request_id=rid, t_enqueue=waiter.t_enqueue, t_admit=t_admit
        )
        self.metrics.queue_delay.observe(ticket.queue_delay_s)
        self.flight.record(
            "admit", request_id=rid,
            queued_s=round(ticket.queue_delay_s, 4),
        )
        return ticket

    def _grant_next(self) -> None:
        """Hand freed capacity to the earliest-deadline waiter. Waiters
        whose deadline already passed are shed HERE — a grant is the last
        gate an expired request could slip through."""
        while self._active < self.config.max_concurrency and self._heap:
            waiter = heapq.heappop(self._heap)
            if waiter.abandoned or waiter.future.done():
                continue
            self._queued -= 1
            now = self._clock()
            rem = waiter.context.time_remaining()
            if rem is not None and rem <= 0:
                waiter.future.set_exception(
                    self._shed(
                        "deadline_expired", 504, waiter.context.id
                    )
                )
                continue
            self._active += 1
            self.admitted += 1
            self.metrics.admitted.inc()
            waiter.future.set_result(now)

    def release(self, ticket: AdmissionTicket, *, ok: bool = True) -> None:
        """Return one admission slot; feeds the service-time EWMA the
        predicted-delay shed uses (successful completions only — an
        early error says nothing about how long real service takes)."""
        if ticket.released:
            return
        ticket.released = True
        self._active = max(0, self._active - 1)
        if ok:
            service_s = max(0.0, self._clock() - ticket.t_admit)
            alpha = self.config.service_ewma_alpha
            self._svc_ewma = (
                service_s if self._svc_ewma is None
                else alpha * service_s + (1 - alpha) * self._svc_ewma
            )
        self._grant_next()
