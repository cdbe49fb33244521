"""Crash plane: fast dead-worker detection + incarnation fencing — the
port's copy of dynamo_tpu/runtime/liveness.py, whole: the TCP request plane
stamps and fences its frames with ``process_incarnation`` and
``note_stale_drop``, and the tracker, the fence and their metric families
come with them.

**Detection** — a worker's liveness is derived from its load-report
cadence, one report per ``interval_s``, judged by a clock-skew-safe
local-observation rule: we record OUR monotonic clock when a worker's
report last ARRIVED and never compare remote timestamps. Miss
``suspect_after`` intervals → SUSPECT (still routable); miss
``dead_after`` → DEAD, and the tracker fires its ``on_dead`` callbacks
(the router's purge, the abort of the worker's in-flight streams with a
typed :class:`WorkerLostError`). Detection-to-migration latency is
therefore bounded by ``dead_after × interval_s``.

**Incarnation fencing** — every worker process stamps a monotonically
fresh :func:`process_incarnation` into its registrations, load reports and
tcp response envelopes. A zombie (a paused/partitioned previous
incarnation whose late packets surface after the restart) and the
restarted worker's fresh state can then never be conflated:
:class:`IncarnationFence` admits only the newest incarnation per worker
id, and every stale packet is COUNTED
(``dynamo_tpu_liveness_stale_incarnation_drops_total{seam}``) and
dropped, never applied.

The restore duration/outcome families are declared here as in the JAX
package; the warm-restart restore that reports into them comes with the
KV checkpoint (ROADMAP A6).
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from dynamo_tpu_torch.runtime import fault_names
from dynamo_tpu_torch.runtime import metric_names as mn
from dynamo_tpu_torch.runtime.device_observe import FlightRecorder
from dynamo_tpu_torch.runtime.faults import fault_point
from dynamo_tpu_torch.runtime.metrics_core import MetricsRegistry
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# Worker state machine values (also the liveness_worker_state gauge).
ALIVE, SUSPECT, DEAD = 0, 1, 2
_STATE_NAMES = {ALIVE: "alive", SUSPECT: "suspect", DEAD: "dead"}


class WorkerLostError(ConnectionError):
    """Typed migratable abort: liveness declared the stream's worker dead
    (missed load reports), so the frontend re-dispatches the stream — with
    its streamed tokens carried — instead of hanging until a TCP timeout.
    Subclasses ConnectionError so the migratable set already covers
    it; llm/migration.py labels the reason ``worker_lost``."""


class StaleIncarnationError(ConnectionError):
    """A reply carried a prior incarnation's stamp: the peer restarted (or
    a zombie's late packets surfaced) and its promised state no longer
    exists. Migratable — the correct recovery is a fresh dispatch, never
    applying the stale payload."""


# ---------------------------------------------------------------------------
# Process incarnation
# ---------------------------------------------------------------------------

_INCARNATION: Optional[int] = None


def process_incarnation() -> int:
    """This process's incarnation id, stamped once at first use.

    Monotonically fresh across restarts of the same logical worker: the
    wall-clock MICROsecond at first call, with the low bits salted so two
    processes born in the same microsecond still differ. Incarnations are
    only ever COMPARED between restarts of one worker id — a restart
    happens at human/orchestrator timescales, so wall-clock monotonicity
    (NTP steps included) holds by a margin of seconds. Microseconds (not
    nanoseconds) keep the stamp ≈2^61: it must survive msgpack's int64
    wire bound (network/codec.py) in tcp envelopes and pull replies."""
    global _INCARNATION
    if _INCARNATION is None:
        _INCARNATION = ((time.time_ns() // 1000) << 10) | random.getrandbits(10)
    return _INCARNATION


def set_process_incarnation(value: Optional[int]) -> None:
    """Pin (or reset with None) the process incarnation — restart
    simulations in tests; the soak harness gives each respawn a fresh
    process, so production never calls this."""
    global _INCARNATION
    _INCARNATION = value


# ---------------------------------------------------------------------------
# Process-global fencing + restore metric families
# ---------------------------------------------------------------------------

_REGISTRY = MetricsRegistry()
STALE_DROPS = _REGISTRY.counter(
    mn.LIVENESS_STALE_DROPS_TOTAL,
    "Packets from a prior worker incarnation dropped (never applied) at a "
    "fencing seam: load_report (liveness tracker) | router_load (scheduler "
    "cost model — a separate subscription, hence a separate seam) | "
    "pull_reply | handoff_ack | tcp",
    ["seam"],
)
RESTORE_SECONDS = _REGISTRY.histogram(
    mn.LIVENESS_RESTORE_SECONDS,
    "Warm-restart KV checkpoint restore wall time (load + verify + "
    "install), successful or not",
)
RESTORE_OUTCOME = _REGISTRY.counter(
    mn.LIVENESS_RESTORE_OUTCOME_TOTAL,
    "Warm-restart restore outcomes: restored | partial (some blocks "
    "dropped by CRC) | empty | cold_mismatch (stamp) | cold_corrupt | "
    "cold_error — every cold_* is a logged cold start, never a crash",
    ["outcome"],
)


def note_stale_drop(seam: str, n: int = 1) -> None:
    """Count a fenced (dropped, never applied) stale-incarnation packet."""
    STALE_DROPS.inc(n, seam=seam)


def stale_drop_counts() -> Dict[str, int]:
    """seam → drop count (tests/bench; scrape-free)."""
    return {
        str(key[0]): int(value)
        for key, value in STALE_DROPS._values.items()
    }


def note_restore(outcome: str, seconds: Optional[float] = None) -> None:
    RESTORE_OUTCOME.inc(outcome=outcome)
    if seconds is not None:
        RESTORE_SECONDS.observe(seconds)


def render_fence_metrics(openmetrics: bool = False) -> str:
    """Process-global fencing/restore families (system-server source)."""
    return _REGISTRY.render(openmetrics=openmetrics)


class IncarnationFence:
    """Highest-seen incarnation per key, admitting only the newest.

    ``admit(key, inc)`` returns one of:

      * ``"applied"``  — same incarnation as before (or unfenced: inc 0 /
        None, from peers predating the stamp) — apply the packet;
      * ``"rejoined"`` — a STRICTLY newer incarnation: the worker
        restarted. The caller must purge the old incarnation's state
        (``drop_worker``) BEFORE applying, so fresh state is never
        conflated with the zombie's;
      * ``"stale"``    — older than the newest seen: a zombie's late
        packet. Counted at ``seam`` and must be dropped, never applied.
    """

    def __init__(self, seam: str) -> None:
        self.seam = seam
        self._newest: Dict[Any, int] = {}

    def admit(self, key: Any, inc: Optional[int]) -> str:
        if not inc:  # unstamped peer (or tests): fencing is opt-in
            return "applied"
        newest = self._newest.get(key, 0)
        if inc < newest:
            note_stale_drop(self.seam)
            return "stale"
        if inc > newest:
            self._newest[key] = inc
            return "rejoined" if newest else "applied"
        return "applied"

    def newest(self, key: Any) -> int:
        return self._newest.get(key, 0)

    def drop(self, key: Any) -> None:
        """Forget a key entirely (worker permanently removed). The next
        registration re-establishes the fence from its own stamp."""
        self._newest.pop(key, None)


# ---------------------------------------------------------------------------
# Liveness tracking
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LivenessConfig:
    """Detection budget, in load-report intervals. The defaults declare a
    worker dead after 5 missed 1 s reports — a 5 s detection-to-migration
    bound, an order of magnitude under the kernel's TCP retransmission
    timeouts and tunable per deployment."""

    interval_s: float = 1.0
    suspect_after: int = 2
    dead_after: int = 5

    def __post_init__(self) -> None:
        if self.interval_s <= 0:
            raise ValueError("interval_s must be positive")
        if not (0 < self.suspect_after <= self.dead_after):
            raise ValueError(
                "need 0 < suspect_after <= dead_after "
                f"(got {self.suspect_after}, {self.dead_after})"
            )

    @property
    def detection_budget_s(self) -> float:
        """The bound detection latency must stay inside."""
        return self.dead_after * self.interval_s


@dataclass
class _WorkerLiveness:
    state: int = ALIVE
    incarnation: int = 0
    last_seen: float = 0.0  # OUR monotonic clock at last admitted report
    declared_dead_at: float = 0.0


class LivenessTracker:
    """Missed-report worker liveness with incarnation fencing.

    Fed one ``observe_report`` per load report (http/worker_monitor.py
    pump); ``evaluate()`` runs on the consumer's cadence (the monitor's
    evaluation task) and fires ``on_dead`` / ``on_rejoin`` callbacks.
    Judged ONLY by local observation time — the leader.py rule — so a
    worker on a skewed clock is never declared dead while its reports
    keep arriving, and a partitioned one is declared dead exactly when
    its reports stop reaching US (which is when it stopped serving us).

    Single event-loop consumer; the flight ring (owner "liveness")
    records every transition for post-mortems."""

    def __init__(
        self,
        config: Optional[LivenessConfig] = None,
        *,
        clock: Callable[[], float] = time.monotonic,
        on_dead: Optional[Callable[[int, int], None]] = None,
        on_rejoin: Optional[Callable[[int, int], None]] = None,
    ) -> None:
        self.config = config or LivenessConfig()
        self._clock = clock
        self._workers: Dict[int, _WorkerLiveness] = {}
        self._fence = IncarnationFence("load_report")
        # (worker_id, incarnation) -> None; rejoin fires BEFORE the fresh
        # report is applied so the old incarnation's router state is
        # purged first.
        self._on_dead: List[Callable[[int, int], None]] = (
            [on_dead] if on_dead else []
        )
        self._on_rejoin: List[Callable[[int, int], None]] = (
            [on_rejoin] if on_rejoin else []
        )
        self.deaths = 0  # total dead declarations (tests/bench)
        self.metrics = LivenessMetrics(self)
        self.flight = FlightRecorder("liveness", capacity=256)

    # -- wiring -------------------------------------------------------------

    def add_dead_callback(self, fn: Callable[[int, int], None]) -> None:
        self._on_dead.append(fn)

    def add_rejoin_callback(self, fn: Callable[[int, int], None]) -> None:
        self._on_rejoin.append(fn)

    # -- observation --------------------------------------------------------

    def observe_report(self, worker_id: int, incarnation: int = 0) -> str:
        """Admit one load report. Returns the fence verdict: ``"stale"``
        means the report must NOT be applied downstream (a zombie's late
        publish); ``"rejoined"`` means the old incarnation's state was
        purged via on_rejoin and the report should then be applied as the
        fresh worker's first."""
        # Chaos seam: an injected failure here models report loss between
        # the wire and the tracker — N consecutive injections MUST trip
        # the same suspect/dead machinery a crashed worker does.
        fault_point(fault_names.LIVENESS_REPORT, worker=worker_id)
        verdict = self._fence.admit(worker_id, incarnation)
        if verdict == "stale":
            self.flight.record(
                "stale_report", worker=worker_id, incarnation=incarnation,
                newest=self._fence.newest(worker_id),
            )
            return verdict
        now = self._clock()
        w = self._workers.get(worker_id)
        if verdict == "rejoined" or (w is not None and w.state == DEAD):
            # Restart (new incarnation) or a dead worker reporting again:
            # purge the old incarnation's router state BEFORE this report
            # is applied so fresh state is never conflated with it.
            self.flight.record(
                "rejoin", worker=worker_id, incarnation=incarnation,
                was=_STATE_NAMES[w.state if w else ALIVE],
            )
            logger.warning(
                "worker %#x rejoined (incarnation %d)", worker_id, incarnation
            )
            for fn in self._on_rejoin:
                try:
                    fn(worker_id, incarnation)
                except Exception:
                    logger.exception("liveness on_rejoin callback failed")
            self._workers[worker_id] = _WorkerLiveness(
                state=ALIVE, incarnation=incarnation, last_seen=now
            )
            return "rejoined"
        if w is None:
            w = self._workers[worker_id] = _WorkerLiveness()
            self.flight.record(
                "discovered", worker=worker_id, incarnation=incarnation
            )
        if w.state == SUSPECT:
            self.flight.record("recovered", worker=worker_id)
        w.state = ALIVE
        w.incarnation = incarnation or w.incarnation
        w.last_seen = now
        return verdict

    # -- evaluation ---------------------------------------------------------

    def evaluate(self) -> List[int]:
        """One detection sweep; returns workers newly declared dead.
        Transitions are judged against each worker's LAST ARRIVAL on our
        monotonic clock — never a remote timestamp."""
        cfg = self.config
        now = self._clock()
        newly_dead: List[int] = []
        for worker_id, w in self._workers.items():
            if w.state == DEAD:
                continue
            missed = (now - w.last_seen) / cfg.interval_s
            if missed >= cfg.dead_after:
                w.state = DEAD
                w.declared_dead_at = now
                self.deaths += 1
                latency = now - w.last_seen
                self.metrics.detection.observe(latency)
                self.flight.record(
                    "dead", worker=worker_id,
                    missed=int(missed), latency_ms=round(latency * 1000, 1),
                )
                logger.error(
                    "worker %#x declared DEAD after %.1f missed load "
                    "reports (%.2fs since last; budget %.2fs)",
                    worker_id, missed, latency, cfg.detection_budget_s,
                )
                newly_dead.append(worker_id)
            elif missed >= cfg.suspect_after and w.state == ALIVE:
                w.state = SUSPECT
                self.flight.record(
                    "suspect", worker=worker_id, missed=int(missed)
                )
                logger.warning(
                    "worker %#x SUSPECT after %d missed load reports",
                    worker_id, int(missed),
                )
        for worker_id in newly_dead:
            inc = self._workers[worker_id].incarnation
            for fn in self._on_dead:
                try:
                    fn(worker_id, inc)
                except Exception:
                    logger.exception("liveness on_dead callback failed")
        return newly_dead

    def note_streams_aborted(self, worker_id: int, streams: int) -> None:
        """Record the dead-worker stream-abort fan-out on the tracker's
        own ring (the on_dead callbacks run inside ``evaluate()``, on the
        ring's single consumer loop)."""
        self.flight.record(
            "streams_aborted", worker=worker_id, streams=streams
        )

    # -- surface ------------------------------------------------------------

    def state_of(self, worker_id: int) -> Optional[int]:
        w = self._workers.get(worker_id)
        return w.state if w is not None else None

    def states(self) -> Dict[int, int]:
        return {wid: w.state for wid, w in self._workers.items()}

    def dead_workers(self) -> List[int]:
        return sorted(
            wid for wid, w in self._workers.items() if w.state == DEAD
        )

    def drop(self, worker_id: int) -> None:
        """Forget a worker entirely (permanent departure via discovery
        DELETE) so dead entries don't accumulate across fleet turnover.
        The fence entry goes too — a re-registration re-establishes it."""
        self._workers.pop(worker_id, None)
        self._fence.drop(worker_id)

    def status(self) -> Dict[str, Any]:
        return {
            f"{wid:#x}": {
                "state": _STATE_NAMES[w.state],
                "incarnation": w.incarnation,
                "age_s": round(self._clock() - w.last_seen, 3),
            }
            for wid, w in self._workers.items()
        }

    def register_metrics(self, server: Any) -> None:
        server.register_metrics(self.metrics.render)
        server.register_flight(self.flight.name, self.flight.snapshot)


class LivenessMetrics:
    """Tracker-owned canonical families (metric_names.py ALL_LIVENESS);
    the process-global fencing/restore families render separately
    (:func:`render_fence_metrics`)."""

    def __init__(self, tracker: "LivenessTracker") -> None:
        self._tracker = tracker
        self.registry = MetricsRegistry()
        self.worker_state = self.registry.gauge(
            mn.LIVENESS_WORKER_STATE,
            "Per-worker liveness state: 0 alive, 1 suspect (2 missed "
            "reports), 2 dead (drop_worker ran, streams aborted)",
            ["worker"],
        )
        self.detection = self.registry.histogram(
            mn.LIVENESS_DETECTION_SECONDS,
            "Last-report-to-declared-dead latency; bounded by dead_after "
            "x interval_s by construction",
        )
        self._gauge_workers: set = set()
        self.registry.on_render(self._sample)

    def _sample(self) -> None:
        labels = set()
        for wid, state in self._tracker.states().items():
            label = f"{wid:#x}"
            labels.add(label)
            self.worker_state.set(state, worker=label)
        for gone in self._gauge_workers - labels:
            self.worker_state.remove(worker=gone)
        self._gauge_workers = labels

    def render(self, openmetrics: bool = False) -> str:
        return self.registry.render(openmetrics=openmetrics)
