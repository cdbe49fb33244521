"""Worker load monitoring + busy-threshold load shedding for the frontend —
the port's copy of dynamo_tpu/http/worker_monitor.py.

Reference parity: lib/llm/src/discovery/worker_monitor.rs (per-worker load
tracking from published stats) and lib/llm/src/http/service/busy_threshold.rs
(per-model thresholds on KV-block utilization and prefill pressure; when ALL
workers for a model exceed them, new requests are rejected 503).

The monitor subscribes to the same load topic the KV router consumes
(router/publisher.py LoadPublisher snapshots) — no new worker-side wiring.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from dynamo_tpu_torch.router.protocols import LoadSnapshot, load_topic
from dynamo_tpu_torch.runtime.liveness import LivenessTracker
from dynamo_tpu_torch.runtime.tasks import reap_task
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@dataclass
class BusyThresholds:
    """(ref: busy_threshold.rs BusyThresholdRequest fields)"""

    # fraction of KV blocks in use above which a worker counts as busy
    active_decode_blocks_threshold: Optional[float] = None
    # queued (not yet admitted) requests above which a worker counts as busy
    # (the prefill-pressure analog of the reference's prefill-token gauges)
    waiting_requests_threshold: Optional[int] = None

    @property
    def configured(self) -> bool:
        return (
            self.active_decode_blocks_threshold is not None
            or self.waiting_requests_threshold is not None
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "active_decode_blocks_threshold": self.active_decode_blocks_threshold,
            "waiting_requests_threshold": self.waiting_requests_threshold,
        }


class WorkerLoadMonitor:
    """Latest load snapshot per (worker, dp_rank) for one component."""

    def __init__(
        self,
        event_plane: Any,
        namespace: str,
        component: str,
        *,
        stale_after_s: float = 10.0,
        liveness: Optional[LivenessTracker] = None,
    ) -> None:
        self._plane = event_plane
        self._topic = load_topic(namespace, component)
        self.stale_after_s = stale_after_s
        self._loads: Dict[Tuple[int, int], Tuple[LoadSnapshot, float]] = {}
        self._sub = None
        self._task: Optional[asyncio.Task] = None
        # Crash plane (runtime/liveness.py): the monitor already consumes
        # every load report, so it is where missed-report liveness lives —
        # the pump feeds the tracker (fencing stale incarnations out of
        # ``_loads`` too) and an evaluation task runs detection sweeps on
        # a fraction of the report cadence.
        self.liveness = liveness
        self._eval_task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        self._sub = self._plane.subscribe(self._topic)
        self._task = asyncio.get_running_loop().create_task(
            self._pump(), name=f"worker-monitor:{self._topic}"
        )
        if self.liveness is not None:
            self._eval_task = asyncio.get_running_loop().create_task(
                self._evaluate_loop(), name=f"liveness:{self._topic}"
            )

    async def stop(self) -> None:
        if self._sub is not None:
            await self._sub.aclose()
            self._sub = None
        for task, what in (
            (self._task, "worker-load monitor pump"),
            (self._eval_task, "liveness evaluate loop"),
        ):
            if task is not None:
                task.cancel()
                await reap_task(task, what, logger)
        self._task = None
        self._eval_task = None

    async def _evaluate_loop(self) -> None:
        # Half the report interval: detection latency error from sweep
        # granularity stays well inside the missed-report budget.
        interval = max(self.liveness.config.interval_s / 2.0, 0.01)
        while True:
            await asyncio.sleep(interval)
            try:
                self.liveness.evaluate()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("liveness evaluation sweep failed")

    async def _pump(self) -> None:
        async for _topic, payload in self._sub:
            try:
                snap = LoadSnapshot.from_dict(payload)
            except Exception:
                logger.exception("bad load snapshot payload")
                continue
            if self.liveness is not None:
                try:
                    verdict = self.liveness.observe_report(
                        snap.worker_id, snap.incarnation
                    )
                except Exception:
                    # The liveness.report chaos seam (or a real tracker
                    # bug) fired: the report is LOST before admission —
                    # exactly the condition detection exists for. Drop it;
                    # enough consecutive losses trip suspect/dead.
                    logger.debug(
                        "load report from %#x lost at the liveness seam",
                        snap.worker_id, exc_info=True,
                    )
                    continue
                if verdict == "stale":
                    continue  # a zombie incarnation's late publish
            self._loads[(snap.worker_id, snap.dp_rank)] = (snap, time.monotonic())

    def fresh_loads(self) -> Dict[Tuple[int, int], LoadSnapshot]:
        cutoff = time.monotonic() - self.stale_after_s
        return {k: s for k, (s, ts) in self._loads.items() if ts >= cutoff}

    def drop_worker(self, worker_id: int) -> None:
        for key in [k for k in self._loads if k[0] == worker_id]:
            self._loads.pop(key, None)

    # -- busy gating --------------------------------------------------------

    def _is_busy(self, snap: LoadSnapshot, th: BusyThresholds) -> bool:
        if th.active_decode_blocks_threshold is not None and snap.total_blocks:
            if snap.active_blocks / snap.total_blocks >= th.active_decode_blocks_threshold:
                return True
        if th.waiting_requests_threshold is not None:
            if snap.waiting >= th.waiting_requests_threshold:
                return True
        return False

    def all_busy(self, thresholds: BusyThresholds) -> bool:
        """True only when thresholds are configured, we have fresh data, and
        EVERY fresh worker exceeds them (ref: busy_threshold.rs middleware).
        No data ⇒ can't tell ⇒ don't shed."""
        if not thresholds.configured:
            return False
        loads = self.fresh_loads()
        if not loads:
            return False
        return all(self._is_busy(s, thresholds) for s in loads.values())
