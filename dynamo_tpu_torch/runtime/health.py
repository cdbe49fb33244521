"""Active (canary) health checking of endpoint instances — the port's copy
of dynamo_tpu/runtime/health.py.

Reference parity: lib/runtime/src/health_check.rs (HealthCheckManager —
per-endpoint canary tasks with a registered payload, request timeout, and
idle gating via canary_wait_time) and
lib/llm/src/discovery/worker_monitor.rs (evicting sick-but-leased workers
from routing). A lease keeps a *dead* worker out of discovery; the canary
catches the worse case — a worker that is alive enough to renew its lease
but no longer serves (hung device loop, deadlocked executor).

Workers advertise their canary payload in instance metadata under
``health_payload`` at serve time; the checker prefers it over the default.
Unhealthy instances are excluded from routing via Client.set_instance_filter
and re-admitted the moment a canary succeeds.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Set

from dynamo_tpu_torch.runtime import fault_names
from dynamo_tpu_torch.runtime.device_observe import FlightRecorder
from dynamo_tpu_torch.runtime.faults import fault_point
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# A minimal generation request every LLM-shaped engine accepts.
DEFAULT_CANARY_PAYLOAD: Dict[str, Any] = {
    "token_ids": [1],
    "request_id": "health-canary",
    "sampling": {"temperature": 0.0},
    "stop": {"max_tokens": 1, "ignore_eos": True},
    "annotations": ["health_check"],
}


@dataclass
class InstanceHealth:
    consecutive_failures: int = 0
    healthy: bool = True
    last_check: float = 0.0
    last_error: Optional[str] = None


class CanaryHealthChecker:
    """Periodically sends a canary request to every instance of a client.

    A worker is marked unhealthy after ``failure_threshold`` consecutive
    canary failures (timeout or error) and excluded from routing; one
    successful canary restores it. Checks are skipped for instances the
    client has seen traffic succeed on within ``canary_wait_time_s``
    (the reference's idle gating — don't spend canaries on a busy worker
    that is demonstrably serving).
    """

    def __init__(
        self,
        client: Any,  # runtime Client
        *,
        interval_s: float = 5.0,
        timeout_s: float = 10.0,
        failure_threshold: int = 2,
        canary_wait_time_s: float = 5.0,
        payload: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.client = client
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.failure_threshold = failure_threshold
        self.canary_wait_time_s = canary_wait_time_s
        self.payload = payload or dict(DEFAULT_CANARY_PAYLOAD)
        self.health: Dict[int, InstanceHealth] = {}
        self._activity: Dict[int, float] = {}  # last successful traffic
        self._task: Optional[asyncio.Task] = None
        self._stop = asyncio.Event()
        # Transition history: which worker went dark when, and what error
        # tripped it — the question the on-call asks first. Single writer:
        # every record happens on the checker's loop.
        self.flight = FlightRecorder("health", capacity=256)
        client.set_instance_filter(self.is_healthy)

    # -- routing integration ----------------------------------------------

    def is_healthy(self, instance_id: int) -> bool:
        h = self.health.get(instance_id)
        return h is None or h.healthy

    def unhealthy_ids(self) -> Set[int]:
        return {iid for iid, h in self.health.items() if not h.healthy}

    def note_success(self, instance_id: int) -> None:
        """Report organic successful traffic (defers the canary)."""
        self._activity[instance_id] = time.monotonic()

    # -- checking ----------------------------------------------------------

    def _payload_for(self, instance: Any) -> Dict[str, Any]:
        meta = getattr(instance, "metadata", None) or {}
        return meta.get("health_payload") or self.payload

    async def check_instance(self, instance_id: int) -> bool:
        """One canary round-trip; updates state; returns health."""
        h = self.health.setdefault(instance_id, InstanceHealth())
        h.last_check = time.monotonic()
        instance = self.client._instances.get(instance_id)
        if instance is None:
            return h.healthy
        try:
            # Chaos seam: an injected canary failure must trip the same
            # exclusion/re-admission machinery a hung worker does.
            fault_point(fault_names.HEALTH_CANARY, instance=instance_id)
            stream = self.client.direct(self._payload_for(instance), instance_id)

            async def _consume():
                async for _ in stream:
                    break  # first item proves liveness

            await asyncio.wait_for(_consume(), timeout=self.timeout_s)
        except Exception as exc:
            h.consecutive_failures += 1
            h.last_error = f"{type(exc).__name__}: {exc}"
            if h.consecutive_failures >= self.failure_threshold and h.healthy:
                h.healthy = False
                self.flight.record(
                    "unhealthy", instance=instance_id,
                    failures=h.consecutive_failures, error=h.last_error,
                )
                logger.warning(
                    "instance %#x marked UNHEALTHY after %d canary failures (%s)",
                    instance_id, h.consecutive_failures, h.last_error,
                )
            return h.healthy
        if not h.healthy:
            self.flight.record(
                "recovered", instance=instance_id,
                after_failures=h.consecutive_failures,
            )
            logger.info("instance %#x recovered (canary ok)", instance_id)
        h.consecutive_failures = 0
        h.healthy = True
        h.last_error = None
        return True

    async def check_all(self) -> None:
        now = time.monotonic()
        for iid in list(self.client.instance_ids):
            recent = self._activity.get(iid, 0.0)
            h = self.health.get(iid)
            if (h is None or h.healthy) and now - recent < self.canary_wait_time_s:
                continue  # organically busy and healthy: skip the canary
            await self.check_instance(iid)
        # Forget departed instances so state doesn't leak.
        live = set(self.client.instance_ids)
        for iid in list(self.health):
            if iid not in live:
                self.health.pop(iid, None)
                self._activity.pop(iid, None)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._task is None:
            self._stop.clear()
            self._task = asyncio.get_running_loop().create_task(
                self._run(), name="canary-health"
            )

    async def _run(self) -> None:
        while not self._stop.is_set():
            try:
                await self.check_all()
            except Exception:
                logger.exception("health check sweep failed")
            try:
                await asyncio.wait_for(self._stop.wait(), timeout=self.interval_s)
            except asyncio.TimeoutError:
                pass

    async def stop(self) -> None:
        self._stop.set()
        if self._task is not None:
            await self._task
            self._task = None

    def status(self) -> Dict[str, Any]:
        """(ref: health_check.rs get_health_check_status)"""
        return {
            f"{iid:#x}": {
                "healthy": h.healthy,
                "consecutive_failures": h.consecutive_failures,
                "last_error": h.last_error,
            }
            for iid, h in self.health.items()
        }
