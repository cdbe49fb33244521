"""Graceful shutdown — the port's copy of ``TaskTracker`` from
dynamo_tpu/runtime/tasks.py, with the parts the HTTP frontend uses:
``guard()`` around each in-flight request and ``drain()`` at shutdown.

Reference parity: the graceful-shutdown TaskTracker
(lib/runtime/src/utils/tasks/tracker.rs). Request handlers register
in-flight work here; shutdown flips to "draining", refuses new work, and
waits for in-flight streams up to a grace period.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any

logger = logging.getLogger(__name__)


class TaskTracker:
    def __init__(self, name: str = "tracker") -> None:
        self.name = name
        self._guards = 0
        self._draining = False
        self._drained = asyncio.Event()
        self._drained.set()

    def guard(self) -> "_Guard":
        """Context manager marking a unit of in-flight work (e.g. a response
        stream) that drain() must wait for."""
        if self._draining:
            raise RuntimeError(f"{self.name}: draining, refusing new work")
        return _Guard(self)

    async def drain(self, grace_period: float = 30.0) -> bool:
        """Stop accepting work; wait for in-flight work.

        Returns True if everything finished within the grace period."""
        self._draining = True
        if not self._guards:
            return True
        try:
            await asyncio.wait_for(self._drained.wait(), timeout=grace_period)
            return True
        except asyncio.TimeoutError:
            logger.warning(
                "%s: %d guarded units still running after %.1fs grace",
                self.name, self._guards, grace_period,
            )
            return False

    def _maybe_drained(self) -> None:
        if not self._guards:
            self._drained.set()


class _Guard:
    def __init__(self, tracker: TaskTracker) -> None:
        self._tracker = tracker
        self._active = False

    def __enter__(self) -> "_Guard":
        self._tracker._guards += 1
        self._tracker._drained.clear()
        self._active = True
        return self

    def __exit__(self, *exc: Any) -> None:
        if self._active:
            self._active = False
            self._tracker._guards -= 1
            self._tracker._maybe_drained()
