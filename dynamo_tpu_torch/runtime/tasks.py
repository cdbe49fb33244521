"""Task tracking and graceful shutdown — the port's copy of
dynamo_tpu/runtime/tasks.py: ``Backoff`` for the reconnect loops,
``reap_task`` for shutdown, and ``TaskTracker`` with its guarded units,
tracked tasks (the runtime's lease keep-alive) and ``drain()``; JAX's
``in_flight`` and ``cancel_all``, which nothing in the port calls, are left
out.

Reference parity: the graceful-shutdown TaskTracker
(lib/runtime/src/utils/tasks/tracker.rs) and critical-task supervision
(utils/tasks/critical.rs). Endpoints register in-flight request tasks here;
shutdown flips to "draining", stops accepting new work, waits for in-flight
streams up to a grace period, then cancels stragglers.
"""

from __future__ import annotations

import asyncio
import logging
import random
from typing import Any, Callable, Coroutine, Optional, Set

logger = logging.getLogger(__name__)


class Backoff:
    """Jittered exponential backoff for reconnect/re-register loops.

    A control-plane blip (discd restart, broker hiccup) disconnects every
    worker at once; bare fixed-interval retries then reconnect as a
    synchronized herd and flatten the recovering service again. This
    schedule spreads them: ``base × 2^n`` capped at ``cap``, multiplied by
    a uniform draw in ``[1 − jitter, 1 + jitter]``. ``reset()`` on the
    first success so steady-state failures start cheap again.

    Deterministic under a seeded ``rng`` (the fake-clock tests replay the
    exact delay sequence); the default draws process randomness, which is
    precisely the de-synchronization production wants."""

    def __init__(
        self,
        base_s: float = 0.1,
        cap_s: float = 15.0,
        jitter: float = 0.5,
        rng: Optional[random.Random] = None,
    ) -> None:
        if not (0.0 <= jitter < 1.0):
            raise ValueError("jitter must be in [0, 1)")
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.jitter = float(jitter)
        self._rng = rng or random.Random()
        self.attempt = 0

    def next_delay(self) -> float:
        """Delay before the (attempt+1)-th retry; advances the attempt."""
        raw = min(self.base_s * (2 ** self.attempt), self.cap_s)
        self.attempt += 1
        if self.jitter:
            raw *= 1.0 + self._rng.uniform(-self.jitter, self.jitter)
        return raw

    def reset(self) -> None:
        self.attempt = 0

    async def sleep(self) -> float:
        delay = self.next_delay()
        await asyncio.sleep(delay)
        return delay


async def reap_task(
    task: Optional["asyncio.Future"],
    what: str = "task",
    log: Optional[logging.Logger] = None,
) -> Optional[BaseException]:
    """Await a (usually just-cancelled) background task at shutdown.

    Cancellation is the expected outcome. A real exception is returned
    and recorded at DEBUG — the task's own failure path already reported
    it when it happened; this is only the reaper's receipt (a
    broad swallow must leave a trace)."""
    if task is None:
        return None
    try:
        # shield: a cancellation of the REAPER (the shutdown path itself
        # sits under wait_for somewhere) must not be mistaken for — or
        # converted into — the task's own cancellation. A bare `await
        # task` would forward the reaper's cancel into the task and then
        # swallow it, making the shutdown path uncancellable.
        await asyncio.shield(task)
    except asyncio.CancelledError:
        if task.cancelled():
            return None
        raise  # reaper cancelled; keep unwinding cooperatively
    except Exception as exc:
        (log or logger).debug("%s ended with %r at shutdown", what, exc)
        return exc
    return None


class TaskTracker:
    def __init__(self, name: str = "tracker") -> None:
        self.name = name
        self._tasks: Set[asyncio.Task] = set()
        self._guards = 0
        self._draining = False
        self._drained = asyncio.Event()
        self._drained.set()

    @property
    def draining(self) -> bool:
        return self._draining

    def guard(self) -> "_Guard":
        """Context manager marking a unit of in-flight work (e.g. a response
        stream) that drain() must wait for."""
        if self._draining:
            raise RuntimeError(f"{self.name}: draining, refusing new work")
        return _Guard(self)

    def spawn(
        self,
        coro: Coroutine[Any, Any, Any],
        *,
        name: Optional[str] = None,
        critical: bool = False,
        on_failure: Optional[Callable[[BaseException], None]] = None,
    ) -> asyncio.Task:
        """Track a task. Critical tasks log at error level when they die
        unexpectedly and invoke ``on_failure`` (e.g. to trigger shutdown)."""
        if self._draining:
            coro.close()
            raise RuntimeError(f"{self.name}: draining, refusing new task")
        task = asyncio.get_running_loop().create_task(coro, name=name)
        self._tasks.add(task)
        self._drained.clear()

        def _done(t: asyncio.Task) -> None:
            self._tasks.discard(t)
            self._maybe_drained()
            if t.cancelled():
                return
            exc = t.exception()
            if exc is not None:
                level = logging.ERROR if critical else logging.WARNING
                logger.log(level, "%s: task %s failed: %r", self.name, t.get_name(), exc)
                if on_failure is not None:
                    on_failure(exc)

        task.add_done_callback(_done)
        return task

    async def drain(self, grace_period: float = 30.0) -> bool:
        """Stop accepting work; wait for in-flight tasks, cancel stragglers.

        Returns True if everything finished within the grace period."""
        self._draining = True
        if not self._tasks and not self._guards:
            return True
        try:
            await asyncio.wait_for(self._drained.wait(), timeout=grace_period)
            return True
        except asyncio.TimeoutError:
            logger.warning(
                "%s: %d tasks still running after %.1fs grace, cancelling",
                self.name,
                len(self._tasks),
                grace_period,
            )
            for t in list(self._tasks):
                t.cancel()
            await asyncio.gather(*self._tasks, return_exceptions=True)
            return False

    def _maybe_drained(self) -> None:
        if not self._tasks and not self._guards:
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
