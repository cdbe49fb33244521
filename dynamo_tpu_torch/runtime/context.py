"""Request context: identity, cancellation, deadlines, tracing baggage —
the port's copy of dynamo_tpu/runtime/context.py.

Reference parity: dynamo-runtime's ``Context``/``AsyncEngineContext``
(lib/runtime/src/engine.rs:201 and pipeline context plumbing). The reference
relies on Rust drop-semantics for cancellation propagation; here we use an
explicit tree of asyncio-friendly stop events with parent→child kill
propagation, which composes with ``asyncio.CancelledError`` at await points.
"""

from __future__ import annotations

import asyncio
import contextvars
import time
import uuid
from typing import Any, Dict, List, Optional

# W3C-traceparent-style propagation: the active context rides a contextvar so
# nested operators and log records can pick it up without explicit threading.
_current_context: contextvars.ContextVar[Optional["Context"]] = contextvars.ContextVar(
    "dynamo_tpu_torch_context", default=None
)


def current_context() -> Optional["Context"]:
    return _current_context.get()


class Context:
    """Per-request context flowing through the pipeline with the payload.

    - ``id``: globally unique request id (also the stream id on the wire).
    - ``stop``: cooperative cancellation. ``stopped`` is checked by engines
      between decode steps; awaiting code can use ``wait_stopped``.
    - ``kill``: hard cancellation — also cancels in-flight network I/O.
    - children: cancelling a parent cancels every child (router → worker
      sub-requests, disagg prefill sub-request, migration retries).
    """

    __slots__ = (
        "_id",
        "_stop_event",
        "_kill_event",
        "_children",
        "_parent",
        "_baggage",
        "_created_at",
        "_deadline",
        "_deadline_handle",
        "_stop_reason",
        "_token",
        "__weakref__",
    )

    def __init__(
        self,
        id: Optional[str] = None,
        *,
        parent: Optional["Context"] = None,
        baggage: Optional[Dict[str, Any]] = None,
        deadline: Optional[float] = None,
    ) -> None:
        self._id = id or uuid.uuid4().hex
        self._stop_event = asyncio.Event()
        self._kill_event = asyncio.Event()
        self._children: List[Context] = []
        self._parent = parent
        self._baggage: Dict[str, Any] = dict(baggage or {})
        self._created_at = time.monotonic()
        self._deadline = deadline
        self._deadline_handle = None
        self._stop_reason: Optional[str] = None
        if deadline is not None:
            # Arm a timer so wait_stopped() waiters observe the deadline even
            # if nobody polls `.stopped`.
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                loop = None
            if loop is not None:
                delay = max(0.0, deadline - time.monotonic())
                handle = loop.call_later(delay, self.stop_generating, "deadline")
                self._deadline_handle = handle
        if parent is not None:
            parent._children.append(self)
            if parent.stopped:
                self.stop_generating(reason=parent._stop_reason or "parent-stopped")
            if parent.killed:
                self.kill()

    # -- identity ---------------------------------------------------------

    @property
    def id(self) -> str:
        return self._id

    @property
    def baggage(self) -> Dict[str, Any]:
        return self._baggage

    @property
    def created_at(self) -> float:
        return self._created_at

    @property
    def elapsed(self) -> float:
        return time.monotonic() - self._created_at

    # -- cancellation -----------------------------------------------------

    @property
    def deadline(self) -> Optional[float]:
        """Absolute monotonic deadline, or None. Operators that spend
        bounded sub-budgets (the disagg pull timeout) derive them from
        ``time_remaining`` so a slow transfer can never eat the whole
        request budget."""
        return self._deadline

    def time_remaining(self) -> Optional[float]:
        """Seconds left until the deadline (None = unbounded, 0 = past)."""
        if self._deadline is None:
            return None
        return max(0.0, self._deadline - time.monotonic())

    def set_deadline(self, deadline: Optional[float]) -> None:
        """(Re)arm the absolute monotonic deadline after construction —
        the overload plane stamps a default budget onto deadline-less
        requests this way. Arms the same wake-up timer the constructor
        would, so ``wait_stopped`` waiters observe the new deadline."""
        if self._deadline_handle is not None:
            self._deadline_handle.cancel()
            self._deadline_handle = None
        self._deadline = deadline
        if deadline is None or self._stop_event.is_set():
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = None
        if loop is not None:
            delay = max(0.0, deadline - time.monotonic())
            self._deadline_handle = loop.call_later(
                delay, self.stop_generating, "deadline"
            )

    @property
    def stopped(self) -> bool:
        if self._deadline is not None and time.monotonic() > self._deadline:
            self.stop_generating(reason="deadline")
        return self._stop_event.is_set()

    @property
    def killed(self) -> bool:
        return self._kill_event.is_set()

    @property
    def stop_reason(self) -> Optional[str]:
        return self._stop_reason

    def stop_generating(self, reason: str = "cancelled") -> None:
        """Cooperatively stop: engines finish the current step then cease."""
        if not self._stop_event.is_set():
            self._stop_reason = reason
            self._stop_event.set()
            if self._deadline_handle is not None:
                self._deadline_handle.cancel()
                self._deadline_handle = None
            for child in self._children:
                child.stop_generating(reason=reason)

    def kill(self) -> None:
        """Hard-stop: also unblocks any ``wait_killed`` waiters (network I/O)."""
        self.stop_generating(reason="killed")
        if not self._kill_event.is_set():
            self._kill_event.set()
            for child in self._children:
                child.kill()

    async def wait_stopped(self) -> None:
        await self._stop_event.wait()

    async def wait_killed(self) -> None:
        await self._kill_event.wait()

    # -- tree -------------------------------------------------------------

    def child(self, id: Optional[str] = None) -> "Context":
        return Context(id=id, parent=self, baggage=self._baggage, deadline=self._deadline)

    # -- scoping ----------------------------------------------------------

    def __enter__(self) -> "Context":
        self._token = _current_context.set(self)
        return self

    def __exit__(self, *exc: Any) -> None:
        _current_context.reset(self._token)

    def __repr__(self) -> str:
        state = "killed" if self.killed else ("stopped" if self.stopped else "live")
        return f"Context({self._id[:8]}…, {state})"


class EngineStream:
    """Pairs a response stream with the context that controls it.

    Dropping the stream (``aclose``) stops the context, mirroring the
    reference's drop-based cancellation of ``AsyncEngineStream``.
    """

    def __init__(self, stream: Any, context: Context) -> None:
        self._stream = stream
        self._context = context

    @property
    def context(self) -> Context:
        return self._context

    def __aiter__(self) -> "EngineStream":
        return self

    async def __anext__(self) -> Any:
        if self._context.killed:
            raise StopAsyncIteration
        try:
            return await self._stream.__anext__()
        except StopAsyncIteration:
            raise

    async def aclose(self) -> None:
        self._context.stop_generating(reason="stream-closed")
        close = getattr(self._stream, "aclose", None)
        if close is not None:
            await close()
