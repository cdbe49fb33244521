"""Event plane: pub/sub for KV events and load metrics — the port's copy of
dynamo_tpu/runtime/events/__init__.py.

Reference parity: lib/runtime/src/transports/event_plane/ (NATS default,
brokerless ZMQ alternative; framed msgpack codec). Backends here:

  - ``MemoryEventPlane`` — process-local shared bus for tests/process-local
    runtimes.
  - ``ZmqEventPlane`` (runtime/events/zmq_plane.py) — pub/sub through a
    broker over the ZeroMQ wire (ZMTP 3.1, runtime/events/zmtp.py: the
    card's machine has no pyzmq), the cross-process default.

Topics are dotted strings; subscriptions match exact topics or prefixes with a
trailing ``.>`` wildcard (NATS-style).
"""

from __future__ import annotations

import asyncio
from typing import Any, AsyncIterator, Dict, List, Optional, Protocol, Tuple


def topic_matches(pattern: str, topic: str) -> bool:
    if pattern == topic:
        return True
    if pattern.endswith(".>"):
        return topic.startswith(pattern[:-1]) or topic == pattern[:-2]
    return False


class EventPlane(Protocol):
    async def publish(self, topic: str, payload: Any) -> None: ...
    def subscribe(self, topic: str) -> "Subscription": ...
    async def close(self) -> None: ...


_SUB_CLOSED = object()


class Subscription:
    """Async iterator of (topic, payload) pairs. ``ready`` is set once the
    subscription can receive (at once on the memory plane; on the ZMQ plane
    when its SUBSCRIBE has been sent to the broker, or its pump ended)."""

    def __init__(self, pattern: str, queue: "asyncio.Queue", on_close=None) -> None:
        self.pattern = pattern
        self._queue = queue
        self._closed = False
        self._on_close = on_close
        self.ready = asyncio.Event()

    def __aiter__(self) -> "Subscription":
        return self

    async def __anext__(self) -> Tuple[str, Any]:
        if self._closed:
            raise StopAsyncIteration
        item = await self._queue.get()
        if item is _SUB_CLOSED:
            self._closed = True
            raise StopAsyncIteration
        return item

    async def get(self, timeout: Optional[float] = None) -> Tuple[str, Any]:
        if timeout is None:
            return await self.__anext__()
        return await asyncio.wait_for(self.__anext__(), timeout=timeout)

    async def aclose(self) -> None:
        if not self._closed:
            self._closed = True
            if self._on_close is not None:
                self._on_close(self)

    async def __aenter__(self) -> "Subscription":
        return self

    async def __aexit__(self, *exc: Any) -> None:
        await self.aclose()


class MemoryEventPlane:
    _buses: Dict[str, "MemoryEventPlane"] = {}

    def __init__(self) -> None:
        self._subs: List[Tuple[str, asyncio.Queue, asyncio.AbstractEventLoop]] = []

    @classmethod
    def shared(cls, bus: str = "default") -> "MemoryEventPlane":
        if bus not in cls._buses:
            cls._buses[bus] = cls()
        return cls._buses[bus]

    @classmethod
    def reset(cls, bus: Optional[str] = None) -> None:
        if bus is None:
            cls._buses.clear()
        else:
            cls._buses.pop(bus, None)

    async def publish(self, topic: str, payload: Any) -> None:
        for pattern, queue, loop in list(self._subs):
            if topic_matches(pattern, topic):
                try:
                    loop.call_soon_threadsafe(queue.put_nowait, (topic, payload))
                except RuntimeError:
                    self._subs = [s for s in self._subs if s[1] is not queue]

    def subscribe(self, topic: str) -> Subscription:
        queue: asyncio.Queue = asyncio.Queue()
        loop = asyncio.get_running_loop()
        self._subs.append((topic, queue, loop))

        def _close(sub: Subscription) -> None:
            self._subs = [s for s in self._subs if s[1] is not queue]
            try:
                loop.call_soon_threadsafe(queue.put_nowait, _SUB_CLOSED)
            except RuntimeError:
                pass

        sub = Subscription(topic, queue, on_close=_close)
        sub.ready.set()
        return sub

    async def close(self) -> None:
        for _, queue, loop in list(self._subs):
            try:
                loop.call_soon_threadsafe(queue.put_nowait, _SUB_CLOSED)
            except RuntimeError:
                pass
        self._subs.clear()
