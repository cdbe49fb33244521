"""Discovery plane: service/instance/model registration + watch — the
port's copy of dynamo_tpu/runtime/discovery/__init__.py.

Reference parity: lib/runtime/src/discovery/{mod.rs,kv_store.rs,mock.rs}
and the lease-backed etcd transport (transports/etcd.rs). Backends:

  - ``MemoryDiscovery``  — process-local shared bus (ref: discovery/mock.rs);
    zero-infra testing, used by DistributedRuntime.process_local().
  - ``FileDiscovery``    — shared-directory backend with mtime-refreshed
    leases (ref: storage/kv/file.rs); works across processes on one host.
  - ``DiscdDiscovery``   — client for the self-hosted discd TCP KV service
    (runtime/discovery/discd.py) for multi-host.

Data model: a flat key → JSON document store with optional leases. Keys:

    instances/{namespace}/{component}/{endpoint}/{instance_id}
    models/{namespace}/{model_slug}/{instance_id}

A lease is kept alive by its owner; when the owner dies the backend expires
the lease and watchers observe Delete events — this is the liveness mechanism
(ref: etcd lease keep-alive).
"""

from __future__ import annotations

import asyncio
import uuid
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, AsyncIterator, Dict, List, Optional, Protocol, Tuple


class EventKind(str, Enum):
    PUT = "put"
    DELETE = "delete"


@dataclass(frozen=True)
class WatchEvent:
    kind: EventKind
    key: str
    value: Optional[Dict[str, Any]] = None  # None for deletes


@dataclass
class Lease:
    id: str
    ttl: float


class DiscoveryBackend(Protocol):
    """Key→JSON store with leases and prefix watch."""

    async def put(self, key: str, value: Dict[str, Any], lease: Optional[Lease] = None) -> None: ...
    async def delete(self, key: str) -> None: ...
    async def get(self, key: str) -> Optional[Dict[str, Any]]: ...
    async def get_prefix(self, prefix: str) -> Dict[str, Dict[str, Any]]: ...
    def watch(self, prefix: str) -> "Watch": ...
    async def create_lease(self, ttl: float) -> Lease: ...
    async def revoke_lease(self, lease: Lease) -> None: ...
    async def close(self) -> None: ...


class Watch:
    """Async iterator of WatchEvents for a key prefix.

    Yields a synthetic PUT for every pre-existing key first (snapshot), then
    live events. Close with ``aclose`` or ``async with``.
    """

    def __init__(self, prefix: str, snapshot: List[WatchEvent], queue: "asyncio.Queue[WatchEvent]", on_close=None) -> None:
        self.prefix = prefix
        self._snapshot = list(snapshot)
        self._queue = queue
        self._closed = False
        self._on_close = on_close

    def __aiter__(self) -> "Watch":
        return self

    async def __anext__(self) -> WatchEvent:
        if self._snapshot:
            return self._snapshot.pop(0)
        if self._closed:
            raise StopAsyncIteration
        event = await self._queue.get()
        if event is _WATCH_CLOSED:
            self._closed = True
            raise StopAsyncIteration
        return event

    def drain_snapshot(self) -> List[WatchEvent]:
        """Synchronously take the initial snapshot (pre-existing keys); the
        iterator then yields only live events. Lets callers apply the snapshot
        inline without racing the watch task."""
        snapshot = self._snapshot
        self._snapshot = []
        return snapshot

    async def aclose(self) -> None:
        if not self._closed:
            self._closed = True
            if self._on_close is not None:
                self._on_close(self)

    async def __aenter__(self) -> "Watch":
        return self

    async def __aexit__(self, *exc: Any) -> None:
        await self.aclose()


_WATCH_CLOSED: WatchEvent = WatchEvent(EventKind.DELETE, "\x00closed\x00")


class MemoryDiscovery:
    """Process-local discovery bus.

    Multiple DistributedRuntimes in one process share state when constructed
    with the same ``bus`` name — this is how accelerator-free integration
    tests emulate a cluster (ref: SharedMockRegistry, discovery/mock.rs).
    """

    _buses: Dict[str, "MemoryDiscovery"] = {}

    def __init__(self) -> None:
        self._data: Dict[str, Dict[str, Any]] = {}
        self._lease_keys: Dict[str, List[str]] = {}
        self._watchers: List[Tuple[str, asyncio.Queue, asyncio.AbstractEventLoop]] = []

    @classmethod
    def shared(cls, bus: str = "default") -> "MemoryDiscovery":
        if bus not in cls._buses:
            cls._buses[bus] = cls()
        return cls._buses[bus]

    @classmethod
    def reset(cls, bus: Optional[str] = None) -> None:
        if bus is None:
            cls._buses.clear()
        else:
            cls._buses.pop(bus, None)

    def _notify(self, event: WatchEvent) -> None:
        for prefix, queue, loop in list(self._watchers):
            if event.key.startswith(prefix):
                try:
                    loop.call_soon_threadsafe(queue.put_nowait, event)
                except RuntimeError:
                    # Watcher's loop is gone (test teardown) — drop it.
                    self._watchers = [w for w in self._watchers if w[1] is not queue]

    async def put(self, key: str, value: Dict[str, Any], lease: Optional[Lease] = None) -> None:
        self._data[key] = dict(value)
        if lease is not None:
            self._lease_keys.setdefault(lease.id, []).append(key)
        self._notify(WatchEvent(EventKind.PUT, key, dict(value)))

    async def delete(self, key: str) -> None:
        if key in self._data:
            del self._data[key]
            self._notify(WatchEvent(EventKind.DELETE, key))

    async def get(self, key: str) -> Optional[Dict[str, Any]]:
        value = self._data.get(key)
        return dict(value) if value is not None else None

    async def get_prefix(self, prefix: str) -> Dict[str, Dict[str, Any]]:
        return {k: dict(v) for k, v in self._data.items() if k.startswith(prefix)}

    def watch(self, prefix: str) -> Watch:
        queue: asyncio.Queue = asyncio.Queue()
        loop = asyncio.get_running_loop()
        entry = (prefix, queue, loop)
        self._watchers.append(entry)
        snapshot = [
            WatchEvent(EventKind.PUT, k, dict(v))
            for k, v in sorted(self._data.items())
            if k.startswith(prefix)
        ]

        def _close(w: Watch) -> None:
            self._watchers = [e for e in self._watchers if e[1] is not queue]
            try:
                loop.call_soon_threadsafe(queue.put_nowait, _WATCH_CLOSED)
            except RuntimeError:
                pass

        return Watch(prefix, snapshot, queue, on_close=_close)

    async def create_lease(self, ttl: float) -> Lease:
        return Lease(id=uuid.uuid4().hex, ttl=ttl)

    async def revoke_lease(self, lease: Lease) -> None:
        for key in self._lease_keys.pop(lease.id, []):
            await self.delete(key)

    async def close(self) -> None:
        pass


def instance_key(namespace: str, component: str, endpoint: str, instance_id: int) -> str:
    return f"instances/{namespace}/{component}/{endpoint}/{instance_id:016x}"


def instance_prefix(namespace: str, component: Optional[str] = None, endpoint: Optional[str] = None) -> str:
    parts = ["instances", namespace]
    if component is not None:
        parts.append(component)
        if endpoint is not None:
            parts.append(endpoint)
    return "/".join(parts) + "/"


def model_key(namespace: str, model_slug: str, instance_id: int) -> str:
    return f"models/{namespace}/{model_slug}/{instance_id:016x}"


MODELS_PREFIX = "models/"
