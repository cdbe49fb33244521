"""Namespaces, components, endpoints, instances, and clients — the port's
copy of dynamo_tpu/runtime/component.py.

Reference parity: lib/runtime/src/component.rs (Namespace, Component,
Endpoint, Instance/TransportType) and the PushRouter
(pipeline/network/egress/push_router.rs — RoundRobin/Random/Direct/KV).

Naming: ``{namespace}/{component}/{endpoint}`` addresses a logical service;
N live *instances* (workers) back it. Serving an endpoint registers an
instance in the discovery plane under a lease; clients watch the prefix and
route per-request among live instances. ``set_kv_picker`` is the seam the
KV router fills (ROADMAP A4c-2).
"""

from __future__ import annotations

import asyncio
import logging
import random
import weakref
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, AsyncIterator, Dict, List, Optional, TYPE_CHECKING

from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.discovery import (
    EventKind,
    instance_key,
    instance_prefix,
)
from dynamo_tpu_torch.runtime.engine import AsyncEngine, as_engine
from dynamo_tpu_torch.runtime.tasks import reap_task

if TYPE_CHECKING:
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class Instance:
    """A live worker behind an endpoint (ref: component.rs:70)."""

    namespace: str
    component: str
    endpoint: str
    instance_id: int
    transport: Dict[str, Any]  # {"kind": "local"|"tcp", ...address info}
    metadata: Dict[str, Any] = field(default_factory=dict, hash=False)

    @property
    def key(self) -> str:
        return instance_key(self.namespace, self.component, self.endpoint, self.instance_id)

    @property
    def endpoint_path(self) -> str:
        return f"{self.namespace}/{self.component}/{self.endpoint}"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "namespace": self.namespace,
            "component": self.component,
            "endpoint": self.endpoint,
            "instance_id": self.instance_id,
            "transport": self.transport,
            "metadata": self.metadata,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Instance":
        return cls(
            namespace=d["namespace"],
            component=d["component"],
            endpoint=d["endpoint"],
            instance_id=int(d["instance_id"]),
            transport=dict(d.get("transport", {})),
            metadata=dict(d.get("metadata", {})),
        )


class RouterMode(str, Enum):
    ROUND_ROBIN = "round_robin"
    RANDOM = "random"
    DIRECT = "direct"
    KV = "kv"


class Namespace:
    def __init__(self, runtime: "DistributedRuntime", name: str) -> None:
        self._runtime = runtime
        self.name = name

    def component(self, name: str) -> "Component":
        return Component(self._runtime, self.name, name)

    @property
    def runtime(self) -> "DistributedRuntime":
        return self._runtime


class Component:
    def __init__(self, runtime: "DistributedRuntime", namespace: str, name: str) -> None:
        self._runtime = runtime
        self.namespace = namespace
        self.name = name

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self._runtime, self.namespace, self.name, name)

    @property
    def path(self) -> str:
        return f"{self.namespace}/{self.name}"


class Endpoint:
    def __init__(
        self, runtime: "DistributedRuntime", namespace: str, component: str, name: str
    ) -> None:
        self._runtime = runtime
        self.namespace = namespace
        self.component = component
        self.name = name

    @property
    def path(self) -> str:
        return f"{self.namespace}/{self.component}/{self.name}"

    async def serve_endpoint(
        self,
        handler: Any,
        *,
        instance_id: Optional[int] = None,
        metadata: Optional[Dict[str, Any]] = None,
    ) -> "ServedEndpoint":
        """Expose ``handler`` (an AsyncEngine or async generator function) as a
        live instance of this endpoint (ref: _core.pyi:153 serve_endpoint)."""
        engine = as_engine(handler)
        return await self._runtime._serve(self, engine, instance_id=instance_id, metadata=metadata or {})

    async def client(self, router_mode: RouterMode = RouterMode.ROUND_ROBIN) -> "Client":
        client = Client(self._runtime, self, router_mode)
        await client.start()
        return client


@dataclass
class ServedEndpoint:
    instance: Instance
    _runtime: "DistributedRuntime"
    _engine: AsyncEngine

    async def shutdown(self, grace_period: float = 30.0) -> None:
        await self._runtime._unserve(self, grace_period=grace_period)


class Client:
    """Routes requests to live instances of an endpoint.

    Reference parity: PushRouter (push_router.rs:41) + the client-side
    instance map fed by discovery watch (distributed.rs:394). KV-mode routing
    delegates instance selection to an injected picker (router layer).
    """

    def __init__(
        self,
        runtime: "DistributedRuntime",
        endpoint: Endpoint,
        router_mode: RouterMode = RouterMode.ROUND_ROBIN,
    ) -> None:
        self._runtime = runtime
        self._endpoint = endpoint
        self.router_mode = router_mode
        self._instances: Dict[int, Instance] = {}
        self._rr_index = 0
        self._watch = None
        self._watch_task: Optional[asyncio.Task] = None
        self._instances_nonempty = asyncio.Event()
        self._kv_picker = None  # async (request, instances) -> instance_id
        self._on_stream_done = None  # (instance_id, request) -> None
        self._instance_filter = None  # (instance_id) -> bool (health gating)
        # Crash plane (runtime/liveness.py): per-instance abort handles for
        # in-flight streams. Opt-in via enable_stream_aborts() — the
        # abortable iteration races each item against the abort future,
        # which costs one extra task per item; sessions without liveness
        # wiring keep the plain fast path.
        self._abortable = False
        self._abort_futures: Dict[int, set] = {}
        # Liveness-evicted instances, kept for revive_instance: a frozen
        # worker that rejoins under the SAME incarnation never re-PUTs
        # its key, so the watch alone cannot restore its capacity.
        self._evicted: Dict[int, Instance] = {}
        # The instances whose stream failed a request, by the request's
        # Context: its re-dispatch (Migration's) prefers the others. A
        # divergence from JAX's Client, whose re-dispatch goes back to a
        # killed worker until liveness evicts it.
        self._failed_for: "weakref.WeakKeyDictionary[Context, set]" = (
            weakref.WeakKeyDictionary()
        )

    @property
    def endpoint_path(self) -> str:
        return self._endpoint.path

    @property
    def instance_ids(self) -> List[int]:
        return sorted(self._instances)

    def set_kv_picker(self, picker) -> None:
        import inspect

        self._kv_picker = picker
        # A context-aware picker ((request, instances, context)) gets the
        # request Context so its selection span joins the request's trace;
        # 2-arg pickers keep working.
        try:
            params = inspect.signature(picker).parameters
            self._picker_takes_context = (
                "context" in params
                or any(
                    p.kind == inspect.Parameter.VAR_KEYWORD
                    for p in params.values()
                )
            )
        except (TypeError, ValueError):
            self._picker_takes_context = False

    def set_instance_filter(self, predicate) -> None:
        """``predicate(instance_id) -> bool``; False excludes the instance
        from routing (ref: worker_monitor.rs eviction of unhealthy workers).
        Direct routing (explicit instance_id) bypasses the filter."""
        self._instance_filter = predicate

    def set_stream_done_callback(self, callback) -> None:
        """``callback(instance_id, request)`` fires when a routed stream ends
        (normally or not) — lets a KV router release its in-flight load
        prediction (ref: kv_router sequence.rs free on completion)."""
        self._on_stream_done = callback

    # -- crash plane --------------------------------------------------------

    def enable_stream_aborts(self) -> None:
        """Arm per-stream abort handles (liveness wiring calls this once)."""
        self._abortable = True

    def abort_instance(self, instance_id: int, exc: BaseException) -> int:
        """Fail every in-flight stream routed to ``instance_id`` with
        ``exc`` RIGHT NOW — the liveness tracker's dead-worker hook. The
        typed exception (WorkerLostError) surfaces through the stream and
        the migration ladder re-dispatches immediately instead of the
        stream hanging until a TCP timeout. Returns streams aborted."""
        aborted = 0
        for fut in list(self._abort_futures.get(instance_id, ())):
            if not fut.done():
                fut.set_exception(exc)
                aborted += 1
        return aborted

    def evict_instance(self, instance_id: int) -> bool:
        """Drop a dead instance from routing immediately, ahead of its
        discovery lease expiring. The instance is stashed: a RESTARTED
        worker re-PUTs its key and the watch re-adds it with fresh
        transport, but a worker that merely froze past the budget (GC
        pause, short partition) resumes under the SAME incarnation with
        no new PUT — revive_instance is the only road back for it."""
        inst = self._instances.pop(instance_id, None)
        if inst is not None:
            self._evicted[instance_id] = inst
        if not self._instances:
            self._instances_nonempty.clear()
        return inst is not None

    def revive_instance(self, instance_id: int) -> bool:
        """Re-admit a liveness-evicted instance on rejoin. Same-incarnation
        rejoins (the process survived; its transport is unchanged) get
        their capacity back here; for a restarted worker the watch PUT
        overwrites this entry with the fresh transport anyway — at worst
        the stale address serves one connection error into migration."""
        inst = self._evicted.pop(instance_id, None)
        if inst is None or instance_id in self._instances:
            return False
        self._instances[instance_id] = inst
        self._instances_nonempty.set()
        return True

    async def start(self) -> None:
        prefix = instance_prefix(
            self._endpoint.namespace, self._endpoint.component, self._endpoint.name
        )
        watch = self._runtime.discovery.watch(prefix)
        self._watch = watch

        def _apply(event) -> None:
            if event.kind == EventKind.PUT and event.value is not None:
                inst = Instance.from_dict(event.value)
                self._instances[inst.instance_id] = inst
                # Authoritative re-registration supersedes any stash.
                self._evicted.pop(inst.instance_id, None)
                self._instances_nonempty.set()
            elif event.kind == EventKind.DELETE:
                iid = _instance_id_from_key(event.key)
                if iid is not None:
                    self._instances.pop(iid, None)
                    self._evicted.pop(iid, None)
                if not self._instances:
                    self._instances_nonempty.clear()

        # Apply the snapshot inline so the first request can route immediately.
        for event in watch.drain_snapshot():
            _apply(event)

        async def _run() -> None:
            async for event in watch:
                _apply(event)

        self._watch_task = asyncio.get_running_loop().create_task(
            _run(), name=f"client-watch:{self.endpoint_path}"
        )

    async def wait_for_instances(self, timeout: float = 10.0) -> List[int]:
        await asyncio.wait_for(self._instances_nonempty.wait(), timeout=timeout)
        return self.instance_ids

    async def close(self) -> None:
        if self._watch is not None:
            await self._watch.aclose()
            self._watch = None
        if self._watch_task is not None:
            self._watch_task.cancel()
            await reap_task(self._watch_task, "endpoint watch", logger)
            self._watch_task = None

    # -- routing ----------------------------------------------------------

    async def _pick(
        self,
        request: Any,
        instance_id: Optional[int],
        context: Optional[Context] = None,
    ) -> Instance:
        if not self._instances:
            raise NoInstancesError(self.endpoint_path)
        if instance_id is not None:
            inst = self._instances.get(instance_id)
            if inst is None:
                raise NoInstancesError(
                    f"{self.endpoint_path} instance {instance_id:#x} not found"
                )
            return inst
        eligible = self._instances
        if self._instance_filter is not None:
            eligible = {
                iid: inst
                for iid, inst in self._instances.items()
                if self._instance_filter(iid)
            }
            if not eligible:
                raise NoInstancesError(
                    f"{self.endpoint_path}: all instances excluded (unhealthy)"
                )
        failed = self._failed_for.get(context) if context is not None else None
        if failed:
            others = {iid: inst for iid, inst in eligible.items() if iid not in failed}
            if others:
                eligible = others
        ids = sorted(eligible)
        if self.router_mode == RouterMode.RANDOM:
            return eligible[random.choice(ids)]
        if self.router_mode == RouterMode.KV and self._kv_picker is not None:
            if getattr(self, "_picker_takes_context", False):
                chosen = await self._kv_picker(
                    request, dict(eligible), context=context
                )
            else:
                chosen = await self._kv_picker(request, dict(eligible))
            if chosen is not None and chosen in eligible:
                return eligible[chosen]
        # Round-robin default (also KV fallback when picker abstains).
        self._rr_index = (self._rr_index + 1) % len(ids)
        return eligible[ids[self._rr_index]]

    def generate(
        self,
        request: Any,
        context: Optional[Context] = None,
        *,
        instance_id: Optional[int] = None,
    ) -> AsyncIterator[Any]:
        ctx = context or Context()
        return self._generate(request, ctx, instance_id)

    async def _generate(
        self, request: Any, context: Context, instance_id: Optional[int]
    ) -> AsyncIterator[Any]:
        instance = None
        try:
            instance = await self._pick(request, instance_id, context)
            remote = self._runtime.request_plane_client(instance)
            if self._abortable:
                async for item in self._abortable_iter(
                    remote, request, context, instance.instance_id
                ):
                    yield item
            else:
                async for item in remote.generate(request, context):
                    yield item
        except Exception:
            if instance is not None:
                self._failed_for.setdefault(context, set()).add(instance.instance_id)
            raise
        finally:
            # Fires even when _pick itself fails after the KV picker charged
            # the scheduler (the instance may have raced away) — otherwise
            # the router's in-flight accounting leaks.
            if self._on_stream_done is not None:
                try:
                    self._on_stream_done(
                        instance.instance_id if instance is not None else None,
                        request,
                    )
                except Exception:
                    logger.exception("stream-done callback failed")

    async def _abortable_iter(
        self, remote: AsyncEngine, request: Any, context: Context, iid: int
    ) -> AsyncIterator[Any]:
        """Iterate a remote stream racing every item against this
        instance's abort handle: when liveness declares the worker dead,
        ``abort_instance`` fails the handle and the stream raises the
        typed error immediately — it never waits out a kernel timeout on
        a socket whose peer no longer exists."""
        agen = remote.generate(request, context).__aiter__()
        abort: asyncio.Future = asyncio.get_running_loop().create_future()
        self._abort_futures.setdefault(iid, set()).add(abort)
        nxt: Optional[asyncio.Task] = None
        try:
            while True:
                nxt = asyncio.ensure_future(agen.__anext__())
                await asyncio.wait(
                    {nxt, abort}, return_when=asyncio.FIRST_COMPLETED
                )
                if abort.done() and not nxt.done():
                    nxt.cancel()
                    await reap_task(nxt, "aborted stream item", logger)
                    try:  # reap the dead worker's generator state
                        await asyncio.wait_for(agen.aclose(), timeout=1.0)
                    except Exception:
                        logger.debug("abort-path stream close failed",
                                     exc_info=True)
                    abort.result()  # raises the typed abort exception
                try:
                    item = nxt.result()
                except StopAsyncIteration:
                    return
                nxt = None
                yield item
        finally:
            if nxt is not None and not nxt.done():
                nxt.cancel()
                await reap_task(nxt, "stream item task", logger)
            handles = self._abort_futures.get(iid)
            if handles is not None:
                handles.discard(abort)
                if not handles:
                    self._abort_futures.pop(iid, None)
            if abort.done():
                abort.exception()  # mark retrieved (late abort after end)
            else:
                abort.cancel()

    def direct(self, request: Any, instance_id: int, context: Optional[Context] = None):
        """Route to a specific instance (RouterMode::Direct)."""
        return self.generate(request, context, instance_id=instance_id)


class NoInstancesError(RuntimeError):
    """No live instances for an endpoint (ref: 'no responders' NATS error —
    the trigger for migration, migration.rs:24)."""


def _instance_id_from_key(key: str) -> Optional[int]:
    try:
        return int(key.rsplit("/", 1)[1], 16)
    except (IndexError, ValueError):
        return None
