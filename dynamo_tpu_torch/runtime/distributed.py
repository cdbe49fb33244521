"""DistributedRuntime: the root handle tying planes together — the port's
copy of dynamo_tpu/runtime/distributed.py.

Reference parity: lib/runtime/src/distributed.rs (DistributedRuntime,
process-local test mode, RequestPlaneMode). A runtime owns:

  - the **discovery plane** (instance/model registration + watch, leases),
  - the **request plane** (request/response streaming to instances),
  - the **event plane** (pub/sub for KV events and load metrics),
  - the set of locally served endpoints and their in-flight task trackers.

Modes:
  - ``DistributedRuntime.process_local(bus=...)`` — everything in-memory; N
    runtimes in one process sharing a bus emulate a cluster.
  - ``DistributedRuntime.detached()`` — single process, no sharing.
  - ``DistributedRuntime.from_settings()`` — the DYN_TPU_* knobs pick
    discovery (memory | file | discd), the request plane (tcp | local) and
    the event plane (memory | zmq, the ZMTP wire without pyzmq).

Unlike the JAX package, ``from_settings`` raises for a plane name it does
not know (JAX falls back to the process-local plane) and for
``DYN_TPU_REQUEST_PLANE=http``: the HTTP request plane is not ported yet
(ROADMAP A4c-H). A fallback would hide a misconfigured cluster.
"""

from __future__ import annotations

import asyncio
import logging
import random
from typing import Any, Dict, Optional

from dynamo_tpu_torch.runtime.component import (
    Endpoint,
    Instance,
    Namespace,
    ServedEndpoint,
)
from dynamo_tpu_torch.runtime import fault_names
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.discovery import DiscoveryBackend, Lease, MemoryDiscovery
from dynamo_tpu_torch.runtime.faults import fault_point
from dynamo_tpu_torch.runtime.engine import AsyncEngine
from dynamo_tpu_torch.runtime.events import EventPlane, MemoryEventPlane
from dynamo_tpu_torch.runtime.tasks import TaskTracker

from dynamo_tpu_torch import config

logger = logging.getLogger(__name__)

_HTTP_PLANE_MISSING = (
    "the HTTP request plane (runtime/network/http_plane.py) is not ported "
    "yet (ROADMAP A4c-H); use DYN_TPU_REQUEST_PLANE=tcp"
)


class LocalRequestPlane:
    """In-process request plane: client calls the engine directly.

    Shared per-bus so multiple runtimes in one process reach each other's
    engines (the process-local analogue of the TCP request plane)."""

    _buses: Dict[str, Dict[str, AsyncEngine]] = {}

    def __init__(self, bus: str = "default") -> None:
        self.bus = bus
        self._engines = self._buses.setdefault(bus, {})

    @classmethod
    def reset(cls, bus: Optional[str] = None) -> None:
        if bus is None:
            cls._buses.clear()
        else:
            cls._buses.pop(bus, None)

    async def serve(self, instance: Instance, engine: AsyncEngine, tracker: TaskTracker) -> Dict[str, Any]:
        self._engines[instance.key] = _TrackedEngine(engine, tracker)
        return {"kind": "local", "bus": self.bus, "key": instance.key}

    async def unserve(self, instance: Instance) -> None:
        self._engines.pop(instance.key, None)

    def client_for(self, instance: Instance) -> AsyncEngine:
        engines = self._buses.get(instance.transport.get("bus", self.bus), {})
        engine = engines.get(instance.transport.get("key", instance.key))
        if engine is None:
            from dynamo_tpu_torch.runtime.component import NoInstancesError

            raise NoInstancesError(f"local engine gone: {instance.key}")
        return engine

    async def close(self) -> None:
        pass


class _TrackedEngine:
    """Wraps a served engine so in-flight streams register with the tracker
    (draining support) and refuse new work once draining."""

    def __init__(self, engine: AsyncEngine, tracker: TaskTracker) -> None:
        self._engine = engine
        self._tracker = tracker

    async def generate(self, request: Any, context: Context):
        if self._tracker.draining:
            from dynamo_tpu_torch.runtime.component import NoInstancesError

            raise NoInstancesError("endpoint draining")
        with self._tracker.guard():
            async for item in self._engine.generate(request, context):
                yield item


class DistributedRuntime:
    def __init__(
        self,
        *,
        discovery: Optional[DiscoveryBackend] = None,
        request_plane: Optional[Any] = None,
        event_plane: Optional[EventPlane] = None,
        bus: str = "default",
    ) -> None:
        self.bus = bus
        self.discovery: DiscoveryBackend = discovery or MemoryDiscovery.shared(bus)
        self.request_plane = request_plane or LocalRequestPlane(bus)
        self.event_plane: EventPlane = event_plane or MemoryEventPlane.shared(bus)
        self.tracker = TaskTracker("runtime")
        self._served: Dict[str, ServedEndpoint] = {}
        self._serve_trackers: Dict[str, TaskTracker] = {}
        # Every doc put under the serving lease, kept for re-registration:
        # after a control-plane outage long enough to expire the lease,
        # the keep-alive loop re-puts these under a fresh lease so the
        # worker rejoins discovery without a process restart.
        self._leased_docs: Dict[str, Dict[str, Any]] = {}
        self._lease: Optional[Lease] = None
        self._shutdown = asyncio.Event()
        self._extra_planes: list = []
        self._owns_bus = False

    # -- constructors ------------------------------------------------------

    @classmethod
    def process_local(cls, bus: str = "default") -> "DistributedRuntime":
        return cls(bus=bus)

    @classmethod
    def detached(cls) -> "DistributedRuntime":
        bus = f"detached-{random.getrandbits(32):08x}"
        runtime = cls(
            discovery=MemoryDiscovery(),
            request_plane=LocalRequestPlane(bus),
            event_plane=MemoryEventPlane(),
            bus=bus,
        )
        runtime._owns_bus = True
        return runtime

    @classmethod
    def from_settings(cls) -> "DistributedRuntime":
        """Cross-process runtime wired from the DYN_TPU_* env registry
        (ref: distributed.rs:536 from_settings; environment_names.rs)."""
        discovery_kind = config.DISCOVERY.get()
        if discovery_kind == "file":
            from dynamo_tpu_torch.runtime.discovery.file import FileDiscovery

            discovery = FileDiscovery(config.DISCOVERY_ADDR.get())
        elif discovery_kind == "discd":
            from dynamo_tpu_torch.runtime.discovery.discd import DiscdDiscovery

            discovery = DiscdDiscovery(config.DISCOVERY_ADDR.get())
        elif discovery_kind == "memory":
            discovery = MemoryDiscovery.shared("default")
        else:
            raise ValueError(
                f"{config.DISCOVERY.name}={discovery_kind!r}: not one of "
                "memory|file|discd"
            )

        plane_kind = config.REQUEST_PLANE.get()
        if plane_kind == "tcp":
            from dynamo_tpu_torch.runtime.network.tcp import TcpRequestPlane

            request_plane = TcpRequestPlane(host=config.TCP_HOST.get())
        elif plane_kind == "http":
            raise NotImplementedError(_HTTP_PLANE_MISSING)
        elif plane_kind == "local":
            request_plane = LocalRequestPlane("default")
        else:
            raise ValueError(
                f"{config.REQUEST_PLANE.name}={plane_kind!r}: not one of "
                "tcp|http|local"
            )

        event_kind = config.EVENT_PLANE.get()
        if event_kind == "zmq":
            from dynamo_tpu_torch.runtime.events.zmq_plane import ZmqEventPlane

            event_plane = ZmqEventPlane(config.EVENT_PLANE_ADDR.get())
        elif event_kind == "memory":
            event_plane = MemoryEventPlane.shared("default")
        else:
            raise ValueError(
                f"{config.EVENT_PLANE.name}={event_kind!r}: not one of "
                "memory|zmq"
            )
        return cls(
            discovery=discovery, request_plane=request_plane, event_plane=event_plane
        )

    # -- naming ------------------------------------------------------------

    def namespace(self, name: str) -> Namespace:
        return Namespace(self, name)

    # -- serving -----------------------------------------------------------

    async def _lease_for_serving(self) -> Lease:
        if self._lease is None:
            self._lease = await self.discovery.create_lease(config.LEASE_TTL.get())
            keep_alive = getattr(self.discovery, "keep_alive", None)
            if keep_alive is not None:
                self.tracker.spawn(
                    self._keep_alive_loop(keep_alive), name="lease-keepalive", critical=True
                )
        return self._lease

    async def _keep_alive_loop(self, keep_alive) -> None:
        assert self._lease is not None
        import time as _time

        from dynamo_tpu_torch.runtime.tasks import Backoff

        interval = max(0.5, self._lease.ttl / 3.0)
        # Failure retries use jittered exponential backoff (capped above
        # the renewal cadence): a control-plane blip disconnects EVERY
        # worker's keep-alive at once, and fixed-interval retries would
        # reconnect as a synchronized herd.
        backoff = Backoff(base_s=interval / 2, cap_s=4 * interval)
        down_since: Optional[float] = None
        while not self._shutdown.is_set():
            delay = interval if down_since is None else backoff.next_delay()
            try:
                # Waiting on the shutdown event (not a bare sleep) lets
                # shutdown() proceed immediately instead of stalling a tick.
                await asyncio.wait_for(self._shutdown.wait(), timeout=delay)
                return
            except asyncio.TimeoutError:
                pass
            try:
                # Chaos seam: a failed renewal is absorbed by the TTL
                # budget (interval = ttl/3, so two consecutive misses
                # still beat expiry); sustained failure expires the lease
                # and watchers observe the instance Delete.
                fault_point(fault_names.DISCOVERY_LEASE_RENEW)
                await keep_alive(self._lease)
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                now = _time.monotonic()
                if down_since is None:
                    down_since = now
                if now - down_since >= self._lease.ttl:
                    # The lease has (almost certainly) expired mid-outage:
                    # watchers saw our keys DELETE, and renewing a dead
                    # lease can never succeed again. Re-establish — fresh
                    # lease, every leased doc re-put — so the worker
                    # rejoins discovery the moment the plane recovers.
                    try:
                        await self._reregister()
                    except asyncio.CancelledError:
                        raise
                    except Exception as rexc:
                        logger.warning(
                            "discovery re-register failed (still down): %r",
                            rexc,
                        )
                        continue
                    down_since = None
                    backoff.reset()
                else:
                    logger.warning("lease keep-alive failed: %r", exc)
                continue
            if down_since is not None:
                down_since = None
                backoff.reset()

    async def _reregister(self) -> None:
        """Fresh lease + re-put of every lease-attached doc (endpoint
        instances and model cards) after an outage expired the old one."""
        lease = await self.discovery.create_lease(config.LEASE_TTL.get())
        self._lease = lease
        for key, doc in self._leased_docs.items():
            await self.discovery.put(key, doc, lease=lease)
        logger.warning(
            "re-registered %d discovery docs under fresh lease %s after "
            "control-plane outage", len(self._leased_docs), lease.id,
        )

    async def put_leased(self, key: str, doc: Dict[str, Any]) -> None:
        """Put a discovery doc under the serving lease AND remember it, so
        the keep-alive loop can re-register it after a control-plane
        outage expires the lease (endpoint instances, model cards)."""
        lease = await self._lease_for_serving()
        self._leased_docs[key] = doc
        await self.discovery.put(key, doc, lease=lease)

    def forget_leased(self, key: str) -> None:
        self._leased_docs.pop(key, None)

    async def _serve(
        self,
        endpoint: Endpoint,
        engine: AsyncEngine,
        *,
        instance_id: Optional[int],
        metadata: Dict[str, Any],
    ) -> ServedEndpoint:
        iid = instance_id if instance_id is not None else random.getrandbits(63)
        instance = Instance(
            namespace=endpoint.namespace,
            component=endpoint.component,
            endpoint=endpoint.name,
            instance_id=iid,
            transport={},
            metadata=metadata,
        )
        tracker = TaskTracker(f"endpoint:{endpoint.path}:{iid:x}")
        transport = await self.request_plane.serve(instance, engine, tracker)
        instance = Instance(
            namespace=instance.namespace,
            component=instance.component,
            endpoint=instance.endpoint,
            instance_id=iid,
            transport=transport,
            metadata=metadata,
        )
        await self.put_leased(instance.key, instance.to_dict())
        served = ServedEndpoint(instance=instance, _runtime=self, _engine=engine)
        self._served[instance.key] = served
        self._serve_trackers[instance.key] = tracker
        logger.info("serving %s as instance %x", endpoint.path, iid)
        return served

    async def _unserve(self, served: ServedEndpoint, grace_period: float = 30.0) -> None:
        key = served.instance.key
        self.forget_leased(key)
        # De-register first so routers stop picking us, then drain. A dead
        # discovery plane must not abort the shutdown: the lease expiry (or
        # a discd snapshot-restore sweep) will retire the key for us.
        try:
            await self.discovery.delete(key)
        except Exception as exc:
            logger.warning(
                "deregister of %s failed (discovery down?): %r", key, exc
            )
        tracker = self._serve_trackers.pop(key, None)
        if tracker is not None:
            await tracker.drain(grace_period)
        await self.request_plane.unserve(served.instance)
        self._served.pop(key, None)

    def request_plane_client(self, instance: Instance) -> AsyncEngine:
        kind = instance.transport.get("kind", "local")
        # The runtime's own plane serves matching transports (a from_settings
        # TCP runtime reuses its plane's connection pool for egress too).
        if getattr(self.request_plane, "kind", "local") == kind:
            return self.request_plane.client_for(instance)
        if kind == "local":
            return self.request_plane.client_for(instance)
        for plane in self._extra_planes:
            if plane.kind == kind:
                return plane.client_for(instance)
        if kind == "tcp":
            from dynamo_tpu_torch.runtime.network.tcp import TcpRequestPlane

            plane = TcpRequestPlane()
            self._extra_planes.append(plane)
            return plane.client_for(instance)
        if kind == "http":
            raise NotImplementedError(_HTTP_PLANE_MISSING)
        raise ValueError(f"unknown transport kind {kind!r} for {instance.key}")

    # -- lifecycle ---------------------------------------------------------

    async def shutdown(self, grace_period: float = 30.0) -> None:
        """Graceful shutdown: de-register, drain in-flight, release leases
        (ref: GracefulShutdownTracker lib.rs:58, docs/fault_tolerance/graceful_shutdown.md)."""
        self._shutdown.set()
        for served in list(self._served.values()):
            await self._unserve(served, grace_period=grace_period)
        if self._lease is not None:
            try:
                await self.discovery.revoke_lease(self._lease)
            except Exception as exc:
                logger.warning(
                    "lease revoke failed (discovery down?): %r — the TTL "
                    "sweep will expire it", exc
                )
            self._lease = None
        await self.tracker.drain(grace_period)
        for plane in self._extra_planes:
            await plane.close()
        await self.request_plane.close()
        await self.discovery.close()
        if self._owns_bus:
            LocalRequestPlane.reset(self.bus)
