"""discd: a self-hosted discovery KV service + client (the etcd of this
framework) — the port's copy of dynamo_tpu/runtime/discovery/discd.py, on
the port's two-part codec (network/codec.py over msgpack_lite), so the
port's client talks to a JAX server and the reverse. The snapshot file is
the same JSON document.

Reference parity: the reference's default non-k8s discovery plane is etcd
with leases and watches (lib/runtime/src/transports/etcd.rs,
storage/kv/etcd.rs). discd is a minimal TCP service speaking the two-part
msgpack codec with the same semantics the runtime needs:
put/delete/get/prefix scan, prefix watch with snapshot, and TTL leases whose
expiry deletes owned keys — watchers observe DELETE events, which is the
cluster's worker-death signal.

Run the server:  python -m dynamo_tpu_torch.discd --port 2379
Client:          DiscdDiscovery("host:2379")
"""

from __future__ import annotations

import asyncio
import itertools
import time
import uuid
from typing import Any, Dict, List, Optional, Set, Tuple

from dynamo_tpu_torch.runtime.discovery import (
    EventKind,
    Lease,
    Watch,
    WatchEvent,
    _WATCH_CLOSED,
)
from dynamo_tpu_torch.runtime.network.codec import FrameReader, FrameWriter
from dynamo_tpu_torch.runtime.tasks import reap_task
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


class DiscdServer:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        snapshot_path: Optional[str] = None,
        snapshot_interval_s: float = 2.0,
    ) -> None:
        self.host = host
        self.port = port
        self._data: Dict[str, Tuple[Dict[str, Any], Optional[str]]] = {}
        self._leases: Dict[str, Tuple[float, float]] = {}  # id → (ttl, last beat)
        self._watchers: Dict[int, Tuple[str, FrameWriter]] = {}
        self._watch_ids = itertools.count(1)
        self._server: Optional[asyncio.base_events.Server] = None
        self._sweeper: Optional[asyncio.Task] = None
        self.bound_port: Optional[int] = None
        self._conn_writers: set = set()
        # -- HA minimum (the raft-replicated-etcd role, single-node form):
        # keyspace + lease snapshots so a crashed/restarted discd comes back
        # with the SAME keys and lease ids. Restored leases restart their
        # TTL clock from boot, so live owners (whose keepalive loops retry
        # through the outage — runtime/distributed._keep_alive_loop) re-beat
        # within one interval and never lose registration; truly dead
        # owners still expire one TTL after the restart.
        # Ref: the reference's etcd lease/keyspace durability
        # (lib/runtime/src/transports/etcd.rs).
        self.snapshot_path = snapshot_path
        self.snapshot_interval_s = snapshot_interval_s
        self._dirty = False
        self.restored_keys = 0

    async def start(self) -> int:
        if self.snapshot_path:
            self._load_snapshot()
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.bound_port = self._server.sockets[0].getsockname()[1]
        self._sweeper = asyncio.get_running_loop().create_task(
            self._sweep_loop(), name="discd-lease-sweeper"
        )
        logger.info("discd listening on %s:%s", self.host, self.bound_port)
        return self.bound_port

    async def stop(self) -> None:
        if self._sweeper is not None:
            self._sweeper.cancel()
            await reap_task(self._sweeper, "discd lease sweeper", logger)
        if self.snapshot_path and self._dirty:
            self._save_snapshot()
        if self._server is not None:
            self._server.close()
            # 3.12 wait_closed() waits for live connections too — close them.
            for writer in list(self._conn_writers):
                writer.close()
            await self._server.wait_closed()

    # -- snapshot persistence ----------------------------------------------

    def _save_snapshot(self) -> None:
        import json
        import os

        doc = {
            "data": {k: [v, lid] for k, (v, lid) in self._data.items()},
            "leases": {lid: ttl for lid, (ttl, _beat) in self._leases.items()},
        }
        tmp = self.snapshot_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, self.snapshot_path)  # atomic on POSIX
            self._dirty = False
        except OSError:
            logger.exception("discd snapshot write failed")

    def _load_snapshot(self) -> None:
        import json
        import os

        if not os.path.exists(self.snapshot_path):
            return
        try:
            with open(self.snapshot_path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            logger.exception("discd snapshot unreadable; starting empty")
            return
        now = time.monotonic()
        self._data = {
            k: (v, lid) for k, (v, lid) in (doc.get("data") or {}).items()
        }
        self._leases = {
            lid: (float(ttl), now) for lid, ttl in (doc.get("leases") or {}).items()
        }
        self.restored_keys = len(self._data)
        logger.info(
            "discd restored %d keys, %d leases from %s",
            len(self._data), len(self._leases), self.snapshot_path,
        )

    async def _sweep_loop(self) -> None:
        last_snap = time.monotonic()
        while True:
            await asyncio.sleep(0.5)
            now = time.monotonic()
            expired = [
                lid for lid, (ttl, beat) in self._leases.items() if now - beat > ttl
            ]
            for lid in expired:
                logger.info("discd lease %s expired", lid[:8])
                await self._drop_lease(lid)
            if (
                self.snapshot_path
                and self._dirty
                and now - last_snap >= self.snapshot_interval_s
            ):
                self._save_snapshot()
                last_snap = now

    async def _drop_lease(self, lease_id: str) -> None:
        if self._leases.pop(lease_id, None) is not None:
            self._dirty = True
        doomed = [k for k, (_, lid) in self._data.items() if lid == lease_id]
        for key in doomed:
            del self._data[key]
            self._dirty = True
            await self._notify(EventKind.DELETE, key, None)

    async def _notify(self, kind: EventKind, key: str, value: Optional[Dict[str, Any]]) -> None:
        dead: List[int] = []
        for wid, (prefix, fw) in list(self._watchers.items()):
            if not key.startswith(prefix):
                continue
            try:
                await fw.send(
                    {"watch": wid, "kind": kind.value, "key": key}, value
                )
            except (ConnectionError, RuntimeError):
                dead.append(wid)
        for wid in dead:
            self._watchers.pop(wid, None)

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        fr = FrameReader(reader)
        fw = FrameWriter(writer)
        self._conn_writers.add(writer)
        conn_watches: Set[int] = set()
        try:
            while True:
                frame = await fr.recv()
                if frame is None:
                    break
                header, payload = frame
                try:
                    await self._dispatch(header, payload, fw, conn_watches)
                except Exception as exc:
                    logger.exception("discd op failed")
                    with _quiet():
                        await fw.send(
                            {"reqid": header.get("reqid"), "error": repr(exc)}
                        )
        except (ConnectionResetError, asyncio.IncompleteReadError):
            pass
        finally:
            for wid in conn_watches:
                self._watchers.pop(wid, None)
            fw.close()
            self._conn_writers.discard(writer)

    async def _dispatch(
        self, header: Dict[str, Any], payload: Any, fw: FrameWriter, conn_watches: Set[int]
    ) -> None:
        op = header.get("op")
        reqid = header.get("reqid")
        if op == "put":
            key = header["key"]
            self._data[key] = (payload, header.get("lease"))
            self._dirty = True
            await fw.send({"reqid": reqid, "ok": True})
            await self._notify(EventKind.PUT, key, payload)
        elif op == "delete":
            key = header["key"]
            existed = self._data.pop(key, None) is not None
            self._dirty = self._dirty or existed
            await fw.send({"reqid": reqid, "ok": True})
            if existed:
                await self._notify(EventKind.DELETE, key, None)
        elif op == "get":
            entry = self._data.get(header["key"])
            await fw.send({"reqid": reqid, "ok": True, "found": entry is not None},
                          entry[0] if entry else None)
        elif op == "get_prefix":
            prefix = header["prefix"]
            out = {k: v for k, (v, _) in self._data.items() if k.startswith(prefix)}
            await fw.send({"reqid": reqid, "ok": True}, out)
        elif op == "watch":
            wid = next(self._watch_ids)
            prefix = header["prefix"]
            snapshot = {
                k: v for k, (v, _) in sorted(self._data.items()) if k.startswith(prefix)
            }
            await fw.send({"reqid": reqid, "ok": True, "watch_id": wid}, snapshot)
            self._watchers[wid] = (prefix, fw)
            conn_watches.add(wid)
        elif op == "unwatch":
            wid = header.get("watch_id")
            self._watchers.pop(wid, None)
            conn_watches.discard(wid)
            await fw.send({"reqid": reqid, "ok": True})
        elif op == "lease_create":
            lid = uuid.uuid4().hex
            self._leases[lid] = (float(header["ttl"]), time.monotonic())
            self._dirty = True
            await fw.send({"reqid": reqid, "ok": True, "lease_id": lid})
        elif op == "lease_keepalive":
            lid = header["lease_id"]
            if lid in self._leases:
                ttl, _ = self._leases[lid]
                self._leases[lid] = (ttl, time.monotonic())
                await fw.send({"reqid": reqid, "ok": True})
            else:
                await fw.send({"reqid": reqid, "error": "lease not found"})
        elif op == "lease_revoke":
            await self._drop_lease(header["lease_id"])
            await fw.send({"reqid": reqid, "ok": True})
        else:
            await fw.send({"reqid": reqid, "error": f"unknown op {op!r}"})


# ---------------------------------------------------------------------------
# Client (DiscoveryBackend implementation)
# ---------------------------------------------------------------------------


class DiscdDiscovery:
    def __init__(self, address: str) -> None:
        host, _, port = address.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self._fw: Optional[FrameWriter] = None
        self._pump: Optional[asyncio.Task] = None
        self._reqids = itertools.count(1)
        self._pending: Dict[int, asyncio.Future] = {}
        self._watches: Dict[int, asyncio.Queue] = {}
        # Strong refs to watch bootstrap/unwatch tasks: the loop keeps
        # only weak ones, so an unretained handle can be GC'd mid-flight.
        self._bg_tasks: Set[asyncio.Task] = set()
        self._lock = asyncio.Lock()
        self._closed = False
        # _closed doubles as "connection needs re-establishing" (the pump
        # sets it on loss); _shutdown is the explicit close() — the only
        # thing that stops a bootstrap retry loop.
        self._shutdown = False

    async def _ensure(self) -> None:
        if self._fw is not None and not self._closed:
            return
        reader, writer = await asyncio.open_connection(self.host, self.port)
        self._fw = FrameWriter(writer)
        fr = FrameReader(reader)
        self._closed = False

        async def pump() -> None:
            try:
                while True:
                    frame = await fr.recv()
                    if frame is None:
                        break
                    header, payload = frame
                    if "watch" in header and "reqid" not in header:
                        q = self._watches.get(header["watch"])
                        if q is not None:
                            kind = EventKind(header["kind"])
                            q.put_nowait(
                                WatchEvent(kind, header["key"],
                                           payload if kind == EventKind.PUT else None)
                            )
                        continue
                    fut = self._pending.pop(header.get("reqid"), None)
                    if fut is not None and not fut.done():
                        fut.set_result((header, payload))
            finally:
                self._closed = True
                for fut in self._pending.values():
                    if not fut.done():
                        fut.set_exception(ConnectionError("discd connection lost"))
                self._pending.clear()
                for q in self._watches.values():
                    q.put_nowait(_WATCH_CLOSED)

        self._pump = asyncio.get_running_loop().create_task(pump(), name="discd-client-pump")

    def _spawn_bg(self, coro, *, name: str) -> asyncio.Task:
        task = asyncio.get_running_loop().create_task(coro, name=name)
        self._bg_tasks.add(task)
        task.add_done_callback(self._bg_done)
        return task

    def _bg_done(self, task: asyncio.Task) -> None:
        # Retrieve the result: an unwatch racing close() fails with the
        # connection, which is no fault (the JAX client leaves it to the
        # loop's "exception was never retrieved" report).
        self._bg_tasks.discard(task)
        if not task.cancelled() and task.exception() is not None:
            logger.debug("%s ended with %r", task.get_name(), task.exception())

    async def _call(self, header: Dict[str, Any], payload: Any = None) -> Tuple[Dict[str, Any], Any]:
        async with self._lock:
            await self._ensure()
            reqid = next(self._reqids)
            header["reqid"] = reqid
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._pending[reqid] = fut
            assert self._fw is not None
            await self._fw.send(header, payload)
        rh, rp = await fut
        if "error" in rh:
            raise RuntimeError(f"discd: {rh['error']}")
        return rh, rp

    # -- DiscoveryBackend ---------------------------------------------------

    async def put(self, key: str, value: Dict[str, Any], lease: Optional[Lease] = None) -> None:
        await self._call({"op": "put", "key": key, "lease": lease.id if lease else None}, value)

    async def delete(self, key: str) -> None:
        await self._call({"op": "delete", "key": key})

    async def get(self, key: str) -> Optional[Dict[str, Any]]:
        rh, rp = await self._call({"op": "get", "key": key})
        return rp if rh.get("found") else None

    async def get_prefix(self, prefix: str) -> Dict[str, Dict[str, Any]]:
        _, rp = await self._call({"op": "get_prefix", "prefix": prefix})
        return rp or {}

    def watch(self, prefix: str) -> Watch:
        queue: asyncio.Queue = asyncio.Queue()
        snapshot_box: List[WatchEvent] = []
        watch_id_box: List[int] = []

        # The Watch must be returned synchronously (interface parity with the
        # memory backend); fetch the snapshot eagerly in a bootstrap task and
        # feed everything through the queue. Bootstrap retries with jittered
        # exponential backoff: a discd restart disconnects every client at
        # once, and bare one-shot bootstraps would either die (old behavior)
        # or stampede the recovering server in lockstep.
        async def bootstrap() -> None:
            from dynamo_tpu_torch.runtime.tasks import Backoff

            backoff = Backoff(base_s=0.1, cap_s=5.0)
            while not self._shutdown:
                try:
                    rh, snapshot = await self._call(
                        {"op": "watch", "prefix": prefix}
                    )
                    wid = rh["watch_id"]
                    watch_id_box.append(wid)
                    self._watches[wid] = queue
                    for k, v in sorted((snapshot or {}).items()):
                        queue.put_nowait(WatchEvent(EventKind.PUT, k, v))
                    return
                except asyncio.CancelledError:
                    raise
                except Exception as exc:
                    delay = backoff.next_delay()
                    logger.warning(
                        "discd watch bootstrap for %r failed (%r); "
                        "retrying in %.2fs", prefix, exc, delay,
                    )
                    await asyncio.sleep(delay)
            queue.put_nowait(_WATCH_CLOSED)

        self._spawn_bg(bootstrap(), name="discd-watch-bootstrap")

        def _close(w: Watch) -> None:
            if watch_id_box:
                wid = watch_id_box[0]
                self._watches.pop(wid, None)
                self._spawn_bg(
                    self._call({"op": "unwatch", "watch_id": wid}),
                    name="discd-unwatch",
                )
            queue.put_nowait(_WATCH_CLOSED)

        return Watch(prefix, snapshot_box, queue, on_close=_close)

    async def create_lease(self, ttl: float) -> Lease:
        rh, _ = await self._call({"op": "lease_create", "ttl": ttl})
        return Lease(id=rh["lease_id"], ttl=ttl)

    async def keep_alive(self, lease: Lease) -> None:
        await self._call({"op": "lease_keepalive", "lease_id": lease.id})

    async def revoke_lease(self, lease: Lease) -> None:
        await self._call({"op": "lease_revoke", "lease_id": lease.id})

    async def close(self) -> None:
        self._closed = True
        self._shutdown = True
        if self._pump is not None:
            self._pump.cancel()
            await reap_task(self._pump, "discd event pump", logger)
        for task in list(self._bg_tasks):
            task.cancel()
            await reap_task(task, "discd background task", logger)
        if self._fw is not None:
            self._fw.close()
            self._fw = None


class _quiet:
    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        return et is not None and issubclass(et, (ConnectionError, RuntimeError))
