"""File-backed discovery: a shared directory as the KV store — the port's
copy of dynamo_tpu/runtime/discovery/file.py, writing the same JSON
documents (``{"value": ..., "lease": id}`` a key, ``{"ttl": s}`` a lease),
so a port process and a JAX process can share one directory.

Reference parity: lib/runtime/src/storage/kv/file.rs (file discovery backend)
with etcd-style lease liveness mapped onto mtime heartbeats: a lease is a
file the owner touches periodically; keys written under a lease are expired
by any participant's poll loop once the heartbeat goes stale.

Good for multi-process single-host clusters. Multi-host uses
DiscdDiscovery (discd.py).
"""

from __future__ import annotations

import asyncio
import json
import os
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from dynamo_tpu_torch.runtime.discovery import (
    EventKind,
    Lease,
    Watch,
    WatchEvent,
    _WATCH_CLOSED,
)
from dynamo_tpu_torch.runtime.tasks import reap_task
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_LEASE_DIR = ".leases"


class FileDiscovery:
    def __init__(self, root: str, *, poll_interval: float = 0.2) -> None:
        self.root = root
        self.poll_interval = poll_interval
        os.makedirs(os.path.join(root, _LEASE_DIR), exist_ok=True)
        self._watchers: List[Tuple[str, asyncio.Queue]] = []
        self._poll_task: Optional[asyncio.Task] = None
        self._known: Dict[str, Any] = {}  # key → value (last observed)
        self._closed = False

    # -- paths -------------------------------------------------------------

    def _path(self, key: str) -> str:
        safe = key.strip("/").replace("/", os.sep)
        return os.path.join(self.root, safe + ".json")

    def _key_of(self, path: str) -> str:
        rel = os.path.relpath(path, self.root)
        return rel[: -len(".json")].replace(os.sep, "/")

    # -- KV ----------------------------------------------------------------

    async def put(self, key: str, value: Dict[str, Any], lease: Optional[Lease] = None) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        doc = {"value": value, "lease": lease.id if lease else None}
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        self._observe(key, value)

    async def delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass
        self._observe(key, None)

    async def get(self, key: str) -> Optional[Dict[str, Any]]:
        doc = self._read(self._path(key))
        return doc["value"] if doc else None

    async def get_prefix(self, prefix: str) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        for key, value in self._scan().items():
            if key.startswith(prefix):
                out[key] = value
        return out

    def _read(self, path: str) -> Optional[Dict[str, Any]]:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None
        lease_id = doc.get("lease")
        if lease_id and self._lease_expired(lease_id):
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
            return None
        return doc

    def _scan(self) -> Dict[str, Dict[str, Any]]:
        found: Dict[str, Dict[str, Any]] = {}
        for dirpath, dirnames, filenames in os.walk(self.root):
            if _LEASE_DIR in dirnames:
                dirnames.remove(_LEASE_DIR)
            for fname in filenames:
                if not fname.endswith(".json"):
                    continue
                path = os.path.join(dirpath, fname)
                doc = self._read(path)
                if doc is not None:
                    found[self._key_of(path)] = doc["value"]
        return found

    # -- leases ------------------------------------------------------------

    def _lease_path(self, lease_id: str) -> str:
        return os.path.join(self.root, _LEASE_DIR, lease_id)

    def _lease_expired(self, lease_id: str) -> bool:
        path = self._lease_path(lease_id)
        try:
            with open(path) as f:
                doc = json.load(f)
            return time.time() - os.path.getmtime(path) > doc["ttl"]
        except (FileNotFoundError, json.JSONDecodeError, KeyError):
            return True

    async def create_lease(self, ttl: float) -> Lease:
        lease = Lease(id=uuid.uuid4().hex, ttl=ttl)
        with open(self._lease_path(lease.id), "w") as f:
            json.dump({"ttl": ttl}, f)
        return lease

    async def keep_alive(self, lease: Lease) -> None:
        try:
            os.utime(self._lease_path(lease.id))
        except FileNotFoundError:
            # Re-create: the lease may have been swept while we were paused.
            with open(self._lease_path(lease.id), "w") as f:
                json.dump({"ttl": lease.ttl}, f)

    async def revoke_lease(self, lease: Lease) -> None:
        # Delete keys owned by the lease, then the heartbeat file.
        for dirpath, dirnames, filenames in os.walk(self.root):
            if _LEASE_DIR in dirnames:
                dirnames.remove(_LEASE_DIR)
            for fname in filenames:
                if not fname.endswith(".json"):
                    continue
                path = os.path.join(dirpath, fname)
                try:
                    with open(path) as f:
                        doc = json.load(f)
                except (FileNotFoundError, json.JSONDecodeError):
                    continue
                if doc.get("lease") == lease.id:
                    try:
                        os.unlink(path)
                    except FileNotFoundError:
                        pass
        try:
            os.unlink(self._lease_path(lease.id))
        except FileNotFoundError:
            pass

    # -- watch -------------------------------------------------------------

    def watch(self, prefix: str) -> Watch:
        queue: asyncio.Queue = asyncio.Queue()
        snapshot_state = self._scan()
        self._known.update(snapshot_state)
        snapshot = [
            WatchEvent(EventKind.PUT, k, v)
            for k, v in sorted(snapshot_state.items())
            if k.startswith(prefix)
        ]
        entry = (prefix, queue)
        self._watchers.append(entry)
        if self._poll_task is None or self._poll_task.done():
            self._poll_task = asyncio.get_running_loop().create_task(
                self._poll_loop(), name="file-discovery-poll"
            )

        def _close(w: Watch) -> None:
            self._watchers = [e for e in self._watchers if e[1] is not queue]
            queue.put_nowait(_WATCH_CLOSED)

        return Watch(prefix, snapshot, queue, on_close=_close)

    def _observe(self, key: str, value: Optional[Dict[str, Any]]) -> None:
        """Local-change fast path: notify watchers without waiting on a poll."""
        prev = self._known.get(key)
        if value is None:
            if key in self._known:
                del self._known[key]
                self._emit(WatchEvent(EventKind.DELETE, key))
        elif prev != value:
            self._known[key] = value
            self._emit(WatchEvent(EventKind.PUT, key, value))

    def _emit(self, event: WatchEvent) -> None:
        for prefix, queue in list(self._watchers):
            if event.key.startswith(prefix):
                queue.put_nowait(event)

    async def _poll_loop(self) -> None:
        from dynamo_tpu_torch.runtime.tasks import Backoff

        # A scan failure (shared-filesystem blip) hits every watcher at
        # once; jittered backoff keeps the recovering mount from being
        # re-polled by the whole fleet in lockstep.
        backoff = Backoff(base_s=self.poll_interval, cap_s=30 * self.poll_interval)
        while not self._closed and self._watchers:
            delay = self.poll_interval
            try:
                current = await asyncio.get_running_loop().run_in_executor(
                    None, self._scan
                )
                for key in list(self._known):
                    if key not in current:
                        self._observe(key, None)
                for key, value in current.items():
                    self._observe(key, value)
                backoff.reset()
            except Exception:
                logger.exception("file discovery poll failed")
                delay = backoff.next_delay()
            await asyncio.sleep(delay)

    async def close(self) -> None:
        self._closed = True
        if self._poll_task is not None:
            self._poll_task.cancel()
            await reap_task(self._poll_task, "file-discovery poll", logger)
            self._poll_task = None
