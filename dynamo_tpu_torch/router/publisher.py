"""Worker-side publishers: KV events and load snapshots onto the event plane —
the port's copy of dynamo_tpu/router/publisher.py (``KvEvent`` from the
port's block pool, where JAX takes it from its mock engine).

Reference parity: lib/llm/src/kv_router/publisher.rs (KvEventPublisher :112 —
engine events → event plane) and the load/stat publishing the scheduler
consumes. Engines call a synchronous callback per KV event; the publisher
queues and ships them from an asyncio task (events survive bursts; order is
preserved per worker).
"""

from __future__ import annotations

import asyncio
from typing import Any, Callable, Optional

from dynamo_tpu_torch.engines.gpu.block_pool import KvEvent
from dynamo_tpu_torch.router.protocols import (
    LoadSnapshot,
    RouterEvent,
    kv_events_topic,
    kv_sync_topic,
    load_topic,
)
from dynamo_tpu_torch.runtime.liveness import process_incarnation
from dynamo_tpu_torch.runtime.tasks import Backoff, reap_task
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class KvEventPublisher:
    """Bridge engine KV events → event plane topic.

    With ``snapshot_fn`` set (a callable returning the engine's current
    [(block_hash, parent_hash)] committed set), the publisher also answers
    sync requests on the kv_sync topic with a full ``kind="snapshot"`` event
    — the JetStream re-sync role (ref: lib/llm/src/kv_router/subscriber.rs:266)
    so a restarted router rebuilds its index immediately instead of waiting
    for TTL churn. Snapshots ride the same queue as live events, preserving
    the per-worker event order the indexer relies on.
    """

    def __init__(
        self,
        event_plane: Any,
        namespace: str,
        component: str,
        worker_id: int,
        *,
        dp_rank: int = 0,
        snapshot_fn: Optional[Callable[[], list]] = None,
    ) -> None:
        self._plane = event_plane
        self._topic = kv_events_topic(namespace, component)
        self._sync_topic = kv_sync_topic(namespace, component)
        self.worker_id = worker_id
        self.dp_rank = dp_rank
        self._snapshot_fn = snapshot_fn
        self._queue: "asyncio.Queue[Optional[RouterEvent]]" = asyncio.Queue()
        self._event_id = 0
        self._task: Optional[asyncio.Task] = None
        self._sync_task: Optional[asyncio.Task] = None

    def on_kv_event(self, event: KvEvent) -> None:
        """Engine callback (synchronous, loop thread)."""
        self._event_id += 1
        self._queue.put_nowait(
            RouterEvent(
                worker_id=self.worker_id,
                dp_rank=self.dp_rank,
                kind=event.kind,
                block_hashes=list(event.block_hashes),
                parent_hash=event.parent_hash,
                event_id=self._event_id,
            )
        )
        self._ensure_task()

    def set_snapshot_fn(self, fn: Callable[[], list]) -> None:
        """Late-bind the snapshot source (the engine is usually constructed
        after the publisher, taking on_kv_event as a callback) and start
        answering sync requests."""
        self._snapshot_fn = fn
        self.start_sync_responder()

    def enqueue_snapshot(self) -> None:
        """Queue a full-state snapshot event (ordered with live events)."""
        if self._snapshot_fn is None:
            return
        blocks = self._snapshot_fn()
        self._event_id += 1
        self._queue.put_nowait(
            RouterEvent(
                worker_id=self.worker_id,
                dp_rank=self.dp_rank,
                kind="snapshot",
                block_hashes=[h for h, _ in blocks],
                parent_hashes=[p for _, p in blocks],
                event_id=self._event_id,
            )
        )
        self._ensure_task()

    def start_sync_responder(self) -> None:
        """Subscribe to the sync topic and answer requests with snapshots."""
        if self._snapshot_fn is None or self._sync_task is not None:
            return
        self._sync_task = asyncio.get_running_loop().create_task(
            self._sync_pump(), name=f"kv-sync:{self.worker_id:#x}"
        )

    async def _sync_pump(self) -> None:
        sub = None
        try:
            sub = self._plane.subscribe(self._sync_topic)
            async for _topic, req in sub:
                target = (req or {}).get("worker_id")
                if target is not None and target != self.worker_id:
                    continue
                self.enqueue_snapshot()
        except asyncio.CancelledError:
            raise
        except Exception:
            logger.exception("kv sync responder died")
        finally:
            if sub is not None:
                await sub.aclose()

    def _ensure_task(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(
                self._pump(), name=f"kv-event-pub:{self.worker_id:#x}"
            )

    async def _pump(self) -> None:
        while True:
            ev = await self._queue.get()
            if ev is None:
                return
            try:
                await self._plane.publish(self._topic, ev.to_dict())
            except Exception:
                logger.exception("failed to publish KV event")

    async def close(self) -> None:
        if self._sync_task is not None:
            self._sync_task.cancel()
            await reap_task(self._sync_task, "kv-event sync task", logger)
            self._sync_task = None
        if self._task is not None and not self._task.done():
            self._queue.put_nowait(None)
            await self._task
        self._task = None


class LoadPublisher:
    """Periodic load snapshots (ref: worker stat publishing feeding
    scheduler.rs ProcessedEndpoints)."""

    def __init__(
        self,
        event_plane: Any,
        namespace: str,
        component: str,
        worker_id: int,
        stats_fn: Callable[[], dict],
        *,
        dp_rank: int = 0,
        total_blocks: int = 0,
        interval_s: Optional[float] = None,
        link_bandwidth_fn: Optional[Callable[[], dict]] = None,
        link_faults_fn: Optional[Callable[[], list]] = None,
        kv_high_watermark: float = 1.0,
        incarnation: Optional[int] = None,
    ) -> None:
        self._plane = event_plane
        self._topic = load_topic(namespace, component)
        self.worker_id = worker_id
        self.dp_rank = dp_rank
        self._stats_fn = stats_fn
        self._total_blocks = total_blocks
        # Cadence is env-tunable (DYN_TPU_LOAD_REPORT_INTERVAL_S): the
        # liveness detection budget is denominated in these intervals.
        if interval_s is None:
            from dynamo_tpu_torch import config as _cfg

            interval_s = _cfg.LOAD_REPORT_INTERVAL_S.get()
        self.interval_s = interval_s
        # () -> {src prefill worker id: bytes/s} — the decode handler's
        # measured pull bandwidths, carried to the router's link-cost model
        # on every load report. Late-bindable (the handler is usually
        # constructed after the publisher).
        self.link_bandwidth_fn = link_bandwidth_fn
        # () -> [src worker ids with an open pull breaker] — prices those
        # pairs out of disagg placement router-side.
        self.link_faults_fn = link_faults_fn
        # This worker's admission refusal threshold, advertised so the
        # router can deflect placements away once usage reaches it
        # (overload backpressure). The stats dict's own value wins when
        # the engine reports one.
        self.kv_high_watermark = kv_high_watermark
        # Incarnation fence stamp (runtime/liveness.py): consumers use it
        # to drop a zombie's late reports and to spot a restart. Defaults
        # to the process incarnation — one worker per process.
        self.incarnation = (
            incarnation if incarnation is not None else process_incarnation()
        )
        self._task: Optional[asyncio.Task] = None
        self._stop = asyncio.Event()

    def snapshot(self) -> LoadSnapshot:
        s = self._stats_fn()
        total = self._total_blocks or s.get("total_blocks", 0)
        free = s.get("free_blocks", 0)
        link_bw = self.link_bandwidth_fn() if self.link_bandwidth_fn else None
        link_faults = self.link_faults_fn() if self.link_faults_fn else None
        return LoadSnapshot(
            worker_id=self.worker_id,
            dp_rank=self.dp_rank,
            active_seqs=s.get("active_seqs", 0),
            waiting=s.get("waiting", 0),
            active_blocks=max(total - free, 0),
            total_blocks=total,
            generated_tokens=s.get("generated_tokens", 0),
            queue_depth=s.get("queue_depth", s.get("waiting", 0)),
            kv_high_watermark=float(
                s.get("kv_high_watermark", self.kv_high_watermark)
            ),
            link_bandwidth=link_bw or None,
            link_faults=list(link_faults) if link_faults else None,
            # Drain bit: the engine's stats carry it (JaxEngine sets
            # ``draining`` the moment begin_drain runs; the controller
            # also force-publishes so routers see it within one RTT).
            draining=bool(s.get("draining", 0)),
            incarnation=self.incarnation,
            # Tick-budgeter advertisement: effective per-tick prefill
            # budget + controller state, straight from engine stats
            # (0/0 when the budgeter is off — scheduler ignores it).
            prefill_budget_tokens=int(s.get("prefill_budget_tokens", 0)),
            budget_state=int(s.get("budget_state", 0)),
        )

    async def publish_once(self) -> None:
        await self._plane.publish(self._topic, self.snapshot().to_dict())

    def start(self) -> None:
        if self._task is None:
            self._stop.clear()
            self._task = asyncio.get_running_loop().create_task(
                self._run(), name=f"load-pub:{self.worker_id:#x}"
            )

    async def _run(self) -> None:
        # Publish-failure backoff: an event-plane blip hits EVERY worker's
        # publisher at once — retrying each at its fixed cadence stampedes
        # the recovering broker. The jittered schedule de-synchronizes the
        # herd; the first success resets it. The cap is deliberately BELOW
        # the liveness death budget (dead_after defaults to 5 intervals;
        # worst post-recovery delay here is 2 × 1.5 jitter = 3 intervals),
        # so a brief plane blip can never make healthy workers go silent
        # past the budget and trigger a fleet-wide false-dead storm.
        backoff = Backoff(base_s=self.interval_s, cap_s=2 * self.interval_s)
        while not self._stop.is_set():
            delay = self.interval_s
            try:
                await self.publish_once()
                backoff.reset()
            except Exception:
                logger.exception("failed to publish load snapshot")
                delay = backoff.next_delay()
            try:
                await asyncio.wait_for(self._stop.wait(), timeout=delay)
            except asyncio.TimeoutError:
                pass

    async def close(self) -> None:
        self._stop.set()
        if self._task is not None:
            await self._task
            self._task = None
