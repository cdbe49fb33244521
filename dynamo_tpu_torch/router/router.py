"""KvRouter: ties the indexer + scheduler to the event plane and the Client —
the port's copy of dynamo_tpu/router/router.py.

Reference parity: lib/llm/src/kv_router.rs (KvRouter :320, find_best_match
:501, AsyncEngine impl :720) and subscriber.rs (event plane → indexer pump).

Usage (frontend side):

    client = await endpoint.client(RouterMode.KV)
    router = KvRouter(runtime, namespace, component, block_size=16)
    await router.start()
    router.attach(client)          # installs the kv picker
    ... client.generate(preprocessed_request) now routes KV-aware ...

Workers run KvEventPublisher/LoadPublisher (publisher.py) so the router sees
their cache contents and load.
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, Optional, Sequence, Tuple

from dynamo_tpu_torch.router.indexer import KvIndexer
from dynamo_tpu_torch.router.protocols import (
    LoadSnapshot,
    RouterEvent,
    WorkerKey,
    kv_events_topic,
    kv_sync_topic,
    load_topic,
)
from dynamo_tpu_torch.router.scheduler import (
    KvRouterConfig,
    KvScheduler,
    TransferContext,
)
from dynamo_tpu_torch.runtime import lifecycle
from dynamo_tpu_torch.runtime.tasks import reap_task
from dynamo_tpu_torch.tokens.blocks import adapter_salt, compute_block_hashes
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# How long start() waits for its KV-event subscription to reach the broker.
SUBSCRIBE_TIMEOUT_S = 10.0


def _worker_label(worker: Any) -> str:
    if isinstance(worker, tuple):
        return ":".join(str(p) for p in worker)
    return str(worker)


class RouterMetrics:
    """Canonical router metric families (runtime/metric_names.py ALL_ROUTER)
    on a private registry; ``render`` plugs into the system status server's
    ``register_metrics`` seam. Per-worker load gauges sample the scheduler's
    cost-model state at scrape time (on_render), so the exposed load is the
    same signal ``select_worker`` is acting on."""

    def __init__(self, scheduler: KvScheduler) -> None:
        from dynamo_tpu_torch.runtime import metric_names as mn
        from dynamo_tpu_torch.runtime.metrics_core import COUNT_BUCKETS, MetricsRegistry

        self._scheduler = scheduler
        self.registry = MetricsRegistry()
        self.decisions = self.registry.counter(
            mn.ROUTER_DECISIONS_TOTAL,
            "Routing decisions by reason "
            "(kv_overlap|load_only|pinned|fallback|no_worker)",
            ["reason"],
        )
        self.overlap_blocks = self.registry.histogram(
            mn.ROUTER_OVERLAP_BLOCKS,
            "Predicted prefix-overlap blocks per routed request",
            buckets=COUNT_BUCKETS,
        )
        self.worker_load = self.registry.gauge(
            mn.ROUTER_WORKER_LOAD_BLOCKS,
            "Predicted active decode blocks per worker (reported + in-flight)",
            ["worker"],
        )
        self.worker_kv_usage = self.registry.gauge(
            mn.ROUTER_WORKER_KV_USAGE,
            "Last reported KV-cache usage fraction per worker",
            ["worker"],
        )
        self.kv_events = self.registry.counter(
            mn.ROUTER_KV_EVENTS_TOTAL,
            "KV cache events applied to the router index",
        )
        self.link_bandwidth = self.registry.gauge(
            mn.ROUTER_LINK_BANDWIDTH,
            "Per-(src, dst) transfer-bandwidth EWMA the link-cost term is "
            "acting on (measured pairs only; unmeasured quote the seed)",
            ["src", "dst"],
        )
        self._gauge_workers: set = set()
        self._gauge_links: set = set()
        self.registry.on_render(self._sample_workers)

    def _sample_workers(self) -> None:
        view = self._scheduler.load_view()
        labels = set()
        for worker, (load_blocks, kv_usage) in view.items():
            label = _worker_label(worker)
            labels.add(label)
            self.worker_load.set(load_blocks, worker=label)
            self.worker_kv_usage.set(kv_usage, worker=label)
        for gone in self._gauge_workers - labels:
            self.worker_load.remove(worker=gone)
            self.worker_kv_usage.remove(worker=gone)
        self._gauge_workers = labels
        links = set()
        for (src, dst), bw in self._scheduler.link_costs.pairs().items():
            pair = (str(src), _worker_label(dst))
            links.add(pair)
            self.link_bandwidth.set(bw, src=pair[0], dst=pair[1])
        for src, dst in self._gauge_links - links:
            self.link_bandwidth.remove(src=src, dst=dst)
        self._gauge_links = links

    def render(self, openmetrics: bool = False) -> str:
        return self.registry.render(openmetrics=openmetrics)


class KvRouter:
    def __init__(
        self,
        runtime: Any,
        namespace: str,
        component: str,
        *,
        block_size: int = 16,
        config: Optional[KvRouterConfig] = None,
        use_kv_events: bool = True,
        prune_config: Optional[Any] = None,
    ) -> None:
        self._runtime = runtime
        self.namespace = namespace
        self.component = component
        self.block_size = block_size
        self.use_kv_events = use_kv_events
        if use_kv_events:
            self.indexer = KvIndexer(block_size)
        else:
            # Approximate mode (ref: kv_router.rs:359): no event feed — the
            # router's own routing decisions seed the index, TTL-pruned.
            from dynamo_tpu_torch.router.approx import ApproxKvIndexer

            self.indexer = ApproxKvIndexer(block_size, prune_config)
        self.scheduler = KvScheduler(config)
        # drop_worker is the single purge path: the scheduler fans the
        # radix-index removal out through this callback, so a crash-plane
        # drop (or a rejoin under a fresh incarnation) reconciles charges,
        # link pairs, breaker faults AND radix entries in one call. The
        # KV-reuse popularity sketch rides the same fan-out (zero-residue
        # audit: a departed worker's hits must not keep a prefix hot).
        self.scheduler.add_drop_callback(self.indexer.remove_worker)
        from dynamo_tpu_torch.runtime.kv_reuse_observe import global_plane

        self.kv_plane = global_plane()
        self.scheduler.add_drop_callback(self.kv_plane.drop_worker)
        self.metrics = RouterMetrics(self.scheduler)
        self._tasks: list = []
        self._subs: list = []
        # request identity -> stack of (worker, charged blocks, report gen);
        # one entry popped per stream end. A stack (not a single slot) keeps
        # the accounting balanced when a caller passes the SAME request
        # object to concurrent generate() calls (hedging/retries): pairing
        # may momentarily cross over, but every charge is released exactly
        # once.
        self._inflight: Dict[int, list] = {}
        # Notified after each applied KV event so tests (and operators) can
        # await "indexer has seen N events" instead of sleeping.
        self._events_cond: Optional[asyncio.Condition] = None
        # Re-sync request throttling: worker → loop-monotonic of last request.
        self._sync_requested: Dict[Optional[WorkerKey], float] = {}
        self._sync_cooldown_s = 2.0

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        plane = self._runtime.event_plane
        load_sub = plane.subscribe(load_topic(self.namespace, self.component))
        self._subs = [load_sub]
        loop = asyncio.get_running_loop()
        self._tasks = [
            loop.create_task(self._pump_load(load_sub), name="kv-router-load"),
        ]
        if self.use_kv_events:
            kv_sub = plane.subscribe(
                kv_events_topic(self.namespace, self.component)
            )
            self._subs.append(kv_sub)
            self._tasks.append(
                loop.create_task(self._pump_kv(kv_sub), name="kv-router-events")
            )
            # A (re)started router has an empty index: broadcast a snapshot
            # request so publishers replay their committed state immediately
            # (JetStream re-sync role) instead of the index warming over TTLs.
            # The port's planes say when a subscription reaches its broker:
            # ask only then, so that the snapshots are not published before
            # the broker forwards them here (JAX's pyzmq plane cannot tell).
            # The broker may still pass the subscription on to a publisher
            # after the request: _pump_load asks such a worker again.
            await asyncio.wait_for(kv_sub.ready.wait(), SUBSCRIBE_TIMEOUT_S)
            await self._request_sync(None)

    async def stop(self) -> None:
        for sub in self._subs:
            await sub.aclose()
        for task in self._tasks:
            task.cancel()
        for task in self._tasks:
            await reap_task(task, "router subscription pump", logger)
        self._tasks = []
        self._subs = []

    async def _pump_kv(self, sub) -> None:
        async for _topic, payload in sub:
            try:
                event = RouterEvent.from_dict(payload)
                if hasattr(self.indexer, "has_gap") and self.indexer.has_gap(event):
                    await self._request_sync(event.worker)
                self.indexer.apply(event)
            except Exception:
                logger.exception("bad KV event payload")
            else:
                self.metrics.kv_events.inc()
            if self._events_cond is not None:
                async with self._events_cond:
                    self._events_cond.notify_all()

    async def _request_sync(self, worker: Optional[WorkerKey]) -> None:
        """Ask publishers (one worker, or all with None) for a snapshot."""
        now = asyncio.get_running_loop().time()
        last = self._sync_requested.get(worker)
        if last is not None and now - last < self._sync_cooldown_s:
            return
        self._sync_requested[worker] = now
        try:
            await self._runtime.event_plane.publish(
                kv_sync_topic(self.namespace, self.component),
                {"worker_id": worker[0] if worker else None},
            )
        except Exception:
            logger.exception("failed to publish kv sync request")

    async def wait_for_events(self, count: int, timeout: float = 5.0) -> None:
        """Block until at least ``count`` KV events have been applied to the
        indexer (deterministic alternative to sleeping in tests)."""
        if self._events_cond is None:
            self._events_cond = asyncio.Condition()
        async with self._events_cond:
            await asyncio.wait_for(
                self._events_cond.wait_for(
                    lambda: self.indexer.events_applied >= count
                ),
                timeout,
            )

    async def _pump_load(self, sub) -> None:
        async for _topic, payload in sub:
            try:
                load = LoadSnapshot.from_dict(payload)
                self.scheduler.update_load(load)
            except Exception:
                logger.exception("bad load payload")
                continue
            # A worker that reports load while the index holds no event of
            # it is asked for its snapshot: the start-up request's answer
            # is lost when it leaves the worker before this router's
            # subscription has reached it (the broker forwards the two on
            # different sockets). The cooldown spaces the asks until one
            # lands; a late duplicate snapshot is dropped as stale.
            worker = (load.worker_id, load.dp_rank)
            if self.use_kv_events and not self.indexer.has_seen(worker):
                await self._request_sync(worker)

    def drop_worker(self, worker: WorkerKey) -> None:
        """Crash-plane reconciliation: one call releases the scheduler's
        in-flight charges, link pairs/faults, and (via the registered drop
        callback) the radix index's entries for this worker."""
        self.scheduler.drop_worker(worker)

    def remove_worker(self, worker: WorkerKey) -> None:
        self.drop_worker(worker)

    def register_metrics(self, server: Any) -> None:
        """Expose this router's metric families on a SystemStatusServer."""
        server.register_metrics(self.metrics.render)

    # -- selection ---------------------------------------------------------

    def find_best_match(
        self,
        token_ids: Sequence[int],
        candidates: Optional[Sequence[WorkerKey]] = None,
        *,
        lora_name: Optional[str] = None,
        transfer: Optional[Any] = None,  # scheduler.TransferContext
    ) -> Tuple[Optional[WorkerKey], int]:
        """Returns (worker, overlap_blocks) — ref: kv_router.rs:501.
        ``lora_name`` salts the hash space the same way the engine does
        (tokens/blocks.py adapter_salt) so overlap is only predicted against
        same-adapter blocks. ``transfer`` prices each candidate's
        overlap-miss pull over the (src, candidate) link — NetKV-style
        network-aware decode placement."""
        hashes = compute_block_hashes(
            token_ids, self.block_size, salt=adapter_salt(lora_name)
        )
        overlaps = self.indexer.find_matches(hashes)
        request_blocks = max(len(hashes), 1)
        worker = self.scheduler.select_worker(
            request_blocks, overlaps, candidates, transfer=transfer
        )
        overlap = overlaps.scores.get(worker, 0) if worker is not None else 0
        if worker is None:
            self.metrics.decisions.inc(reason="no_worker")
        else:
            self.metrics.decisions.inc(
                reason="kv_overlap" if overlap > 0 else "load_only"
            )
            self.metrics.overlap_blocks.observe(overlap)
            if overlap > 0:
                # Popularity feed: the matched prefix is keyed by its
                # block-hash-chain anchor (deepest matched block) and
                # attributed to the chosen worker so drop_worker can purge
                # it. Popularity only — the engine-side hit accounts the
                # ROI counters (a router feed too would double-count).
                self.kv_plane.note_router_match(
                    hashes[overlap - 1],
                    tokens=overlap * self.block_size,
                    worker=worker,
                )
        if not self.use_kv_events and worker is not None:
            # Approximate mode: assume the chosen worker will cache these
            # blocks (ref: kv_router.rs:937 routing-decision recording).
            self.indexer.process_routing_decision(hashes, worker)
        return worker, overlap

    def release(
        self, worker: WorkerKey, charged_blocks: int, report_gen: Optional[int] = None
    ) -> None:
        """Release the in-flight prediction for a finished stream."""
        self.scheduler.complete_request(worker, charged_blocks, report_gen)

    def attach(self, client: Any) -> None:
        """Install this router as the Client's KV-mode instance picker."""

        async def _select(request: Any, instances: Dict[int, Any], sp) -> Optional[int]:
            # Gateway pin (the EPP's x-dynamo-worker header hint,
            # gateway/epp.py): the upstream picker already ran the KV
            # algorithm and charged its own bookkeeping — honor the pin
            # when that instance is still live.
            pin = None
            if isinstance(request, dict):
                pin = request.get("_pinned_worker")
                if pin is None:
                    pin = (request.get("extra") or {}).get("_pinned_worker")
            else:
                # PreprocessedRequest object (the primary HTTP path passes
                # the dataclass itself).
                pin = (getattr(request, "extra", None) or {}).get("_pinned_worker")
            if pin is not None and int(pin) in instances:
                self.metrics.decisions.inc(reason="pinned")
                lifecycle.record(
                    _request_id_of(request), "routed",
                    worker=int(pin), reason="pinned",
                )
                if sp is not None:
                    sp.attributes.update({"worker": int(pin), "pinned": True})
                return int(pin)
            token_ids = _token_ids_of(request)
            if token_ids is None:
                self.metrics.decisions.inc(reason="fallback")
                return None  # not a preprocessed request; fall back
            candidates = [(iid, 0) for iid in instances]
            lora = (
                request.get("lora_name")
                if isinstance(request, dict)
                else getattr(request, "lora_name", None)
            )
            worker, overlap = self.find_best_match(
                token_ids, candidates, lora_name=lora,
                transfer=_transfer_context_of(request),
            )
            if sp is not None:
                # Decision record: how many candidates were actually
                # scored, the overlap/link terms — the "why this worker"
                # answer inside the request's own trace.
                sp.attributes.update({
                    k: v
                    for k, v in self.scheduler.last_decision.items()
                    if v is not None
                })
            if worker is None:
                return None
            n_blocks = max(len(token_ids) // self.block_size, 1)
            self._inflight.setdefault(id(request), []).append(
                (
                    worker,
                    max(n_blocks - overlap, 0),
                    self.scheduler.report_generation(worker),
                )
            )
            # The overlap prediction rides to the worker as its
            # speculative-onboard hint (engines/tpu/engine.py
            # _maybe_prefetch): positive means "start the tier walk at
            # enqueue", zero means the engine never speculates — cold
            # traffic stays prefetch-free by construction.
            if isinstance(request, dict):
                request["estimated_prefix_hit_blocks"] = overlap
            else:
                try:
                    request.estimated_prefix_hit_blocks = overlap
                except AttributeError:
                    pass
            lifecycle.record(
                _request_id_of(request), "routed",
                worker=worker[0], overlap_blocks=overlap,
                prefetch_hint=overlap > 0,
            )
            return worker[0]

        async def picker(
            request: Any, instances: Dict[int, Any], context: Any = None,
        ) -> Optional[int]:
            if context is None:
                return await _select(request, instances, None)
            # Trajectory span: the routing decision is a hop that can
            # dominate tail latency (lock contention, huge fleets) and
            # its attributes answer "why THIS worker" post-hoc.
            from dynamo_tpu_torch.utils.tracing import span

            with span("router.select_worker", context) as sp:
                return await _select(request, instances, sp)

        def on_done(instance_id: Optional[int], request: Any) -> None:
            entries = self._inflight.get(id(request))
            if entries:
                self.release(*entries.pop())
                if not entries:
                    del self._inflight[id(request)]

        client.set_kv_picker(picker)
        client.set_stream_done_callback(on_done)


def _transfer_context_of(request: Any) -> Optional[TransferContext]:
    """Disagg decode placement: a request carrying bootstrap metadata names
    the prefill worker its KV must be pulled FROM and what one block costs
    on the wire (disagg/handlers.py PrefillHandler). No metadata → no link
    term (aggregated routing is unchanged)."""
    dp = (
        request.get("disaggregated_params")
        if isinstance(request, dict)
        else getattr(request, "disaggregated_params", None)
    )
    if dp is None:
        return None
    if isinstance(dp, dict):
        worker_id = dp.get("worker_id")
        info = dp.get("kv_transfer") or {}
    else:
        worker_id = getattr(dp, "worker_id", None)
        info = getattr(dp, "kv_transfer", None) or {}
    block_bytes = info.get("block_bytes")
    if worker_id is None or not block_bytes:
        return None
    return TransferContext(src=int(worker_id), bytes_per_block=int(block_bytes))


def _token_ids_of(request: Any) -> Optional[Sequence[int]]:
    if isinstance(request, dict):
        ids = request.get("token_ids")
        return ids if isinstance(ids, (list, tuple)) else None
    return getattr(request, "token_ids", None)


def _request_id_of(request: Any) -> Optional[str]:
    if isinstance(request, dict):
        rid = request.get("request_id")
        return rid if isinstance(rid, str) else None
    return getattr(request, "request_id", None)
