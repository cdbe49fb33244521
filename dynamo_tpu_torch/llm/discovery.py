"""Dynamic model discovery: register_llm + ModelWatcher — the port's copy
of dynamo_tpu/llm/discovery.py.

Reference parity: lib/bindings rust/lib.rs:232 (register_llm — publish a
ModelDeploymentCard to the discovery plane under the worker's lease) and
lib/llm/src/discovery/watcher.rs:57,112 (ModelWatcher — watch the models/
prefix; on add, assemble a routed pipeline and hand it to the frontend's
ModelManager; on delete, tear it down when the last instance goes).

The assembled chain matches entrypoint/input/common.rs:173:
    OpenAIPreprocessor → Backend → Migration → Client[KV-routed]

Divergences from the JAX module: a ``multimodal`` card is refused with a
ValueError (the encode stage, JAX's MultimodalPreprocessor, comes with
ROADMAP A9); every model's Migration counts into the one
``migration_metrics`` the watcher holds, so that the frontend can render
them on its ``/metrics`` (the JAX frontend renders them nowhere); and the
``clear_kv`` fan-out waits for its control client's instances.
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict, Optional

from dynamo_tpu_torch.llm.backend import Backend
from dynamo_tpu_torch.llm.entrypoint import resolve_chat_template, resolve_tokenizer
from dynamo_tpu_torch.llm.migration import Migration, MigrationMetrics
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.router import KvRouter, KvRouterConfig
from dynamo_tpu_torch.runtime.component import Endpoint, RouterMode
from dynamo_tpu_torch.runtime.discovery import MODELS_PREFIX, model_key
from dynamo_tpu_torch.runtime.pipeline import build_pipeline
from dynamo_tpu_torch.runtime.tasks import reap_task
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


async def register_llm(
    runtime: Any,
    card: ModelDeploymentCard,
    endpoint: Endpoint,
    instance_id: int,
    incarnation: int = 0,
) -> str:
    """Publish the model card for a served endpoint instance. Returns the
    discovery key. The card rides the runtime's serving lease, so it vanishes
    with the worker (liveness, ref: watcher.rs delete handling).

    ``incarnation`` (runtime/liveness.py process_incarnation) rides the doc
    so the frontend's liveness tracker fences the registration itself: a
    restarted worker re-registering under the same instance_id announces
    its fresh incarnation before its first load report arrives."""
    key = model_key(endpoint.namespace, card.slug, instance_id)
    doc = {
        "card": card.to_dict(),
        "endpoint": {
            "namespace": endpoint.namespace,
            "component": endpoint.component,
            "endpoint": endpoint.name,
        },
        "instance_id": instance_id,
        "incarnation": incarnation,
    }
    # put_leased remembers the doc: a control-plane outage that expires
    # the lease gets the card re-registered automatically on recovery.
    await runtime.put_leased(key, doc)
    logger.info("registered model %s at %s", card.name, key)
    return key


class ModelWatcher:
    """Feeds a ModelManager from the discovery plane."""

    def __init__(
        self,
        runtime: Any,
        model_manager: Any,
        *,
        router_mode: RouterMode = RouterMode.KV,
        kv_router_config: Optional[KvRouterConfig] = None,
        enable_disagg: bool = True,
        prefill_component: str = "prefill",
        encode_component: str = "encoder",
        disagg_threshold_tokens: int = 32,
        enable_busy_monitor: bool = True,
        enable_canary: bool = False,
        canary_interval_s: float = 5.0,
        canary_timeout_s: float = 10.0,
        enable_liveness: bool = True,
        liveness_config: Optional[Any] = None,  # runtime.liveness.LivenessConfig
    ) -> None:
        self._runtime = runtime
        self._manager = model_manager
        self.router_mode = router_mode
        self._kv_config = kv_router_config
        self.enable_disagg = enable_disagg
        self.prefill_component = prefill_component
        self.encode_component = encode_component
        self.disagg_threshold_tokens = disagg_threshold_tokens
        self.enable_busy_monitor = enable_busy_monitor
        self.enable_canary = enable_canary
        self.canary_interval_s = canary_interval_s
        self.canary_timeout_s = canary_timeout_s
        # Crash plane: missed-load-report dead-worker detection with the
        # drop_worker + stream-abort reconciliation (runtime/liveness.py).
        self.enable_liveness = enable_liveness
        self._liveness_config = liveness_config
        # model slug → state
        self._models: Dict[str, Dict[str, Any]] = {}
        self._task: Optional[asyncio.Task] = None
        self._watch = None
        self._ready = asyncio.Event()
        # Every model's Migration counts here (a divergence: see the module
        # docstring); the frontend main sets one on its HttpService's
        # registry before start(), so that /metrics renders it.
        self.migration_metrics = MigrationMetrics()

    async def start(self) -> None:
        self._watch = self._runtime.discovery.watch(MODELS_PREFIX)
        for event in self._watch.drain_snapshot():
            await self._apply(event)
        self._ready.set()
        self._task = asyncio.get_running_loop().create_task(
            self._run(), name="model-watcher"
        )

    async def stop(self) -> None:
        if self._watch is not None:
            await self._watch.aclose()
        if self._task is not None:
            self._task.cancel()
            await reap_task(self._task, "model-watcher", logger)
        for slug in list(self._models):
            await self._remove_model(slug)

    async def wait_for_model(self, name: str, timeout: float = 10.0) -> None:
        async def poll() -> None:
            while self._manager.get(name) is None:
                await asyncio.sleep(0.05)

        await asyncio.wait_for(poll(), timeout)

    async def _run(self) -> None:
        async for event in self._watch:
            try:
                await self._apply(event)
            except Exception:
                logger.exception("model watch event failed")

    async def _apply(self, event) -> None:
        # key: models/{namespace}/{slug}/{instance_id}
        parts = event.key.split("/")
        if len(parts) != 4:
            return
        _, namespace, slug, iid_hex = parts
        from dynamo_tpu_torch.runtime.discovery import EventKind

        if event.kind == EventKind.PUT and event.value is not None:
            await self._add_instance(slug, event.value)
        elif event.kind == EventKind.DELETE:
            await self._drop_instance(slug, iid_hex)

    async def _add_instance(self, slug: str, doc: Dict[str, Any]) -> None:
        state = self._models.get(slug)
        if state is not None:
            state["instances"].add(doc["instance_id"])
            if state.get("liveness") is not None and doc.get("incarnation"):
                # Registration is evidence of life AND of identity: seed
                # the fence/last-seen now so a warm-rejoining worker's old
                # incarnation is purged before its first load report.
                state["liveness"].observe_report(
                    doc["instance_id"], doc["incarnation"]
                )
            return
        card = ModelDeploymentCard.from_dict(doc["card"])
        if card.model_type == "multimodal":
            # E/P/D staging splices encode-worker embeddings into the
            # preprocessed request (JAX: multimodal/handlers.py
            # MultimodalPreprocessor); the port has no encode stage yet.
            raise ValueError(
                f"model {card.name!r} has a multimodal card: the encode stage "
                "(MultimodalPreprocessor) is not ported yet (ROADMAP A9, "
                "multimodal)"
            )
        ep_info = doc["endpoint"]
        endpoint = (
            self._runtime.namespace(ep_info["namespace"])
            .component(ep_info["component"])
            .endpoint(ep_info["endpoint"])
        )
        client = await endpoint.client(self.router_mode)
        router = None
        if self.router_mode == RouterMode.KV:
            router = KvRouter(
                self._runtime,
                ep_info["namespace"],
                ep_info["component"],
                block_size=card.kv_block_size,
                config=self._kv_config,
            )
            await router.start()
            router.attach(client)
        tokenizer = resolve_tokenizer(card)
        operators = [
            OpenAIPreprocessor(card, tokenizer, resolve_chat_template(card)),
        ]
        migration = Migration(card.migration_limit)
        migration.metrics = self.migration_metrics
        operators += [
            Backend(tokenizer),
            migration,
        ]
        if self.enable_disagg:
            from dynamo_tpu_torch.disagg import PrefillRouter

            ns = ep_info["namespace"]

            async def prefill_client():
                return await (
                    self._runtime.namespace(ns)
                    .component(self.prefill_component)
                    .endpoint("generate")
                    .client()
                )

            operators.append(
                PrefillRouter(
                    prefill_client, threshold_tokens=self.disagg_threshold_tokens
                )
            )
        pipeline = build_pipeline(operators, client)
        monitor = None
        liveness = None
        if self.enable_liveness:
            from dynamo_tpu_torch import config as _cfg
            from dynamo_tpu_torch.runtime.liveness import (
                LivenessConfig,
                LivenessTracker,
                WorkerLostError,
            )

            liveness = LivenessTracker(
                self._liveness_config
                or LivenessConfig(
                    interval_s=_cfg.LIVENESS_INTERVAL_S.get(),
                    suspect_after=_cfg.LIVENESS_SUSPECT_AFTER.get(),
                    dead_after=_cfg.LIVENESS_DEAD_AFTER.get(),
                )
            )
            client.enable_stream_aborts()

            def on_dead(worker_id: int, _inc: int, _router=router,
                        _client=client, _liveness=liveness) -> None:
                # The whole crash-recovery fan-out for an unplanned death:
                # (1) one drop_worker reconciliation (charges, link pairs,
                # breaker faults, radix entries), (2) routing eviction
                # ahead of the discovery lease expiring, (3) every
                # in-flight stream aborted into the migration ladder with
                # the typed worker_lost reason — all bounded by the
                # missed-report budget, none of it waiting on TCP.
                if _router is not None:
                    _router.drop_worker((worker_id, 0))
                _client.evict_instance(worker_id)
                aborted = _client.abort_instance(
                    worker_id,
                    WorkerLostError(
                        f"worker {worker_id:#x} declared dead (missed "
                        "load reports); re-dispatch with carried tokens"
                    ),
                )
                if aborted:
                    _liveness.note_streams_aborted(worker_id, aborted)

            def on_rejoin(worker_id: int, _inc: int, _router=router,
                          _client=client) -> None:
                # A rejoin: purge whatever state the old incarnation left
                # so the worker's reports and KV events rebuild from a
                # clean slate (its restored prefixes arrive via the
                # re-advertised snapshot) — and give its routing capacity
                # back. A RESTARTED worker re-PUTs its key (the watch
                # re-adds fresh transport), but a frozen-and-resumed one
                # (same incarnation, no new PUT) only comes back through
                # the revive; without it the eviction would be permanent.
                if _router is not None:
                    _router.drop_worker((worker_id, 0))
                _client.revive_instance(worker_id)

            liveness.add_dead_callback(on_dead)
            liveness.add_rejoin_callback(on_rejoin)
        if self.enable_busy_monitor or liveness is not None:
            from dynamo_tpu_torch.http.worker_monitor import WorkerLoadMonitor

            monitor = WorkerLoadMonitor(
                self._runtime.event_plane, ep_info["namespace"],
                ep_info["component"], liveness=liveness,
            )
            await monitor.start()
        health = None
        if self.enable_canary:
            from dynamo_tpu_torch.runtime.health import CanaryHealthChecker

            health = CanaryHealthChecker(
                client,
                interval_s=self.canary_interval_s,
                timeout_s=self.canary_timeout_s,
            )
            health.start()
        ns, comp = ep_info["namespace"], ep_info["component"]

        async def clear_kv() -> int:
            """Fan clear_kv_blocks out to every live worker instance
            (ref: clear_kv_blocks.rs)."""
            from dynamo_tpu_torch.runtime.engine import collect

            ctl = await (
                self._runtime.namespace(ns).component(comp).endpoint("control").client()
            )
            cleared = 0
            try:
                # A divergence: over discd a new client learns its
                # instances from a watch snapshot that arrives after
                # client() returns; JAX's loop runs over the empty list
                # then and clears nothing. Wait for the snapshot.
                try:
                    await ctl.wait_for_instances(timeout=5.0)
                except asyncio.TimeoutError:
                    pass  # no live instance: nothing to clear
                for iid in list(ctl.instance_ids):
                    try:
                        out = await collect(ctl.direct({"op": "clear_kv_blocks"}, iid))
                        cleared += int(out[-1].get("cleared", 0)) if out else 0
                    except Exception:
                        logger.exception("clear_kv_blocks on %#x failed", iid)
            finally:
                await ctl.close()
            return cleared

        self._models[slug] = {
            "card": card,
            "client": client,
            "router": router,
            "monitor": monitor,
            "health": health,
            "liveness": liveness,
            "instances": {doc["instance_id"]},
        }
        if liveness is not None and doc.get("incarnation"):
            liveness.observe_report(doc["instance_id"], doc["incarnation"])
        self._manager.register(
            card.name, pipeline, card, monitor=monitor, health=health,
            admin={"clear_kv": clear_kv},
        )
        logger.info("model %s online (instance %x)", card.name, doc["instance_id"])

    async def _drop_instance(self, slug: str, iid_hex: str) -> None:
        state = self._models.get(slug)
        if state is None:
            return
        try:
            iid = int(iid_hex, 16)
        except ValueError:
            iid = None
        state["instances"].discard(iid)
        if state["router"] is not None and iid is not None:
            state["router"].remove_worker((iid, 0))
        if state.get("monitor") is not None and iid is not None:
            state["monitor"].drop_worker(iid)
        if state.get("liveness") is not None and iid is not None:
            # Discovery DELETE is the permanent departure: forget the
            # tracker entry (and its fence) so dead workers don't
            # accumulate across fleet turnover.
            state["liveness"].drop(iid)
        if not state["instances"]:
            await self._remove_model(slug)

    async def _remove_model(self, slug: str) -> None:
        state = self._models.pop(slug, None)
        if state is None:
            return
        self._manager.unregister(state["card"].name)
        if state.get("health") is not None:
            await state["health"].stop()
        if state.get("monitor") is not None:
            await state["monitor"].stop()
        if state["router"] is not None:
            await state["router"].stop()
        await state["client"].close()
        logger.info("model %s offline", state["card"].name)
