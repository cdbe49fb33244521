"""Per-process system HTTP server — the port's counterpart of
dynamo_tpu/runtime/system_server.py, on the port's http/web.py (the card's
machine has no aiohttp). Every worker process can expose it for
orchestration and debugging:

  GET  /health               aggregated health (registered sources)
  GET  /live, /healthz       liveness (the process event loop turns)
  GET  /readyz               readiness (every registered source ready)
  GET  /metrics              Prometheus text (registered collectors;
                             OpenMetrics when the scraper asks for it)
  ANY  /engine/{path}        registered engine callbacks (stats, clear)
  GET  /debug/requests[/{id}]          request-timeline summaries / one
  GET  /debug/traces[?trace_id=]       the process tracer's span ring
  GET  /debug/trajectory[/{trace_id}]  stitched request trajectories
  GET  /debug/kvcache[/prefixes]       the KV-reuse plane
  GET  /debug/perf           the perf ledger (runtime/perf_ledger.py)
  GET  /debug/memory         the HBM ledger beside the CUDA allocator
  GET  /debug/compiles       compile telemetry: the CUDA graph captures
  GET  /debug/flight         merged flight-recorder rings
  POST /debug/profile        {"action": "start"|"stop"|"status", "dir"?,
                             "seconds"?} — a torch.profiler capture

Routes whose planes the port has not yet answer 501 with a JSON ``error``
naming the ROADMAP item that brings them: ``/drain`` (the drain plane,
A11) and ``/v1/loras`` (LoRA, A7). So the registration API has no
``register_drain`` or ``register_loras`` yet.

Divergences from JAX's server: a profiler capture that fails to start or
stop answers 500 (JAX's answers 200 with ``degraded: true``, a no-op that
would hide the device), and its start and stop are awaited off the event
loop (a first start on the card takes seconds, a stop writes the trace
without the GIL, with the attached engine's device thread parked);
``/debug/memory`` and a profile cover the one device of the attached
engine, where JAX's cover every device of the process, and the memory view
has ``host_weight_cache: null`` (weight loading is ROADMAP A9).
"""

from __future__ import annotations

import asyncio
import inspect
from typing import Any, Awaitable, Callable, Dict, List, Optional, Tuple

from dynamo_tpu_torch.http import web
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# handler(body: dict) -> (status, payload)
EngineRoute = Callable[[Dict[str, Any]], Awaitable[Tuple[int, Any]]]

# The methods /engine/{path} answers (aiohttp's "*" route answers any).
ENGINE_METHODS = ("GET", "HEAD", "POST", "PUT", "PATCH", "DELETE", "OPTIONS")

# (route, methods, what is not ported, the ROADMAP item that brings it)
UNPORTED_ROUTES = (
    ("/drain", ("GET", "POST"), "the drain plane", "A11"),
    ("/v1/loras", ("GET", "POST"), "LoRA", "A7"),
    ("/v1/loras/{name}", ("DELETE",), "LoRA", "A7"),
)


def _takes_openmetrics(fn: Callable[..., str]) -> bool:
    """Does this metrics source accept an ``openmetrics`` keyword
    (metrics_core registries do; plain text lambdas don't)?"""
    try:
        return "openmetrics" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


def _merge_expositions(parts: List[str]) -> str:
    """Concatenate metric sources, collapsing duplicate family metadata.

    Two same-kind subsystem objects on one server each emit their own
    ``# HELP``/``# TYPE`` block for the same family, and Prometheus rejects
    an exposition whose metadata repeats or interleaves. Group every
    source's samples under one metadata block per family (first HELP/TYPE
    wins); sample lines pass through verbatim, so identical series from two
    sources stay visible as duplicates instead of being collapsed or summed.
    """
    order: List[str] = []
    meta: Dict[str, List[str]] = {}
    samples: Dict[str, List[str]] = {}

    def block(name: str) -> None:
        if name not in meta:
            meta[name] = []
            samples[name] = []
            order.append(name)

    for part in parts:
        current = ""  # bare samples before any metadata keep source order
        for line in part.splitlines():
            line = line.rstrip()
            if not line:
                continue
            if line.startswith("# HELP ") or line.startswith("# TYPE "):
                kind, name = line.split(None, 3)[1:3]
                block(name)
                current = name
                if not any(m.startswith(f"# {kind} ") for m in meta[name]):
                    meta[name].append(line)
            elif line.startswith("#"):
                continue  # stray comments / EOF markers from a source
            else:
                block(current)
                samples[current].append(line)
    lines: List[str] = []
    for name in order:
        lines.extend(meta[name])
        lines.extend(samples[name])
    return "\n".join(lines)


async def _json_body(request: web.Request) -> Dict[str, Any]:
    """The request's JSON object body; {} when it has none or another."""
    try:
        body = await request.json() if request.can_read_body else {}
    except ValueError:
        body = {}
    return body if isinstance(body, dict) else {}


class SystemStatusServer:
    def __init__(
        self,
        *,
        host: str = "0.0.0.0",
        port: int = 0,
        lifecycle: Any = None,  # RequestLifecycle; None = process-global
        tracer: Any = None,  # utils/tracing.Tracer; None = process-global
        trajectory: Any = None,  # TrajectoryStore; None = process-global
    ) -> None:
        self.host = host
        self.port = port
        self._lifecycle = lifecycle
        self._tracer = tracer
        self._trajectory = trajectory
        self._engine_routes: Dict[str, EngineRoute] = {}
        self._health_sources: Dict[str, Callable[[], Tuple[bool, Any]]] = {}
        # /readyz is 200 only when EVERY registered source reports ready;
        # liveness (/healthz, /live) is process-up only.
        self._ready_sources: Dict[str, Callable[[], Tuple[bool, Any]]] = {}
        # (render fn, takes-openmetrics-kwarg), classified at registration
        self._metrics_sources: List[Tuple[Callable[[], str], bool]] = []
        self._flight_sources: List[Tuple[str, Callable[[], List[Any]]]] = []
        self._memory_sources: List[Tuple[str, Callable[[], Dict[str, int]]]] = []
        self._profile_timers: set = set()  # strong refs to auto-stop tasks
        # The engine's torch.device (attach_engine): the one device
        # /debug/memory reads and a profile records. None: the CPU. And its
        # device_held, which a profile's stop runs inside.
        self.device: Any = None
        self.device_hold: Optional[Callable[[], Any]] = None
        self._runtime_metrics_registered = False
        self._server: Optional[web.Server] = None

    # -- registration ------------------------------------------------------

    def register_engine_route(self, path: str, handler: EngineRoute) -> None:
        self._engine_routes[path.strip("/")] = handler

    def register_health(self, name: str, fn: Callable[[], Tuple[bool, Any]]) -> None:
        self._health_sources[name] = fn

    def register_readiness(self, name: str, fn: Callable[[], Tuple[bool, Any]]) -> None:
        """``fn() -> (ready, detail)``; /readyz is 503 until every source
        is ready. The worker registers its registration gate here."""
        self._ready_sources[name] = fn

    def register_metrics(self, fn: Callable[[], str]) -> None:
        """fn returns Prometheus exposition-format text."""
        self._metrics_sources.append((fn, _takes_openmetrics(fn)))

    def register_flight(self, name: str, fn: Callable[[], List[Any]]) -> None:
        """fn returns a FlightRecorder snapshot (list of event dicts);
        /debug/flight merges every registered ring by timestamp."""
        self._flight_sources.append((name, fn))

    def register_memory(self, name: str, fn: Callable[[], Dict[str, int]]) -> None:
        """fn returns {category: bytes}; /debug/memory groups by source.
        Sources named ``*_detail`` are informational breakdowns of bytes
        another source already accounts for — shown, but excluded from
        ``ledger_total_bytes``."""
        self._memory_sources.append((name, fn))

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        # Process-global families, as JAX's server registers them; guarded
        # for a stop()/start().
        if not self._runtime_metrics_registered:
            from dynamo_tpu_torch.runtime.device_observe import render_runtime_metrics
            from dynamo_tpu_torch.runtime.kv_reuse_observe import render_kv_reuse_metrics
            from dynamo_tpu_torch.runtime.liveness import render_fence_metrics
            from dynamo_tpu_torch.runtime.perf_ledger import (
                global_perf_ledger,
                render_perf_metrics,
            )
            from dynamo_tpu_torch.runtime.trajectory import render_trajectory_metrics

            self.register_metrics(render_runtime_metrics)
            self.register_metrics(render_fence_metrics)
            self.register_metrics(render_trajectory_metrics)
            self.register_metrics(render_kv_reuse_metrics)
            # The perf ledger's families and its "perf" flight ring: one
            # ledger a process, which the engine feeds.
            self.register_metrics(render_perf_metrics)
            self.register_flight("perf", global_perf_ledger().flight.snapshot)
            self._runtime_metrics_registered = True
        app = web.Application()
        router = app.router
        router.add_get("/health", self._health)
        router.add_get("/live", self._live)
        router.add_get("/healthz", self._live)
        router.add_get("/readyz", self._ready)
        router.add_get("/metrics", self._metrics)
        router.add_get("/debug/requests", self._debug_requests)
        router.add_get("/debug/requests/{id}", self._debug_request)
        router.add_get("/debug/traces", self._debug_traces)
        router.add_get("/debug/trajectory", self._debug_trajectories)
        router.add_get("/debug/trajectory/{trace_id}", self._debug_trajectory)
        router.add_get("/debug/kvcache", self._debug_kvcache)
        router.add_get("/debug/kvcache/prefixes", self._debug_kvcache_prefixes)
        router.add_get("/debug/perf", self._debug_perf)
        router.add_get("/debug/memory", self._debug_memory)
        router.add_get("/debug/compiles", self._debug_compiles)
        router.add_get("/debug/flight", self._debug_flight)
        router.add_post("/debug/profile", self._debug_profile)
        for method in ENGINE_METHODS:
            router.add_route(method, "/engine/{path:.*}", self._engine)
        for path, methods, what, item in UNPORTED_ROUTES:
            for method in methods:
                router.add_route(method, path, _unported(what, item))
        self._server = web.Server(app)
        self.port = await self._server.start(self.host, self.port)
        logger.info("system status server on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._server is not None:
            await self._server.stop()
            self._server = None

    # -- handlers ----------------------------------------------------------

    async def _health(self, request: web.Request) -> web.Response:
        details: Dict[str, Any] = {}
        healthy = True
        for name, fn in self._health_sources.items():
            try:
                ok, detail = fn()
            except Exception as exc:  # a broken source is an unhealthy one
                ok, detail = False, f"health source error: {exc}"
            details[name] = detail
            healthy = healthy and ok
        return web.json_response(
            {"status": "healthy" if healthy else "unhealthy", "details": details},
            status=200 if healthy else 503,
        )

    async def _live(self, request: web.Request) -> web.Response:
        return web.json_response({"status": "live"})

    async def _ready(self, request: web.Request) -> web.Response:
        details: Dict[str, Any] = {}
        ready = True
        for name, fn in self._ready_sources.items():
            try:
                ok, detail = fn()
            except Exception as exc:  # a broken source is a not-ready one
                ok, detail = False, f"readiness source error: {exc}"
            details[name] = detail
            ready = ready and ok
        return web.json_response(
            {"status": "ready" if ready else "not_ready", "details": details},
            status=200 if ready else 503,
        )

    async def _metrics(self, request: web.Request) -> web.Response:
        openmetrics = "application/openmetrics-text" in request.headers.get("Accept", "")
        parts = []
        for fn, takes_om in self._metrics_sources:
            try:
                parts.append(fn(openmetrics=True) if openmetrics and takes_om else fn())
            except Exception:
                logger.exception("metrics source failed")
        text = _merge_expositions([p for p in parts if p])
        if openmetrics:
            return web.Response(text=text + "\n# EOF\n",
                                content_type="application/openmetrics-text")
        return web.Response(text=text + "\n", content_type="text/plain")

    # -- debug surface (lifecycle timelines + trace ring) ------------------

    def _lifecycle_obj(self):
        if self._lifecycle is None:
            from dynamo_tpu_torch.runtime.lifecycle import global_lifecycle

            self._lifecycle = global_lifecycle()
        return self._lifecycle

    def _tracer_obj(self):
        if self._tracer is None:
            from dynamo_tpu_torch.utils.tracing import global_tracer

            self._tracer = global_tracer()
        return self._tracer

    async def _debug_requests(self, request: web.Request) -> web.Response:
        lc = self._lifecycle_obj()
        return web.json_response({
            "slow_threshold_s": lc.slow_threshold_s,
            "requests": [tl.summary() for tl in lc.timelines()],
            "slow": [tl.request_id for tl in lc.slow_timelines()],
        })

    async def _debug_request(self, request: web.Request) -> web.Response:
        rid = request.match_info["id"]
        tl = self._lifecycle_obj().get(rid)
        if tl is None:
            return web.json_response({"error": f"no timeline for request {rid!r}"}, status=404)
        return web.json_response(tl.to_dict())

    async def _debug_traces(self, request: web.Request) -> web.Response:
        """The span ring, or with ?trace_id= only that trace's spans."""
        want = request.query.get("trace_id")
        spans = self._tracer_obj().finished_spans()
        if want:
            spans = [s for s in spans if s.trace_id == want]
        return web.json_response({"spans": [s.to_dict() for s in spans]})

    # -- trajectory plane (runtime/trajectory.py) --------------------------

    def _trajectory_obj(self):
        if self._trajectory is None:
            from dynamo_tpu_torch.runtime.trajectory import global_store

            self._trajectory = global_store()
        return self._trajectory

    async def _debug_trajectories(self, request: web.Request) -> web.Response:
        from dynamo_tpu_torch.runtime.trajectory import trajectory_index

        return web.json_response(trajectory_index(self._trajectory_obj()))

    async def _debug_trajectory(self, request: web.Request) -> web.Response:
        from dynamo_tpu_torch.runtime.trajectory import trajectory_view

        tid = request.match_info["trace_id"]
        stitched = trajectory_view(tid, self._trajectory_obj())
        if stitched is None:
            return web.json_response({"error": f"no trajectory for trace {tid!r}"}, status=404)
        return web.json_response(stitched)

    # -- KV-reuse plane (runtime/kv_reuse_observe.py) ----------------------

    async def _debug_kvcache(self, request: web.Request) -> web.Response:
        from dynamo_tpu_torch.runtime.kv_reuse_observe import kvcache_index

        try:
            top_k = int(request.query.get("top_k", "10"))
        except ValueError:
            top_k = 10
        return web.json_response(kvcache_index(top_k=top_k))

    async def _debug_kvcache_prefixes(self, request: web.Request) -> web.Response:
        from dynamo_tpu_torch.runtime.kv_reuse_observe import kvcache_prefixes

        try:
            k = int(request.query.get("k", "50"))
        except ValueError:
            k = 50
        return web.json_response(kvcache_prefixes(k=k))

    # -- perf ledger (runtime/perf_ledger.py) ------------------------------

    async def _debug_perf(self, request: web.Request) -> web.Response:
        from dynamo_tpu_torch.runtime.perf_ledger import perf_index

        return web.json_response(perf_index())

    # -- device plane (runtime/device_observe.py) --------------------------

    async def _debug_compiles(self, request: web.Request) -> web.Response:
        from dynamo_tpu_torch.runtime.device_observe import global_compile_watcher

        return web.json_response(global_compile_watcher().snapshot())

    async def _debug_memory(self, request: web.Request) -> web.Response:
        from dynamo_tpu_torch.runtime.device_observe import device_memory_stats

        sources: Dict[str, Dict[str, int]] = {}
        total = 0
        for name, fn in self._memory_sources:
            try:
                snap = fn()
            except Exception as exc:
                snap = {"error": f"{type(exc).__name__}: {exc}"}  # type: ignore[dict-item]
            sources[name] = snap
            if not name.endswith("_detail"):
                total += sum(v for v in snap.values() if isinstance(v, int) and v > 0)
        body: Dict[str, Any] = {
            "sources": sources,
            "ledger_total_bytes": total,
            "devices": device_memory_stats(self.device),
            "host_weight_cache": None,  # weight loading is ROADMAP A9
        }
        # Unaccounted = the engine's device's allocator in-use minus
        # everything the ledger names (JAX's multi-device note has no case
        # here: a worker's engine has one device).
        stats = body["devices"][0]["memory_stats"]
        if stats and stats.get("bytes_in_use"):
            body["device_bytes_in_use"] = stats["bytes_in_use"]
            body["unaccounted_bytes"] = stats["bytes_in_use"] - total
        return web.json_response(body)

    async def _debug_flight(self, request: web.Request) -> web.Response:
        """Merged flight-recorder rings, timestamp-ordered. Query params:
        ?limit=N (newest N after the merge), ?kind=dispatch (filter)."""
        events: List[Any] = []
        rings = []
        for name, fn in self._flight_sources:
            rings.append(name)
            try:
                events.extend(fn())
            except Exception:
                logger.exception("flight source %s failed", name)
        want_kind = request.query.get("kind")
        if want_kind:
            events = [e for e in events if e.get("kind") == want_kind]
        events.sort(key=lambda e: e.get("t_mono", 0.0))
        try:
            limit = int(request.query.get("limit", "0"))
        except ValueError:
            limit = 0
        if limit > 0:
            events = events[-limit:]
        return web.json_response({"rings": rings, "events": events})

    async def _debug_profile(self, request: web.Request) -> web.Response:
        from dynamo_tpu_torch.runtime.device_observe import global_profiler

        body = await _json_body(request)
        action = str(body.get("action", "status"))
        profiler = global_profiler()
        if action == "status":
            return web.json_response(profiler.status())
        if action not in ("start", "stop"):
            return web.json_response(
                {"error": f"unknown action {action!r} (start|stop|status)"}, status=400)
        seconds: Optional[float] = None
        if action == "start" and body.get("seconds") is not None:
            # Validated before the capture starts: a bad value after the
            # start would leave a capture that nothing stops.
            try:
                seconds = float(body["seconds"])
            except (TypeError, ValueError):
                seconds = float("nan")
            if not 0 < seconds < float("inf"):  # NaN fails; inf never fires
                return web.json_response(
                    {"error": f"bad seconds {body['seconds']!r} "
                              "(need a positive finite number)"}, status=400)
        # Awaited off the event loop, on the profiler's thread: a first start
        # on the card takes seconds, and a stop writes the trace.
        try:
            result = await asyncio.wrap_future(
                profiler.start(body.get("dir"), self.device) if action == "start"
                else profiler.stop(self.device_hold))
        except Exception as exc:
            logger.exception("profiler %s failed", action)
            return web.json_response(
                {"ok": False, "error": f"{type(exc).__name__}: {exc}"}, status=500)
        if action == "start" and result.get("ok") and seconds:
            self._auto_stop(profiler, result["generation"], seconds)
            result["auto_stop_s"] = seconds
        return web.json_response(result, status=200 if result.get("ok") else 409)

    def _auto_stop(self, profiler: Any, generation: int, seconds: float) -> None:
        """Stop capture ``generation`` after ``seconds``, unless it already
        stopped: a manual stop and a fresh start meanwhile (even into the
        same dir) must not have that capture killed by this timer."""

        async def stop_later() -> None:
            await asyncio.sleep(seconds)
            status = profiler.status()
            if status.get("active") and status.get("generation") == generation:
                stopped = await asyncio.wrap_future(profiler.stop(self.device_hold))
                logger.info("auto-stopped profiler capture: %s", stopped)

        # Held strongly: the loop keeps only weak task refs, and a GC'd
        # timer would leave the capture unbounded.
        task = asyncio.get_running_loop().create_task(stop_later())
        self._profile_timers.add(task)
        task.add_done_callback(self._profile_timers.discard)

    async def _engine(self, request: web.Request) -> web.Response:
        path = request.match_info["path"].strip("/")
        handler = self._engine_routes.get(path)
        if handler is None:
            return web.json_response(
                {"error": f"no engine route {path!r}", "routes": sorted(self._engine_routes)},
                status=404,
            )
        body = await _json_body(request)
        try:
            status, payload = await handler(body)
        except Exception as exc:
            logger.exception("engine route %s failed", path)
            return web.json_response({"error": str(exc)}, status=500)
        return web.json_response(payload, status=status)


def _unported(what: str, item: str) -> web.Handler:
    async def refuse(request: web.Request) -> web.Response:
        return web.json_response(
            {"error": f"{what} is not ported (ROADMAP {item})"}, status=501)

    return refuse


def engine_stats_prometheus(stats: Dict[str, Any]) -> str:
    """Engine stats dict → Prometheus gauges with canonical names
    (runtime/metric_names.engine_gauge). Nested dict stats flatten into
    ``<prefix>_<key>_<subkey>`` gauges."""
    from dynamo_tpu_torch.runtime.metric_names import engine_gauge

    lines: List[str] = []

    def emit(name: str, value: float, source: str) -> None:
        lines.append(f"# HELP {name} Engine stat {source!r} (engine.stats())")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {float(value)}")

    def numeric(value: Any) -> bool:
        return not isinstance(value, bool) and isinstance(value, (int, float))

    for key, value in stats.items():
        if isinstance(value, dict):
            for sub, sv in value.items():
                if numeric(sv):
                    emit(engine_gauge(f"{key}_{sub}"), sv, f"{key}.{sub}")
            continue
        if numeric(value):
            emit(engine_gauge(key), value, key)
    return "\n".join(lines)


def attach_engine(server: SystemStatusServer, engine: Any) -> None:
    """Register a TorchEngine's admin surface on the system server: the
    ``stats`` and ``clear_kv_blocks`` routes, its health, its stats gauges,
    its step metrics, its HBM ledger (``/debug/memory`` and its gauges) and
    the KV pool's byte split (``kv_pool_detail``). JAX's also registers
    sleep/wake, the KV checkpoint, LoRA and the engine's flight rings, which
    the port's engine does not have yet."""

    async def _stats(body: Dict[str, Any]):
        return 200, engine.stats()

    async def _clear(body: Dict[str, Any]):
        return 200, {"cleared_blocks": engine.clear_kv_blocks()}

    server.device = engine.runner.device
    server.device_hold = engine.device_held
    server.register_engine_route("stats", _stats)
    server.register_engine_route("clear_kv_blocks", _clear)

    def _engine_health():
        failure = getattr(engine, "_failure", None)
        if failure is not None:
            return False, f"engine failed: {failure}"
        return True, "serving"

    server.register_health("engine", _engine_health)
    server.register_metrics(lambda: engine_stats_prometheus(engine.stats()))
    engine.step_metrics.register_metrics(server)
    server.register_memory("engine", engine.hbm.snapshot)
    server.register_metrics(engine.hbm.registry.render)
    # Informational split of the ledger's kv_cache bytes (active vs
    # reusable-cached vs free vs sink) — "_detail" keeps it out of the total.
    server.register_memory("kv_pool_detail", engine.kv_pool_bytes_breakdown)
