"""The port's system server (runtime/system_server.py, on http/web.py)
against the JAX package's (on aiohttp), over sockets:

  - every route, with the same registered sources and the same requests,
    gives the same status, content type and JSON body (times, ids and the
    profiler's directories masked): the probes, /health, /metrics (text
    and OpenMetrics, equal line for line for the same registries, the
    process-global families of both servers swapped for empty ones), the
    request timelines, traces, trajectories, the KV-reuse plane, the perf
    ledger (/debug/perf) and the compile watcher (/debug/compiles) fed the
    same observations, /debug/memory, /debug/flight (the perf ledgers'
    rings merged in), /debug/profile's state machine (a 409 on a second
    start, a 400 on bad ``seconds``, an auto-stop that stops only its own
    capture) and /engine/{path};
  - on a host with two cards, /debug/memory reads the attached engine's
    card alone, with its unaccounted bytes;
  - the routes of unported planes (drain, LoRA) answer 501 naming their
    ROADMAP items;
  - ``engine_stats_prometheus`` gives JAX's text for the same dict;
  - ``attach_engine`` over a TorchEngine and a JaxEngine on the same tiny
    weights and requests: the same health, clear and ledger categories, the
    port's ``kv_cache`` one sink block a pool above JAX's and its
    ``slot_state`` in its own widths (the rules stated below);
  - the worker main with ``--system-port 0``: /live at once, /readyz 503
    while ``engine.start()`` is held by a gate and 200 once it serves, then
    the step, perf and compile families on /metrics and the perf ring on
    /debug/flight;
  - the CLI: delegation to the mains, ``env``, and ``observe kvcache`` /
    ``observe trajectory`` / ``observe perf`` / ``observe`` (the device
    plane) printing what JAX's CLI prints for a live port worker.
Each test that starts servers or processes keeps its own deadline."""

import argparse
import asyncio
import contextlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest
import torch

from dynamo_tpu.cli import run as jrun
from dynamo_tpu.runtime import device_observe as jdo
from dynamo_tpu.runtime import kv_reuse_observe as jkv
from dynamo_tpu.runtime import lifecycle as jlifecycle
from dynamo_tpu.runtime import liveness as jliveness
from dynamo_tpu.runtime import metrics_core as jmetrics
from dynamo_tpu.runtime import perf_ledger as jperf
from dynamo_tpu.runtime import system_server as jss
from dynamo_tpu.runtime import trajectory as jtrajectory
from dynamo_tpu.utils import tracing as jtracing
from dynamo_tpu_torch import config as tconfig
from dynamo_tpu_torch.cli import __main__ as tcli
from dynamo_tpu_torch.cli import run as trun
from dynamo_tpu_torch.llm.protocols import common as tproto
from dynamo_tpu_torch.runtime import device_observe as tdo
from dynamo_tpu_torch.runtime import kv_reuse_observe as tkv
from dynamo_tpu_torch.runtime import lifecycle as tlifecycle
from dynamo_tpu_torch.runtime import liveness as tliveness
from dynamo_tpu_torch.runtime import metrics_core as tmetrics
from dynamo_tpu_torch.runtime import perf_ledger as tperf
from dynamo_tpu_torch.runtime import system_server as tss
from dynamo_tpu_torch.runtime import trajectory as ttrajectory
from dynamo_tpu_torch.runtime.context import Context as TContext
from dynamo_tpu_torch.runtime.device_observe import FlightRecorder as TFlight
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime as TRuntime
from dynamo_tpu_torch.utils import tracing as ttracing
from dynamo_tpu_torch.worker import __main__ as tworker
from tests.test_torch_device_observe import two_cards  # noqa: F401  (the fixture)
from tests.test_torch_http_service import call
from tests.test_torch_kv_events import JAX, PROMPTS, TORCH, _jax_engine, _torch_engine, _traffic
from tests.test_torch_kv_events import weights  # noqa: F401  (the fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 60.0  # each process test's own bound
JAX_PKG = argparse.Namespace(name="jax", ss=jss, metrics=jmetrics, lifecycle=jlifecycle,
                             tracing=jtracing, trajectory=jtrajectory, Flight=jdo.FlightRecorder)
PORT_PKG = argparse.Namespace(name="port", ss=tss, metrics=tmetrics, lifecycle=tlifecycle,
                              tracing=ttracing, trajectory=ttrajectory, Flight=TFlight)


def _masked(obj):
    """Floats, ids and directories masked: what stays must be equal."""
    if isinstance(obj, dict):
        return {k: ("<id>" if k in ("trace_id", "span_id", "parent_id") and v else
                    "<dir>" if k in ("dir", "trace") and isinstance(v, str) else _masked(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_masked(v) for v in obj]
    return "<f>" if isinstance(obj, float) else obj


def _view(response):
    status, headers, body = response
    ctype = headers.get("content-type", "")
    json_body = body and ctype.startswith("application/json")
    content = _masked(json.loads(body)) if json_body else body
    if "openmetrics" in ctype or ctype.startswith("text/plain"):
        # A bucket bound is written as prometheus_client writes it (5.0),
        # where JAX's runtime registries write 5: compared as numbers.
        content = re.sub(rb'le="([^"]+)"', lambda m: b'le="%r"' % float(m.group(1)), body)
    return status, ctype, headers.get("allow"), content


@pytest.fixture
def fresh_globals(monkeypatch):
    """Each package's process-global families rendered empty, a fresh
    KV-reuse plane and no process name for spans: what other tests in this
    process did does not show."""
    empty = lambda openmetrics=False: ""  # noqa: E731
    for module, name in ((jdo, "render_runtime_metrics"), (jliveness, "render_fence_metrics"),
                         (jtrajectory, "render_trajectory_metrics"),
                         (jkv, "render_kv_reuse_metrics"), (jperf, "render_perf_metrics"),
                         (tdo, "render_runtime_metrics"), (tliveness, "render_fence_metrics"),
                         (ttrajectory, "render_trajectory_metrics"),
                         (tkv, "render_kv_reuse_metrics"), (tperf, "render_perf_metrics")):
        monkeypatch.setattr(module, name, empty)
    monkeypatch.setattr(jkv, "_PLANE", jkv.KvReusePlane())
    monkeypatch.setattr(tkv, "_PLANE", tkv.KvReusePlane())
    # fresh perf ledgers and compile watchers, fed the same observations
    jdo.global_profiler()  # JAX makes its two process globals together
    for perf, do in ((jperf, jdo), (tperf, tdo)):
        led = perf.PerfLedger()
        led.configure(preset="tiny-llama", backend="cuda", host="h")
        for i in range(3):
            led.observe_decode(4, "w4", "fallback", 0.01 + i / 1000, 8, 2, 50.0 + i, 0.0,
                               0.001, 0.0002)
        led.observe_prefill(32, 0.004, 30)
        led.flight.record("fingerprint_load", path="x", loaded=0)
        monkeypatch.setattr(perf, "_LEDGER", led)
        watcher = do.CompileWatcher()
        watcher.set_budget("runner.decode_state", 18)
        watcher.program("runner.decode_state").on_compile(1, 0.25)
        monkeypatch.setattr(do, "_WATCHER", watcher)
    # A main run in this process earlier (another test) named it: spans
    # carry the pid default again.
    monkeypatch.setattr(jtracing, "_SERVICE", None)
    monkeypatch.setattr(ttracing, "_SERVICE", None)


def _registries(pkg):
    """Two registries sharing a family (merged under one HELP/TYPE), a
    plain text source, and a source that fails."""
    a, b = pkg.metrics.MetricsRegistry(), pkg.metrics.MetricsRegistry()
    c = a.counter("dynamo_tpu_test_requests_total", "Requests", ["route"])
    c.inc(3, route="a")
    c.inc(route="b")
    a.gauge("dynamo_tpu_test_depth", "Depth", ["src"]).set(2.5, src="a")
    b.gauge("dynamo_tpu_test_depth", "Depth", ["src"]).set(4, src="b")
    h = a.histogram("dynamo_tpu_test_seconds", "Seconds", buckets=(0.1, 1.0, 5.0))
    for v in (0.05, 0.5, 2.0, 9.0):
        h.observe(v)
    return [a.render, b.render, lambda: "dynamo_tpu_test_plain 1\n", lambda: 1 // 0]


class Servers:
    """JAX's server and the port's, each over its own package's copies of
    the same sources."""

    def __init__(self, ready):
        self.ready = ready
        self.servers, self.objs = [], []
        for pkg in (JAX_PKG, PORT_PKG):
            lc = pkg.lifecycle.RequestLifecycle(slow_threshold_s=60.0)
            for event in ("received", "routed", "first_token", "finished"):
                lc.record("r1", event, worker="0x1")
            tracer = pkg.tracing.Tracer(otlp=False)
            with tracer.span("op.a", None, k=1):
                pass
            store = pkg.trajectory.TrajectoryStore()
            server = pkg.ss.SystemStatusServer(host="127.0.0.1", port=0, lifecycle=lc,
                                               tracer=tracer, trajectory=store)
            server.register_health("ok", lambda: (True, "fine"))
            server.register_health("broken", lambda: 1 // 0)
            server.register_readiness("gate", lambda: (self.ready["ready"], "gated"))
            for fn in _registries(pkg):
                server.register_metrics(fn)
            server.register_memory("engine", lambda: {"kv_cache": 100, "params": 50, "x": -1})
            server.register_memory("kv_pool_detail", lambda: {"active_bytes": 60})
            server.register_memory("broken", lambda: 1 // 0)
            flight = pkg.Flight("engine", capacity=4)
            for i in range(6):
                flight.record("dispatch" if i % 2 else "reap", nb=i)
            server.register_flight(flight.name, flight.snapshot)

            async def echo(body):
                return 200, {"got": body}

            async def boom(body):
                raise ValueError("boom")

            server.register_engine_route("echo", echo)
            server.register_engine_route("/a/b/", echo)
            server.register_engine_route("boom", boom)
            self.servers.append(server)
            self.objs.append(tracer)

    async def __aenter__(self):
        for s in self.servers:
            await s.start()
        return self

    async def __aexit__(self, *exc):
        for s in self.servers:
            await s.stop()

    async def both(self, method, path, body=None, headers=None):
        return [await asyncio.to_thread(call, s.port, method, path, body, headers)
                for s in self.servers]


ROUTES = [
    ("GET", "/live", None, None), ("HEAD", "/live", None, None), ("GET", "/healthz", None, None),
    ("GET", "/health", None, None), ("POST", "/health", {}, None), ("GET", "/nope", None, None),
    ("GET", "/metrics", None, None),
    ("GET", "/metrics", None, {"Accept": "application/openmetrics-text; version=1.0.0"}),
    ("GET", "/debug/requests", None, None), ("GET", "/debug/requests/r1", None, None),
    ("GET", "/debug/requests/nope", None, None), ("GET", "/debug/traces", None, None),
    ("GET", "/debug/traces?trace_id=nope", None, None),
    ("GET", "/debug/trajectory", None, None), ("GET", "/debug/trajectory/abc", None, None),
    ("GET", "/debug/kvcache", None, None), ("GET", "/debug/kvcache?top_k=x", None, None),
    ("GET", "/debug/kvcache/prefixes?k=3", None, None),
    ("GET", "/debug/perf", None, None), ("GET", "/debug/compiles", None, None),
    ("GET", "/engine/echo", None, None), ("POST", "/engine/echo", {"x": 1}, None),
    ("PUT", "/engine/echo", {"y": [2]}, None), ("POST", "/engine/echo", [1, 2], None),
    ("POST", "/engine/echo", b"{not json", None), ("DELETE", "/engine/a/b", None, None),
    ("GET", "/engine/nope", None, None), ("GET", "/engine/", None, None),
    ("POST", "/engine/boom", {}, None), ("GET", "/engine", None, None),
]


async def test_each_route_answers_as_jaxs_for_the_same_sources(fresh_globals):
    ready = {"ready": False}
    async with asyncio.timeout(DEADLINE_S):
        async with Servers(ready) as s:
            for method, path, body, headers in ROUTES:
                got = await s.both(method, path, body, headers)
                assert _view(got[1]) == _view(got[0]), (method, path)
            # /readyz 503 until the source says ready
            for want in (503, 200):
                got = await s.both("GET", "/readyz")
                assert _view(got[1]) == _view(got[0]) and got[1][0] == want
                ready["ready"] = True
            # the traces of one trace id (each package drew its own ids)
            tids = [t.finished_spans()[0].trace_id for t in s.objs]
            got = [await asyncio.to_thread(call, srv.port, "GET", f"/debug/traces?trace_id={t}")
                   for srv, t in zip(s.servers, tids)]
            assert _view(got[1]) == _view(got[0])
            assert len(json.loads(got[1][2])["spans"]) == 1
            # /debug/memory: the same body; the port has one cpu device
            got = [json.loads(b) for _, _, b in await s.both("GET", "/debug/memory")]
            devices = [g.pop("devices") for g in got]
            assert got[1].pop("host_weight_cache") is None  # weight loading is ROADMAP A9
            got[0].pop("host_weight_cache")
            assert got[1] == got[0] and got[1]["ledger_total_bytes"] == 150
            assert devices[1] == [{"id": 0, "platform": "cpu", "memory_stats": None}]
            assert {d["platform"] for d in devices[0]} == {"cpu"}
            # /debug/flight: both servers merge their perf ledger's ring
            for query in ("", "?limit=2", "?kind=reap", "?kind=fingerprint_load", "?limit=x"):
                got = [json.loads(b) for _, _, b in await s.both("GET", "/debug/flight" + query)]
                assert _masked(got[1]) == _masked(got[0]) and got[1]["events"], query
                assert got[1]["rings"] == ["engine", "perf"]
            perf = json.loads((await s.both("GET", "/debug/perf"))[1][2])
            assert perf["decode"][0]["samples"] == 3 and perf["prefill"]["32"]["samples"] == 1
            compiles = json.loads((await s.both("GET", "/debug/compiles"))[1][2])
            assert compiles["totals"]["compiles"] == 1
            metrics = (await s.both("GET", "/metrics"))[1][2].decode()
            assert metrics.count("# HELP dynamo_tpu_test_depth ") == 1


async def test_memory_view_reads_the_attached_engines_card_alone(two_cards):  # noqa: F811
    server = tss.SystemStatusServer(host="127.0.0.1", port=0)
    server.device = torch.device("cuda", 1)  # as attach_engine sets it
    server.register_memory("engine", lambda: {"params": 500, "kv_cache": 300})
    await server.start()
    try:
        async with asyncio.timeout(DEADLINE_S):
            _, _, raw = await asyncio.to_thread(call, server.port, "GET", "/debug/memory")
    finally:
        await server.stop()
    body = json.loads(raw)
    assert [d["id"] for d in body["devices"]] == [1]
    assert body["device_bytes_in_use"] == 2000 and body["unaccounted_bytes"] == 1200
    assert "unaccounted_note" not in body


async def test_unported_routes_answer_501_naming_their_item():
    """/drain and /v1/loras; /debug/perf and /debug/compiles are served."""
    server = tss.SystemStatusServer(host="127.0.0.1", port=0)
    await server.start()
    try:
        for path, methods, what, item in tss.UNPORTED_ROUTES:
            for method in methods:
                url = path.replace("{name}", "adapter")
                status, headers, body = await asyncio.to_thread(
                    call, server.port, method, url, {} if method == "POST" else None)
                assert status == 501, (method, url)
                assert json.loads(body) == {"error": f"{what} is not ported (ROADMAP {item})"}
        assert {p for p, *_ in tss.UNPORTED_ROUTES} == {"/drain", "/v1/loras", "/v1/loras/{name}"}
        for path in ("/debug/perf", "/debug/compiles"):
            assert (await asyncio.to_thread(call, server.port, "GET", path))[0] == 200
    finally:
        await server.stop()


async def _profile_script(port, tmp):
    """The /debug/profile requests of the state machine: (status, body)."""
    out = []

    async def post(body):
        status, _, raw = await asyncio.to_thread(call, port, "POST", "/debug/profile", body)
        out.append((status, json.loads(raw)))
        return out[-1][1]

    base = await post({"action": "status"})
    await post(None)  # no body: status
    await post(b"{broken")  # not JSON: status
    await post({"action": "stop"})  # nothing to stop: 409
    for bad in ("abc", -1, 0, "inf", "nan", [1]):
        await post({"action": "start", "seconds": bad, "dir": str(tmp / "bad")})
    await post({"action": "bogus"})
    await post({"action": "start", "dir": str(tmp / "d1")})
    await post({"action": "start", "dir": str(tmp / "d2")})  # one at a time: 409
    stopped = dict(await post({"action": "stop"}))
    # a bounded capture stopped by hand, then a new one that its timer leaves
    await post({"action": "start", "dir": str(tmp / "d3"), "seconds": 0.3})
    await post({"action": "stop"})
    await post({"action": "start", "dir": str(tmp / "d4")})
    await asyncio.sleep(0.6)
    await post({"action": "status"})  # d4 still active
    await post({"action": "stop"})
    # a bounded capture that its timer stops
    await post({"action": "start", "dir": str(tmp / "d5"), "seconds": 0.2})
    for _ in range(250):
        status = json.loads((await asyncio.to_thread(
            call, port, "POST", "/debug/profile", {"action": "status"}))[2])
        if not status["active"]:
            break
        await asyncio.sleep(0.02)
    out.append((200, status))
    # counts from this script's start: the profilers are process-global
    for _, body in out:
        for k in ("generation", "captures"):
            if k in body:
                body[k] -= base[k]
        body.pop("activities", None)  # the port's: which activities it records
        body.pop("trace", None)  # the port's: the Chrome trace it wrote
    return out, stopped


async def test_profile_routes_run_jaxs_state_machine(tmp_path):
    results = []
    async with asyncio.timeout(DEADLINE_S):
        for pkg in (JAX_PKG, PORT_PKG):
            server = pkg.ss.SystemStatusServer(host="127.0.0.1", port=0)
            await server.start()
            try:
                results.append(await _profile_script(server.port, tmp_path / pkg.name))
            finally:
                await server.stop()
    (jax_out, _), (port_out, stopped) = results
    assert [(s, _masked(b)) for s, b in port_out] == [(s, _masked(b)) for s, b in jax_out]
    assert [s for s, _ in port_out] == [200, 200, 200, 409] + [400] * 7 + [
        200, 409, 200, 200, 200, 200, 200, 200, 200, 200]
    assert port_out[-1][1] == {"active": False, "dir": None, "captures": 4, "generation": 4}
    assert port_out[-4][1]["active"] and port_out[-4][1]["dir"].endswith("d4")
    assert os.path.exists(stopped["trace"])


def test_engine_stats_prometheus_is_jaxs():
    stats = {"active_seqs": 3, "kv_usage": 0.25, "draining": 0, "flag": True, "name": "x",
             "nested": {"a": 1, "b": 2.5, "c": "no", "d": False}, "none": None,
             "graph_capture_ms": 12.75}
    assert tss.engine_stats_prometheus(stats) == jss.engine_stats_prometheus(stats)
    texts = ["# HELP a x\n# TYPE a gauge\na 1\n", "a 2\n# EOF\n", "# HELP b y\nb{l=\"1\"} 3",
             "# TYPE a gauge\n# HELP a other\na 4\n"]
    assert tss._merge_expositions(texts) == jss._merge_expositions(texts)


async def test_attach_engine_over_both_engines_on_the_same_weights(weights):  # noqa: F811
    jeng, teng = _jax_engine(weights), _torch_engine(weights)
    servers = [jss.SystemStatusServer(host="127.0.0.1", port=0),
               tss.SystemStatusServer(host="127.0.0.1", port=0)]
    try:
        async with asyncio.timeout(DEADLINE_S):
            await _traffic(jeng, JAX, "prefixes")
            await _traffic(teng, TORCH, "prefixes")
            for ss, server, engine in zip((jss, tss), servers, (jeng, teng)):
                ss.attach_engine(server, engine)
                await server.start()

            async def both(method, path):
                return [await asyncio.to_thread(call, s.port, method, path) for s in servers]

            assert set(servers[1]._engine_routes) == {"stats", "clear_kv_blocks"}
            # the engine's one device, and the hold a profile's stop runs in
            assert servers[1].device == teng.runner.device
            assert servers[1].device_hold == teng.device_held
            assert set(servers[1]._engine_routes) <= set(servers[0]._engine_routes)
            got = await both("GET", "/health")
            assert _view(got[1]) == _view(got[0])
            assert json.loads(got[1][2]) == {"status": "healthy", "details": {"engine": "serving"}}
            stats = [json.loads(b) for _, _, b in await both("GET", "/engine/stats")]
            assert stats[1] == json.loads(json.dumps(teng.stats()))
            for k in ("active_seqs", "waiting", "kv_usage", "free_blocks", "cached_blocks",
                      "total_blocks", "prefill_tokens", "generated_tokens", "preemptions"):
                assert stats[1][k] == stats[0][k], k
            mem = [json.loads(b) for _, _, b in await both("GET", "/debug/memory")]
            j, t = mem[0]["sources"]["engine"], mem[1]["sources"]["engine"]
            assert list(t) == list(j)
            nb = jeng.args.num_kv_blocks
            # the sink rule: each pool holds NB + 1 blocks where JAX's hold NB
            assert t["kv_cache"] * nb == j["kv_cache"] * (nb + 1)
            # the port's slot state: no adapter ids; tokens, salts and bias
            # ids in int64 where JAX's are int32
            jst = jeng.runner.slot_state
            widened = sum(jst[k].nbytes for k in ("tokens", "salts", "bias_ids"))
            assert t["slot_state"] == j["slot_state"] - jst["adapter_ids"].nbytes + widened
            for k in ("params", "slot_tables", "lora", "proc_state"):
                assert t[k] == j[k], k
            jd, td = mem[0]["sources"]["kv_pool_detail"], mem[1]["sources"]["kv_pool_detail"]
            for k in ("active_bytes", "cached_bytes", "free_bytes"):
                assert td[k] == jd[k], k
            assert td["total_bytes"] == t["kv_cache"] == (
                td["active_bytes"] + td["cached_bytes"] + td["free_bytes"] + td["sink_bytes"])
            assert mem[1]["ledger_total_bytes"] == sum(v for v in t.values() if v > 0)
            metrics = [b.decode() for _, _, b in await both("GET", "/metrics")]
            for line in tss.engine_stats_prometheus(teng.stats()).splitlines():
                if not line.startswith("#") and "_graph" not in line:
                    assert line in metrics[1], line
            for category in j:
                for text in metrics:
                    assert f'dynamo_tpu_runtime_hbm_bytes{{category="{category}"}}' in text
            cleared = [json.loads(b) for _, _, b in await both("POST", "/engine/clear_kv_blocks")]
            assert cleared[1] == cleared[0] and cleared[1]["cleared_blocks"] > 0
    finally:
        for server in servers:
            await server.stop()
        for engine in (jeng, teng):
            await engine.stop()


GATED_WORKER = """import asyncio, os, sys
sys.path.insert(0, {root!r})
from dynamo_tpu_torch.engines.gpu import engine as e
start = e.TorchEngine.start

async def gated(self):
    while not os.path.exists({gate!r}):
        await asyncio.sleep(0.02)
    await start(self)

e.TorchEngine.start = gated
from dynamo_tpu_torch.worker import __main__ as worker
asyncio.run(worker.main())
"""


def _get(port, path):
    status, headers, body = call(port, "GET", path)
    return status, json.loads(body) if headers.get("content-type", "").startswith(
        "application/json") else body.decode()


def test_worker_main_serves_its_system_server_ready_once_serving(tmp_path):
    """``--system-port 0``: the server prints its port before the engine
    starts; /live and /healthz answer at once; /readyz is 503 while a gate
    holds ``engine.start()`` and 200 once the worker serves; /metrics then
    carries the engine's, its step metrics', the HBM ledger's and the
    process-global families (the perf ledger's and the compile watcher's
    among them) and the overload controller's; SIGTERM ends it with exit
    0."""
    gate = str(tmp_path / "gate")
    script = tmp_path / "gated_worker.py"
    script.write_text(GATED_WORKER.format(root=ROOT, gate=gate))
    env = {**os.environ, "PYTHONUNBUFFERED": "1", "DYN_TPU_DISCOVERY": "memory",
           "DYN_TPU_EVENT_PLANE": "memory", "DYN_TPU_GRACE_PERIOD": "2"}
    proc = subprocess.Popen([sys.executable, str(script), "--model", "tiny", "--device", "cpu",
                             "--num-kv-blocks", "64", "--max-model-len", "256",
                             "--system-port", "0"], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + DEADLINE_S
    lines = []
    try:
        def wait_for(pattern):
            while time.monotonic() < deadline:
                line = proc.stdout.readline()
                assert line, "exited: " + "".join(lines)[-3000:]
                lines.append(line)
                m = re.search(pattern, line)
                if m:
                    return m
            raise AssertionError(f"{pattern!r} not seen: " + "".join(lines)[-3000:])

        port = int(wait_for(r"^system server on :(\d+)$").group(1))
        assert _get(port, "/live") == (200, {"status": "live"})
        assert _get(port, "/healthz") == (200, {"status": "live"})
        for _ in range(3):
            assert _get(port, "/readyz") == (503, {"status": "not_ready",
                                                   "details": {"worker": "starting engine"}})
            time.sleep(0.1)
        assert not any("worker serving" in line for line in lines)
        open(gate, "w").close()
        wait_for(r"worker serving tiny-llama as dynamo/backend/generate")
        status, body = _get(port, "/readyz")
        assert status == 200 and body["status"] == "ready"
        assert re.fullmatch(r"serving \(incarnation 0x[0-9a-f]+\)", body["details"]["worker"])
        assert _get(port, "/health") == (200, {"status": "healthy",
                                               "details": {"engine": "serving"}})
        _, metrics = _get(port, "/metrics")
        for family in ("dynamo_tpu_engine_kv_usage", "dynamo_tpu_engine_decode_graphs",
                       'dynamo_tpu_runtime_hbm_bytes{category="kv_cache"}',
                       "dynamo_tpu_runtime_profiler_captures_total", "dynamo_tpu_overload_state",
                       "# TYPE dynamo_tpu_slo_goodput_ratio", "# TYPE dynamo_tpu_kvcache_",
                       "# TYPE dynamo_tpu_liveness_stale_incarnation_drops_total",
                       "# TYPE dynamo_tpu_engine_step_duration_seconds histogram",
                       "# TYPE dynamo_tpu_engine_host_gap_seconds histogram",
                       "dynamo_tpu_perf_fingerprints_loaded 0",
                       "# TYPE dynamo_tpu_perf_roofline_fraction gauge",
                       'dynamo_tpu_runtime_compiles_total{program="runner.decode_state"} 0'):
            assert family in metrics, family
        status, mem = _get(port, "/debug/memory")
        assert status == 200 and set(mem["sources"]) == {"engine", "kv_pool_detail"}
        assert mem["devices"] == [{"id": 0, "platform": "cpu", "memory_stats": None}]
        assert "device_bytes_in_use" not in mem and mem["host_weight_cache"] is None
        status, rings = _get(port, "/debug/flight")
        # a decode worker's DecodeHandler adds the disagg ring (and its
        # families), after the overload controller's, as JAX's worker does
        assert status == 200 and rings["rings"] == ["perf", "overload", "disagg"]
        assert "# TYPE dynamo_tpu_disagg_transfers_total counter" in metrics
        status, perf = _get(port, "/debug/perf")
        assert status == 200 and perf["identity"]["preset"] == "tiny-llama"
        assert perf["identity"]["backend"] == "cpu" and perf["decode"] == []
        status, compiles = _get(port, "/debug/compiles")
        assert status == 200 and compiles["totals"]["compiles"] == 0
        assert call(port, "POST", "/engine/clear_kv_blocks")[:1] == (200,)
        assert call(port, "GET", "/drain")[0] == 501
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=15) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=10)


def _cli(args, env=None):
    return subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                          timeout=60, cwd=ROOT, env={**os.environ, **(env or {})})


def test_cli_delegates_to_the_mains_and_prints_the_ports_knobs():
    for service, module in tcli.SERVICES.items():
        via_cli = _cli(["dynamo_tpu_torch.cli", service, "--help"])
        direct = _cli([module, "--help"])
        assert via_cli.returncode == direct.returncode == 0
        assert via_cli.stdout == direct.stdout and via_cli.stdout.startswith("usage:")
    env = _cli(["dynamo_tpu_torch.cli", "env"], {"DYN_TPU_SYSTEM_PORT": "7777"})
    assert env.returncode == 0
    rows = re.findall(r"^(DYN_TPU_\S+)\s+default=(.*?)(?: \[set: (.*)\])?$", env.stdout, re.M)
    knobs = {v.name: v for v in vars(tconfig).values() if isinstance(v, tconfig.EnvVar)}
    assert [r[0] for r in rows] == sorted(knobs)
    for name, default, value in rows:
        assert default == repr(knobs[name].default)
        assert value == ("7777" if name == "DYN_TPU_SYSTEM_PORT" else "")


async def test_observe_views_print_jaxs_text_for_a_live_port_worker(monkeypatch, fresh_globals):
    monkeypatch.setenv("DYN_TPU_WORKER_ID", "0x101")
    rt = TRuntime.detached()
    args = tworker.build_parser().parse_args(
        ["--model", "tiny", "--device", "cpu", "--block-size", "4", "--num-kv-blocks", "64",
         "--max-model-len", "256", "--prefill-chunk", "32", "--decode-steps", "4",
         "--system-port", "0"])
    worker = await tworker.serve_worker(args, rt)
    try:
        async with asyncio.timeout(DEADLINE_S):
            for i, prompt in enumerate(PROMPTS[:3]):  # a shared prefix: hits
                req = tproto.PreprocessedRequest(
                    token_ids=list(prompt), request_id=f"r{i}",
                    sampling=tproto.SamplingOptions(temperature=0.0),
                    stop=tproto.StopConditions(max_tokens=4))
                async for _ in worker.engine.generate(req, TContext()):
                    pass
            port = worker.system_server.port
            texts = {}
            for what, as_json in (("kvcache", False), ("kvcache", True), ("trajectory", False),
                                  ("perf", False), ("perf", True), (None, False),
                                  (None, True)):
                ns = argparse.Namespace(what=what, trace_id=None, top_k=5, host="127.0.0.1",
                                        port=port, json=as_json, flight_limit=24)
                got, raw = [], None
                for run in (jrun.main_observe, trun.main_observe):
                    out = io.StringIO()
                    with contextlib.redirect_stdout(out):
                        if asyncio.iscoroutinefunction(run):
                            await run(ns)
                        else:
                            await asyncio.to_thread(run, ns)
                    # the sketch decays with time between the two reads
                    raw = out.getvalue()
                    got.append(re.sub(r"(age|score|age_s|score_error)(\W+)[\d.]+", r"\1\2<f>",
                                      raw))
                assert got[1] == got[0], (what, as_json)
                texts[what, as_json] = raw
            # two of the three prompts found their shared prefix cached
            assert "hit rate 0.667  (hits=2.0 misses=1.0" in texts["kvcache", False]
            assert json.loads(texts["kvcache", True])["kvcache"]["hits"]
            # the perf ledger the worker's engine fed (JAX's test_cli.py:232-282)
            out = texts["perf", False]
            assert "perf ledger" in out and "sentinel" in out and "fingerprints_loaded=" in out
            assert "step p50" in out and "tok/s" in out and "backend=cpu" in out
            doc = json.loads(texts["perf", True])
            assert doc["identity"]["preset"] == worker.engine.config.name
            assert doc["decode"] and doc["decode"][0]["samples"] >= 1
            assert doc["decode"][0]["step_p50_s"] > 0.0 and doc["decode"][0]["path"] == "fallback"
            # the device plane: memory, compiles (no graphs on the CPU), flight
            out = texts[None, False]
            for head in ("== device memory", "== compiled programs", "== flight recorder"):
                assert head in out, head
            doc = json.loads(texts[None, True])
            # the fixture's one compile: a CPU worker captures no graphs
            assert doc["compiles"]["totals"]["compiles"] == 1
            assert set(doc["memory"]["sources"]) == {"engine", "kv_pool_detail"}
            assert "perf" in doc["flight"]["rings"]
            _, metrics = await asyncio.to_thread(_get, port, "/metrics")
            assert 'dynamo_tpu_engine_step_duration_seconds_count{phase="decode"}' in metrics
            ns = argparse.Namespace(what="kvcache", trace_id=None, top_k=5, host="127.0.0.1",
                                    port=1, json=False)  # nothing listens there
            with pytest.raises(SystemExit, match="cannot reach system server"):
                trun.main_observe(ns)
    finally:
        await worker.close()
        await rt.shutdown(grace_period=1)
