"""The trajectory plane of the port (dynamo_tpu_torch/runtime/trajectory.py)
against the JAX package's, and across processes.

``stitch``, ``attribute_phases``, ``TrajectoryStore`` (ingest, the recent
and slow rings, summaries, its flight ring), ``SloTracker`` under an
injected clock and ``render_trajectory_metrics`` give JAX's outputs on the
same span records: a frontend root whose parent is a client's, a worker's
spans in another clock domain, a worker whose wall clock runs 5 s ahead
(re-anchored, ``skew_flagged``), orphans, a trace with no root, an empty
one, KV-reuse ROI events, an errored span.

Then the wire: a ``TrajectoryShipper`` on the port's tracer publishes over
the port's ZMTP event plane through the port's broker, and the port's
``TrajectoryCollector`` and JAX's (on pyzmq) both receive the batches;
their stores stitch equal views. The ``trajectory.ship`` fault drops a
batch and counts it, while a ``TorchEngine`` stream served at that moment
ends whole, its phase spans shipped with the next batch.

Last, one trace id through processes on the CPU: the port's discd, a
``python -m dynamo_tpu_torch.worker --model tiny --device cpu`` and
``python -m dynamo_tpu_torch.frontend``. A streamed chat carrying a
``traceparent`` appears on the frontend's ``/debug/trajectory/{trace_id}``
with the frontend's and the worker's spans, queue, prefill and decode
above zero, the phases summing to the root, and no skew flagged but the
serve span's end (see the test); the
frontend's ``/metrics`` carries the SLO families (own deadline, 80 s)."""

import asyncio
import copy
import json
import os
import re
import signal
import time

import pytest

from dynamo_tpu.runtime import trajectory as jtraj
from dynamo_tpu.runtime.events import zmq_plane as jplane
from dynamo_tpu_torch.engines.gpu.engine import TorchEngine, TorchEngineArgs
from dynamo_tpu_torch.llm.protocols import common as tcommon
from dynamo_tpu_torch.models.config import tiny_config
from dynamo_tpu_torch.runtime import fault_names as tfault_names
from dynamo_tpu_torch.runtime import faults as tfaults
from dynamo_tpu_torch.runtime import trajectory as ttraj
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.events import zmq_plane as tplane
from dynamo_tpu_torch.utils import tracing as ttracing
from tests.test_torch_mains import DEADLINE_S, Proc, _get, _post

T0 = 1_700_000_000.0  # a wall clock
M0 = 5_000.0  # the frontend's monotonic clock
W0 = 90_000.0  # the worker's


def rec(name, sid, parent, proc, start_ms, dur_ms, *, trace="a" * 32, mono=M0,
        wall_skew_s=0.0, status="ok", **attrs):
    """One span record, as Span.to_dict writes it; ``start_ms`` from T0."""
    return {
        "name": name, "trace_id": trace, "span_id": sid, "parent_span_id": parent,
        "proc": proc, "start_unix_s": round(T0 + start_ms / 1000 + wall_skew_s, 6),
        "start_mono_s": round(mono + start_ms / 1000, 6), "duration_ms": dur_ms,
        "attributes": attrs, "events": [], "status": status,
    }


def request_spans(skew_s=0.0, trace="a" * 32):
    """A served request: the frontend's root (its parent the client's), the
    queue wait and the routing decision, the worker's serve span with the
    engine's three phases (another clock domain, its wall ``skew_s`` off)."""
    w = dict(trace=trace, mono=W0, wall_skew_s=skew_s)
    f = dict(trace=trace)
    return [
        rec("http.chat_completions", "f1", "c0", "frontend", 0.0, 120.0, model="m", **f),
        rec("overload.queue", "f2", "f1", "frontend", 0.5, 3.0, queued_s=0.003, **f),
        rec("router.select_worker", "f3", "f1", "frontend", 4.0, 1.0, **f),
        rec("endpoint.serve", "w1", "f1", "worker-0x101", 6.0, 110.0, items=9, **w),
        rec("engine.queue", "w2", "w1", "worker-0x101", 6.2, 2.0, **w),
        rec("engine.prefill", "w3", "w1", "worker-0x101", 8.2, 30.0, prompt_tokens=40,
            cached_tokens=16, **w),
        rec("engine.decode", "w4", "w1", "worker-0x101", 38.2, 70.0, generated=8, **w),
    ]


ROI = [{"trace_id": "a" * 32, "ring": "kvcache", "kind": "roi", "t_wall": T0 + 0.007,
        "cached_tokens": 16, "recomputed_tokens": 24, "seconds_saved": 0.0021,
        "tier": "device"},
       {"trace_id": "a" * 32, "ring": "migration", "kind": "retry", "t_wall": T0 + 9.0}]

CASES = {
    "request": (request_spans(), ROI, True),
    "worker wall 5 s ahead": (request_spans(5.0), ROI, True),
    "worker wall 3 s behind": (request_spans(-3.0), [], True),
    "worker spans before the root": (request_spans()[3:], [], False),
    "orphan beside a root": (request_spans()[:3] + [
        rec("engine.decode", "o1", "gone", "worker-0x202", 50.0, 10.0)], [], True),
    "errored": ([dict(r, status="error: RuntimeError") if r["span_id"] == "w4" else r
                 for r in request_spans()], [], True),
    "root alone": (request_spans()[:1], [], True),
    "empty": ([], ROI, False),
}


@pytest.mark.parametrize("name", list(CASES))
def test_stitch_and_attribute_phases_match_jax(name):
    spans, events, complete = CASES[name]
    want = jtraj.stitch(copy.deepcopy(spans), copy.deepcopy(events), trace_id="a" * 32,
                        complete=complete)
    got = ttraj.stitch(copy.deepcopy(spans), copy.deepcopy(events), trace_id="a" * 32,
                       complete=complete)
    assert got == want
    if name == "worker wall 5 s ahead":
        assert got["skew_flagged"] and any(s.get("skew_flagged") for s in got["spans"])
    if name == "request":
        assert not got["skew_flagged"] and got["dominant_phase"] == "decode"
        assert got["kv_reuse"]["cached_tokens"] == 16
    for total in (0.0, 50.0, 120.0, 500.0):
        assert ttraj.attribute_phases(spans, total) == jtraj.attribute_phases(spans, total)


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def slo_run(mod):
    clock = Clock()
    slo = mod.SloTracker(ttft_sla_s=0.5, itl_sla_s=0.05, target=0.9,
                         windows=(300.0, 3600.0), max_phase_traces=3, clock=clock)
    verdicts = [(0.2, 0.01, 200), (0.7, 0.01, 200), (0.2, 0.09, 200), (None, None, 429),
                (None, None, 503), (0.1, None, 200), (None, 0.01, 200), (0.3, 0.02, 504)]
    for i, (ttft, itl, status) in enumerate(verdicts):
        clock.t += 60.0 * i
        slo.note_stream(f"t{i}", ttft_s=ttft, mean_itl_s=itl, status=status)
    for i in range(5):
        clock.t += 1.0
        slo.note_phases(f"p{i % 4}", {p: float(i * 10 + j) for j, p in enumerate(mod.PHASES)})
    slo.note_phases("", {"queue": 1.0})
    out = [slo.snapshot(), slo.render(), slo.render(openmetrics=True)]
    clock.t += 4000.0  # every window empties
    out += [slo.snapshot(), slo.render()]
    off = mod.SloTracker(ttft_sla_s=None, itl_sla_s=None, clock=clock)
    off.note_stream("x", ttft_s=9.0, mean_itl_s=9.0, status=503)
    return out + [off.snapshot(), off.render(), slo.good_streams, slo.breached_streams]


def test_slo_tracker_matches_jax(monkeypatch):
    for k in ("DYN_TPU_SLO_TTFT_MS", "DYN_TPU_SLO_ITL_MS", "DYN_TPU_SLO_TARGET"):
        monkeypatch.delenv(k, raising=False)
    assert slo_run(ttraj) == slo_run(jtraj)


def test_render_trajectory_metrics_matches_jax(monkeypatch):
    monkeypatch.setenv("DYN_TPU_SLO_TTFT_MS", "500")
    monkeypatch.setenv("DYN_TPU_SLO_ITL_MS", "50")
    for mod in (jtraj, ttraj):
        monkeypatch.setattr(mod, "_STORE", None)
        monkeypatch.setattr(mod, "_SHIPPER", None)
    outs = []
    for mod in (jtraj, ttraj):
        store = mod.TrajectoryStore(max_recent=4, max_slow=2, slow_threshold_s=0.1)
        monkeypatch.setattr(mod, "_STORE", store)
        for ttft, status in ((0.1, 200), (0.9, 200), (None, 429)):
            mod.global_slo().note_stream("t", ttft_s=ttft, mean_itl_s=0.01, status=status)
        for r in request_spans():
            store.add_span(dict(r))
        index = mod.trajectory_index()
        outs.append((mod.render_trajectory_metrics(), index["slow"], index["traces"],
                     mod.trajectory_view("a" * 32), mod.trajectory_view("f" * 32)))
    assert outs[1] == outs[0]
    assert outs[1][1][0]["retained"] == "slow"


def store_run(mod):
    """Ingest, rings and reads of one store; the flight ring without its
    monotonic stamps."""
    store = mod.TrajectoryStore(max_recent=3, max_slow=2, slow_threshold_s=0.1,
                                slo=mod.SloTracker(ttft_sla_s=1.0), max_spans_per_trace=6)
    # the worker's batch lands first (incomplete), then the frontend root
    store.ingest({"proc": "worker-0x101", "spans": [
        {k: v for k, v in r.items() if k != "proc"} for r in request_spans()[3:]],
        "events": copy.deepcopy(ROI)})
    first = store.get("a" * 32)
    for r in request_spans()[:3]:
        store.add_span(dict(r))  # the 7th span of the trace is dropped
    whole = store.get("a" * 32)
    for i, trace in enumerate(("b" * 32, "c" * 32, "d" * 32, "e" * 32)):
        spans = request_spans(trace=trace)
        if i == 1:
            spans = [dict(s, duration_ms=20.0) for s in spans]  # under the threshold
        store.ingest({"proc": "frontend", "spans": spans[:3]})
    store.add_span({"name": "x"})  # no trace id: ignored
    store.add_event({"ring": "r"})
    flight = [{k: v for k, v in ev.items() if k != "t_mono"} for ev in store.flight.snapshot()]
    return [first, whole, store.get("a" * 32), store.get("c" * 32), store.summaries(),
            store.slow_summaries(), flight, store.spans_ingested, store.spans_dropped,
            store.slo.snapshot()]


def test_trajectory_store_matches_jax():
    got, want = store_run(ttraj), store_run(jtraj)
    assert got == want
    assert got[0]["complete"] is False and got[1]["complete"] is True
    assert got[2] is None  # evicted from both rings by the later traces
    assert got[8] == 1  # the dropped span


# -- the wire ------------------------------------------------------------------

SETTLE = 0.3  # subscriptions reach the publisher (tests/test_torch_event_plane.py)


async def until(cond, what, timeout=10.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, what
        await asyncio.sleep(0.01)


async def test_shipper_to_collectors_over_the_ports_zmtp_plane(monkeypatch):
    """The port's shipper → the port's broker → the port's collector and
    JAX's (pyzmq): equal stitched views; the ship fault drops one batch,
    counted, while a served stream ends whole."""
    monkeypatch.setattr(ttraj, "_SHIPPER", None)
    monkeypatch.setattr(ttraj, "_STORE", None)
    monkeypatch.setattr(jtraj, "_STORE", None)
    broker = tplane.EventBroker()
    broker.start()
    planes = [tplane.ZmqEventPlane(broker.address), tplane.ZmqEventPlane(broker.address),
              jplane.ZmqEventPlane(broker.address)]
    tstore = ttraj.TrajectoryStore(slow_threshold_s=60.0)
    jstore = jtraj.TrajectoryStore(slow_threshold_s=60.0)
    tcol = ttraj.TrajectoryCollector(planes[1], "ns", tstore)
    jcol = jtraj.TrajectoryCollector(planes[2], "ns", jstore)
    tracer = ttracing.Tracer(path="", otlp=False)
    shipper = ttraj.TrajectoryShipper(planes[0], "ns", proc="worker-0x101",
                                      flush_interval_s=60.0)
    shipper.attach(tracer)
    engine = TorchEngine(TorchEngineArgs(config=tiny_config(), device="cpu",
                                         cuda_graphs=False, block_size=4, num_kv_blocks=64,
                                         max_num_seqs=2, max_model_len=128))
    try:
        await tcol.start()
        await jcol.start()
        await asyncio.sleep(SETTLE)
        ctx = Context(baggage={"traceparent": "00-" + "a" * 32 + "-" + "c" * 16 + "-01"})
        with tracer.span("endpoint.serve", ctx, endpoint="k"):
            with tracer.span("engine.prefill", ctx):
                pass
        ttraj.set_global_shipper(shipper)
        ttraj.note_event("a" * 32, "kvcache", "roi", cached_tokens=4)
        ttraj.set_global_shipper(None)
        await shipper.flush_once()
        assert shipper.shipped == 3 and shipper.dropped == 0

        def spans_of(store, trace):
            view = store.get(trace)
            return len(view["spans"]) if view else 0

        await until(lambda: spans_of(tstore, "a" * 32) == spans_of(jstore, "a" * 32) == 2,
                    "the batch on both sides")
        assert tstore.get("a" * 32) == jstore.get("a" * 32)
        # each span carries the label of the process that exported it
        assert {s["proc"] for s in tstore.get("a" * 32)["spans"]} == {
            ttracing.service_label()}
        assert tstore.get("a" * 32)["events"][0]["cached_tokens"] == 4
        # the ship fault: the batch holding the served stream's spans drops
        plan = tfaults.FaultPlan(rules=(tfaults.FaultRule(
            tfault_names.TRAJECTORY_SHIP, at=(1,), kind="connection"),))
        ttracing_global = ttracing.global_tracer()
        ttracing_global.add_listener(shipper._on_span)
        try:
            req = tcommon.PreprocessedRequest(
                token_ids=list(range(10, 26)), request_id="r",
                sampling=tcommon.SamplingOptions(temperature=0.0),
                stop=tcommon.StopConditions(max_tokens=8))
            served = Context(baggage={"traceparent": "00-" + "b" * 32 + "-" + "d" * 16 + "-01"})
            with tfaults.armed(plan) as plane:
                outs = [o async for o in engine.generate(req, served)]
                n_spans = len(shipper._spans)
                await shipper.flush_once()
                assert plane.injected == {tfault_names.TRAJECTORY_SHIP: 1}
            assert sum(len(o.token_ids or []) for o in outs) == 8
            assert outs[-1].finish_reason == tcommon.FinishReason.LENGTH
            assert n_spans == 3 and shipper.dropped == 3 and not shipper._spans
            # the next batch ships
            outs = [o async for o in engine.generate(dict(req.to_dict(), request_id="s"),
                                                     served)]
            assert sum(len(o.token_ids or []) for o in outs) == 8
            await shipper.flush_once()
            await until(lambda: spans_of(tstore, "b" * 32) == 3, "the next batch")
            names = sorted(s["name"] for s in tstore.get("b" * 32)["spans"])
            assert names == ["engine.decode", "engine.prefill", "engine.queue"]
            prefill = next(s for s in tstore.get("b" * 32)["spans"]
                           if s["name"] == "engine.prefill")
            assert prefill["attributes"]["prompt_tokens"] == 16
            # the first stream's 4 blocks, less the last prompt token
            assert prefill["attributes"]["cached_tokens"] == 15
        finally:
            ttracing_global.remove_listener(shipper._on_span)
    finally:
        await engine.stop()
        await shipper.close()
        await tcol.stop()
        await jcol.stop()
        for p in planes:
            await p.close()
        await broker.close()


# -- one trace id across processes ---------------------------------------------


def test_one_trace_id_through_the_frontend_and_a_worker_main_is_stitched():
    deadline = time.monotonic() + DEADLINE_S
    env = {**os.environ, "PYTHONUNBUFFERED": "1", "DYN_TPU_GRACE_PERIOD": "5",
           "DYN_TPU_TRAJECTORY_SHIP_S": "0.1", "DYN_TPU_SLO_TTFT_MS": "60000",
           "DYN_TPU_SLO_ITL_MS": "60000"}
    procs = []
    try:
        discd = Proc(["dynamo_tpu_torch.discd", "--port", "0", "--xsub", "0", "--xpub", "0"],
                     env)
        procs.append(discd)
        m = discd.wait_for(r"discd ready: discovery (\S+), events (\S+)", deadline)
        env.update({"DYN_TPU_DISCOVERY": "discd", "DYN_TPU_DISCOVERY_ADDR": m.group(1),
                    "DYN_TPU_EVENT_PLANE": "zmq", "DYN_TPU_EVENT_PLANE_ADDR": m.group(2),
                    "DYN_TPU_REQUEST_PLANE": "tcp"})
        frontend = Proc(["dynamo_tpu_torch.frontend", "--host", "127.0.0.1",
                         "--http-port", "0"], env)
        procs.append(frontend)
        port = int(frontend.wait_for(r"frontend listening on \S+:(\d+)", deadline).group(1))
        worker = Proc(["dynamo_tpu_torch.worker", "--model", "tiny", "--device", "cpu",
                       "--num-kv-blocks", "256", "--max-model-len", "512"],
                      {**env, "DYN_TPU_WORKER_ID": str(0x101)})
        procs.append(worker)
        worker.wait_for(r"worker serving tiny-llama", deadline)
        while [m["id"] for m in json.loads(_get(port, "/v1/models")[1])["data"]] != [
                "tiny-llama"]:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        trace = "4bf92f3577b34da6a3ce929d0e0e4736"
        r = _post(port, "/v1/chat/completions", {
            "model": "tiny-llama", "messages": [{"role": "user", "content": "hello"}],
            "max_tokens": 24, "temperature": 0.0, "stream": True},
            {"traceparent": f"00-{trace}-00f067aa0ba902b7-01"})
        assert r.status == 200 and b"[DONE]" in r.read()
        while True:
            status, body = _get(port, f"/debug/trajectory/{trace}")
            view = json.loads(body) if status == 200 else {}
            if any(p.startswith("worker-") for p in view.get("processes", [])) and len(
                    view["spans"]) >= 7:
                break
            assert time.monotonic() < deadline, (status, body[:2000])
            time.sleep(0.05)
        names = {s["name"] for s in view["spans"]}
        assert {"http.chat_completions", "overload.queue", "router.select_worker",
                "endpoint.serve", "engine.queue", "engine.prefill",
                "engine.decode"} <= names, names
        assert view["processes"][0] == "frontend" and "worker-0x101" in view["processes"]
        assert view["complete"]
        # The worker's endpoint.serve span closes after it sent the last
        # item, and the frontend's root may close first (its Backend stops
        # at the finish item): on a loaded machine the stitcher then
        # re-anchors the serve span inside the root and flags the rest as
        # skew. Nothing else may be flagged: no span starts early.
        flagged = [s for s in view["spans"] if s.get("skew_flagged")]
        assert all(s["name"] == "endpoint.serve" and s["skew_ms"] > 0 for s in flagged), flagged
        phases = view["phases"]
        assert phases["queue"] > 0 and phases["prefill"] > 0 and phases["decode"] > 0
        assert abs(sum(phases.values()) - view["root_ms"]) < 0.01, view
        index = json.loads(_get(port, "/debug/trajectory")[1])
        assert trace in {t["trace_id"] for t in index["traces"]}
        assert index["slo"]["good_streams"] >= 1
        metrics = _get(port, "/metrics")[1].decode()
        assert re.search(r'^dynamo_tpu_slo_goodput_ratio\{window="5m"\} 1', metrics, re.M)
        assert 'dynamo_tpu_overload_admitted_total 1' in metrics
        assert json.loads(_get(port, "/debug/overload")[1])["admitted"] == 1
        worker.proc.send_signal(signal.SIGTERM)
        assert worker.proc.wait(timeout=10) == 0
        frontend.proc.send_signal(signal.SIGTERM)
        assert frontend.proc.wait(timeout=10) == 0
        assert time.monotonic() < deadline
    finally:
        for p in reversed(procs):
            p.end()
