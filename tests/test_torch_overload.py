"""The overload plane of the port (dynamo_tpu_torch/runtime/overload.py)
against the JAX package's, and its wiring.

The same call sequences run through both packages' ``OverloadController``
under an injected clock, each package on its own Context and fault plane:
admission and release, EDF order, ``queue_full``, the predicted-delay
shed, a deadline dead on arrival, one that dies while queued (re-checked
at grant), a waiter expired by the ``overload.admit`` fault plan,
``observe_itl`` and ``evaluate`` through healthy → brownout → shed →
healthy (ITL and occupancy), the ``max_tokens`` clamp. Grants, statuses,
``Retry-After`` values, transitions, snapshots, flight events and the
rendered metric families must be equal (histogram ``le`` labels compared
as numbers: the port writes them as prometheus_client does).

Then the port's HTTP service over a CPU ``TorchEngine`` under saturation:
streams are held open by a gate (never by sleeps) and the waiter that
expires is expired by the ``overload.admit`` fault plan (never by a wall
clock), so nothing races. Typed 429s with ``Retry-After``, a 504
deadline shed that never reached the engine, the 503 brownout shed, the
brownout clamp, admitted streams token-exact against the unguarded
service, and an under-capacity run with no shed, no transition and no
activity (``faults.activity_snapshot``).

Last, the engine's typed deadline shed against ``JaxEngine``: a request
whose deadline passed while it waited ends with ``error_kind="timeout"``
and counts in ``stats()["deadline_sheds"]``, with no prefill spent; a
plain cancellation stays a quiet CANCELLED; each ~1 s. Over the TCP
plane, a client context stopped by its deadline stops the served stream's
context with the reason ``deadline`` (the cancel frame carries it), and a
queued request there ends in the typed timeout. A request that expires
behind a full engine (its one slot held far past the TCP server's cancel
grace) is shed at its deadline, so the frontend answers 504 and its
controller frees the request's slot; and a stream that outlives the grace
is hard-cancelled with a typed ``err`` frame, never left without an
answer."""

import asyncio
import http.client
import json
import re
import time
from types import SimpleNamespace

import pytest

from dynamo_tpu.engines.tpu import JaxEngine, JaxEngineArgs
from dynamo_tpu.llm.protocols import common as jcommon
from dynamo_tpu.models.config import tiny_config as jtiny_config
from dynamo_tpu.runtime import context as jcontext
from dynamo_tpu.runtime import fault_names as jfault_names
from dynamo_tpu.runtime import faults as jfaults
from dynamo_tpu.runtime import overload as joverload
from dynamo_tpu.runtime.engine import collect as jcollect
from dynamo_tpu_torch.engines.gpu.engine import TorchEngine, TorchEngineArgs
from dynamo_tpu_torch.http import HttpService, ModelManager
from dynamo_tpu_torch.llm.discovery import ModelWatcher
from dynamo_tpu_torch.llm import model_card as tcard
from dynamo_tpu_torch.llm.protocols import common as tcommon
from dynamo_tpu_torch.models.config import tiny_config as ttiny_config
from dynamo_tpu_torch.runtime import context as tcontext
from dynamo_tpu_torch.runtime import fault_names as tfault_names
from dynamo_tpu_torch.runtime import faults as tfaults
from dynamo_tpu_torch.runtime import overload as toverload
from dynamo_tpu_torch.runtime.discovery import MemoryDiscovery
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.network import tcp as ttcp
from dynamo_tpu_torch.runtime.network.tcp import TcpRequestPlane
from dynamo_tpu_torch.worker import __main__ as tworker
from tests.test_torch_pipeline import _torch_pipeline

JAX = SimpleNamespace(overload=joverload, Context=jcontext.Context, faults=jfaults,
                      fault_names=jfault_names)
PORT = SimpleNamespace(overload=toverload, Context=tcontext.Context, faults=tfaults,
                       fault_names=tfault_names)


@pytest.fixture(autouse=True)
def _disarmed():
    for f in (jfaults, tfaults):
        f.disarm()
    yield
    for f in (jfaults, tfaults):
        f.disarm()


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def metric_lines(text):
    """The exposition's lines, each histogram ``le`` label as a float."""
    return sorted(re.sub(r'le="([^"]+)"', lambda m: f'le="{float(m.group(1))!r}"', line)
                  for line in text.splitlines() if line)


def flight(ctrl):
    """The flight ring without its monotonic stamps; a waiter's remaining
    budget (read off each package's own clock) to the second."""
    out = []
    for ev in ctrl.flight.snapshot():
        ev = {k: v for k, v in ev.items() if k != "t_mono"}
        if ev.get("deadline_in_s") is not None:
            ev["deadline_in_s"] = round(ev["deadline_in_s"])
        out.append(ev)
    return out


def shed_of(exc):
    return ("shed", exc.reason, exc.status, exc.retry_after)


async def admission_trace(pkg):
    """One admission sequence on one package: every outcome in order."""
    o, Context = pkg.overload, pkg.Context
    clock = Clock()
    ctrl = o.OverloadController(o.OverloadConfig(
        max_concurrency=2, max_queue_depth=3, max_queue_delay_s=10.0, retry_after_s=1.5),
        clock=clock)
    trace = []
    far = time.monotonic() + 1000.0

    def ctx(name, deadline=None):
        return Context(id=name, deadline=deadline)

    async def settle():
        for _ in range(5):
            await asyncio.sleep(0)

    a = await ctrl.admit(ctx("a"))
    b = await ctrl.admit(ctx("b"))
    trace.append(("granted", a.request_id, a.queue_delay_s, b.request_id))
    # dead on arrival: 504, no Retry-After
    with pytest.raises(o.OverloadShedError) as exc:
        await ctrl.admit(ctx("doa", deadline=time.monotonic() - 1.0))
    trace.append(shed_of(exc.value))
    # three waiters: no deadline, a far one, a nearer one; EDF grants the
    # nearer first, then the far one, then the deadline-less
    waits = {}
    for name, dl in (("c", None), ("d", far + 500.0), ("e", far)):
        waits[name] = asyncio.ensure_future(ctrl.admit(ctx(name, dl)))
        await settle()
    trace.append(("queued", ctrl.snapshot()))
    with pytest.raises(o.OverloadShedError) as exc:
        await ctrl.admit(ctx("f"))
    trace.append(shed_of(exc.value))  # queue_full, Retry-After the floor
    clock.t += 4.0
    ctrl.release(a)  # service 4 s: the EWMA's first sample
    await settle()
    trace.append(("done", sorted(n for n, t in waits.items() if t.done())))
    e = waits["e"].result()
    trace.append(("granted", e.request_id, e.queue_delay_s))
    clock.t += 2.0
    ctrl.release(b)  # EWMA 0.25·2 + 0.75·4 = 3.5
    await settle()
    d = waits["d"].result()
    trace.append(("granted", d.request_id, d.queue_delay_s, ctrl.snapshot()))
    # predicted delay: (1 + 1) · 3.5 / 2 = 3.5 s against a 2 s budget
    with pytest.raises(o.OverloadShedError) as exc:
        await ctrl.admit(ctx("g", deadline=time.monotonic() + 2.0))
    trace.append(shed_of(exc.value))
    # a waiter whose deadline dies while queued is shed at grant
    h_ctx = ctx("h", deadline=far)
    waits["h"] = asyncio.ensure_future(ctrl.admit(h_ctx))
    await settle()
    h_ctx.set_deadline(time.monotonic() - 1.0)
    clock.t += 1.0
    ctrl.release(e)
    await settle()
    c = waits["c"].result()
    with pytest.raises(o.OverloadShedError) as exc:
        waits["h"].result()
    trace.append(("grant-time", c.request_id, shed_of(exc.value), ctrl.snapshot()))
    # the fault plan expires the next queued waiter deterministically
    plan = pkg.faults.FaultPlan(rules=(pkg.faults.FaultRule(
        pkg.fault_names.OVERLOAD_ADMIT, at=(1,), kind="timeout"),))
    with pkg.faults.armed(plan) as plane:
        with pytest.raises(o.OverloadShedError) as exc:
            await ctrl.admit(ctx("i", deadline=far))
        trace.append(shed_of(exc.value))
        trace.append(("plane", dict(plane.hits), list(plane.trace)))
    # the last releases: the EWMA (ok) and not (an error)
    clock.t += 0.5
    ctrl.release(c, ok=False)
    ctrl.release(d)
    ctrl.release(d)  # twice: a no-op
    trace.append(("released", ctrl.snapshot()))
    trace.append(("flight", flight(ctrl)))
    trace.append(("metrics", metric_lines(ctrl.metrics.render()),
                  metric_lines(ctrl.metrics.render(openmetrics=True))))
    return trace


async def brownout_trace(pkg):
    """observe_itl / evaluate through every state under a fake clock."""
    o, Context = pkg.overload, pkg.Context
    clock = Clock()
    ctrl = o.OverloadController(o.OverloadConfig(
        itl_sla_s=0.01, min_itl_samples=4, itl_window=4, brownout_after=2, recover_after=3,
        brownout_max_tokens=32, itl_sample_ttl_s=5.0), clock=clock)
    trace, seen = [], []
    ctrl.on_transition(lambda old, new: seen.append((old, new)))

    def feed(itl, n=4):
        for _ in range(n):
            ctrl.observe_itl(itl)

    def step(dt=0.25):
        clock.t += dt
        trace.append(("eval", ctrl.evaluate(), ctrl.snapshot()["itl_p50_ms"]))

    step()  # too few samples: healthy
    feed(0.02)
    step(0.1)  # inside min_eval_interval: a no-op
    step()
    step()  # two breaches: brownout
    trace.append(("clamp", [ctrl.clamp_max_tokens(v) for v in (None, 8, 512, True, "x")],
                  ctrl.spec_enabled()))
    feed(0.05)  # past 3x the SLA: critical
    step()
    step()  # shed
    with pytest.raises(o.OverloadShedError) as exc:
        await ctrl.admit(Context(id="s"))
    trace.append(shed_of(exc.value))
    feed(0.001)
    for _ in range(7):  # three clean: brownout, three more: healthy
        step()
    # stale samples age out: a congested window decays to unknown
    feed(0.05)
    clock.t += 6.0
    trace.append(("stale", ctrl.evaluate(), ctrl.snapshot()["itl_p50_ms"]))
    trace.append(("clamp", ctrl.clamp_max_tokens(512), ctrl.spec_enabled()))
    trace.append(("transitions", seen, ctrl.snapshot()))
    trace.append(("flight", flight(ctrl)))
    trace.append(("metrics", metric_lines(ctrl.metrics.render())))
    # occupancy drives a worker-side controller alone (no ITL SLA); a
    # failing source reads as unknown
    occ = [0.5]

    def source():
        if occ[0] is None:
            raise RuntimeError("pool gone")
        return occ[0]

    w = o.OverloadController(o.OverloadConfig(brownout_after=2, recover_after=2),
                             clock=clock, occupancy_source=source)
    states = []
    for value in (0.5, 0.96, 0.96, 0.999, 0.999, None, 0.1, 0.1, 0.1, 0.1):
        occ[0] = value
        clock.t += 0.3
        states.append(w.evaluate())
    trace.append(("occupancy", states, w.snapshot(), flight(w)))
    return trace


async def test_admission_sequence_matches_jax():
    assert await admission_trace(PORT) == await admission_trace(JAX)


async def test_brownout_sequence_matches_jax():
    assert await brownout_trace(PORT) == await brownout_trace(JAX)


def test_config_from_env_matches_jax(monkeypatch):
    assert toverload.config_from_env() == toverload.OverloadConfig()
    env = {"DYN_TPU_OVERLOAD_MAX_CONCURRENCY": "4", "DYN_TPU_OVERLOAD_MAX_QUEUE": "5",
           "DYN_TPU_OVERLOAD_MAX_QUEUE_DELAY_S": "2.5",
           "DYN_TPU_OVERLOAD_DEFAULT_DEADLINE_S": "7", "DYN_TPU_OVERLOAD_ITL_SLA_MS": "0.5",
           "DYN_TPU_OVERLOAD_BROWNOUT_MAX_TOKENS": "64"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = toverload.config_from_env(), joverload.config_from_env()
    assert vars(got) == vars(want)
    assert got.itl_sla_s == 0.0005 and got.max_concurrency == 4


# -- the HTTP service under saturation --------------------------------------


class Gated:
    """An AsyncEngine in front of the pipeline: each stream waits on the
    gate before its first item, and records that it started."""

    def __init__(self, inner):
        self.inner, self.gate, self.started = inner, asyncio.Event(), []

    async def generate(self, body, context):
        self.started.append(context.id)
        await self.gate.wait()
        async for item in self.inner.generate(body, context):
            yield item


def post(port, body, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/v1/completions", json.dumps(body),
                     {"Content-Type": "application/json", **(headers or {})})
        r = conn.getresponse()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, json.loads(r.read())
    finally:
        conn.close()


def get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read().decode()
    finally:
        conn.close()


BODY = {"model": "tiny", "prompt": "hello world this is a test", "max_tokens": 12,
        "temperature": 0.0}


async def until(cond, what):
    for _ in range(2000):
        if cond():
            return
        await asyncio.sleep(0.005)
    raise AssertionError(f"not reached: {what}")


async def test_http_saturation_typed_sheds_token_exact():
    pipeline, engine, _, _ = _torch_pipeline("tiny")
    card = tcard.ModelDeploymentCard(name="tiny", context_length=160, kv_block_size=4,
                                     eos_token_ids=[2])
    gated = Gated(pipeline)
    clock = Clock()
    ctrl = toverload.OverloadController(toverload.OverloadConfig(
        max_concurrency=2, max_queue_depth=2, itl_sla_s=0.01, min_itl_samples=4,
        brownout_after=2, brownout_max_tokens=5), clock=clock)
    plain_mm, mm = ModelManager(), ModelManager()
    plain_mm.register("tiny", pipeline, card)
    mm.register("tiny", gated, card)
    plain = HttpService(plain_mm, host="127.0.0.1", port=0)
    service = HttpService(mm, host="127.0.0.1", port=0, overload=ctrl)
    try:
        plain_port, port = await plain.start(), await service.start()
        want = await asyncio.to_thread(post, plain_port, BODY)
        assert want[0] == 200
        send = lambda headers=None: asyncio.ensure_future(  # noqa: E731
            asyncio.to_thread(post, port, BODY, headers))
        fillers = [send() for _ in range(2)]
        await until(lambda: len(gated.started) == 2, "two streams at the gate")
        # the first queued admission (hit 1 of the seam) expires by the plan
        plan = tfaults.FaultPlan(rules=(tfaults.FaultRule(
            tfault_names.OVERLOAD_ADMIT, at=(1,), kind="timeout"),))
        with tfaults.armed(plan):
            expired = await send({"x-dynamo-deadline-ms": "600000"})
            queued = [send(), send()]
            await until(lambda: ctrl.snapshot()["queue_depth"] == 2, "two waiters")
            over = await asyncio.gather(*(send() for _ in range(3)))
        assert gated.started == gated.started[:2] and len(gated.started) == 2
        gated.gate.set()
        served = await asyncio.gather(*fillers, *queued)
    finally:
        await service.stop(grace_period=5)
        await plain.stop(grace_period=5)
    status, headers, body = expired
    assert status == 504 and "retry-after" not in headers
    assert body["error"]["type"] == "deadline_exceeded"
    assert body["error"]["error_kind"] == "timeout"
    for status, headers, body in over:
        assert status == 429 and headers["retry-after"] == "1"
        assert body["error"]["error_kind"] == "queue_full"
        assert body["error"]["type"] == "overloaded"
    for status, _, body in served:
        assert status == 200
        assert body["choices"][0]["text"] == want[2]["choices"][0]["text"]
        assert body["usage"] == want[2]["usage"]
    assert len(gated.started) == 4  # the shed requests never reached the engine
    snap = ctrl.snapshot()
    assert snap["sheds"] == {"deadline_expired": 1, "queue_full": 3}
    assert snap["admitted"] == 4 and snap["queue_depth"] == 0 and snap["active"] == 0
    assert snap["peak_queue_depth"] == 2
    await engine.stop()


async def test_http_brownout_clamps_then_sheds_503():
    pipeline, engine, _, _ = _torch_pipeline("tiny")
    card = tcard.ModelDeploymentCard(name="tiny", context_length=160, kv_block_size=4,
                                     eos_token_ids=[2])
    clock = Clock()
    ctrl = toverload.OverloadController(toverload.OverloadConfig(
        itl_sla_s=0.01, min_itl_samples=4, brownout_after=2, brownout_max_tokens=5),
        clock=clock)
    mm = ModelManager()
    mm.register("tiny", pipeline, card)
    service = HttpService(mm, host="127.0.0.1", port=0, overload=ctrl)
    try:
        port = await service.start()
        for _ in range(4):
            ctrl.observe_itl(0.02)
        for _ in range(2):
            clock.t += 0.3
            ctrl.evaluate()
        assert ctrl.state == toverload.BROWNOUT
        clock.t += 0.01  # the admission's own evaluation: inside the interval
        status, _, body = await asyncio.to_thread(post, port, dict(BODY, nvext={"ignore_eos": True}))
        assert status == 200 and body["usage"]["completion_tokens"] == 5  # clamped
        # the clamped request's own ITLs (at most 4, real and short) joined
        # the window: outnumber them so that the p50 is 0.05 s
        for _ in range(16):
            ctrl.observe_itl(0.05)
        for _ in range(2):
            clock.t += 0.3
            ctrl.evaluate()
        assert ctrl.state == toverload.SHED
        clock.t += 0.01
        status, headers, body = await asyncio.to_thread(post, port, BODY)
        overload = json.loads((await asyncio.to_thread(get, port, "/debug/overload"))[1])
        metrics = (await asyncio.to_thread(get, port, "/metrics"))[1]
    finally:
        await service.stop(grace_period=5)
        await engine.stop()
    assert status == 503 and headers["retry-after"] == "1"
    assert body["error"]["error_kind"] == "brownout_shed"
    assert overload["enabled"] and overload["state"] == "shed"
    assert overload["transitions"] == {"brownout": 1, "shed": 1}
    assert [e["to"] for e in overload["events"] if e["kind"] == "state"] == ["brownout", "shed"]
    assert "dynamo_tpu_overload_state 2" in metrics
    assert 'dynamo_tpu_overload_shed_total{reason="brownout_shed"} 1' in metrics
    assert 'dynamo_tpu_overload_transitions_total{to="shed"} 1' in metrics


async def test_http_under_capacity_sheds_nothing_and_activates_nothing():
    pipeline, engine, _, _ = _torch_pipeline("tiny")
    card = tcard.ModelDeploymentCard(name="tiny", context_length=160, kv_block_size=4,
                                     eos_token_ids=[2])
    ctrl = toverload.OverloadController(toverload.OverloadConfig(
        max_concurrency=4, max_queue_depth=8))
    mm = ModelManager()
    mm.register("tiny", pipeline, card)
    service = HttpService(mm, host="127.0.0.1", port=0, overload=ctrl)
    tfaults.reset_activity()
    try:
        port = await service.start()
        texts = [await asyncio.to_thread(post, port, BODY) for _ in range(4)]
    finally:
        await service.stop(grace_period=5)
        await engine.stop()
    assert {t[0] for t in texts} == {200}
    assert len({t[2]["choices"][0]["text"] for t in texts}) == 1
    snap = ctrl.snapshot()
    assert snap["sheds"] == {} and snap["transitions"] == {} and snap["state"] == "healthy"
    assert snap["admitted"] == 4
    activity = tfaults.activity_snapshot()
    assert not {"sheds", "brownout_transitions", "deadline_expired"} & set(activity)
    assert tfaults.plane_snapshot() == {"armed": False, "injections": {}, "activity": activity}


# -- the engine's typed deadline shed ---------------------------------------


def _req(api, rid="r"):
    return api.PreprocessedRequest(
        token_ids=list(range(10, 26)), request_id=rid,
        sampling=api.SamplingOptions(temperature=0.0),
        stop=api.StopConditions(max_tokens=8),
    )


async def _tcollect(stream):
    return [x async for x in stream]


ENGINE_KW = dict(block_size=4, num_kv_blocks=64, max_num_seqs=4, max_model_len=128,
                 prefill_chunk=32, decode_steps=4)


async def test_engine_deadline_shed_matches_jax():
    """A request whose deadline passed while it waited ends with JAX's
    typed timeout, counted in deadline_sheds, before any prefill."""
    je = JaxEngine(JaxEngineArgs(config=jtiny_config(), **ENGINE_KW))
    te = TorchEngine(TorchEngineArgs(config=ttiny_config(), device="cpu", cuda_graphs=False,
                                     **ENGINE_KW))
    tfaults.reset_activity()
    try:
        jouts = await jcollect(je.generate(
            _req(jcommon), jcontext.Context(deadline=time.monotonic() - 0.5)))
        touts = await _tcollect(te.generate(
            _req(tcommon), tcontext.Context(deadline=time.monotonic() - 0.5)))
        assert [o.to_dict() for o in touts] == [o.to_dict() for o in jouts]
        assert touts[-1].error_kind == "timeout"
        assert touts[-1].finish_reason == tcommon.FinishReason.ERROR
        assert te.prefill_tokens == je.prefill_tokens == 0
        assert te.deadline_sheds == je.deadline_sheds == 1
        assert te.stats()["deadline_sheds"] == je.stats()["deadline_sheds"] == 1
        assert tfaults.activity_snapshot().get("deadline_expired") == 1
        # a plain cancellation stays a quiet CANCELLED, on both
        jc, tc = jcontext.Context(), tcontext.Context()
        jc.stop_generating(reason="client-gone")
        tc.stop_generating(reason="client-gone")
        jouts = await jcollect(je.generate(_req(jcommon, "c"), jc))
        touts = await _tcollect(te.generate(_req(tcommon, "c"), tc))
        assert [o.to_dict() for o in touts] == [o.to_dict() for o in jouts]
        assert touts[-1].finish_reason == tcommon.FinishReason.CANCELLED
        assert touts[-1].error is None
        assert te.deadline_sheds == je.deadline_sheds == 1
        te.set_spec_suspended(True)
        je.set_spec_suspended(True)
        assert te._spec_suspended == je._spec_suspended is True
    finally:
        await je.stop()
        await te.stop()


async def test_a_deadline_cancel_carries_its_reason_over_tcp():
    """The cancel frame of a client whose deadline passed names the
    reason; the server's context stops with it (deterministically: the
    client's context here carries no deadline for the server to arm)."""
    disco = MemoryDiscovery()
    worker_rt = DistributedRuntime(discovery=disco, request_plane=TcpRequestPlane(),
                                   bus="ovl-tcp-reason")
    frontend_rt = DistributedRuntime(discovery=disco, request_plane=TcpRequestPlane(),
                                     bus="ovl-tcp-reason")
    engine = TorchEngine(TorchEngineArgs(config=ttiny_config(), device="cpu", cuda_graphs=False,
                                         **dict(ENGINE_KW, max_num_seqs=1)))
    gate = asyncio.Event()

    async def handler(request, context):
        if request.get("op") == "reason":
            await context.wait_stopped()
            yield {"reason": context.stop_reason}
            return
        if request.get("op") == "fill":
            async for out in engine.generate(_req(tcommon, "fill"), context):
                await gate.wait()
                yield out.to_dict()
            return
        async for out in engine.generate(_req(tcommon, "late"), context):
            yield out.to_dict()

    served = await worker_rt.namespace("n").component("c").endpoint("gen").serve_endpoint(
        handler)
    client = await frontend_rt.namespace("n").component("c").endpoint("gen").client()
    try:
        got = {}
        for reason in ("deadline", "client-gone"):
            ctx = tcontext.Context()
            stream = asyncio.ensure_future(_tcollect(client.generate({"op": "reason"}, ctx)))
            await asyncio.sleep(0.05)
            ctx.stop_generating(reason=reason)
            got[reason] = (await stream)[0]["reason"]
        assert got == {"deadline": "deadline", "client-gone": "client-cancelled"}
        # a request queued behind a full engine: its deadline stops it there
        fill = asyncio.ensure_future(_tcollect(client.generate({"op": "fill"}, tcontext.Context())))
        await until(lambda: engine.stats()["active_seqs"] == 1, "the filler admitted")
        late_ctx = tcontext.Context()
        late = asyncio.ensure_future(_tcollect(client.generate({"op": "late"}, late_ctx)))
        await until(lambda: engine.stats()["waiting"] == 1, "the late request queued")
        late_ctx.stop_generating(reason="deadline")
        await asyncio.sleep(0.05)
        gate.set()
        outs = await late
        assert outs[-1]["error_kind"] == "timeout" and outs[-1]["finish_reason"] == "error"
        assert engine.deadline_sheds == 1
        assert sum(len(o["token_ids"]) for o in await fill) == 8
    finally:
        await client.close()
        await served.shutdown(grace_period=1)
        await frontend_rt.shutdown(grace_period=1)
        await worker_rt.shutdown(grace_period=1)
        await engine.stop()


async def test_a_request_expired_behind_a_full_engine_answers_504_and_frees_its_slot(
        monkeypatch):
    """A worker main's engine with one slot, served over TCP, behind the
    frontend's pieces with an overload controller: a running stream holds
    the slot (its decode steps held by a gate) while a request with a 1 s
    deadline waits. The engine sheds that request at its deadline, not
    when a slot frees, so the frontend answers 504 with the engine's typed
    timeout and the controller holds only the running stream's slot."""
    monkeypatch.setenv("DYN_TPU_WORKER_ID", "257")
    rt = DistributedRuntime(discovery=MemoryDiscovery(), request_plane=TcpRequestPlane(),
                            bus="ovl-expired-full")
    args = tworker.build_parser().parse_args([
        "--model", "tiny", "--num-kv-blocks", "64", "--max-num-seqs", "1",
        "--max-model-len", "128", "--prefill-chunk", "32", "--decode-steps", "4",
        "--device", "cpu"])
    worker = await tworker.serve_worker(args, rt)
    engine, gate = worker.engine, asyncio.Event()
    tick = engine._decode_tick

    async def held_tick():
        if gate.is_set():
            return await tick()
        await asyncio.sleep(0.005)  # no step: the running stream keeps its slot

    engine._decode_tick = held_tick
    ctrl = toverload.OverloadController(toverload.OverloadConfig(
        max_concurrency=4, max_queue_depth=4))
    manager = ModelManager()
    watcher = ModelWatcher(rt, manager, enable_liveness=False)
    await watcher.start()
    service = HttpService(manager, host="127.0.0.1", port=0, overload=ctrl)
    body = dict(BODY, model="tiny-llama")
    try:
        port = await service.start()
        await until(lambda: watcher._models.get("tiny-llama", {}).get("instances"),
                    "the worker listed")
        filler = asyncio.ensure_future(asyncio.to_thread(post, port, body))
        await until(lambda: engine.stats()["active_seqs"] == 1, "the filler in the slot")
        late = await asyncio.wait_for(asyncio.to_thread(
            post, port, body, {"x-dynamo-deadline-ms": "1000"}), ttcp.CANCEL_GRACE_S + 10)
        held = (engine.stats()["active_seqs"], ctrl.snapshot()["active"], filler.done())
        gate.set()
        served = await filler
    finally:
        await service.stop(grace_period=1)
        await watcher.stop()
        await worker.close()
        await rt.shutdown(grace_period=1)
    status, headers, doc = late
    assert status == 504 and "retry-after" not in headers
    assert doc["error"]["error_kind"] == "timeout"
    assert "deadline expired before admission" in doc["error"]["message"]
    assert engine.deadline_sheds == 1
    assert held == (1, 1, False)  # shed while the filler still held the slot
    assert served[0] == 200 and served[2]["usage"]["completion_tokens"] == 12
    snap = ctrl.snapshot()
    assert snap["active"] == 0 and snap["admitted"] == 2 and snap["sheds"] == {}


async def test_a_stream_past_the_cancel_grace_ends_in_a_typed_err_frame(monkeypatch):
    """A handler that never looks at its context is hard-cancelled
    CANCEL_GRACE_S after the cancel frame, and its client gets an err frame
    (a TimeoutError for a deadline, a RuntimeError otherwise) instead of
    waiting for the connection to close."""
    monkeypatch.setattr(ttcp, "CANCEL_GRACE_S", 0.2)
    disco = MemoryDiscovery()
    worker_rt = DistributedRuntime(discovery=disco, request_plane=TcpRequestPlane(),
                                   bus="ovl-tcp-hard")
    frontend_rt = DistributedRuntime(discovery=disco, request_plane=TcpRequestPlane(),
                                     bus="ovl-tcp-hard")

    async def stuck(request, context):
        yield {"started": True}
        await asyncio.Event().wait()

    served = await worker_rt.namespace("n").component("c").endpoint("gen").serve_endpoint(
        stuck)
    client = await frontend_rt.namespace("n").component("c").endpoint("gen").client()
    got = {}
    try:
        for reason in ("deadline", "client-gone"):
            ctx, items = tcontext.Context(), []

            async def consume(ctx=ctx, items=items):
                async for item in client.generate({}, ctx):
                    items.append(item)

            task = asyncio.ensure_future(consume())
            await until(lambda items=items: items, "the first item")
            ctx.stop_generating(reason=reason)
            with pytest.raises(Exception) as exc:
                await asyncio.wait_for(task, 10)
            got[reason] = (type(exc.value).__name__, "hard-cancelled" in str(exc.value))
    finally:
        await client.close()
        await served.shutdown(grace_period=1)
        await frontend_rt.shutdown(grace_period=1)
        await worker_rt.shutdown(grace_period=1)
    assert got == {"deadline": ("TimeoutError", True), "client-gone": ("RuntimeError", True)}
