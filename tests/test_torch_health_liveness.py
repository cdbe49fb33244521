"""The port's copies of the JAX package's canary health tests
(tests/test_health.py, TestCanary) and of the liveness tests
(tests/test_liveness.py) that cover the modules the port has: the
incarnation fence, the detection state machine, Backoff, the discd watch
bootstrap retry, the keep-alive re-registration, abort_instance and the tcp
incarnation fence — each run against dynamo_tpu_torch."""

import asyncio
import os
import time

import pytest

from dynamo_tpu_torch.runtime import (
    Context,
    DistributedRuntime,
    NoInstancesError,
    collect,
)
from dynamo_tpu_torch.runtime import fault_names as fn
from dynamo_tpu_torch.runtime import faults
from dynamo_tpu_torch.runtime.health import CanaryHealthChecker
from dynamo_tpu_torch.runtime.liveness import (
    ALIVE,
    DEAD,
    SUSPECT,
    IncarnationFence,
    LivenessConfig,
    LivenessTracker,
    STALE_DROPS,
    WorkerLostError,
    process_incarnation,
    set_process_incarnation,
)
from dynamo_tpu_torch.runtime.tasks import Backoff


@pytest.fixture(autouse=True)
def _disarmed():
    faults.disarm()
    yield
    faults.disarm()


def drops(seam: str) -> float:
    return STALE_DROPS.value(seam=seam)


def make_worker(hung: asyncio.Event):
    """A worker that serves normally until `hung` is set, then stalls."""

    async def handler(request, context):
        if hung.is_set():
            await asyncio.sleep(3600)
        yield {"token_ids": [1], "finish_reason": "stop"}

    return handler


class TestCanary:
    def test_start_outside_loop_fails_loudly(self):
        """start() outside a running loop raises at the call site
        (get_running_loop), instead of get_event_loop silently binding a
        dead loop that never runs the canary task."""
        class StubClient:
            def set_instance_filter(self, fn):
                pass

        checker = CanaryHealthChecker(StubClient())
        with pytest.raises(RuntimeError):
            checker.start()
        assert checker._task is None

    async def test_hung_worker_evicted_and_recovers(self):
        drt = DistributedRuntime.detached()
        ep = drt.namespace("health").component("backend").endpoint("generate")
        hang0 = asyncio.Event()
        hang1 = asyncio.Event()
        await ep.serve_endpoint(make_worker(hang0), instance_id=0)
        await ep.serve_endpoint(make_worker(hang1), instance_id=1)
        client = await ep.client()
        await client.wait_for_instances()

        checker = CanaryHealthChecker(
            client, interval_s=0.1, timeout_s=0.2, failure_threshold=2,
            canary_wait_time_s=0.0,
        )
        await checker.check_all()
        assert checker.unhealthy_ids() == set()

        hang1.set()  # worker 1 hangs but its lease stays alive
        await checker.check_all()  # strike 1
        await checker.check_all()  # strike 2 → unhealthy
        assert checker.unhealthy_ids() == {1}

        # routing excludes the hung worker: 8 requests all land on worker 0
        for _ in range(8):
            out = await collect(client.generate({"x": 1}, Context()))
            assert out[0]["token_ids"] == [1]

        hang1.clear()  # worker recovers
        await checker.check_all()
        assert checker.unhealthy_ids() == set()

    async def test_all_unhealthy_raises_no_instances(self):
        drt = DistributedRuntime.detached()
        ep = drt.namespace("health2").component("backend").endpoint("generate")
        hang = asyncio.Event()
        await ep.serve_endpoint(make_worker(hang), instance_id=0)
        client = await ep.client()
        await client.wait_for_instances()
        checker = CanaryHealthChecker(
            client, interval_s=0.1, timeout_s=0.2, failure_threshold=1,
            canary_wait_time_s=0.0,
        )
        hang.set()
        await checker.check_all()
        assert checker.unhealthy_ids() == {0}
        with pytest.raises(NoInstancesError):
            await collect(client.generate({"x": 1}, Context()))
        # direct routing bypasses the health filter (migration/debug path)
        hang.clear()
        out = await collect(client.direct({"x": 1}, 0))
        assert out[0]["finish_reason"] == "stop"

    async def test_injected_canary_faults_evict_then_first_pass_readmits(self):
        """faultline seam: injected canary failures must drive the same
        exclusion machinery as a hung worker — the sick instance stops
        receiving routed traffic, transitions land on the health flight
        ring, and the FIRST passing canary re-admits it."""
        
        drt = DistributedRuntime.detached()
        ep = drt.namespace("health5").component("backend").endpoint("generate")
        calls = []

        def worker(wid):
            async def handler(request, context):
                calls.append(wid)
                yield {"token_ids": [wid], "finish_reason": "stop"}
            return handler

        await ep.serve_endpoint(worker(0), instance_id=0)
        await ep.serve_endpoint(worker(1), instance_id=1)
        client = await ep.client()
        await client.wait_for_instances()
        checker = CanaryHealthChecker(
            client, interval_s=0.1, timeout_s=0.5, failure_threshold=2,
            canary_wait_time_s=0.0,
        )
        # Canary probes alternate instance 0, 1 per sweep; fail ONLY
        # instance 1's probes (hits 2 and 4), twice → threshold.
        plan = faults.FaultPlan(rules=(
            faults.FaultRule(
                point=fn.HEALTH_CANARY, at=(2, 4), kind="timeout",
            ),
        ))
        try:
            with faults.armed(plan):
                await checker.check_all()  # strike 1 on instance 1
                await checker.check_all()  # strike 2 → unhealthy
            assert checker.unhealthy_ids() == {1}
            events = checker.flight.snapshot()
            assert [e["kind"] for e in events] == ["unhealthy"]
            assert events[0]["instance"] == 1 and events[0]["failures"] == 2
            # Routed traffic excludes the sick worker entirely.
            calls.clear()
            for _ in range(6):
                out = await collect(client.generate({"x": 1}, Context()))
                assert out[0]["token_ids"] == [0]
            assert set(calls) == {0}
            # Plan disarmed (fault cleared): the FIRST passing canary
            # re-admits the worker and records the recovery.
            await checker.check_all()
            assert checker.unhealthy_ids() == set()
            kinds = [e["kind"] for e in checker.flight.snapshot()]
            assert kinds == ["unhealthy", "recovered"]
            calls.clear()
            for _ in range(8):
                await collect(client.generate({"x": 1}, Context()))
            assert set(calls) == {0, 1}  # back in rotation
        finally:
            faults.disarm()
            await drt.shutdown(grace_period=1)

    async def test_worker_metadata_payload_preferred(self):
        drt = DistributedRuntime.detached()
        ep = drt.namespace("health3").component("backend").endpoint("generate")
        seen = []

        async def handler(request, context):
            seen.append(request)
            yield {"ok": True}

        await ep.serve_endpoint(
            handler, instance_id=0,
            metadata={"health_payload": {"canary": "custom"}},
        )
        client = await ep.client()
        await client.wait_for_instances()
        checker = CanaryHealthChecker(client, canary_wait_time_s=0.0)
        await checker.check_all()
        assert seen and seen[-1] == {"canary": "custom"}

    async def test_background_loop_marks_unhealthy(self):
        """A hung (not dead) worker stops receiving requests within the
        canary interval."""
        drt = DistributedRuntime.detached()
        ep = drt.namespace("health4").component("backend").endpoint("generate")
        hang = asyncio.Event()
        served = []

        async def healthy_handler(request, context):
            served.append(request)
            yield {"from": "healthy"}

        await ep.serve_endpoint(make_worker(hang), instance_id=0)
        await ep.serve_endpoint(healthy_handler, instance_id=1)
        client = await ep.client()
        await client.wait_for_instances()
        checker = CanaryHealthChecker(
            client, interval_s=0.05, timeout_s=0.1, failure_threshold=2,
            canary_wait_time_s=0.0,
        )
        checker.start()
        try:
            hang.set()
            for _ in range(100):
                if checker.unhealthy_ids() == {0}:
                    break
                await asyncio.sleep(0.05)
            assert checker.unhealthy_ids() == {0}
            out = await collect(client.generate({"q": 1}, Context()))
            assert out[0]["from"] == "healthy"
        finally:
            await checker.stop()


class TestIncarnationFence:
    def test_newest_wins_and_stale_is_counted(self):
        fence = IncarnationFence("load_report")
        before = drops("load_report")
        assert fence.admit(1, 100) == "applied"  # first sighting
        assert fence.admit(1, 100) == "applied"  # same incarnation
        assert fence.admit(1, 200) == "rejoined"  # restart
        assert fence.admit(1, 100) == "stale"  # zombie's late packet
        assert fence.admit(1, 200) == "applied"
        assert drops("load_report") == before + 1
        assert fence.newest(1) == 200

    def test_unstamped_peers_pass_free(self):
        """Mixed fleets: a pre-crash-plane peer (inc 0/None) is never
        fenced — fencing is opt-in by stamping."""
        fence = IncarnationFence("tcp")
        assert fence.admit(7, 0) == "applied"
        assert fence.admit(7, None) == "applied"
        assert fence.admit(7, 5) == "applied"  # first stamp, no prior
        assert fence.admit(7, 0) == "applied"  # unstamped still free

    def test_drop_forgets_key(self):
        fence = IncarnationFence("load_report")
        fence.admit(1, 100)
        fence.drop(1)
        # Re-registration re-establishes from its own stamp: an OLDER
        # stamp after a full departure is a fresh worldview, not a zombie.
        assert fence.admit(1, 50) == "applied"

    def test_process_incarnation_fits_the_wire(self):
        """The stamp must survive msgpack's int64 bound (tcp envelopes,
        pull replies) — a nanosecond stamp would not."""
        saved = process_incarnation()
        assert 0 < saved < 2 ** 63
        set_process_incarnation(None)
        try:
            fresh = process_incarnation()
            assert 0 < fresh < 2 ** 63
            assert fresh >= saved  # monotonically fresh across "restarts"
        finally:
            set_process_incarnation(saved)


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


class TestDetection:
    def mk(self, **kw):
        clock = FakeClock()
        deaths, rejoins = [], []
        tracker = LivenessTracker(
            LivenessConfig(interval_s=1.0, suspect_after=2, dead_after=5),
            clock=clock,
            on_dead=lambda w, inc: deaths.append((w, inc)),
            on_rejoin=lambda w, inc: rejoins.append((w, inc)),
            **kw,
        )
        return tracker, clock, deaths, rejoins

    def test_suspect_then_dead_within_budget(self):
        tracker, clock, deaths, _ = self.mk()
        tracker.observe_report(1, 100)
        assert tracker.state_of(1) == ALIVE

        clock.advance(1.0)
        tracker.observe_report(1, 100)  # on-cadence report keeps it alive
        assert tracker.evaluate() == []
        assert tracker.state_of(1) == ALIVE

        clock.advance(2.5)  # 2.5 intervals missed
        assert tracker.evaluate() == []
        assert tracker.state_of(1) == SUSPECT
        assert not deaths

        clock.advance(2.5)  # 5 intervals total: the budget
        assert tracker.evaluate() == [1]
        assert tracker.state_of(1) == DEAD
        assert deaths == [(1, 100)]
        # The bound is CONFIGURATION, not TCP: detection latency recorded
        # for this death is exactly the elapsed fake time since the last
        # report — within one sweep of dead_after × interval_s.
        assert tracker.config.detection_budget_s == 5.0
        # A second sweep must not re-fire.
        assert tracker.evaluate() == []
        assert deaths == [(1, 100)]

    def test_report_after_death_is_a_rejoin_even_same_incarnation(self):
        """A worker that froze (GC pause, SIGSTOP) past the budget and
        resumed REPORTS again under the same incarnation. Its router
        state was purged at death, so re-admission must rebuild from a
        clean slate: the tracker treats it as a rejoin."""
        tracker, clock, deaths, rejoins = self.mk()
        tracker.observe_report(1, 100)
        clock.advance(6.0)
        assert tracker.evaluate() == [1]
        tracker.observe_report(1, 100)
        assert rejoins == [(1, 100)]
        assert tracker.state_of(1) == ALIVE

    def test_fresh_incarnation_purges_before_apply(self):
        """Restart detected by incarnation (before any death sweep):
        on_rejoin (the drop_worker hook) fires BEFORE the fresh report is
        applied, so old and new state never conflate."""
        tracker, clock, _, rejoins = self.mk()
        tracker.observe_report(1, 100)
        clock.advance(0.5)
        assert tracker.observe_report(1, 200) == "rejoined"
        assert rejoins == [(1, 200)]
        assert tracker.state_of(1) == ALIVE

    def test_zombie_report_does_not_keep_worker_alive(self):
        """The crash-plane failure mode fencing exists for: the restarted
        worker dies, and the OLD zombie's late reports keep arriving.
        They must not mask the death."""
        tracker, clock, deaths, _ = self.mk()
        before = drops("load_report")
        tracker.observe_report(1, 200)
        for _ in range(6):
            clock.advance(1.0)
            assert tracker.observe_report(1, 100) == "stale"  # zombie
        assert tracker.evaluate() == [1]
        assert deaths and drops("load_report") == before + 6

    def test_suspect_recovers_on_next_report(self):
        tracker, clock, deaths, rejoins = self.mk()
        tracker.observe_report(1, 100)
        clock.advance(3.0)
        tracker.evaluate()
        assert tracker.state_of(1) == SUSPECT
        tracker.observe_report(1, 100)
        assert tracker.state_of(1) == ALIVE
        assert not deaths and not rejoins

    def test_drop_forgets_worker_and_fence(self):
        tracker, clock, _, _ = self.mk()
        tracker.observe_report(1, 100)
        tracker.drop(1)
        assert tracker.state_of(1) is None
        assert tracker.observe_report(1, 50) == "applied"  # fresh fence

    def test_injected_report_loss_trips_detection(self):
        """The liveness.report chaos seam: N consecutive lost reports trip
        the same machinery a crashed worker does."""
        tracker, clock, deaths, _ = self.mk()
        tracker.observe_report(1, 100)
        plan = faults.FaultPlan(seed=3, rules=(
            faults.FaultRule(point=fn.LIVENESS_REPORT, every=1,
                             kind="error", times=100),
        ))
        with faults.armed(plan):
            for _ in range(6):
                clock.advance(1.0)
                with pytest.raises(faults.InjectedError):
                    tracker.observe_report(1, 100)
        assert tracker.evaluate() == [1]
        assert deaths == [(1, 100)]

    def test_metrics_and_flight_surface(self):
        tracker, clock, _, _ = self.mk()
        tracker.observe_report(1, 100)
        clock.advance(6.0)
        tracker.evaluate()
        text = tracker.metrics.render()
        assert "dynamo_tpu_liveness_worker_state" in text
        assert "dynamo_tpu_liveness_detection_seconds" in text
        kinds = [e["kind"] for e in tracker.flight.snapshot()]
        assert "discovered" in kinds and "dead" in kinds


class TestBackoff:
    def test_deterministic_under_seeded_rng(self):
        import random as _random

        a = Backoff(base_s=0.1, cap_s=2.0, rng=_random.Random(7))
        b = Backoff(base_s=0.1, cap_s=2.0, rng=_random.Random(7))
        seq_a = [a.next_delay() for _ in range(8)]
        seq_b = [b.next_delay() for _ in range(8)]
        assert seq_a == seq_b  # fake-clock replayable

    def test_doubles_caps_and_jitters(self):
        import random as _random

        bo = Backoff(base_s=0.1, cap_s=1.0, jitter=0.5,
                     rng=_random.Random(11))
        raw = [0.1 * 2 ** n for n in range(8)]
        for n, delay in enumerate(bo.next_delay() for _ in range(8)):
            base = min(raw[n], 1.0)
            assert 0.5 * base <= delay <= 1.5 * base

    def test_two_workers_desynchronize(self):
        """The point of the jitter: two processes failing at the same
        instant must NOT retry at the same instants."""
        import random as _random

        a = Backoff(base_s=0.5, cap_s=30.0, rng=_random.Random(1))
        b = Backoff(base_s=0.5, cap_s=30.0, rng=_random.Random(2))
        seq_a = [a.next_delay() for _ in range(6)]
        seq_b = [b.next_delay() for _ in range(6)]
        assert seq_a != seq_b

    def test_reset_restarts_cheap(self):
        bo = Backoff(base_s=0.1, cap_s=10.0, jitter=0.0)
        assert [bo.next_delay() for _ in range(3)] == [0.1, 0.2, 0.4]
        bo.reset()
        assert bo.next_delay() == 0.1


async def test_discd_watch_bootstrap_retries_until_server_appears():
    """A watch requested while discd is down (or mid-restart) must not die
    with a one-shot bootstrap failure: it retries with backoff and
    delivers the snapshot once the server is back."""
    import socket

    from dynamo_tpu_torch.runtime.discovery import EventKind
    from dynamo_tpu_torch.runtime.discovery.discd import DiscdDiscovery, DiscdServer

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    client = DiscdDiscovery(f"127.0.0.1:{port}")
    watch = client.watch("inst/")  # nothing is listening yet
    await asyncio.sleep(0.3)  # a few failed bootstrap attempts

    server = DiscdServer(host="127.0.0.1", port=port)
    await server.start()
    try:
        await client.put("inst/a", {"v": 1})
        event = await asyncio.wait_for(watch.__anext__(), timeout=10)
        assert event.kind == EventKind.PUT and event.key == "inst/a"
    finally:
        await watch.aclose()
        await client.close()
        await server.stop()


async def test_keepalive_outage_reregisters_under_fresh_lease():
    """A control-plane outage long enough to expire the serving lease
    must END with the worker re-registered (fresh lease, every leased doc
    re-put) — not permanently vanished until a human restarts it."""
    from dynamo_tpu_torch.runtime.discovery import Lease, MemoryDiscovery
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    class OutageDiscovery(MemoryDiscovery):
        def __init__(self):
            super().__init__()
            self.down = False
            self.lease_seq = 0
            self.dead_leases = set()

        async def create_lease(self, ttl: float) -> Lease:
            if self.down:
                raise ConnectionError("control plane down")
            self.lease_seq += 1
            return Lease(id=f"l{self.lease_seq}", ttl=ttl)

        async def keep_alive(self, lease: Lease) -> None:
            if self.down:
                # A renewal missed while down expires the lease for good
                # — exactly etcd's behavior once the TTL lapses.
                self.dead_leases.add(lease.id)
                raise ConnectionError("control plane down")
            if lease.id in self.dead_leases:
                raise ConnectionError("lease expired")

    disco = OutageDiscovery()
    rt = DistributedRuntime(discovery=disco, bus="liveness-rereg")
    os.environ["DYN_TPU_LEASE_TTL"] = "0.2"
    served = None
    try:
        class Echo:
            async def generate(self, request, context):
                yield {"ok": True}

        ep = rt.namespace("lv").component("backend").endpoint("generate")
        served = await ep.serve_endpoint(Echo().generate, instance_id=9)
        key = served.instance.key
        assert await disco.get(key) is not None

        # Outage: keep-alives fail; past the TTL the lease is dead. The
        # memory backend doesn't sweep, so model the expiry explicitly.
        # Long enough for at least one keep-alive attempt to hit the
        # outage (the loop cadence is max(0.5, ttl/3) = 0.5s).
        disco.down = True
        await asyncio.sleep(1.2)
        await disco.delete(key)
        disco.down = False

        deadline = time.monotonic() + 10
        while await disco.get(key) is None:
            assert time.monotonic() < deadline, "never re-registered"
            await asyncio.sleep(0.05)
        assert disco.lease_seq >= 2  # a FRESH lease, not the dead one
    finally:
        os.environ.pop("DYN_TPU_LEASE_TTL", None)
        if served is not None:
            await served.shutdown(grace_period=1)
        await rt.shutdown(grace_period=1)


async def test_abort_instance_fails_streams_immediately():
    """abort_instance must fail an in-flight stream NOW (typed), not
    after any transport timeout."""
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

    rt = DistributedRuntime.detached()
    served = None
    try:
        class Stuck:
            async def generate(self, request, context):
                yield {"token_ids": [1]}
                await asyncio.sleep(3600)  # the dead worker never answers

        ep = rt.namespace("lv").component("backend").endpoint("generate")
        served = await ep.serve_endpoint(Stuck().generate, instance_id=5)
        client = await ep.client()
        await client.wait_for_instances()
        client.enable_stream_aborts()

        got = []

        async def consume():
            async for item in client.generate({"token_ids": [1, 2]}, Context()):
                got.append(item)

        task = asyncio.ensure_future(consume())
        while not got:
            await asyncio.sleep(0.01)

        err = WorkerLostError("worker 0x5 declared dead")
        t0 = time.monotonic()
        assert client.abort_instance(5, err) == 1
        with pytest.raises(WorkerLostError):
            await task
        assert time.monotonic() - t0 < 2.0  # immediate, not a timeout
        assert isinstance(err, ConnectionError)  # migratable
        assert client.evict_instance(5) is True
        assert client.abort_instance(5, err) == 0  # nothing left
        # Same-incarnation rejoin (frozen worker resumed — it never
        # re-PUTs its discovery key, so the watch can't re-add it):
        # revive_instance is the road back, and it must round-trip.
        assert client.revive_instance(5) is True
        assert client.revive_instance(5) is False  # already routable
        assert 5 in (await client.wait_for_instances())
    finally:
        if served is not None:
            await served.shutdown(grace_period=1)
        await rt.shutdown(grace_period=1)


async def test_tcp_frames_fenced_to_one_incarnation():
    """One tcp stream = one serving incarnation: frames claiming another
    (a zombie's late packets after the listener restarted) are counted
    and dropped, never delivered."""
    from dynamo_tpu_torch.runtime.network.tcp import _TcpClientEngine

    class FakeConn:
        def __init__(self):
            self.q = asyncio.Queue()
            self.closed_streams = []

        def open_stream(self):
            return 1, self.q

        async def send(self, header, payload=None):
            pass

        def close_stream(self, sid):
            self.closed_streams.append(sid)

    class FakePlane:
        def __init__(self, conn):
            self.conn = conn

        async def _conn(self, addr):
            return self.conn

    conn = FakeConn()
    engine = _TcpClientEngine(FakePlane(conn), ("127.0.0.1", 1), "k")
    conn.q.put_nowait(("item", {"t": 1}, 7000))
    conn.q.put_nowait(("item", {"t": 666}, 6999))  # zombie frame
    conn.q.put_nowait(("item", {"t": 2}, 7000))
    conn.q.put_nowait(("end", None, 7000))

    before = drops("tcp")
    items = await collect(engine.generate({}, Context()))
    assert [i["t"] for i in items] == [1, 2]
    assert drops("tcp") == before + 1
