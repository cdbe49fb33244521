"""The port's event plane (runtime/events/zmq_plane.py over its own ZMTP,
runtime/events/zmtp.py) against the JAX package's over pyzmq: every
combination of broker, publisher and subscriber package (exact and
wildcard topics, long frames, publish before subscribe dropped as libzmq
drops it); the ZMTP greeting equal to libzmq's; REQ/REP between the port's
sockets and pyzmq's; the durable logs of the two brokers byte-equal for one
published sequence; replay_events across the packages; a restarted broker
continuing the sequence over a log either package wrote, a torn tail
truncated."""

import asyncio
import io
import socket
import types

import msgpack
import pytest
import zmq
import zmq.asyncio

from dynamo_tpu.runtime.events import zmq_plane as jplane
from dynamo_tpu_torch.runtime.events import zmq_plane as tplane
from dynamo_tpu_torch.runtime.events import zmtp

JAX = types.SimpleNamespace(name="jax", plane=jplane)
PORT = types.SimpleNamespace(name="port", plane=tplane)
APIS = [pytest.param(JAX, id="jax"), pytest.param(PORT, id="port")]
WAIT = 5.0
PROBE = "settle-probe"  # the payload key of an in-band probe, and the raw probes' topic


async def until(cond, what, timeout=2 * WAIT):
    """Poll ``cond()`` (sync or async) until it is truthy; fail after
    ``timeout`` seconds."""
    deadline = asyncio.get_running_loop().time() + timeout
    while True:
        got = cond()
        if asyncio.iscoroutine(got):
            got = await got
        if got:
            return got
        assert asyncio.get_running_loop().time() < deadline, f"{what}: not within {timeout} s"
        await asyncio.sleep(0.01)


async def until_delivered(pub, topic, subs, timeout=2 * WAIT):
    """Publish probes on ``topic`` until each subscription of ``subs`` has
    read one: ``pub`` now sends what it publishes on ``topic`` (a
    subscription covering it reached ``pub`` through the broker), and the
    broker forwards it to each of ``subs``. A publisher's messages reach a
    subscriber in order, so what ``pub`` publishes next arrives after every
    probe; ``get`` skips them."""
    pending = list(subs)
    deadline = asyncio.get_running_loop().time() + timeout
    n = 0
    while pending:
        assert asyncio.get_running_loop().time() < deadline, f"no probe on {topic} within {timeout} s"
        await pub.publish(topic, {PROBE: n})
        n += 1
        for sub in list(pending):
            try:
                _, payload = await sub.get(0.02)
            except asyncio.TimeoutError:
                continue
            assert PROBE in payload, f"a message before any probe: {payload}"
            pending.remove(sub)


async def get(sub, timeout=WAIT):
    """The next message of ``sub`` that is not a probe."""
    while True:
        topic, payload = await sub.get(timeout)
        if not (isinstance(payload, dict) and PROBE in payload):
            return topic, payload


async def _send_raw(plane, frames):
    if hasattr(plane, "_connect_pub"):  # the port's publisher connects in the background
        await asyncio.shield(plane._connect_pub())
    await plane._pub.send_multipart(frames)


async def publisher_holds_subscriptions(plane, broker_address, timeout=2 * WAIT):
    """Wait until the publisher of ``plane`` holds every subscription its
    broker has handed up so far. A raw SUB made now subscribes to the probe
    topic; the broker hands that up after the earlier ones, in order on each
    publisher's connection, so the first probe of ``plane`` that reaches it
    proves the publisher has them all. The probes have three frames, which
    neither package's durable broker logs (it logs two-frame messages)."""
    host, _, xpub = broker_address.rsplit(":", 2)
    probe = zmq.asyncio.Context.instance().socket(zmq.SUB)
    probe.connect(f"tcp://{host}:{xpub}")
    probe.setsockopt(zmq.SUBSCRIBE, PROBE.encode())
    deadline = asyncio.get_running_loop().time() + timeout
    try:
        while True:
            assert asyncio.get_running_loop().time() < deadline, \
                f"the publisher got no subscription within {timeout} s"
            await _send_raw(plane, [PROBE.encode(), b"", b""])
            if await probe.poll(20):
                await probe.recv_multipart()
                return
    finally:
        probe.close(0)


def _broker(api, **kw):
    broker = api.plane.EventBroker(**kw)
    broker.start()
    return broker


@pytest.mark.parametrize("sub_api", APIS)
@pytest.mark.parametrize("pub_api", APIS)
@pytest.mark.parametrize("broker_api", APIS)
async def test_pub_sub_through_either_broker(broker_api, pub_api, sub_api):
    broker = _broker(broker_api)
    pub = pub_api.plane.ZmqEventPlane(broker.address)
    subs = sub_api.plane.ZmqEventPlane(broker.address)
    try:
        exact = subs.subscribe("ns.comp.kv_events")
        wild = subs.subscribe("ns.>")
        await until_delivered(pub, "ns.comp.kv_events", [exact, wild])
        await until_delivered(pub, "ns.comp.load", [wild])
        big = {"blob": b"\x07" * 5000, "ids": list(range(300))}
        await pub.publish("ns.comp.kv_events", {"k": 1})
        await pub.publish("other.topic", {"k": 2})
        await pub.publish("ns.comp.load", big)
        assert await get(exact) == ("ns.comp.kv_events", {"k": 1})
        assert await get(wild) == ("ns.comp.kv_events", {"k": 1})
        assert await get(wild) == ("ns.comp.load", big)  # other.topic filtered
        await exact.aclose()
        await wild.aclose()
    finally:
        await pub.close()
        await subs.close()
        await broker.close()


@pytest.mark.parametrize("pub_api", APIS)
async def test_publish_before_subscribe_is_dropped_as_by_libzmq(pub_api):
    """A non-durable broker forwards only what a subscriber asked for: a
    message published before the subscription reached the publisher is
    dropped at the publisher, with pyzmq's PUB and the port's alike."""
    broker = _broker(JAX)
    pub = pub_api.plane.ZmqEventPlane(broker.address)
    subs = JAX.plane.ZmqEventPlane(broker.address)
    try:
        # the publisher is connected and holds no subscription to t.>
        await publisher_holds_subscriptions(pub, broker.address)
        await pub.publish("t.a", {"n": 1})
        sub = subs.subscribe("t.>")
        await until_delivered(pub, "t.b", [sub])
        await pub.publish("t.b", {"n": 2})
        assert await get(sub) == ("t.b", {"n": 2})  # t.a, published first, is not there
        with pytest.raises(asyncio.TimeoutError):
            await get(sub, 0.2)
    finally:
        await pub.close()
        await subs.close()
        await broker.close()


async def test_greeting_is_libzmqs():
    """The 64-byte greeting a pyzmq socket sends is byte for byte the
    port's (signature, version 3.1, NULL, as-server 0, filler)."""
    ctx = zmq.asyncio.Context.instance()
    xpub = ctx.socket(zmq.XPUB)
    port = xpub.bind_to_random_port("tcp://127.0.0.1")
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(zmtp.GREETING)
        await writer.drain()
        got = await asyncio.wait_for(reader.readexactly(64), WAIT)
        writer.close()
        assert got == zmtp.GREETING
    finally:
        xpub.close(0)


async def test_port_sockets_refuse_a_wrong_socket_type():
    """A SUB cannot talk to a REP: the handshake raises."""
    rep = zmtp.RepSocket("127.0.0.1")
    await rep.start()
    try:
        with pytest.raises(zmtp.ZmtpError, match="cannot talk"):
            await asyncio.wait_for(zmtp.connect("127.0.0.1", rep.port, b"SUB"), WAIT)
    finally:
        await rep.close()


async def test_port_req_against_pyzmq_rep():
    ctx = zmq.asyncio.Context.instance()
    rep = ctx.socket(zmq.REP)
    port = rep.bind_to_random_port("tcp://127.0.0.1")
    req = zmtp.ReqSocket()
    try:
        await asyncio.wait_for(req.connect("127.0.0.1", port), WAIT)
        for body in (b"one", b"", b"x" * 1000):
            await req.send(body)
            got = await asyncio.wait_for(rep.recv(), WAIT)
            assert got == body
            await rep.send(b"re:" + got)
            assert await asyncio.wait_for(req.recv(), WAIT) == b"re:" + body
    finally:
        req.close()
        rep.close(0)


async def test_pyzmq_req_against_port_rep():
    rep = zmtp.RepSocket("127.0.0.1")
    await rep.start()
    ctx = zmq.asyncio.Context.instance()
    reqs = [ctx.socket(zmq.REQ) for _ in range(2)]
    try:
        for r in reqs:
            r.connect(f"tcp://127.0.0.1:{rep.port}")
        for i in range(3):
            for j, r in enumerate(reqs):  # replies go back to their sender
                await r.send(b"q%d%d" % (i, j) * (100 * i + 1))
                got = await asyncio.wait_for(rep.recv(), WAIT)
                await rep.send(got[::-1])
                assert await asyncio.wait_for(r.recv(), WAIT) == got[::-1]
    finally:
        for r in reqs:
            r.close(0)
        await rep.close()


SEQUENCE = [("ns.kv.%d" % (i % 3), {"i": i, "blocks": list(range(i % 7)),
                                    "pad": "é" * (i * 13 % 400)}) for i in range(300)]


async def _durable_log(broker_api, tmp_path, publisher_api=JAX):
    log = str(tmp_path / f"{broker_api.name}-{publisher_api.name}.log")
    broker = _broker(broker_api, log_path=log)
    pub = publisher_api.plane.ZmqEventPlane(broker.address)
    try:
        await publisher_holds_subscriptions(pub, broker.address)  # the broker's subscribe-all
        for topic, payload in SEQUENCE:
            await pub.publish(topic, payload)
        for _ in range(200):
            if broker.seq == len(SEQUENCE):
                break
            await asyncio.sleep(0.02)
        assert broker.seq == len(SEQUENCE)
        replay_port = broker.replay_port
        return log, broker, pub, replay_port
    except BaseException:
        await pub.close()
        await broker.close()
        raise


async def test_the_two_brokers_logs_are_byte_equal(tmp_path):
    logs = {}
    for api in (JAX, PORT):
        log, broker, pub, _ = await _durable_log(api, tmp_path)
        await pub.close()
        await broker.close()
        with open(log, "rb") as f:
            logs[api.name] = f.read()
    assert logs["jax"] == logs["port"]
    records = list(msgpack.Unpacker(io.BytesIO(logs["port"]), raw=False))
    assert [r[0] for r in records] == list(range(1, len(SEQUENCE) + 1))
    assert [(t, msgpack.unpackb(p, raw=False)) for _, t, p in records] == SEQUENCE


@pytest.mark.parametrize("replayer", APIS)
@pytest.mark.parametrize("broker_api", APIS)
async def test_replay_events_across_the_packages(tmp_path, broker_api, replayer):
    log, broker, pub, replay_port = await _durable_log(broker_api, tmp_path, PORT)
    try:
        got = await replayer.plane.replay_events("127.0.0.1", replay_port, timeout_s=WAIT)
        assert [(s, t, p) for s, t, p in got] == [
            (i + 1, t, p) for i, (t, p) in enumerate(SEQUENCE)]
        tail = await replayer.plane.replay_events("127.0.0.1", replay_port, from_seq=290,
                                                  timeout_s=WAIT)
        assert [s for s, _, _ in tail] == list(range(290, 301))
        assert await replayer.plane.replay_events("127.0.0.1", replay_port, from_seq=301,
                                                  timeout_s=WAIT) == []
    finally:
        await pub.close()
        await broker.close()


@pytest.mark.parametrize("restarted", APIS)
@pytest.mark.parametrize("first", APIS)
async def test_a_restarted_broker_continues_the_sequence(tmp_path, first, restarted):
    """A broker restarted over a log (either package's) indexes it, drops a
    torn tail, continues the sequence and serves the whole history."""
    log, broker, pub, _ = await _durable_log(first, tmp_path, PORT)
    await pub.close()
    await broker.close()
    with open(log, "ab") as f:
        f.write(msgpack.packb([301, "torn"], use_bin_type=True)[:-2])  # a crash mid-write
    again = _broker(restarted, log_path=log)
    pub = PORT.plane.ZmqEventPlane(again.address)
    try:
        assert again.seq == len(SEQUENCE)
        assert again._offsets == {1: 0, 257: again._offsets[257]}
        await publisher_holds_subscriptions(pub, again.address)
        await pub.publish("ns.after", {"restart": True})
        for _ in range(200):
            if again.seq == len(SEQUENCE) + 1:
                break
            await asyncio.sleep(0.02)
        got = await PORT.plane.replay_events("127.0.0.1", again.replay_port, from_seq=299,
                                             timeout_s=WAIT)
        assert got == [(299, *SEQUENCE[298]), (300, *SEQUENCE[299]),
                       (301, "ns.after", {"restart": True})]
    finally:
        await pub.close()
        await again.close()


async def test_a_plane_that_cannot_reach_its_broker_raises():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    plane = tplane.ZmqEventPlane(f"127.0.0.1:{port}:{port}")
    try:
        for _ in range(2):  # no reconnect: every publish raises
            with pytest.raises(ConnectionError):
                await asyncio.wait_for(plane.publish("t", {}), WAIT)
        sub = plane.subscribe("t")
        with pytest.raises(StopAsyncIteration):
            await sub.get(WAIT)  # the pump closes the subscription
    finally:
        await plane.close()


async def test_a_subscription_closes_when_its_broker_goes():
    broker = _broker(PORT)
    plane = tplane.ZmqEventPlane(broker.address)
    try:
        sub = plane.subscribe("t.>")
        await until(lambda: broker._xpub._all.get(b"t."), "the subscription at the broker")
        await broker.close()
        with pytest.raises(StopAsyncIteration):
            await sub.get(WAIT)
        with pytest.raises(ConnectionError):
            await plane.publish("t.x", {})
    finally:
        await plane.close()


async def test_publish_never_waits_on_a_broker_that_stops_reading(monkeypatch):
    """A broker that stops reading (its loop stalled) holds XSUB_INBOX
    messages and then reads its publishers' connections no more; the
    publisher queues up to SEND_QUEUE_BYTES and drops past it, as libzmq's
    PUB drops at its high-water mark: publish returns at once throughout,
    and what arrives once the broker reads again is in order."""
    monkeypatch.setattr(zmtp, "XSUB_INBOX", 8)
    monkeypatch.setattr(zmtp, "SEND_QUEUE_BYTES", 1 << 20)
    xsub = zmtp.XSubSocket("127.0.0.1")
    await xsub.start()
    plane = tplane.ZmqEventPlane(f"127.0.0.1:{xsub.port}:{xsub.port}")
    blob, n = b"\x07" * (64 * 1024), 800  # 50 MiB: past every buffer on the way

    async def publish_all():
        for i in range(n):
            await plane.publish("t", {"i": i, "blob": blob})
            await asyncio.sleep(0)  # the broker's sessions may read

    try:
        await xsub.send(b"\x01")  # subscribe to all, as the durable broker does
        await plane._connect_pub()
        await until(lambda: b"" in plane._pub._subs, "the subscribe-all at the publisher")
        await asyncio.wait_for(publish_all(), WAIT)
        assert xsub._inbox.qsize() == 8
        assert plane._pub._conn.queued() <= (1 << 20) + len(blob) + 64
        got = []
        while True:
            try:
                frames = await asyncio.wait_for(xsub.recv_multipart(), 1.0)
            except asyncio.TimeoutError:
                break
            got.append(msgpack.unpackb(frames[1])["i"])
        assert got[:8] == list(range(8)) and got == sorted(set(got))
        assert len(got) < n  # the rest were dropped at the publisher
    finally:
        await plane.close()
        await xsub.close()
