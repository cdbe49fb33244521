"""The runtime's request and discovery planes, the port against the JAX
package: the port's copies of tests/test_distributed_network.py's ten
tests (codec, TCP streaming / cancellation / disconnect, file discovery,
discd, the ZMQ event plane, the full discd + TCP + ZMQ stack, discd's
snapshot restore) run on dynamo_tpu_torch; frames byte-equal to JAX's
pack_frame; a JAX client against a port server and the reverse over TCP
(streaming, a cancel that reaches the worker, a dead worker, every typed
``err`` kind); the port's discd client against JAX's server and the
reverse; a snapshot written by one server restored by the other; the file
backend's documents equal and read across the packages."""

import asyncio
import json
import os
import types

import pytest

from dynamo_tpu.llm.protocols import common as jproto
from dynamo_tpu.parsers import incremental as jincremental
from dynamo_tpu.runtime import component as jcomponent
from dynamo_tpu.runtime import context as jcontext
from dynamo_tpu.runtime import drain as jdrain
from dynamo_tpu.runtime import tasks as jtasks
from dynamo_tpu.runtime.discovery import Lease as JLease
from dynamo_tpu.runtime.discovery import discd as jdiscd
from dynamo_tpu.runtime.discovery import file as jfile
from dynamo_tpu.runtime.network import codec as jcodec
from dynamo_tpu.runtime.network import tcp as jtcp
from dynamo_tpu_torch.llm.protocols import common as tproto
from dynamo_tpu_torch.llm.protocols.common import BackendOutput, FinishReason
from dynamo_tpu_torch.parsers import incremental as tincremental
from dynamo_tpu_torch.runtime import component as tcomponent
from dynamo_tpu_torch.runtime import context as tcontext
from dynamo_tpu_torch.runtime import drain as tdrain
from dynamo_tpu_torch.runtime import tasks as ttasks
from dynamo_tpu_torch.runtime.component import RouterMode
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.discovery import EventKind, MemoryDiscovery
from dynamo_tpu_torch.runtime.discovery import Lease as TLease
from dynamo_tpu_torch.runtime.discovery import discd as tdiscd
from dynamo_tpu_torch.runtime.discovery import file as tfile
from dynamo_tpu_torch.runtime.discovery.discd import DiscdDiscovery, DiscdServer
from dynamo_tpu_torch.runtime.discovery.file import FileDiscovery
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.engine import collect
from dynamo_tpu_torch.runtime.events.zmq_plane import EventBroker, ZmqEventPlane
from dynamo_tpu_torch.runtime.network import codec as tcodec
from dynamo_tpu_torch.runtime.network import tcp as ttcp
from dynamo_tpu_torch.runtime.network.codec import FrameReader, FrameWriter, pack_frame
from dynamo_tpu_torch.runtime.network.tcp import StreamDisconnectedError, TcpRequestPlane


# -- codec -------------------------------------------------------------------


async def test_codec_roundtrip():
    server_frames = []
    done = asyncio.Event()

    async def handle(reader, writer):
        fr = FrameReader(reader)
        while True:
            frame = await fr.recv()
            if frame is None:
                break
            server_frames.append(frame)
        writer.close()  # else 3.12 server.wait_closed() below never returns
        done.set()

    server = await asyncio.start_server(handle, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    fw = FrameWriter(writer)
    await fw.send({"type": "req", "stream": 1}, {"token_ids": [1, 2, 3]})
    # Dataclasses with to_dict serialize transparently.
    await fw.send({"type": "item"}, BackendOutput(token_ids=[7], finish_reason=FinishReason.EOS))
    await fw.send({"empty": True}, None)
    fw.close()
    await asyncio.wait_for(done.wait(), 5)
    server.close()
    await server.wait_closed()

    assert server_frames[0] == ({"type": "req", "stream": 1}, {"token_ids": [1, 2, 3]})
    assert server_frames[1][1]["token_ids"] == [7]
    assert server_frames[1][1]["finish_reason"] == "eos"
    assert server_frames[2] == ({"empty": True}, None)


# -- TCP request plane -------------------------------------------------------


async def _tcp_pair():
    """Two runtimes sharing a memory discovery bus but talking over real TCP."""
    disco = MemoryDiscovery()
    worker_rt = DistributedRuntime(
        discovery=disco, request_plane=TcpRequestPlane(), bus="tcp-test"
    )
    frontend_rt = DistributedRuntime(
        discovery=disco, request_plane=TcpRequestPlane(), bus="tcp-test"
    )
    return worker_rt, frontend_rt


async def test_tcp_streaming_end_to_end():
    worker_rt, frontend_rt = await _tcp_pair()

    async def handler(request, context):
        for i in range(int(request["n"])):
            yield {"i": i}

    ep = worker_rt.namespace("n").component("c").endpoint("gen")
    served = await ep.serve_endpoint(handler)
    client = await frontend_rt.namespace("n").component("c").endpoint("gen").client()
    try:
        out = await collect(client.generate({"n": 5}))
        assert [o["i"] for o in out] == list(range(5))
    finally:
        await client.close()
        await served.shutdown(grace_period=1)
        await frontend_rt.shutdown(grace_period=1)
        await worker_rt.shutdown(grace_period=1)


async def test_tcp_cancellation_reaches_worker():
    worker_rt, frontend_rt = await _tcp_pair()
    worker_saw_cancel = asyncio.Event()

    async def handler(request, context):
        i = 0
        while True:
            if context.stopped:
                worker_saw_cancel.set()
                return
            yield {"i": i}
            i += 1
            await asyncio.sleep(0.01)

    ep = worker_rt.namespace("n").component("c").endpoint("gen")
    served = await ep.serve_endpoint(handler)
    client = await frontend_rt.namespace("n").component("c").endpoint("gen").client()
    try:
        ctx = Context()
        got = []
        async for item in client.generate({}, ctx):
            got.append(item)
            if len(got) == 3:
                ctx.stop_generating()
                break
        await asyncio.wait_for(worker_saw_cancel.wait(), 5)
    finally:
        await client.close()
        await served.shutdown(grace_period=1)
        await frontend_rt.shutdown(grace_period=1)
        await worker_rt.shutdown(grace_period=1)


async def test_tcp_worker_death_surfaces_disconnect():
    worker_rt, frontend_rt = await _tcp_pair()

    async def handler(request, context):
        yield {"i": 0}
        await asyncio.sleep(30)
        yield {"i": 1}

    ep = worker_rt.namespace("n").component("c").endpoint("gen")
    served = await ep.serve_endpoint(handler)
    client = await frontend_rt.namespace("n").component("c").endpoint("gen").client()
    try:
        with pytest.raises(StreamDisconnectedError):
            async for item in client.generate({}):
                # Kill the worker's plane mid-stream (simulates worker crash).
                await worker_rt.request_plane.close()
    finally:
        await client.close()
        await frontend_rt.shutdown(grace_period=1)
        await worker_rt.shutdown(grace_period=1)


# -- file discovery ----------------------------------------------------------


async def test_file_discovery_put_get_watch(tmp_path):
    d1 = FileDiscovery(str(tmp_path), poll_interval=0.05)
    d2 = FileDiscovery(str(tmp_path), poll_interval=0.05)
    try:
        await d1.put("instances/ns/c/e/0001", {"x": 1})
        assert await d2.get("instances/ns/c/e/0001") == {"x": 1}

        watch = d2.watch("instances/ns/")
        snap = watch.drain_snapshot()
        assert len(snap) == 1 and snap[0].value == {"x": 1}

        await d1.put("instances/ns/c/e/0002", {"x": 2})
        ev = await asyncio.wait_for(watch.__anext__(), 5)
        assert ev.kind == EventKind.PUT and ev.value == {"x": 2}

        await d1.delete("instances/ns/c/e/0001")
        ev = await asyncio.wait_for(watch.__anext__(), 5)
        assert ev.kind == EventKind.DELETE
        await watch.aclose()
    finally:
        await d1.close()
        await d2.close()


async def test_file_discovery_lease_expiry(tmp_path):
    d1 = FileDiscovery(str(tmp_path), poll_interval=0.05)
    d2 = FileDiscovery(str(tmp_path), poll_interval=0.05)
    try:
        lease = await d1.create_lease(ttl=0.3)
        await d1.put("instances/ns/c/e/0001", {"x": 1}, lease=lease)
        assert await d2.get("instances/ns/c/e/0001") == {"x": 1}
        watch = d2.watch("instances/")
        watch.drain_snapshot()
        # No keep-alive → expiry → watchers see DELETE (worker-death signal).
        ev = await asyncio.wait_for(watch.__anext__(), 5)
        assert ev.kind == EventKind.DELETE
        assert await d2.get("instances/ns/c/e/0001") is None
        await watch.aclose()
    finally:
        await d1.close()
        await d2.close()


# -- discd -------------------------------------------------------------------


async def test_discd_end_to_end():
    server = DiscdServer()
    port = await server.start()
    c1 = DiscdDiscovery(f"127.0.0.1:{port}")
    c2 = DiscdDiscovery(f"127.0.0.1:{port}")
    try:
        await c1.put("instances/ns/c/e/01", {"host": "a"})
        assert await c2.get("instances/ns/c/e/01") == {"host": "a"}
        assert "instances/ns/c/e/01" in await c2.get_prefix("instances/")

        watch = c2.watch("instances/")
        ev = await asyncio.wait_for(watch.__anext__(), 5)  # snapshot PUT
        assert ev.kind == EventKind.PUT and ev.key == "instances/ns/c/e/01"

        await c1.put("instances/ns/c/e/02", {"host": "b"})
        ev = await asyncio.wait_for(watch.__anext__(), 5)
        assert ev.value == {"host": "b"}

        # Lease expiry deletes keys and notifies watchers.
        lease = await c1.create_lease(ttl=0.6)
        await c1.put("instances/ns/c/e/03", {"host": "c"}, lease=lease)
        ev = await asyncio.wait_for(watch.__anext__(), 5)
        assert ev.key.endswith("/03")
        ev = await asyncio.wait_for(watch.__anext__(), 5)
        assert ev.kind == EventKind.DELETE and ev.key.endswith("/03")

        # keep_alive holds a second lease open past its TTL.
        lease2 = await c1.create_lease(ttl=0.6)
        await c1.put("instances/ns/c/e/04", {"host": "d"}, lease=lease2)
        for _ in range(4):
            await asyncio.sleep(0.3)
            await c1.keep_alive(lease2)
        assert await c2.get("instances/ns/c/e/04") == {"host": "d"}
        await watch.aclose()
    finally:
        await c1.close()
        await c2.close()
        await server.stop()


# -- zmq event plane ---------------------------------------------------------


async def test_zmq_event_plane_pub_sub():
    broker = EventBroker()
    broker.start()
    p1 = ZmqEventPlane(broker.address)
    p2 = ZmqEventPlane(broker.address)
    try:
        sub = p2.subscribe("ns.comp.kv_events")
        wild = p2.subscribe("ns.>")
        await asyncio.sleep(0.3)  # let SUB connections propagate
        await p1.publish("ns.comp.kv_events", {"k": 1})
        topic, payload = await asyncio.wait_for(sub.get(), 5)
        assert topic == "ns.comp.kv_events" and payload == {"k": 1}
        topic, payload = await asyncio.wait_for(wild.get(), 5)
        assert payload == {"k": 1}

        await p1.publish("other.topic", {"k": 2})
        await p1.publish("ns.comp.load", {"k": 3})
        topic, payload = await asyncio.wait_for(wild.get(), 5)
        assert topic == "ns.comp.load"  # non-matching topic filtered out
        await sub.aclose()
        await wild.aclose()
    finally:
        await p1.close()
        await p2.close()
        await broker.close()


# -- full cross-process-style stack -----------------------------------------


async def test_runtime_over_discd_tcp_zmq(tmp_path):
    """Worker and frontend runtimes wired like separate processes: discd
    discovery, TCP request plane, ZMQ events (the from_settings topology)."""
    server = DiscdServer()
    port = await server.start()
    broker = EventBroker()
    broker.start()

    worker_rt = DistributedRuntime(
        discovery=DiscdDiscovery(f"127.0.0.1:{port}"),
        request_plane=TcpRequestPlane(),
        event_plane=ZmqEventPlane(broker.address),
    )
    front_rt = DistributedRuntime(
        discovery=DiscdDiscovery(f"127.0.0.1:{port}"),
        request_plane=TcpRequestPlane(),
        event_plane=ZmqEventPlane(broker.address),
    )

    async def handler(request, context):
        yield {"echo": request["msg"]}

    served = await worker_rt.namespace("ns").component("w").endpoint("g").serve_endpoint(handler)
    client = await front_rt.namespace("ns").component("w").endpoint("g").client()
    try:
        await client.wait_for_instances(timeout=5)
        out = await collect(client.generate({"msg": "hi"}))
        assert out == [{"echo": "hi"}]
    finally:
        await client.close()
        await served.shutdown(grace_period=1)
        await front_rt.shutdown(grace_period=1)
        await worker_rt.shutdown(grace_period=1)
        await broker.close()
        await server.stop()


async def test_discd_kill_and_restore_from_snapshot(tmp_path):
    """HA minimum (the etcd-durability role): kill discd mid-serve —
    established request-plane traffic keeps flowing on leases — then
    restart discd from its snapshot: the SAME keys and lease ids are back,
    keepalives resume, and a fresh client resolves the worker without it
    re-registering."""
    snap = str(tmp_path / "discd.json")
    server = DiscdServer(snapshot_path=snap, snapshot_interval_s=0.2)
    port = await server.start()

    worker_rt = DistributedRuntime(
        discovery=DiscdDiscovery(f"127.0.0.1:{port}"),
        request_plane=TcpRequestPlane(),
    )
    front_rt = DistributedRuntime(
        discovery=DiscdDiscovery(f"127.0.0.1:{port}"),
        request_plane=TcpRequestPlane(),
    )

    async def handler(request, context):
        yield {"echo": request["msg"]}

    served = await (
        worker_rt.namespace("ha").component("w").endpoint("g")
        .serve_endpoint(handler)
    )
    client = await front_rt.namespace("ha").component("w").endpoint("g").client()
    try:
        await client.wait_for_instances(timeout=5)
        assert (await collect(client.generate({"msg": "a"}))) == [{"echo": "a"}]
        # let a dirty snapshot land
        await asyncio.sleep(0.8)

        # ---- kill discd (ungraceful close of the service object) ----
        await server.stop()

        # serving continues: the request plane is a direct worker TCP
        # connection; discovery being down must not break it
        assert (await collect(client.generate({"msg": "b"}))) == [{"echo": "b"}]

        # ---- restart from the snapshot on the SAME port ----
        server2 = DiscdServer(port=port, snapshot_path=snap)
        await server2.start()
        try:
            assert server2.restored_keys >= 1, "snapshot restored no keys"

            # the worker's lease id survived: its keepalive loop resumes
            # against the restored lease (no 'lease not found' churn)
            lease_ids = set(server2._leases)
            assert worker_rt._lease.id in lease_ids

            # a brand-new client resolves the worker from restored state
            # WITHOUT the worker re-registering
            fresh_rt = DistributedRuntime(
                discovery=DiscdDiscovery(f"127.0.0.1:{port}"),
                request_plane=TcpRequestPlane(),
            )
            fresh = await (
                fresh_rt.namespace("ha").component("w").endpoint("g").client()
            )
            try:
                await fresh.wait_for_instances(timeout=5)
                out = await collect(fresh.generate({"msg": "c"}))
                assert out == [{"echo": "c"}]
            finally:
                await fresh.close()
                await fresh_rt.shutdown(grace_period=1)

            # a key whose owner DIED during the outage still expires: drop
            # the worker's lease and watch the key disappear
            await server2._drop_lease(worker_rt._lease.id)
            left = [
                k for k in server2._data if k.startswith("instances/ha/")
            ]
            assert not left, left
        finally:
            await server2.stop()
    finally:
        await client.close()
        try:
            await served.shutdown(grace_period=1)
        except Exception:
            pass
        await front_rt.shutdown(grace_period=1)
        await worker_rt.shutdown(grace_period=1)


# -- across the packages -----------------------------------------------------

JAX = types.SimpleNamespace(
    name="jax", tcp=jtcp, component=jcomponent, context=jcontext, drain=jdrain,
    incremental=jincremental, tasks=jtasks, discd=jdiscd, file=jfile, Lease=JLease,
    proto=jproto)
PORT = types.SimpleNamespace(
    name="port", tcp=ttcp, component=tcomponent, context=tcontext, drain=tdrain,
    incremental=tincremental, tasks=ttasks, discd=tdiscd, file=tfile, Lease=TLease,
    proto=tproto)
ACROSS = [pytest.param(JAX, PORT, id="jax_server-port_client"),
          pytest.param(PORT, JAX, id="port_server-jax_client")]
WAIT = 5.0


def _frame_cases():
    out = []
    for proto in (jproto, tproto):
        item = proto.BackendOutput(token_ids=[3, 4], finish_reason=proto.FinishReason.LENGTH,
                                   cumulative_tokens=2, extra={"x": b"\x00" * 300})
        out.append(({"type": "item", "stream": 9, "inc": 2 ** 61 + 5}, item))
    out += [
        ({"type": "req", "stream": 1, "key": "instances/n/c/e/00000000000000ff",
          "ctx": {"id": "r", "baggage": {}, "deadline_s": 1.25}},
         {"token_ids": list(range(300)), "sampling": {"logit_bias": {17: -100.0}}}),
        ({"type": "end", "stream": 2 ** 32}, None),
        ({"type": "err", "stream": 3, "message": "é" * 40, "kind": "draining"}, None),
        ({"reqid": 4, "ok": True, "found": False}, {"k": [None, True, -1.5]}),
    ]
    return out


@pytest.mark.parametrize("header,payload", _frame_cases())
def test_frames_byte_equal_to_jax_pack_frame(header, payload):
    assert tcodec.pack_frame(header, payload) == jcodec.pack_frame(header, payload)


class _Handler:
    """A served engine: a stream of ``n`` items (dicts and BackendOutputs of
    the serving package), a stream that runs until cancelled, or a raise."""

    def __init__(self, api):
        self.api = api
        self.cancelled = asyncio.Event()
        self.first = asyncio.Event()

    async def generate(self, request, context):
        mode = request["mode"]
        if mode == "items":
            for i in range(request["n"]):
                yield {"i": i} if i % 2 else self.api.proto.BackendOutput(
                    token_ids=[i], finish_reason=None, extra={"b": b"\x01" * i})
        elif mode == "forever":
            i = 0
            while not context.stopped:
                yield {"i": i}
                i += 1
                self.first.set()
                await asyncio.sleep(0.01)
            self.cancelled.set()
        elif mode == "hang":
            yield {"i": 0}
            self.first.set()
            await asyncio.sleep(3600)
        else:
            raise _RAISE[mode](self.api)("boom " + mode)


_RAISE = {
    "draining": lambda api: api.drain.WorkerDrainingError,
    "no_instances": lambda api: api.component.NoInstancesError,
    "tool_call_parse": lambda api: api.incremental.ToolCallParseError,
    "timeout": lambda api: TimeoutError,
    "connection": lambda api: ConnectionError,
    "other": lambda api: KeyError,
}


async def _serve(api, handler):
    plane = api.tcp.TcpRequestPlane()
    inst = api.component.Instance("n", "c", "gen", 0xFF, {})
    transport = await plane.serve(inst, handler, api.tasks.TaskTracker("t"))
    return plane, transport


def _client(api, transport):
    plane = api.tcp.TcpRequestPlane()
    inst = api.component.Instance("n", "c", "gen", 0xFF, transport)
    return plane, plane.client_for(inst)


async def _collect_items(engine, api, request):
    return await asyncio.wait_for(collect(engine.generate(request, api.context.Context())), WAIT)


@pytest.mark.parametrize("server,client", ACROSS)
async def test_tcp_streaming_across_packages(server, client):
    splane, transport = await _serve(server, _Handler(server))
    cplane, engine = _client(client, transport)
    same_plane, same = _client(server, transport)
    try:
        got = await _collect_items(engine, client, {"mode": "items", "n": 6})
        want = await _collect_items(same, server, {"mode": "items", "n": 6})
        assert got == want and len(got) == 6
        assert got[0]["token_ids"] == [0] and got[1] == {"i": 1}
        assert got[4]["extra"] == {"b": b"\x01" * 4}
    finally:
        for plane in (cplane, same_plane, splane):
            await plane.close()


@pytest.mark.parametrize("server,client", ACROSS)
async def test_tcp_cancel_reaches_worker_across_packages(server, client):
    handler = _Handler(server)
    splane, transport = await _serve(server, handler)
    cplane, engine = _client(client, transport)
    try:
        ctx = client.context.Context()
        got = []

        async def consume():
            async for item in engine.generate({"mode": "forever"}, ctx):
                got.append(item)
                if len(got) == 3:
                    ctx.stop_generating()
                    break

        await asyncio.wait_for(consume(), WAIT)
        await asyncio.wait_for(handler.cancelled.wait(), WAIT)
        assert [g["i"] for g in got] == [0, 1, 2]
    finally:
        await cplane.close()
        await splane.close()


@pytest.mark.parametrize("server,client", ACROSS)
async def test_tcp_dead_worker_across_packages(server, client):
    handler = _Handler(server)
    splane, transport = await _serve(server, handler)
    cplane, engine = _client(client, transport)
    try:
        got = []

        async def consume():
            async for item in engine.generate({"mode": "hang"}, client.context.Context()):
                got.append(item)
                await splane.close()  # the worker's plane dies mid-stream

        with pytest.raises(client.tcp.StreamDisconnectedError):
            await asyncio.wait_for(consume(), WAIT)
        assert got == [{"i": 0}]
    finally:
        await cplane.close()


@pytest.mark.parametrize("kind", sorted(_RAISE))
@pytest.mark.parametrize("server,client", ACROSS)
async def test_tcp_err_kinds_raise_the_clients_types(server, client, kind):
    """A handler's typed failure crosses as an ``err`` frame and re-raises
    as the CLIENT package's matching class."""
    splane, transport = await _serve(server, _Handler(server))
    cplane, engine = _client(client, transport)
    try:
        with pytest.raises(Exception) as info:
            await _collect_items(engine, client, {"mode": kind})
        want = RuntimeError if kind == "other" else _RAISE[kind](client)
        assert type(info.value) is want
        assert ("boom " + kind) in str(info.value)
        assert client.tcp.StreamDisconnectedError not in type(info.value).__mro__
    finally:
        await cplane.close()
        await splane.close()


async def _discd_scenario(c1, c2):
    """put/get/prefix, a watch's snapshot and live PUT, a lease's expiry
    deleting its key, keep_alive holding a lease open."""
    await c1.put("instances/ns/c/e/01", {"host": "a", "n": [1, 2]})
    assert await c2.get("instances/ns/c/e/01") == {"host": "a", "n": [1, 2]}
    assert list(await c2.get_prefix("instances/")) == ["instances/ns/c/e/01"]
    assert await c2.get("instances/none") is None
    watch = c2.watch("instances/")
    ev = await asyncio.wait_for(watch.__anext__(), WAIT)
    assert ev.kind.value == "put" and ev.key == "instances/ns/c/e/01"
    await c1.put("instances/ns/c/e/02", {"host": "b"})
    ev = await asyncio.wait_for(watch.__anext__(), WAIT)
    assert ev.value == {"host": "b"}
    lease = await c1.create_lease(ttl=0.6)
    await c1.put("instances/ns/c/e/03", {"host": "c"}, lease=lease)
    ev = await asyncio.wait_for(watch.__anext__(), WAIT)
    assert ev.key.endswith("/03")
    ev = await asyncio.wait_for(watch.__anext__(), WAIT)
    assert ev.kind.value == "delete" and ev.key.endswith("/03") and ev.value is None
    lease2 = await c1.create_lease(ttl=0.6)
    await c1.put("instances/ns/c/e/04", {"host": "d"}, lease=lease2)
    for _ in range(4):
        await asyncio.sleep(0.3)
        await c1.keep_alive(lease2)
    assert await c2.get("instances/ns/c/e/04") == {"host": "d"}
    await c1.delete("instances/ns/c/e/04")
    ev = await asyncio.wait_for(watch.__anext__(), WAIT)
    assert ev.key.endswith("/04") and ev.kind.value == "put"
    ev = await asyncio.wait_for(watch.__anext__(), WAIT)
    assert ev.key.endswith("/04") and ev.kind.value == "delete"
    await watch.aclose()


@pytest.mark.parametrize("server,client", ACROSS)
async def test_discd_client_against_the_other_packages_server(server, client):
    srv = server.discd.DiscdServer()
    port = await srv.start()
    c1 = client.discd.DiscdDiscovery(f"127.0.0.1:{port}")
    c2 = client.discd.DiscdDiscovery(f"127.0.0.1:{port}")
    try:
        await _discd_scenario(c1, c2)
    finally:
        await c1.close()
        await c2.close()
        await srv.stop()


@pytest.mark.parametrize("server,client", ACROSS)
async def test_runtime_across_packages_over_discd_and_tcp(server, client):
    """A worker runtime of one package and a frontend runtime of the other
    on one discd: the frontend's client resolves the instance and streams
    from it over TCP."""
    from dynamo_tpu.runtime.distributed import DistributedRuntime as JRuntime

    runtimes = {"jax": JRuntime, "port": DistributedRuntime}
    srv = DiscdServer()
    port = await srv.start()
    worker = runtimes[server.name](discovery=server.discd.DiscdDiscovery(f"127.0.0.1:{port}"),
                                   request_plane=server.tcp.TcpRequestPlane())
    front = runtimes[client.name](discovery=client.discd.DiscdDiscovery(f"127.0.0.1:{port}"),
                                  request_plane=client.tcp.TcpRequestPlane())
    served = await (worker.namespace("x").component("w").endpoint("g")
                    .serve_endpoint(_Handler(server).generate, metadata={"m": 1}))
    cl = await front.namespace("x").component("w").endpoint("g").client()
    try:
        assert await cl.wait_for_instances(timeout=WAIT) == [served.instance.instance_id]
        out = await asyncio.wait_for(collect(cl.generate({"mode": "items", "n": 3})), WAIT)
        assert out[1] == {"i": 1} and out[2]["token_ids"] == [2]
        assert cl._instances[served.instance.instance_id].metadata == {"m": 1}
    finally:
        await cl.close()
        await served.shutdown(grace_period=1)
        await front.shutdown(grace_period=1)
        await worker.shutdown(grace_period=1)
        await srv.stop()


@pytest.mark.parametrize("writer,reader", ACROSS)
async def test_snapshot_written_by_one_server_restored_by_the_other(tmp_path, writer, reader):
    snap = str(tmp_path / "discd.json")
    first = writer.discd.DiscdServer(snapshot_path=snap)
    port = await first.start()
    c = writer.discd.DiscdDiscovery(f"127.0.0.1:{port}")
    try:
        lease = await c.create_lease(ttl=30.0)
        await c.put("instances/a/b/c/01", {"v": [1, "x"]}, lease=lease)
        await c.put("models/a/m/01", {"name": "m"})
    finally:
        await c.close()
        await first.stop()  # writes the snapshot
    second = reader.discd.DiscdServer(port=port, snapshot_path=snap)
    await second.start()
    c = reader.discd.DiscdDiscovery(f"127.0.0.1:{port}")
    try:
        assert second.restored_keys == 2
        assert second._data == first._data
        assert set(second._leases) == set(first._leases) == {lease.id}
        await c.keep_alive(lease)  # the restored lease id is live
        assert await c.get("instances/a/b/c/01") == {"v": [1, "x"]}
        again = str(tmp_path / "again.json")
        second.snapshot_path = again
        second._save_snapshot()
        with open(snap) as f, open(again) as g:
            assert json.load(f) == json.load(g)
    finally:
        await c.close()
        await second.stop()


async def test_file_discovery_documents_equal_and_read_across(tmp_path):
    roots = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    backends = {"jax": JAX.file.FileDiscovery(roots["jax"], poll_interval=0.05),
                "port": FileDiscovery(roots["port"], poll_interval=0.05)}
    leases = {"jax": JAX.Lease(id="l1", ttl=5.0), "port": TLease(id="l1", ttl=5.0)}
    value = {"instance_id": 2 ** 62, "transport": {"kind": "tcp", "port": 1}, "é": [None]}
    try:
        for name, disco in backends.items():
            await disco.put("instances/n/c/e/0001", value, lease=leases[name])
            await disco.put("models/n/m/0001", {"m": 1})
            made = await disco.create_lease(ttl=2.5)
            os.replace(os.path.join(roots[name], ".leases", made.id),
                       os.path.join(roots[name], ".leases", "made"))
            with open(os.path.join(roots[name], ".leases", "l1"), "w") as f:
                json.dump({"ttl": 5.0}, f)
        files = {}
        for name, root in roots.items():
            for d, _, fs in os.walk(root):
                for fn in fs:
                    with open(os.path.join(d, fn), "rb") as f:
                        files.setdefault(name, {})[os.path.relpath(os.path.join(d, fn), root)] = f.read()
        assert files["jax"] == files["port"]
        # each package reads the other's directory
        jreads = JAX.file.FileDiscovery(roots["port"], poll_interval=0.05)
        treads = FileDiscovery(roots["jax"], poll_interval=0.05)
        try:
            for reader in (jreads, treads):
                assert await reader.get("instances/n/c/e/0001") == value
                assert sorted(await reader.get_prefix("")) == ["instances/n/c/e/0001",
                                                               "models/n/m/0001"]
            watch = jreads.watch("instances/")
            assert [e.key for e in watch.drain_snapshot()] == ["instances/n/c/e/0001"]
            await backends["port"].delete("instances/n/c/e/0001")
            ev = await asyncio.wait_for(watch.__anext__(), WAIT)
            assert ev.kind.value == "delete" and ev.key == "instances/n/c/e/0001"
            await watch.aclose()
        finally:
            await jreads.close()
            await treads.close()
    finally:
        for disco in backends.values():
            await disco.close()


@pytest.mark.parametrize("env,err", [
    ({"DYN_TPU_REQUEST_PLANE": "http"}, (NotImplementedError, "A4c-H")),
    ({"DYN_TPU_REQUEST_PLANE": "nats"}, (ValueError, "DYN_TPU_REQUEST_PLANE='nats'")),
    ({"DYN_TPU_DISCOVERY": "etcd"}, (ValueError, "DYN_TPU_DISCOVERY='etcd'")),
    ({"DYN_TPU_EVENT_PLANE": "nats"}, (ValueError, "DYN_TPU_EVENT_PLANE='nats'")),
], ids=["http", "request_plane", "discovery", "event_plane"])
async def test_from_settings_raises_for_unported_and_unknown_planes(monkeypatch, env, err):
    """No fallback to a process-local plane: the JAX package would serve
    an unknown name locally, which hides a misconfigured cluster."""
    monkeypatch.setenv("DYN_TPU_EVENT_PLANE", "memory")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(err[0], match=err[1]):
        DistributedRuntime.from_settings()


async def test_from_settings_wires_discd_tcp_and_zmq(monkeypatch):
    """The README's cluster settings give the cross-process planes, and a
    tcp instance of an http-planed runtime's peer raises rather than
    falling back."""
    srv = DiscdServer()
    port = await srv.start()
    broker = EventBroker()
    broker.start()
    monkeypatch.setenv("DYN_TPU_DISCOVERY", "discd")
    monkeypatch.setenv("DYN_TPU_DISCOVERY_ADDR", f"127.0.0.1:{port}")
    monkeypatch.setenv("DYN_TPU_REQUEST_PLANE", "tcp")
    monkeypatch.setenv("DYN_TPU_EVENT_PLANE", "zmq")
    monkeypatch.setenv("DYN_TPU_EVENT_PLANE_ADDR", broker.address)
    rt = DistributedRuntime.from_settings()
    try:
        assert isinstance(rt.discovery, DiscdDiscovery)
        assert isinstance(rt.request_plane, TcpRequestPlane)
        assert isinstance(rt.event_plane, ZmqEventPlane)
        http_peer = tcomponent.Instance("n", "c", "e", 1, {"kind": "http"})
        with pytest.raises(NotImplementedError, match="A4c-H"):
            rt.request_plane_client(http_peer)
    finally:
        await rt.shutdown(grace_period=1)
        await rt.event_plane.close()
        await broker.close()
        await srv.stop()
