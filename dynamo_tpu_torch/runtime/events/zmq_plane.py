"""ZMQ event plane: cross-process pub/sub through an XPUB/XSUB broker — the
port's copy of dynamo_tpu/runtime/events/zmq_plane.py, on the ZeroMQ wire
written in pure Python (runtime/events/zmtp.py) and the pure-Python msgpack
subset (runtime/network/msgpack_lite.py): the card's machine has neither
pyzmq nor msgpack. The wire is the JAX package's, so a port publisher
reaches a JAX broker and a JAX subscriber reads a port broker.

Reference parity: lib/runtime/src/transports/event_plane/ — NATS is the
reference default with a brokerless ZMQ alternative (zmq_transport.rs).
Publishers PUB→XSUB, subscribers SUB←XPUB, through a small forwarder.
Messages are ``topic-utf8 | msgpack payload`` two-frame multipart.

The broker runs standalone (python -m dynamo_tpu_torch.discd) or embedded
in any process via ``EventBroker``. Prefix subscriptions over-match the
NATS-style patterns (``a.>``), so deliveries are re-checked with
``topic_matches`` client-side.

As with pyzmq, a publisher's messages that match no subscription the broker
has sent it are dropped (a durable broker subscribes to everything). Unlike
pyzmq, a plane that cannot reach its broker raises ``ConnectionError`` from
``publish`` (and a subscription whose broker goes away closes), where a
pyzmq socket would go on reconnecting in the background.
"""

from __future__ import annotations

import asyncio
import os
from typing import Any, List, Optional, Tuple

from dynamo_tpu_torch.runtime import fault_names
from dynamo_tpu_torch.runtime.events import Subscription, _SUB_CLOSED, topic_matches
from dynamo_tpu_torch.runtime.events import zmtp
from dynamo_tpu_torch.runtime.faults import fault_point
from dynamo_tpu_torch.runtime.network import msgpack_lite
from dynamo_tpu_torch.runtime.tasks import reap_task
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


class EventBroker:
    """XSUB/XPUB forwarder (the 'nats-server' of this framework).

    With ``log_path`` set, every forwarded message is appended to a durable
    sequence-numbered log and a REP socket answers replay requests — the
    JetStream role (ref: lib/runtime/src/transports/nats.rs). A broker
    restarted over the same log continues the sequence and serves history.
    The log's records are ``msgpack([seq, topic, payload bytes])``, byte for
    byte the JAX broker's. Replay protocol (REQ/REP msgpack): {"from_seq":
    N, "max": M} → {"events": [[seq, topic, payload], ...], "next_seq": K,
    "end": bool}.
    """

    # Sparse offset index: one entry per stride bounds broker RAM on busy
    # planes (replay scans forward from the nearest indexed record).
    OFFSET_STRIDE = 256

    def __init__(
        self, host: str = "127.0.0.1", xsub_port: int = 0, xpub_port: int = 0,
        *, log_path: Optional[str] = None, replay_port: int = 0,
    ) -> None:
        self.host = host
        self._xsub = zmtp.XSubSocket(host, xsub_port)
        self._xpub = zmtp.XPubSocket(host, xpub_port)
        self.xsub_port = self._xsub.port
        self.xpub_port = self._xpub.port
        self._task: Optional[asyncio.Task] = None
        self._replay_task: Optional[asyncio.Task] = None
        self.log_path = log_path
        self._log = None
        self.seq = 0
        self._rep: Optional[zmtp.RepSocket] = None
        self.replay_port = 0
        self._offsets: dict = {}  # seq → byte offset (O(page) replay)
        if log_path:
            self.seq = self._recover_log(log_path)
            self._log = open(log_path, "ab")
            self._rep = zmtp.RepSocket(host, replay_port)
            self.replay_port = self._rep.port

    def _recover_log(self, log_path: str) -> int:
        """Continue the sequence after a broker restart over the same log:
        index every record's byte offset (O(page) replay instead of a full
        rescan per request) and TRUNCATE any crash-torn tail — appending
        after garbage would poison every future replay."""
        if not os.path.exists(log_path):
            return 0
        last = 0
        valid_end = 0
        try:
            with open(log_path, "rb") as f:
                unpacker = msgpack_lite.Unpacker(f, strict_map_key=False)
                try:
                    for rec in unpacker:
                        if rec[0] % self.OFFSET_STRIDE == 1 or self.OFFSET_STRIDE == 1:
                            self._offsets[rec[0]] = valid_end
                        last = rec[0]
                        valid_end = unpacker.tell()
                except Exception:
                    logger.warning(
                        "event log %s has a torn tail after seq %d; truncating",
                        log_path, last,
                    )
            if valid_end < os.path.getsize(log_path):
                with open(log_path, "r+b") as f:
                    f.truncate(valid_end)
        except OSError as exc:
            # Continuing at seq 0 over an existing log would append
            # DUPLICATE sequence numbers and poison every future replay —
            # refuse to start instead.
            raise RuntimeError(
                f"durable event log {log_path} unreadable: {exc}"
            ) from exc
        return last

    @property
    def address(self) -> str:
        """Connection string clients take: host:xsub:xpub."""
        return f"{self.host}:{self.xsub_port}:{self.xpub_port}"

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(
                self._forward(), name="event-broker"
            )
            logger.info("event broker on %s", self.address)
        if self._rep is not None and self._replay_task is None:
            self._replay_task = asyncio.get_running_loop().create_task(
                self._serve_replay(), name="event-broker-replay"
            )
            logger.info("event replay on %s:%d", self.host, self.replay_port)

    def _append(self, frames: List[bytes]) -> None:
        if self._log is None or len(frames) != 2:
            return
        self.seq += 1
        if self.seq % self.OFFSET_STRIDE == 1 or self.OFFSET_STRIDE == 1:
            self._offsets[self.seq] = self._log.tell()
        self._log.write(
            msgpack_lite.packb([self.seq, frames[0].decode(), frames[1]])
        )
        self._log.flush()

    async def _forward(self) -> None:
        # Bidirectional proxy: data XSUB→XPUB, subscriptions XPUB→XSUB.
        await self._xsub.start()
        await self._xpub.start()
        if self._log is not None:
            # Durable mode must capture events even with ZERO live
            # subscribers: publishers drop messages that match no
            # subscription, so the broker itself subscribes to everything
            # (the upstream \x01 subscribe-all message).
            await self._xsub.send(b"\x01")

        async def data() -> None:
            while True:
                frames = await self._xsub.recv_multipart()
                self._append(frames)
                self._xpub.send_multipart(frames)

        async def subscriptions() -> None:
            while True:
                await self._xsub.send(await self._xpub.recv())

        async with asyncio.TaskGroup() as group:
            group.create_task(data(), name="event-broker-data")
            group.create_task(subscriptions(), name="event-broker-subscriptions")

    async def _serve_replay(self) -> None:
        assert self._rep is not None
        await self._rep.start()
        while True:
            try:
                req = msgpack_lite.unpackb(await self._rep.recv())
                from_seq = int(req.get("from_seq", 1))
                limit = int(req.get("max", 1024))
                if from_seq > self.seq:
                    # Fully caught up: O(1) empty page, no log scan.
                    await self._rep.send(msgpack_lite.packb(
                        {"events": [], "next_seq": from_seq, "end": True}
                    ))
                    continue
                out = []
                # Seek to the nearest indexed record at or before from_seq
                # (sparse index; the parse loop skips the remainder).
                start_seq = max(from_seq, 1)
                while start_seq > 1 and start_seq not in self._offsets:
                    start_seq -= 1
                with open(self.log_path, "rb") as f:  # type: ignore[arg-type]
                    f.seek(self._offsets.get(start_seq, 0))
                    for rec in msgpack_lite.Unpacker(f, strict_map_key=False):
                        if rec[0] >= from_seq:
                            out.append(rec)
                            if len(out) >= limit:
                                break
                next_seq = (out[-1][0] + 1) if out else from_seq
                await self._rep.send(msgpack_lite.packb({
                    "events": out,
                    "next_seq": next_seq,
                    "end": next_seq > self.seq,
                }))
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("event replay request failed")
                try:
                    await self._rep.send(msgpack_lite.packb({"error": "replay failed"}))
                except Exception as exc:
                    # The requester already sees a timeout; the socket
                    # state is what matters here.
                    logger.debug("replay error reply also failed: %s", exc)

    async def close(self) -> None:
        for task in (self._task, self._replay_task):
            if task is not None:
                task.cancel()
                await reap_task(task, "event-broker pump", logger)
        await self._xsub.close()
        await self._xpub.close()
        if self._rep is not None:
            await self._rep.close()
        if self._log is not None:
            self._log.close()


async def replay_events(
    host: str, replay_port: int, from_seq: int = 1, *, timeout_s: float = 10.0,
):
    """Fetch the broker's durable history from ``from_seq`` onward. Returns
    a list of (seq, topic, payload) — a rejoining consumer applies these
    before switching to the live subscription (the JetStream resync flow).
    Each connect, send and receive waits at most ``timeout_s``."""
    sock = zmtp.ReqSocket()
    await asyncio.wait_for(sock.connect(host, replay_port), timeout_s)
    out = []
    try:
        while True:
            await asyncio.wait_for(
                sock.send(msgpack_lite.packb({"from_seq": from_seq})), timeout_s
            )
            resp = msgpack_lite.unpackb(
                await asyncio.wait_for(sock.recv(), timeout_s), strict_map_key=False
            )
            if "error" in resp:
                raise RuntimeError(resp["error"])
            for seq, topic, raw in resp["events"]:
                out.append((seq, topic, msgpack_lite.unpackb(raw, strict_map_key=False)))
            from_seq = resp["next_seq"]
            if resp["end"] or not resp["events"]:
                return out
    finally:
        sock.close()


class ZmqEventPlane:
    """EventPlane over a broker at ``host:xsub_port:xpub_port``.

    The publisher connects when the plane is made inside a running loop
    (else at the first publish), as pyzmq's connect starts at once, so that
    the broker's subscriptions have reached it by the time it publishes."""

    def __init__(self, address: str) -> None:
        host, xsub, xpub = address.rsplit(":", 2)
        self._host = host
        self._xsub_port = int(xsub)
        self._xpub_port = int(xpub)
        self._pub = zmtp.PubSocket()
        self._pub_connect: Optional[asyncio.Task] = None
        self._subs: List[Tuple[str, Subscription, asyncio.Task]] = []
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return
        self._connect_pub()

    def _connect_pub(self) -> asyncio.Task:
        if self._pub_connect is None:
            self._pub_connect = asyncio.get_running_loop().create_task(
                self._pub.connect(self._host, self._xsub_port), name="zmq-pub-connect"
            )
        return self._pub_connect

    async def publish(self, topic: str, payload: Any) -> None:
        # Chaos seam: publishers (KV events, load reports) must tolerate a
        # lost publish — their pumps log and continue; the router heals via
        # event-id gap detection + snapshot resync.
        fault_point(fault_names.NET_ZMQ_SEND, topic=topic)
        # raises (every time) when the broker could not be reached
        await asyncio.shield(self._connect_pub())
        await self._pub.send_multipart(
            [topic.encode(), msgpack_lite.packb(payload)]
        )

    def subscribe(self, topic: str) -> Subscription:
        prefix = topic[:-1] if topic.endswith(".>") else topic
        queue: asyncio.Queue = asyncio.Queue()
        sub = Subscription(topic, queue, on_close=lambda s: self._close_sub(s))

        async def pump() -> None:
            sock = zmtp.SubSocket()
            try:
                await sock.connect(self._host, self._xpub_port)
                await sock.subscribe(prefix.encode())
                sub.ready.set()
                while True:
                    raw_topic, raw_payload = await sock.recv_multipart()
                    fault_point(fault_names.NET_ZMQ_RECV, topic=topic)
                    t = raw_topic.decode()
                    if topic_matches(topic, t):
                        queue.put_nowait((t, msgpack_lite.unpackb(
                            raw_payload, strict_map_key=False
                        )))
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("zmq subscription pump died (%s)", topic)
                queue.put_nowait(_SUB_CLOSED)
            finally:
                sub.ready.set()
                sock.close()

        task = asyncio.get_running_loop().create_task(pump(), name=f"zmq-sub:{topic}")
        self._subs.append((topic, sub, task))
        return sub

    def _close_sub(self, sub: Subscription) -> None:
        for i, (topic, s, task) in enumerate(self._subs):
            if s is sub:
                task.cancel()  # the pump's finally closes its socket
                sub._queue.put_nowait(_SUB_CLOSED)
                del self._subs[i]
                return

    async def close(self) -> None:
        for _, sub, task in list(self._subs):
            task.cancel()
            await reap_task(task, "zmq subscription pump", logger)
        self._subs.clear()
        if self._pub_connect is not None:
            self._pub_connect.cancel()
            await reap_task(self._pub_connect, "zmq publisher connect", logger)
        await self._pub.close()
