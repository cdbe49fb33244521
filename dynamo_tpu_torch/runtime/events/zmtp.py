"""The ZeroMQ wire (ZMTP 3.1, NULL mechanism) on asyncio streams — the
port's stand-in for the ``zmq`` package, which the card's machine lacks,
as far as the event plane (runtime/events/zmq_plane.py) uses it.

A ZMTP session is a 64-byte greeting each way (signature ``FF 00..01 7F``,
version 3.1, mechanism ``NULL``), a ``READY`` command each way carrying
``Socket-Type`` (and ``Identity`` from a REQ, as libzmq sends it), then
frames: a flags byte (bit 0 MORE, bit 1 LONG, bit 2 COMMAND), a size (one
byte, or eight big-endian bytes when LONG) and the body. A message is the
frames up to the first without MORE. The sockets here talk to libzmq's
(pyzmq's) and to each other:

- ``PubSocket`` connects and sends a message only where a subscription the
  peer sent matches its first frame by prefix, as libzmq's PUB does: a
  message published before any subscription arrived is dropped.
- ``SubSocket`` connects, subscribes by sending ``\\x01`` + prefix (a
  cancel is ``\\x00`` + prefix) and keeps only the messages that match.
- ``XSubSocket`` binds, receives every publisher's messages in arrival
  order, and sends its subscriptions to every publisher, replaying them to
  one that connects later.
- ``XPubSocket`` binds, sends each message to the subscribers that match,
  and hands the subscriptions up (one message per prefix the first time
  any subscriber takes it, a cancel when the last one drops it).
- ``ReqSocket`` / ``RepSocket`` exchange one request and one reply at a
  time behind the empty delimiter frame.

Received subscriptions are taken in both forms libzmq sends: the
``\\x01``/``\\x00`` + prefix message, and the ZMTP 3.1 ``SUBSCRIBE`` /
``CANCEL`` commands. ``PING`` is answered with ``PONG``.

Neither PUB nor XPUB ever waits on a peer: past ``SEND_QUEUE_BYTES``
queued to one peer, a message is dropped for that peer, as libzmq's PUB and
XPUB drop at their send high-water mark. An XSUB holds at most ``XSUB_INBOX``
messages not yet read (libzmq's receive high-water mark); past it, it stops
reading its publishers' connections until the broker reads again, so a
stalled broker fills the publishers' queues and they drop.

What is left out: CURVE and PLAIN, reconnection (a socket whose peer goes
away raises ``ConnectionError`` on its next call, and the event plane
closes the subscription as its JAX pump does), high-water marks counted in
messages on the sending side (the bound is in bytes), and every socket type
the event plane does not use.
"""

from __future__ import annotations

import asyncio
import socket
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

from dynamo_tpu_torch.runtime.tasks import reap_task
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# signature: 0xFF, 8 padding bytes (libzmq writes its routing-id length + 1
# there), 0x7F; version 3.1; mechanism NULL; as-server 0; 31 filler bytes
GREETING = (b"\xff" + (1).to_bytes(8, "big") + b"\x7f" + bytes((3, 1))
            + b"NULL".ljust(20, b"\x00") + b"\x00" + bytes(31))

MORE, LONG, COMMAND = 0x01, 0x02, 0x04
MAX_FRAME = 256 * 1024 * 1024  # defensive cap, as the request plane's codec
HANDSHAKE_TIMEOUT_S = 30.0  # libzmq's ZMQ_HANDSHAKE_IVL default
SEND_QUEUE_BYTES = 64 * 1024 * 1024  # bytes a PUB/XPUB queues to one peer
XSUB_INBOX = 1000  # messages an XSUB holds unread (libzmq's ZMQ_RCVHWM default)

# who may talk to whom (libzmq's mechanism_t::check_socket_type)
_PEERS = {
    b"PUB": (b"SUB", b"XSUB"), b"XPUB": (b"SUB", b"XSUB"),
    b"SUB": (b"PUB", b"XPUB"), b"XSUB": (b"PUB", b"XPUB"),
    b"REQ": (b"REP", b"ROUTER"), b"REP": (b"REQ", b"DEALER"),
}

_U64 = struct.Struct(">Q")
_U32 = struct.Struct(">I")


class ZmtpError(ConnectionError):
    """The peer broke the protocol or is of a socket type we cannot talk to."""


def encode_frames(frames: Sequence[bytes], command: bool = False) -> bytes:
    """The wire bytes of one message (or, with ``command``, one command)."""
    out = []
    last = len(frames) - 1
    for i, body in enumerate(frames):
        flags = (COMMAND if command else 0) | (MORE if i < last else 0)
        n = len(body)
        if n > 255:
            out.append(bytes((flags | LONG,)) + _U64.pack(n))
        else:
            out.append(bytes((flags, n)))
        out.append(bytes(body))
    return b"".join(out)


def command(name: bytes, data: bytes = b"") -> bytes:
    return encode_frames([bytes((len(name),)) + name + data], command=True)


def ready(socket_type: bytes, identity: Optional[bytes] = None) -> bytes:
    """The READY command with its metadata properties."""
    props = [(b"Socket-Type", socket_type)]
    if identity is not None:
        props.append((b"Identity", identity))
    data = b"".join(bytes((len(k),)) + k + _U32.pack(len(v)) + v for k, v in props)
    return command(b"READY", data)


def parse_properties(data: bytes) -> Dict[bytes, bytes]:
    props, i = {}, 0
    while i < len(data):
        n = data[i]
        name = data[i + 1:i + 1 + n]
        i += 1 + n
        if i + 4 > len(data):
            raise ZmtpError("truncated READY metadata")
        (vlen,) = _U32.unpack_from(data, i)
        props[name] = data[i + 4:i + 4 + vlen]
        i += 4 + vlen
    return props


class Connection:
    """One ZMTP session over an asyncio stream pair."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 socket_type: bytes, identity: Optional[bytes] = None) -> None:
        self.reader = reader
        self.writer = writer
        self.socket_type = socket_type
        self.identity = identity
        self.peer_type = b""
        self.closed = False
        self._more = False  # the frame last read had MORE set

    async def handshake(self) -> None:
        """Greeting and READY both ways; checks the peer's socket type."""
        self.writer.write(GREETING + ready(self.socket_type, self.identity))
        await self.writer.drain()
        greeting = await self.reader.readexactly(64)
        if greeting[0] != 0xFF or not greeting[9] & 0x01 or greeting[10] < 3:
            raise ZmtpError(f"not a ZMTP 3 peer (greeting {greeting[:12].hex()})")
        if greeting[12:32].rstrip(b"\x00") != b"NULL":
            raise ZmtpError(f"mechanism {greeting[12:32].rstrip(bytes(1))!r}, not NULL")
        is_command, body = await self._frame()
        if not is_command or not body or body[1:1 + body[0]] != b"READY":
            raise ZmtpError("the peer's first command is not READY")
        props = parse_properties(body[1 + body[0]:])
        self.peer_type = props.get(b"Socket-Type", b"")
        if self.peer_type not in _PEERS[self.socket_type]:
            raise ZmtpError(f"a {self.socket_type.decode()} socket cannot talk to a "
                            f"{self.peer_type.decode() or 'typeless'} one")

    async def _frame(self) -> Tuple[bool, bytes]:
        flags, = await self.reader.readexactly(1)
        if flags & LONG:
            (n,) = _U64.unpack(await self.reader.readexactly(8))
        else:
            n = (await self.reader.readexactly(1))[0]
        if n > MAX_FRAME:
            raise ZmtpError(f"frame of {n} bytes")
        body = await self.reader.readexactly(n) if n else b""
        self._more = bool(flags & MORE)
        return bool(flags & COMMAND), body

    async def recv(self) -> Optional[Tuple[str, Any]]:
        """The next ("message", frames), ("subscribe", prefix) or
        ("cancel", prefix) from the peer; None when it closed the stream.
        A subscription arrives as a SUBSCRIBE/CANCEL command (ZMTP 3.1) or,
        from a SUB/XSUB peer, as a one-frame message \\x01/\\x00 + prefix."""
        try:
            while True:
                is_command, body = await self._frame()
                if is_command:
                    if not body:
                        raise ZmtpError("an empty command frame")
                    name = body[1:1 + body[0]]
                    data = body[1 + body[0]:]
                    if name == b"SUBSCRIBE":
                        return "subscribe", data
                    if name == b"CANCEL":
                        return "cancel", data
                    if name == b"PING":  # TTL (2 bytes), then the context
                        self.writer.write(command(b"PONG", data[2:]))
                    elif name == b"ERROR":  # reason size (1 byte), then the reason
                        raise ZmtpError(f"peer error: {data[1:1 + data[0]] if data else b''!r}")
                    continue  # PONG and unknown commands
                frames = [body]
                while self._more:
                    is_command, body = await self._frame()
                    if is_command:
                        raise ZmtpError("a command inside a multipart message")
                    frames.append(body)
                if (self.peer_type in (b"SUB", b"XSUB") and len(frames) == 1
                        and frames[0][:1] in (b"\x00", b"\x01")):
                    return ("subscribe" if frames[0][0] else "cancel"), frames[0][1:]
                return "message", frames
        except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError):
            self.closed = True
            return None

    def write(self, frames: Sequence[bytes]) -> None:
        self.writer.write(encode_frames(frames))

    def queued(self) -> int:
        return self.writer.transport.get_write_buffer_size()

    async def send(self, frames: Sequence[bytes]) -> None:
        if self.closed or self.writer.is_closing():
            raise ConnectionError(f"{self.socket_type.decode()} peer is gone")
        self.write(frames)
        await self.writer.drain()

    def close(self) -> None:
        self.closed = True
        self.writer.close()


async def connect(host: str, port: int, socket_type: bytes,
                  identity: Optional[bytes] = None) -> Connection:
    """Open a TCP connection and complete the ZMTP handshake. Raises
    ConnectionError (OSError) when nothing listens there."""
    reader, writer = await asyncio.open_connection(host, port)
    conn = Connection(reader, writer, socket_type, identity)
    try:
        await asyncio.wait_for(conn.handshake(), HANDSHAKE_TIMEOUT_S)
    except BaseException:
        conn.close()
        raise
    return conn


def _match(prefixes: Dict[bytes, int], topic: bytes) -> bool:
    return any(topic.startswith(p) for p in prefixes)


def _count(prefixes: Dict[bytes, int], kind: str, prefix: bytes) -> bool:
    """Apply a subscribe/cancel to a prefix multiset; True when the prefix
    appeared (first subscribe) or disappeared (last cancel)."""
    n = prefixes.get(prefix, 0)
    if kind == "subscribe":
        prefixes[prefix] = n + 1
        return n == 0
    if n <= 1:
        prefixes.pop(prefix, None)
        return n == 1
    prefixes[prefix] = n - 1
    return False


# ---------------------------------------------------------------------------
# Connecting sockets
# ---------------------------------------------------------------------------


class PubSocket:
    """Connects to an XSUB (the broker) and publishes by prefix match on the
    subscriptions the peer sent."""

    def __init__(self) -> None:
        self._conn: Optional[Connection] = None
        self._subs: Dict[bytes, int] = {}
        self._pump: Optional[asyncio.Task] = None

    async def connect(self, host: str, port: int) -> None:
        self._conn = await connect(host, port, b"PUB")
        self._pump = asyncio.get_running_loop().create_task(
            self._read(self._conn), name="zmtp-pub-subscriptions")

    async def _read(self, conn: Connection) -> None:
        while True:
            got = await conn.recv()
            if got is None:
                return
            kind, value = got
            if kind != "message":
                _count(self._subs, kind, value)

    async def send_multipart(self, frames: Sequence[bytes]) -> None:
        """Never waits on the broker: a message past SEND_QUEUE_BYTES
        queued to it is dropped."""
        conn = self._conn
        if conn is None or conn.closed or conn.writer.is_closing():
            raise ConnectionError("event broker connection lost")
        if _match(self._subs, frames[0]) and conn.queued() <= SEND_QUEUE_BYTES:
            conn.write(frames)

    async def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
        if self._pump is not None:
            self._pump.cancel()
            await reap_task(self._pump, "zmtp pub reader", logger)


class SubSocket:
    """Connects to an XPUB (the broker) and receives what matches its
    subscriptions."""

    def __init__(self) -> None:
        self._conn: Optional[Connection] = None
        self._subs: Dict[bytes, int] = {}

    async def connect(self, host: str, port: int) -> None:
        self._conn = await connect(host, port, b"SUB")

    async def subscribe(self, prefix: bytes) -> None:
        assert self._conn is not None
        if _count(self._subs, "subscribe", prefix):
            await self._conn.send([b"\x01" + prefix])

    async def recv_multipart(self) -> List[bytes]:
        assert self._conn is not None
        while True:
            got = await self._conn.recv()
            if got is None:
                raise ConnectionError("event broker connection lost")
            kind, frames = got
            if kind == "message" and _match(self._subs, frames[0]):
                return frames

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()


class ReqSocket:
    """One request, then its reply, behind the empty delimiter frame."""

    def __init__(self) -> None:
        self._conn: Optional[Connection] = None

    async def connect(self, host: str, port: int) -> None:
        self._conn = await connect(host, port, b"REQ", identity=b"")

    async def send(self, body: bytes) -> None:
        assert self._conn is not None
        await self._conn.send([b"", body])

    async def recv(self) -> bytes:
        assert self._conn is not None
        while True:
            got = await self._conn.recv()
            if got is None:
                raise ConnectionError("REP peer closed the connection")
            kind, frames = got
            # a reply is the delimiter and one body; libzmq's REQ drops others
            if kind == "message" and len(frames) == 2 and frames[0] == b"":
                return frames[1]

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()


# ---------------------------------------------------------------------------
# Bound sockets
# ---------------------------------------------------------------------------


class _Bound:
    """A listening socket bound at construction (so its port is known at
    once, as zmq's bind is) and served from ``start()``, one ZMTP session
    a peer."""

    socket_type = b""

    def __init__(self, host: str, port: int = 0) -> None:
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._lsock.bind((host, port))
            self._lsock.listen(128)
        except OSError:
            self._lsock.close()
            raise
        self._lsock.setblocking(False)
        self.port = self._lsock.getsockname()[1]
        self._server: Optional[asyncio.base_events.Server] = None
        self.peers: List[Connection] = []
        self._tasks: set = set()

    async def start(self) -> None:
        if self._server is None:
            self._server = await asyncio.start_server(self._accept, sock=self._lsock)

    async def _accept(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        conn = Connection(reader, writer, self.socket_type)
        task = asyncio.current_task()
        self._tasks.add(task)
        try:
            try:
                await asyncio.wait_for(conn.handshake(), HANDSHAKE_TIMEOUT_S)
            except (ConnectionError, asyncio.IncompleteReadError, asyncio.TimeoutError) as exc:
                logger.warning("zmtp %s: handshake failed: %r", self.socket_type.decode(), exc)
                return
            self.peers.append(conn)
            self._joined(conn)
            while True:
                got = await conn.recv()
                if got is None:
                    return
                await self._received(conn, *got)
        finally:
            if conn in self.peers:
                self.peers.remove(conn)
                self._left(conn)
            conn.close()
            self._tasks.discard(task)

    def _joined(self, conn: Connection) -> None:
        pass

    def _left(self, conn: Connection) -> None:
        pass

    async def _received(self, conn: Connection, kind: str, value: Any) -> None:
        """One thing from ``conn``; the session reads no more until it
        returns."""
        raise NotImplementedError

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
        else:
            self._lsock.close()
        for conn in list(self.peers):
            conn.close()
        for task in list(self._tasks):
            task.cancel()
            await reap_task(task, "zmtp session", logger)
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None


class XSubSocket(_Bound):
    """Bound; every publisher's messages in arrival order, and
    subscriptions sent upstream to each publisher."""

    socket_type = b"XSUB"

    def __init__(self, host: str, port: int = 0) -> None:
        super().__init__(host, port)
        self._inbox: asyncio.Queue = asyncio.Queue(XSUB_INBOX)
        self._subs: Dict[bytes, int] = {}

    def _joined(self, conn: Connection) -> None:
        for prefix in self._subs:  # a late publisher gets them all
            conn.write([b"\x01" + prefix])

    async def _received(self, conn: Connection, kind: str, value: Any) -> None:
        if kind == "message":
            await self._inbox.put(value)  # a full inbox stops this session's reads

    async def recv_multipart(self) -> List[bytes]:
        return await self._inbox.get()

    async def send(self, message: bytes) -> None:
        """A subscription message (\\x01 + prefix) or a cancel (\\x00 +
        prefix), kept for later publishers and sent to every current one
        when the prefix comes or goes."""
        if message[:1] not in (b"\x00", b"\x01"):
            raise ValueError("an XSUB sends subscriptions only")
        kind = "subscribe" if message[0] else "cancel"
        if _count(self._subs, kind, message[1:]):
            for conn in list(self.peers):
                conn.write([message])


class XPubSocket(_Bound):
    """Bound; each message to the subscribers whose prefixes match, and
    the subscriptions handed up as they first come and last go."""

    socket_type = b"XPUB"

    def __init__(self, host: str, port: int = 0) -> None:
        super().__init__(host, port)
        self._inbox: asyncio.Queue = asyncio.Queue()
        self._by_peer: Dict[int, Dict[bytes, int]] = {}
        self._all: Dict[bytes, int] = {}

    def _joined(self, conn: Connection) -> None:
        self._by_peer[id(conn)] = {}

    def _left(self, conn: Connection) -> None:
        for prefix in self._by_peer.pop(id(conn), {}):
            if _count(self._all, "cancel", prefix):
                self._inbox.put_nowait(b"\x00" + prefix)

    async def _received(self, conn: Connection, kind: str, value: Any) -> None:
        if kind == "message":
            return  # a SUB sends nothing else
        mine = self._by_peer[id(conn)]
        if kind == "cancel" and value not in mine:
            return
        _count(mine, kind, value)
        if _count(self._all, kind, value):
            self._inbox.put_nowait((b"\x01" if kind == "subscribe" else b"\x00") + value)

    async def recv(self) -> bytes:
        """The next subscription message for upstream."""
        return await self._inbox.get()

    def send_multipart(self, frames: Sequence[bytes]) -> None:
        for conn in list(self.peers):
            if (_match(self._by_peer.get(id(conn), {}), frames[0])
                    and conn.queued() <= SEND_QUEUE_BYTES):
                conn.write(frames)


class RepSocket(_Bound):
    """Bound; requests from every REQ peer in arrival order, each reply to
    the peer that sent the request last received."""

    socket_type = b"REP"

    def __init__(self, host: str, port: int = 0) -> None:
        super().__init__(host, port)
        self._inbox: asyncio.Queue = asyncio.Queue()
        self._current: Optional[Tuple[Connection, List[bytes]]] = None

    async def _received(self, conn: Connection, kind: str, value: Any) -> None:
        if kind != "message" or b"" not in value:
            return  # no envelope: libzmq's REP drops it too
        cut = value.index(b"") + 1
        self._inbox.put_nowait((conn, value[:cut], value[cut:]))

    async def recv(self) -> bytes:
        conn, envelope, body = await self._inbox.get()
        self._current = (conn, envelope)
        return body[0] if body else b""

    async def send(self, body: bytes) -> None:
        if self._current is None:
            raise RuntimeError("REP send without a request")
        (conn, envelope), self._current = self._current, None
        if not conn.closed:
            await conn.send(envelope + [body])
