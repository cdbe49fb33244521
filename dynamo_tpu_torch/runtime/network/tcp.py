"""TCP request plane: multiplexed request/response streaming — the port's
copy of dynamo_tpu/runtime/network/tcp.py, on the port's codec
(network/codec.py over network/msgpack_lite.py), so a JAX client reads a
port server and a port client reads a JAX server.

Reference parity: lib/runtime/src/pipeline/network/tcp/{server,client}.rs +
ingress/shared_tcp_endpoint.rs (one listener per process shared by every
served endpoint) + egress/push_router.rs client side. Frames use the
two-part codec; one connection multiplexes many request streams.

Frame headers:
  {"type": "req",    "stream": id, "key": instance_key, "ctx": {...}}  payload=request
  {"type": "cancel", "stream": id}                                     (client→server)
  {"type": "item",   "stream": id}  payload=response item              (server→client)
  {"type": "end",    "stream": id}                                     stream done
  {"type": "err",    "stream": id, "message": str, "kind": str}        stream failed

A dropped connection cancels every stream riding it — on the client side this
surfaces as StreamDisconnectedError, the trigger for request migration
(ref: migration.rs no-responder handling).

``err`` frames carry a ``kind`` (network/errors.py) so TYPED remote
failures re-raise as the matching exception class on the client instead of
a flat RuntimeError. Old peers that omit ``kind`` keep the RuntimeError
behavior.

Incarnation fencing (runtime/liveness.py): every server→client frame is
stamped with the serving process's incarnation (``inc``). One stream's
frames must all carry ONE incarnation — a frame claiming a different one
(a zombie's late packets, or a restarted listener conflated with its
predecessor) is counted (``stale_incarnation_drops_total{seam="tcp"}``)
and dropped, never delivered. Old peers that omit ``inc`` skip the check.

The JAX server wraps each stream in an ``endpoint.serve`` tracing span;
the port has no tracing yet (ROADMAP A4c-4), so its server does not.
"""

from __future__ import annotations

import asyncio
import itertools
import os
import time
from typing import Any, AsyncIterator, Dict, Optional, Tuple

from dynamo_tpu_torch.runtime import fault_names
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.engine import AsyncEngine
from dynamo_tpu_torch.runtime.faults import fault_point
from dynamo_tpu_torch.runtime.liveness import note_stale_drop, process_incarnation
from dynamo_tpu_torch.runtime.network.codec import FrameReader, FrameWriter
from dynamo_tpu_torch.runtime.network.errors import err_exception, err_kind
from dynamo_tpu_torch.runtime.tasks import TaskTracker, reap_task
from dynamo_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

CANCEL_GRACE_S = 2.0  # cooperative-cancel window before hard task cancel


class StreamDisconnectedError(ConnectionError):
    """Worker connection died mid-stream (migration trigger)."""


class TcpRequestPlane:
    kind = "tcp"

    def __init__(self, host: Optional[str] = None, port: int = 0) -> None:
        self.host = host or os.environ.get("DYN_TCP_HOST", "127.0.0.1")
        self.port = port
        self._server: Optional[asyncio.base_events.Server] = None
        self._engines: Dict[str, Tuple[AsyncEngine, TaskTracker]] = {}
        self._bound_port: Optional[int] = None
        self._conns: Dict[Tuple[str, int], "_ClientConn"] = {}
        self._conn_lock: Optional[asyncio.Lock] = None
        self._ingress_writers: set = set()  # live server-side connections

    # -- server side -------------------------------------------------------

    async def serve(
        self, instance: Any, engine: AsyncEngine, tracker: TaskTracker
    ) -> Dict[str, Any]:
        if self._server is None:
            self._server = await asyncio.start_server(
                self._handle_conn, host=self.host, port=self.port
            )
            self._bound_port = self._server.sockets[0].getsockname()[1]
            logger.info("tcp request plane listening on %s:%s", self.host, self._bound_port)
        self._engines[instance.key] = (engine, tracker)
        return {
            "kind": "tcp",
            "host": self.host,
            "port": self._bound_port,
            "key": instance.key,
        }

    async def unserve(self, instance: Any) -> None:
        self._engines.pop(instance.key, None)

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        fr = FrameReader(reader)
        fw = FrameWriter(writer)
        self._ingress_writers.add(writer)
        loop = asyncio.get_running_loop()
        streams: Dict[int, Tuple[asyncio.Task, Context]] = {}
        try:
            while True:
                frame = await fr.recv()
                if frame is None:
                    break
                header, payload = frame
                ftype = header.get("type")
                sid = header.get("stream")
                if ftype == "req":
                    ctx_info = header.get("ctx") or {}
                    # Deadline propagation: the wire carries REMAINING
                    # seconds (monotonic clocks don't cross hosts); the
                    # server re-anchors it so engine admission and the
                    # disagg pull timeouts see the client's real budget.
                    deadline_s = ctx_info.get("deadline_s")
                    ctx = Context(
                        id=ctx_info.get("id"),
                        baggage=ctx_info.get("baggage") or {},
                        deadline=(
                            time.monotonic() + float(deadline_s)
                            if deadline_s is not None
                            else None
                        ),
                    )
                    task = loop.create_task(
                        self._run_stream(fw, sid, header, payload, ctx),
                        name=f"tcp-ingress:{sid}",
                    )
                    streams[sid] = (task, ctx)
                    task.add_done_callback(lambda t, s=sid: streams.pop(s, None))
                elif ftype == "cancel":
                    entry = streams.get(sid)
                    if entry is not None:
                        task, ctx = entry
                        # Cooperative first (engines check ctx between decode
                        # steps); hard-cancel as a backstop for stuck handlers.
                        ctx.stop_generating(reason="client-cancelled")
                        loop.call_later(
                            CANCEL_GRACE_S,
                            lambda t=task: t.cancel() if not t.done() else None,
                        )
                else:
                    logger.warning("unknown frame type %r", ftype)
        except (ConnectionResetError, asyncio.IncompleteReadError):
            pass
        finally:
            for task, ctx in list(streams.values()):
                ctx.stop_generating(reason="connection-closed")
                task.cancel()
            for task, _ in list(streams.values()):
                await reap_task(task, "ingress stream", logger)
            fw.close()
            self._ingress_writers.discard(writer)

    async def _run_stream(
        self,
        fw: FrameWriter,
        sid: int,
        header: Dict[str, Any],
        request: Any,
        ctx: Context,
    ) -> None:
        key = header.get("key", "")
        entry = self._engines.get(key)
        if entry is None:
            await fw.send({"type": "err", "stream": sid,
                           "message": f"no such endpoint instance: {key}"})
            return
        engine, tracker = entry
        # Incarnation stamp on every response envelope: the client fences
        # a stream to ONE serving incarnation, so a zombie's late frames
        # can never be conflated with a restarted worker's.
        inc = process_incarnation()
        try:
            if tracker.draining:
                await fw.send({
                    "type": "err", "stream": sid, "inc": inc,
                    "message": "endpoint draining; re-dispatch",
                    "kind": "draining",
                })
                return
            with tracker.guard():
                async for item in engine.generate(request, ctx):
                    await fw.send(
                        {"type": "item", "stream": sid, "inc": inc}, item
                    )
            await fw.send({"type": "end", "stream": sid, "inc": inc})
        except asyncio.CancelledError:
            ctx.stop_generating(reason="client-cancelled")
            raise
        except (ConnectionResetError, BrokenPipeError):
            ctx.stop_generating(reason="connection-lost")
        except Exception as exc:
            logger.exception("stream %s handler failed", sid)
            with _suppress_conn():
                await fw.send({
                    "type": "err", "stream": sid, "inc": inc,
                    "message": repr(exc), "kind": err_kind(exc),
                })

    # -- client side -------------------------------------------------------

    def client_for(self, instance: Any) -> AsyncEngine:
        host = instance.transport["host"]
        port = instance.transport["port"]
        key = instance.transport.get("key", instance.key)
        return _TcpClientEngine(self, (host, port), key)

    async def _conn(self, addr: Tuple[str, int]) -> "_ClientConn":
        # Serialized: concurrent first requests must not each open a
        # connection (the loser's socket + pump task would leak).
        if self._conn_lock is None:
            self._conn_lock = asyncio.Lock()
        async with self._conn_lock:
            conn = self._conns.get(addr)
            if conn is None or conn.closed:
                conn = _ClientConn(addr)
                await conn.connect()
                self._conns[addr] = conn
            return conn

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            # wait_closed() (3.12 semantics) waits for every live connection,
            # not just the accept loop — close established ingress
            # connections or it never returns.
            for writer in list(self._ingress_writers):
                writer.close()
            await self._server.wait_closed()
            self._server = None
        for conn in self._conns.values():
            await conn.close()
        self._conns.clear()


class _ClientConn:
    """One pooled connection; demuxes response frames to stream queues."""

    def __init__(self, addr: Tuple[str, int]) -> None:
        self.addr = addr
        self._ids = itertools.count(1)
        self._queues: Dict[int, asyncio.Queue] = {}
        self._fw: Optional[FrameWriter] = None
        self._pump: Optional[asyncio.Task] = None
        self.closed = False

    async def connect(self) -> None:
        reader, writer = await asyncio.open_connection(*self.addr)
        self._fw = FrameWriter(writer)
        fr = FrameReader(reader)

        async def pump() -> None:
            try:
                while True:
                    frame = await fr.recv()
                    if frame is None:
                        break
                    # Chaos seam: a fault here models the connection dying
                    # mid-stream — the finally below fans out "disconnect"
                    # to every stream, surfacing StreamDisconnectedError
                    # (the migration trigger) exactly like a real RST.
                    fault_point(fault_names.NET_TCP_RECV)
                    header, payload = frame
                    q = self._queues.get(header.get("stream"))
                    if q is None:
                        continue
                    ftype = header.get("type")
                    inc = header.get("inc")
                    if ftype == "item":
                        q.put_nowait(("item", payload, inc))
                    elif ftype == "end":
                        q.put_nowait(("end", None, inc))
                    elif ftype == "err":
                        q.put_nowait((
                            "err",
                            (
                                header.get("message", "remote error"),
                                header.get("kind", "other"),
                            ),
                            inc,
                        ))
            finally:
                self.closed = True
                for q in self._queues.values():
                    q.put_nowait(("disconnect", None, None))

        self._pump = asyncio.get_running_loop().create_task(
            pump(), name=f"tcp-client-pump:{self.addr}"
        )

    def open_stream(self) -> Tuple[int, asyncio.Queue]:
        sid = next(self._ids)
        q: asyncio.Queue = asyncio.Queue()
        self._queues[sid] = q
        return sid, q

    def close_stream(self, sid: int) -> None:
        self._queues.pop(sid, None)

    async def send(self, header: Any, payload: Any = None) -> None:
        assert self._fw is not None
        fault_point(fault_names.NET_TCP_SEND)
        await self._fw.send(header, payload)

    async def close(self) -> None:
        self.closed = True
        if self._fw is not None:
            self._fw.close()
        if self._pump is not None:
            self._pump.cancel()
            await reap_task(self._pump, "tcp client pump", logger)


class _TcpClientEngine:
    """AsyncEngine view of a remote instance over the TCP plane."""

    def __init__(self, plane: TcpRequestPlane, addr: Tuple[str, int], key: str) -> None:
        self._plane = plane
        self._addr = addr
        self._key = key

    async def generate(self, request: Any, context: Context) -> AsyncIterator[Any]:
        try:
            conn = await self._plane._conn(self._addr)
        except OSError as exc:
            raise StreamDisconnectedError(f"connect {self._addr}: {exc}") from exc
        sid, q = conn.open_stream()
        ctx_env: Dict[str, Any] = {
            "id": context.id, "baggage": context.baggage,
        }
        remaining = context.time_remaining()
        if remaining is not None:
            # Relative, not absolute: the receiving host re-anchors onto
            # its own monotonic clock.
            ctx_env["deadline_s"] = remaining
        await conn.send(
            {
                "type": "req",
                "stream": sid,
                "key": self._key,
                "ctx": ctx_env,
            },
            request,
        )

        async def watch_cancel() -> None:
            await context.wait_stopped()
            with _suppress_conn():
                await conn.send({"type": "cancel", "stream": sid})

        cancel_task = asyncio.get_running_loop().create_task(watch_cancel())
        stream_inc: Optional[int] = None
        try:
            while True:
                kind, payload, inc = await q.get()
                if inc is not None:
                    # Incarnation fence: the stream belongs to whichever
                    # incarnation answered FIRST; frames claiming another
                    # (a zombie's late packets) are counted and dropped —
                    # a restarted listener cannot continue a stream it
                    # never held.
                    if stream_inc is None:
                        stream_inc = inc
                    elif inc != stream_inc:
                        note_stale_drop("tcp")
                        logger.warning(
                            "dropping frame from foreign incarnation on "
                            "stream %d of %s", sid, self._addr,
                        )
                        continue
                if kind == "item":
                    yield payload
                elif kind == "end":
                    return
                elif kind == "err":
                    message, ekind = payload
                    raise err_exception(ekind, message)
                elif kind == "disconnect":
                    raise StreamDisconnectedError(
                        f"worker connection lost: {self._addr}"
                    )
        finally:
            cancel_task.cancel()
            conn.close_stream(sid)


class _suppress_conn:
    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        return et is not None and issubclass(
            et, (ConnectionError, BrokenPipeError, RuntimeError, AssertionError)
        )
