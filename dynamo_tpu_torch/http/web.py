"""A small HTTP/1.1 server on the standard library's asyncio streams, with
the subset of aiohttp's ``web`` API that http/service.py uses: ``Request``,
``Response``, ``json_response``, ``StreamResponse``, an ``Application``
whose router takes ``add_get`` / ``add_post`` / ``add_delete`` (exact paths,
paths with ``{name}`` segments whose values land in ``Request.match_info``,
and a last ``{name:.*}`` segment that takes the rest of the path), and
``Server`` to serve it through ``asyncio.start_server``, over TLS when it
is given an ``ssl.SSLContext``. The JAX frontend runs on aiohttp, which
the card's machine lacks; this module answers on the wire as aiohttp 3.13
does for everything the frontend sends and receives:

* request framing — ``Content-Length`` and chunked bodies (both at once is
  refused, 400), ``Expect: 100-continue`` answered with ``HTTP/1.1 100
  Continue`` before the handler runs (curl waits a second for it before a
  large POST), and a body above ``CLIENT_MAX_SIZE`` (aiohttp's default
  ``client_max_size``, 1 MiB) refused with 413 when the handler reads it;
* connections — keep-alive for HTTP/1.1 unless ``Connection: close``;
  HTTP/1.0 closes unless ``Connection: keep-alive``; a body the handler
  left unread is read and dropped so the next request parses;
* status codes — 404 ``404: Not Found`` and 405 ``405: Method Not
  Allowed`` with ``Allow`` as plain text; 500 for a handler that raised;
* responses — ``json_response`` serializes with ``json.dumps``'s default
  separators as ``application/json; charset=utf-8``; a ``StreamResponse``
  goes out with ``Transfer-Encoding: chunked``, and each ``write()``
  awaits ``drain()``, so an SSE frame leaves at once;
* ``TCP_NODELAY`` on every accepted socket (as aiohttp sets it), so a
  small frame never waits on Nagle's algorithm and a delayed ACK;
* disconnects — handlers are not cancelled when their client leaves
  (aiohttp's default ``handler_cancellation=False``): a unary request runs
  to its end, and ``StreamResponse.write()`` raises
  ``ConnectionResetError`` once the client has closed, which is how the
  SSE path learns that its client went away.
"""

from __future__ import annotations

import asyncio
import email.utils
import json
import logging
import socket
import sys
from collections.abc import Mapping, MutableMapping
from http import HTTPStatus
from typing import Any, Awaitable, Callable, Dict, Iterator, List, Optional, Tuple
from urllib.parse import parse_qsl, unquote, urlsplit

logger = logging.getLogger(__name__)

CLIENT_MAX_SIZE = 1024 ** 2  # aiohttp's default client_max_size
_HEAD_LIMIT = 64 * 1024  # request line and headers
_LINGER_BYTES, _LINGER_S = 16 * CLIENT_MAX_SIZE, 2.0  # see Server._linger
SERVER = f"Python/{sys.version_info[0]}.{sys.version_info[1]} dynamo_tpu_torch"


class Headers(MutableMapping):
    """Case-insensitive header map that keeps each name's spelling."""

    def __init__(self, items: Any = ()) -> None:
        self._d: Dict[str, Tuple[str, str]] = {}
        for k, v in items.items() if isinstance(items, Mapping) else items:
            self[k] = v

    def __getitem__(self, key: str) -> str:
        return self._d[key.lower()][1]

    def __setitem__(self, key: str, value: Any) -> None:
        self._d[key.lower()] = (key, str(value))

    def __delitem__(self, key: str) -> None:
        del self._d[key.lower()]

    def __iter__(self) -> Iterator[str]:
        return (name for name, _ in self._d.values())

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: object) -> bool:
        return isinstance(key, str) and key.lower() in self._d

    def _add(self, key: str, value: str) -> None:
        """A repeated request header joins its values with ', '."""
        if key in self:
            value = f"{self[key]}, {value}"
        self[key] = value


class HTTPException(Exception):
    """Raised in a handler (or by the server) to answer with a plain-text
    error, as aiohttp's ``web.HTTPException`` does."""

    def __init__(self, status: int, text: Optional[str] = None,
                 headers: Optional[Dict[str, str]] = None) -> None:
        self.status = status
        self.text = text or f"{status}: {HTTPStatus(status).phrase}"
        self.headers = headers or {}
        super().__init__(self.text)

    def response(self) -> "Response":
        return Response(status=self.status, text=self.text, headers=self.headers)


class _Conn:
    """One accepted connection: its streams and the HTTP version and
    keep-alive decision of the request being served."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        self.reader = reader
        self.writer = writer
        self.version = "HTTP/1.1"
        self.keep_alive = True

    def check_open(self) -> None:
        # asyncio's StreamWriter.write does not raise on a closing
        # transport, and a peer's FIN only shows at the reader.
        if self.writer.transport.is_closing() or self.reader.at_eof():
            raise ConnectionResetError("Cannot write to closing transport")

    def head(self, status: int, headers: Headers, framing: Tuple[str, str]) -> bytes:
        lines = [f"{self.version} {status} {HTTPStatus(status).phrase}"]
        lines += [f"{k}: {v}" for k, v in headers.items()
                  if k.lower() not in ("content-length", "transfer-encoding")]
        lines.append(f"{framing[0]}: {framing[1]}")
        lines.append(f"Date: {email.utils.formatdate(usegmt=True)}")
        lines.append(f"Server: {SERVER}")
        if "connection" not in headers:
            if self.version == "HTTP/1.1" and not self.keep_alive:
                lines.append("Connection: close")
            elif self.version == "HTTP/1.0" and self.keep_alive:
                lines.append("Connection: keep-alive")
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


class Request:
    """What a handler sees: ``method``, ``path``, ``query``, ``headers``,
    the body through ``read()`` / ``text()`` / ``json()`` (read at most
    once, ``CLIENT_MAX_SIZE`` bytes at most)."""

    def __init__(self, conn: _Conn, method: str, target: str, headers: Headers,
                 body_kind: str, content_length: int) -> None:
        self._conn = conn
        self.method = method
        parts = urlsplit(target)
        self.path = unquote(parts.path)
        self.query: Dict[str, str] = {}
        for k, v in parse_qsl(parts.query, keep_blank_values=True):
            self.query.setdefault(k, v)
        self.headers = headers
        self.match_info: Dict[str, str] = {}  # a {name} route's segments
        self.version = conn.version
        self._body_kind = body_kind  # none | length | chunked
        self._content_length = content_length
        self._body: Optional[bytes] = None

    @property
    def body_exists(self) -> bool:
        return self._body_kind != "none"

    @property
    def can_read_body(self) -> bool:
        return self.body_exists and self._body is None

    async def read(self) -> bytes:
        if self._body is None:
            try:
                self._body = await self._read_body()
            except (asyncio.IncompleteReadError, asyncio.LimitOverrunError) as exc:
                raise ConnectionResetError("client closed the request body early") from exc
        return self._body

    async def text(self) -> str:
        return (await self.read()).decode("utf-8")

    async def json(self) -> Any:
        return json.loads(await self.text())

    def _too_large(self, actual: int) -> HTTPException:
        self._body_kind = "broken"  # unread: the connection cannot be reused
        return HTTPException(
            413, f"Maximum request body size {CLIENT_MAX_SIZE} exceeded, "
            f"actual body size {actual}")

    async def _read_body(self) -> bytes:
        reader = self._conn.reader
        if self._body_kind == "length":
            if self._content_length > CLIENT_MAX_SIZE:
                raise self._too_large(self._content_length)
            return await reader.readexactly(self._content_length)
        if self._body_kind != "chunked":
            return b""
        parts, size = [], 0
        while True:
            line = await reader.readuntil(b"\r\n")
            try:
                n = int(line.split(b";", 1)[0].strip(), 16)
            except ValueError:
                self._body_kind = "broken"
                raise HTTPException(400, "Bad Request: invalid chunk size") from None
            if n == 0:
                while await reader.readuntil(b"\r\n") != b"\r\n":
                    pass  # trailer fields
                return b"".join(parts)
            size += n
            if size > CLIENT_MAX_SIZE:
                raise self._too_large(size)
            parts.append(await reader.readexactly(n))
            await reader.readexactly(2)

    def _discard_body(self) -> bool:
        """Whether the body the handler left unread can be read and dropped
        (so the connection can carry the next request)."""
        if self._body_kind == "broken":
            return False
        return self._body is not None or self._body_kind == "none" or (
            self._body_kind == "length" and self._content_length <= CLIENT_MAX_SIZE)


class StreamResponse:
    """A response written in pieces: ``prepare(request)`` sends the status
    line and headers (``Transfer-Encoding: chunked`` on HTTP/1.1), each
    ``write(data)`` sends one chunk and waits for the socket to take it,
    ``write_eof()`` ends the body."""

    def __init__(self, *, status: int = 200, headers: Optional[Mapping] = None) -> None:
        self.status = status
        self.headers = Headers(headers or ())
        self._conn: Optional[_Conn] = None
        self._chunked = False
        self._head_only = False
        self._eof = False

    async def prepare(self, request: Request) -> None:
        if self._conn is not None:
            return
        conn = self._conn = request._conn
        self._head_only = request.method == "HEAD"
        conn.check_open()
        if conn.version == "HTTP/1.1":
            self._chunked = True
            framing = ("Transfer-Encoding", "chunked")
        else:  # HTTP/1.0: the body ends where the connection does
            conn.keep_alive = False
            self.headers.pop("Connection", None)
            framing = ("Connection", "close")
        conn.writer.write(conn.head(self.status, self.headers, framing))
        await conn.writer.drain()

    async def write(self, data: bytes) -> None:
        if self._conn is None:
            raise RuntimeError("write() before prepare()")
        if self._eof:
            raise RuntimeError("write() after write_eof()")
        self._conn.check_open()
        if not data or self._head_only:
            return
        if self._chunked:
            data = b"%x\r\n%b\r\n" % (len(data), data)
        self._conn.writer.write(data)
        await self._conn.writer.drain()

    async def write_eof(self) -> None:
        if self._eof or self._conn is None:
            return
        self._eof = True
        if self._chunked and not self._head_only:
            self._conn.check_open()
            self._conn.writer.write(b"0\r\n\r\n")
            await self._conn.writer.drain()


class Response(StreamResponse):
    """A whole response: ``body`` bytes (``content_type`` as given) or
    ``text`` (``content_type`` text/plain by default, ``; charset=utf-8``
    added), sent with a Content-Length."""

    def __init__(self, *, status: int = 200, body: Optional[bytes] = None,
                 text: Optional[str] = None, content_type: Optional[str] = None,
                 headers: Optional[Mapping] = None) -> None:
        super().__init__(status=status, headers=headers)
        if text is not None:
            self.body = text.encode("utf-8")
            content_type = f"{content_type or 'text/plain'}; charset=utf-8"
        else:
            self.body = body or b""
            content_type = content_type or "application/octet-stream"
        if "Content-Type" not in self.headers:
            # first on the wire, as aiohttp sends it
            self.headers = Headers([("Content-Type", content_type), *self.headers.items()])

    async def prepare(self, request: Request) -> None:
        if self._conn is not None:
            return
        conn = self._conn = request._conn
        self._eof = True
        data = conn.head(self.status, self.headers, ("Content-Length", str(len(self.body))))
        conn.writer.write(data if request.method == "HEAD" else data + self.body)
        await conn.writer.drain()


def json_response(data: Any, *, status: int = 200,
                  headers: Optional[Mapping] = None) -> Response:
    return Response(status=status, text=json.dumps(data), content_type="application/json",
                    headers=headers)


Handler = Callable[[Request], Awaitable[StreamResponse]]


class Router:
    """Routes matched in the order they were added, as aiohttp's are: an
    exact path, or a path with ``{name}`` segments (each matching one
    non-empty segment, aiohttp's default pattern) and perhaps a last
    ``{name:.*}`` segment (the rest of the path, slashes included, possibly
    empty), whose values land in ``Request.match_info``. A path that some
    route matches under another
    method only is a 405 naming the methods; ``add_get`` also answers
    HEAD, as aiohttp's does."""

    def __init__(self) -> None:
        # (path segments, whether any is a {name}, method → handler)
        self._routes: List[Tuple[List[str], bool, Dict[str, Handler]]] = []

    def add_route(self, method: str, path: str, handler: Handler) -> None:
        segments = path.split("/")
        for seg, _, methods in self._routes:
            if seg == segments:
                methods[method] = handler
                return
        self._routes.append((segments, "{" in path, {method: handler}))

    def add_get(self, path: str, handler: Handler) -> None:
        self.add_route("GET", path, handler)
        self.add_route("HEAD", path, handler)

    def add_post(self, path: str, handler: Handler) -> None:
        self.add_route("POST", path, handler)

    def add_delete(self, path: str, handler: Handler) -> None:
        self.add_route("DELETE", path, handler)

    def resolve(self, method: str, path: str) -> Tuple[Handler, Dict[str, str]]:
        """(handler, match_info) for a request, or HTTPException 404/405."""
        parts = path.split("/")
        allowed: set = set()
        for segments, dynamic, methods in self._routes:
            match = _match(segments, parts) if dynamic else ({} if segments == parts else None)
            if match is None:
                continue
            if method in methods:
                return methods[method], match
            allowed.update(methods)
        if allowed:
            raise HTTPException(405, headers={"Allow": ",".join(sorted(allowed))})
        raise HTTPException(404)


def _match(segments: List[str], parts: List[str]) -> Optional[Dict[str, str]]:
    """A {name} route's match_info for a path's segments, or None."""
    last = segments[-1]
    if last.startswith("{") and last.endswith(":.*}"):
        head = len(segments) - 1
        if len(parts) < len(segments):
            return None
        match = _match(segments[:head], parts[:head])
        if match is not None:
            match[last[1:-4]] = "/".join(parts[head:])
        return match
    if len(segments) != len(parts):
        return None
    match: Dict[str, str] = {}
    for want, got in zip(segments, parts):
        if want.startswith("{") and want.endswith("}"):
            if not got:
                return None
            match[want[1:-1]] = got
        elif want != got:
            return None
    return match


class Application:
    def __init__(self) -> None:
        self.router = Router()


def _bad_request(what: str) -> HTTPException:
    return HTTPException(400, f"Bad Request: {what}")


class Server:
    """Serves an Application: ``await start(host, port)`` binds and returns
    the bound port (useful with port 0); ``await stop()`` closes the
    listening socket and every connection, cancelling handlers still
    running on them."""

    def __init__(self, app: Application) -> None:
        self.app = app
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()

    async def start(self, host: str, port: int, ssl: Any = None) -> int:
        """Bind and serve (over TLS when ``ssl`` is an SSLContext)."""
        self._server = await asyncio.start_server(self._serve, host, port,
                                                  limit=_HEAD_LIMIT, ssl=ssl)
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is None:
            return
        self._server.close()
        for task in list(self._conns):
            task.cancel()
        await asyncio.gather(*self._conns, return_exceptions=True)
        await self._server.wait_closed()
        self._server = None

    async def _serve(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        sock = writer.get_extra_info("socket")
        if sock is not None:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = _Conn(reader, writer)
        try:
            while await self._one(conn):
                pass
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # the client went away
        finally:
            self._conns.discard(task)
            writer.close()

    async def _one(self, conn: _Conn) -> bool:
        """Serve one request; whether the connection carries another."""
        try:
            head = await conn.reader.readuntil(b"\r\n\r\n")
        except asyncio.IncompleteReadError:
            return False  # closed between requests
        except asyncio.LimitOverrunError:
            await self._send_error(conn, _bad_request("request head too large"))
            return False
        try:
            request = self._parse(conn, head)
        except HTTPException as exc:
            await self._send_error(conn, exc)
            return False
        if request.body_exists and request.version == "HTTP/1.1" and \
                request.headers.get("Expect", "").lower() == "100-continue":
            conn.writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        try:
            handler, request.match_info = self.app.router.resolve(
                request.method, request.path)
            response = await handler(request)
        except HTTPException as exc:
            response = exc.response()
        except ConnectionError:
            return False
        except Exception:
            logger.exception("error handling %s %s", request.method, request.path)
            response = HTTPException(
                500, "500 Internal Server Error\n\nServer got itself in trouble").response()
        drainable = request._discard_body()
        if not drainable:
            conn.keep_alive = False
        await response.prepare(request)
        await response.write_eof()
        if not drainable:
            await self._linger(conn)
        elif request._body is None:
            await request.read()
        return conn.keep_alive

    @staticmethod
    async def _linger(conn: _Conn) -> None:
        """Before closing on a body left unread, read and drop what the
        client still sends (up to ``_LINGER_BYTES`` or ``_LINGER_S``):
        closing a socket with unread input resets the connection, and the
        client could lose the response with it."""
        if conn.writer.can_write_eof():
            conn.writer.write_eof()
        got = 0
        try:
            async with asyncio.timeout(_LINGER_S):
                while got < _LINGER_BYTES:
                    data = await conn.reader.read(_HEAD_LIMIT)
                    if not data:
                        return
                    got += len(data)
        except TimeoutError:
            pass

    def _parse(self, conn: _Conn, head: bytes) -> Request:
        lines = head.decode("latin-1").split("\r\n")
        while lines and not lines[0]:
            lines.pop(0)  # empty lines before a request line are ignored
        parts = lines[0].split(" ") if lines else []
        if len(parts) != 3 or not parts[0].isalpha() or not parts[0].isupper():
            raise _bad_request("invalid request line")
        method, target, version = parts
        if version not in ("HTTP/1.1", "HTTP/1.0"):
            raise HTTPException(505, "HTTP Version Not Supported")
        conn.version = version
        headers = Headers()
        for line in lines[1:]:
            if not line:
                continue
            name, sep, value = line.partition(":")
            if not sep or not name or name != name.strip():
                raise _bad_request("invalid header line")
            headers._add(name, value.strip())
        tokens = {t.strip().lower() for t in headers.get("Connection", "").split(",")}
        conn.keep_alive = ("close" not in tokens) if version == "HTTP/1.1" \
            else ("keep-alive" in tokens)
        length, kind = 0, "none"
        if "Transfer-Encoding" in headers:
            if "Content-Length" in headers:
                raise _bad_request("Content-Length with Transfer-Encoding")
            if headers["Transfer-Encoding"].lower().split(",")[-1].strip() != "chunked":
                raise _bad_request("unsupported Transfer-Encoding")
            kind = "chunked"
        elif "Content-Length" in headers:
            raw = headers["Content-Length"]
            if not raw.isdigit():
                raise _bad_request("invalid Content-Length")
            length = int(raw)
            kind = "length" if length else "none"
        return Request(conn, method, target, headers, kind, length)

    @staticmethod
    async def _send_error(conn: _Conn, exc: HTTPException) -> None:
        conn.keep_alive = False
        response = exc.response()
        data = conn.head(response.status, response.headers,
                         ("Content-Length", str(len(response.body))))
        conn.writer.write(data + response.body)
        await conn.writer.drain()
