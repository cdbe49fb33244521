"""The port's standard-library HTTP/1.1 server (dynamo_tpu_torch/http/web.py)
alone, through ``http.client`` and raw sockets on 127.0.0.1. One small
app, written once against the API both modules share, runs on the port's
server and on aiohttp's (the JAX frontend's server): the same raw requests
— Content-Length and chunked bodies, ``Expect: 100-continue``, 404, 405,
413, routes with ``{name}`` segments (matched in the order added), JSON
and plain-text responses, a chunked SSE response, HTTP/1.0 —
must get the same status line, headers (``Date`` and ``Server`` aside) and
body from both. Then what only the port's side can show from inside:
keep-alive (several requests on one connection, ``Connection: close``,
HTTP/1.0 with and without keep-alive), each SSE frame reaching the client
before the next is written, ``TCP_NODELAY`` on the accepted socket, and
``StreamResponse.write()`` raising ``ConnectionResetError`` once the
client has closed while a unary handler whose client left runs to its
end."""

import asyncio
import http.client
import json
import socket

import pytest
from aiohttp import web as aioweb

from dynamo_tpu_torch.http import web as tweb


def make_app(web, state):
    """The same handlers on either module."""
    async def echo(request):
        body = await request.json()
        return web.json_response({"got": body, "method": request.method,
                                  "q": request.query.get("q")})

    async def plain(request):
        return web.Response(body=b"hello", content_type="text/plain")

    async def text(request):
        return web.Response(text="héllo", status=201, headers={"X-Thing": "1"})

    async def sse(request):
        resp = web.StreamResponse(status=200, headers={
            "Content-Type": "text/event-stream", "Cache-Control": "no-cache",
            "Connection": "keep-alive", "X-Request-Id": "r1"})
        await resp.prepare(request)
        for i in range(3):
            await resp.write(f"data: {i}\n\n".encode())
            if state.get("frames") is not None:
                await state["frames"].put(i)
                await state["go"].wait()
                state["go"].clear()
        await resp.write(b"data: [DONE]\n\n")
        await resp.write_eof()
        return resp

    async def busy(request):
        resp = web.json_response({"error": "busy"}, status=503)
        resp.headers["Retry-After"] = "1"
        return resp

    async def nodelay(request):
        # (the accepted socket, from inside the port's server)
        transport = request._conn.writer.transport
        sock = transport.get_extra_info("socket")
        return web.json_response(
            {"nodelay": sock.getsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY) != 0,
             "peer": list(transport.get_extra_info("peername"))})

    async def boom(request):
        raise RuntimeError("handler bug")

    async def item(request):
        return web.json_response({"name": request.match_info["name"]})

    async def fixed(request):
        return web.json_response({"fixed": True})

    app = web.Application()
    app.router.add_post("/echo", echo)
    app.router.add_get("/plain", plain)
    app.router.add_get("/text", text)
    app.router.add_post("/sse", sse)
    app.router.add_get("/busy", busy)
    app.router.add_get("/nodelay", nodelay)
    app.router.add_get("/boom", boom)
    # a {name} route, after an exact route it also matches
    app.router.add_get("/item/fixed", fixed)
    app.router.add_get("/item/{name}", item)
    app.router.add_post("/item/{name}/tag", item)
    return app


class Served:
    """An app on the port's server or aiohttp's, on 127.0.0.1, port 0."""

    def __init__(self, kind, state=None):
        self.kind, self.state = kind, state if state is not None else {}

    async def __aenter__(self):
        if self.kind == "port":
            self.server = tweb.Server(make_app(tweb, self.state))
            self.port = await self.server.start("127.0.0.1", 0)
        else:
            self.runner = aioweb.AppRunner(make_app(aioweb, self.state), access_log=None)
            await self.runner.setup()
            site = aioweb.TCPSite(self.runner, "127.0.0.1", 0)
            await site.start()
            self.port = site._server.sockets[0].getsockname()[1]
        return self

    async def __aexit__(self, *exc):
        if self.kind == "port":
            await self.server.stop()
        else:
            await self.runner.cleanup()


async def exchange(port, data, *, until_close=True, idle=0.5):
    """Send raw bytes; read until the server closes (or ``idle`` seconds
    pass without data)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(data)
    await writer.drain()
    out = b""
    try:
        while True:
            chunk = await asyncio.wait_for(reader.read(65536), idle)
            if not chunk:
                break
            out += chunk
    except asyncio.TimeoutError:
        assert not until_close, out
    except ConnectionResetError:
        pass
    writer.close()
    return out


def normalized(raw):
    """Status line, headers without Date / Server (as a sorted list), body,
    and the interim (1xx) status lines before them."""
    interim = []
    while raw.startswith(b"HTTP/1.1 1"):
        line, _, raw = raw.partition(b"\r\n\r\n")
        interim.append(line.decode())
    head, _, body = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = sorted((k.lower(), v) for k, _, v in (x.partition(": ") for x in lines[1:])
                     if k.lower() not in ("date", "server"))
    return lines[0], headers, body, interim


BIG = json.dumps(list(range(300_000))).encode()  # > 1 MiB
CASES = {
    "json": b"POST /echo?q=1 HTTP/1.1\r\nHost: x\r\nContent-Length: 7\r\n"
            b"Connection: close\r\n\r\n[1,\"a\"]",
    "chunked": b"POST /echo HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked\r\n"
               b"Connection: close\r\n\r\n4\r\n{\"a\"\r\n3;ext=1\r\n: 1\r\n1\r\n}\r\n0\r\n\r\n",
    "continue": b"POST /echo HTTP/1.1\r\nHost: x\r\nContent-Length: 2\r\n"
                b"Expect: 100-continue\r\nConnection: close\r\n\r\n{}",
    "not found": b"GET /nope HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n",
    "not found, continue": b"POST /nope HTTP/1.1\r\nHost: x\r\nContent-Length: 2\r\n"
                           b"Expect: 100-continue\r\nConnection: close\r\n\r\n{}",
    "method": b"POST /plain HTTP/1.1\r\nHost: x\r\nContent-Length: 0\r\n"
              b"Connection: close\r\n\r\n",
    "method, post only": b"GET /echo HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n",
    "plain": b"GET /plain HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n",
    "match": b"GET /item/4bf92f35 HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n",
    "match, exact first": b"GET /item/fixed HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n",
    "match, two segments": b"POST /item/a/tag HTTP/1.1\r\nHost: x\r\nContent-Length: 0\r\n"
                           b"Connection: close\r\n\r\n",
    "match, empty segment": b"GET /item/ HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n",
    "match, too deep": b"GET /item/a/b HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n",
    "match, method": b"POST /item/a HTTP/1.1\r\nHost: x\r\nContent-Length: 0\r\n"
                     b"Connection: close\r\n\r\n",
    "text": b"GET /text HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n",
    "head": b"HEAD /plain HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n",
    "retry-after": b"GET /busy HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n",
    "sse": b"POST /sse HTTP/1.1\r\nHost: x\r\nContent-Length: 0\r\nConnection: close\r\n\r\n",
    "http/1.0": b"GET /plain HTTP/1.0\r\n\r\n",
    "invalid json": b"POST /echo HTTP/1.1\r\nHost: x\r\nContent-Length: 3\r\n"
                    b"Connection: close\r\n\r\n{x}",
    "too large": b"POST /echo HTTP/1.1\r\nHost: x\r\nContent-Length: %d\r\n\r\n%b"
                 % (len(BIG), BIG),
}


@pytest.mark.parametrize("case", sorted(CASES))
async def test_wire_matches_aiohttp(case):
    got = []
    for kind in ("aiohttp", "port"):
        async with Served(kind) as s:
            # after a 413 aiohttp keeps the connection open; the port closes it
            got.append(normalized(await exchange(s.port, CASES[case],
                                                 until_close=case != "too large")))
    want, mine = got
    if case == "invalid json":
        # a handler's uncaught error: 500 as plain text on both
        assert (mine[0], want[0]) == ("HTTP/1.1 500 Internal Server Error",) * 2
        assert dict(mine[1])["content-type"] == dict(want[1])["content-type"]
        return
    if case == "too large":
        # aiohttp reports how much it had read when it gave up; the port
        # reports the declared length
        assert mine[0] == want[0] == "HTTP/1.1 413 Request Entity Too Large"
        prefix = b"Maximum request body size 1048576 exceeded, actual body size "
        assert mine[2].startswith(prefix) and want[2].startswith(prefix)
        assert mine[2] == prefix + str(len(BIG)).encode()
        return
    assert mine == want
    # 100 Continue goes out before routing, a 404 too
    assert mine[3] == (["HTTP/1.1 100 Continue"] if "continue" in case else [])


async def test_handler_error_is_a_500_like_aiohttp():
    got = []
    for kind in ("aiohttp", "port"):
        async with Served(kind) as s:
            got.append(normalized(await exchange(
                s.port, b"GET /boom HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n")))
    assert got[1] == got[0]
    assert got[0][0] == "HTTP/1.1 500 Internal Server Error"


async def test_keep_alive_and_close():
    async with Served("port") as s:
        def client():
            conn = http.client.HTTPConnection("127.0.0.1", s.port, timeout=10)
            peers = []
            for i in range(4):
                conn.request("POST", "/echo", json.dumps({"i": i}),
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                assert resp.status == 200 and json.loads(resp.read())["got"] == {"i": i}
                conn.request("GET", "/nodelay")
                peers.append(json.loads(conn.getresponse().read())["peer"])
            # SSE between plain requests on the same connection
            conn.request("POST", "/sse", b"")
            resp = conn.getresponse()
            assert resp.getheader("Transfer-Encoding") == "chunked"
            assert resp.read() == b"".join(b"data: %d\n\n" % i for i in range(3)) + \
                b"data: [DONE]\n\n"
            conn.request("GET", "/nodelay")
            peers.append(json.loads(conn.getresponse().read())["peer"])
            conn.close()
            return peers

        peers = await asyncio.to_thread(client)
        assert len({tuple(p) for p in peers}) == 1  # one connection throughout
        # two requests pipelined, then Connection: close: both answered, then EOF
        raw = await exchange(s.port, b"GET /plain HTTP/1.1\r\nHost: x\r\n\r\n"
                                     b"GET /plain HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n")
        assert raw.count(b"HTTP/1.1 200 OK") == 2 and raw.endswith(b"hello")
        assert b"Connection: close" in raw.split(b"HTTP/1.1 200 OK")[2]
        # HTTP/1.0 closes unless asked to keep the connection alive
        raw = await exchange(s.port, b"GET /plain HTTP/1.0\r\n\r\n")
        assert raw.startswith(b"HTTP/1.0 200 OK") and raw.endswith(b"hello")
        raw = await exchange(s.port, b"GET /plain HTTP/1.0\r\nConnection: keep-alive\r\n\r\n",
                             until_close=False)
        assert b"Connection: keep-alive" in raw and raw.endswith(b"hello")
        # a body the handler never read is dropped and the next request parses
        raw = await exchange(s.port, b"GET /plain HTTP/1.1\r\nHost: x\r\nContent-Length: 5\r\n\r\n"
                                     b"xxxxxGET /plain HTTP/1.1\r\nHost: x\r\n"
                                     b"Connection: close\r\n\r\n")
        assert raw.count(b"HTTP/1.1 200 OK") == 2


async def test_sse_frames_leave_one_at_a_time_on_a_nodelay_socket():
    state = {"frames": asyncio.Queue(), "go": asyncio.Event()}
    async with Served("port", state) as s:
        reader, writer = await asyncio.open_connection("127.0.0.1", s.port)
        writer.write(b"POST /sse HTTP/1.1\r\nHost: x\r\nContent-Length: 0\r\n\r\n")
        await reader.readuntil(b"\r\n\r\n")
        for i in range(3):
            # the handler has written frame i and waits: the client holds it
            assert await asyncio.wait_for(state["frames"].get(), 5) == i
            frame = b"data: %d\n\n" % i
            want = b"%x\r\n%b\r\n" % (len(frame), frame)
            assert await asyncio.wait_for(reader.readexactly(len(want)), 5) == want
            state["go"].set()
        assert await asyncio.wait_for(reader.readuntil(b"0\r\n\r\n"), 5) == \
            b"e\r\ndata: [DONE]\n\n\r\n0\r\n\r\n"
        writer.write(b"GET /nodelay HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n")
        body = (await asyncio.wait_for(reader.read(), 5)).partition(b"\r\n\r\n")[2]
        assert json.loads(body)["nodelay"] is True
        writer.close()


async def test_write_raises_after_the_client_closes_and_unary_runs_on():
    log = {}
    left = asyncio.Event()

    async def stream(request):
        resp = tweb.StreamResponse(headers={"Content-Type": "text/event-stream"})
        await resp.prepare(request)
        await resp.write(b"data: 0\n\n")
        await left.wait()
        writes = 0
        try:
            for _ in range(50):
                await asyncio.sleep(0.01)
                writes += 1
                await resp.write(b"data: more\n\n")
        except ConnectionResetError as exc:
            log["stream"] = (writes, str(exc))
        return resp

    async def unary(request):
        await left.wait()
        await asyncio.sleep(0.05)
        log["unary"] = "finished"
        return tweb.json_response({"ok": True})

    app = tweb.Application()
    app.router.add_post("/stream", stream)
    app.router.add_post("/unary", unary)
    server = tweb.Server(app)
    port = await server.start("127.0.0.1", 0)
    try:
        conns = []
        for path in (b"/stream", b"/unary"):
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(b"POST %b HTTP/1.1\r\nHost: x\r\nContent-Length: 0\r\n\r\n" % path)
            await writer.drain()
            conns.append((reader, writer))
        await asyncio.wait_for(conns[0][0].readuntil(b"data: 0\n\n\r\n"), 5)
        for _, writer in conns:
            writer.close()
        await asyncio.sleep(0.05)
        left.set()
        for _ in range(200):
            if len(log) == 2:
                break
            await asyncio.sleep(0.01)
        assert log["unary"] == "finished"  # not cancelled when its client left
        writes, msg = log["stream"]
        assert writes <= 2 and "closing transport" in msg
    finally:
        await server.stop()


async def test_stop_cancels_a_handler_still_running():
    cancelled = asyncio.Event()

    async def forever(request):
        try:
            await asyncio.Event().wait()
        except asyncio.CancelledError:
            cancelled.set()
            raise

    app = tweb.Application()
    app.router.add_get("/forever", forever)
    server = tweb.Server(app)
    port = await server.start("127.0.0.1", 0)
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(b"GET /forever HTTP/1.1\r\nHost: x\r\n\r\n")
    await writer.drain()
    await asyncio.sleep(0.05)
    await asyncio.wait_for(server.stop(), 5)
    assert cancelled.is_set()
    assert await asyncio.wait_for(reader.read(), 5) == b""
    writer.close()
