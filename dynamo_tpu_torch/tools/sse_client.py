"""A standard-library HTTP/1.1 client that sends a set of requests to an
OpenAI server at once, each on its own connection, and records when each
SSE frame arrived — the load side of ``chip_smoke.py``'s ``http`` phase,
kept out of the served process so that its own parsing does not run on
the server's event loop.

    python3 dynamo_tpu_torch/tools/sse_client.py PORT < requests.json

Run it by path: it imports nothing of the package (nor torch). The input
is a JSON list of ``{"method": "POST", "path": ..., "body": {...} or
"raw": "...", "headers": {...}, "close_after": N}`` (``headers``: extra
request headers; ``close_after``: close the connection after N SSE frames,
as a client that leaves mid-stream). The output, on
stdout, is a JSON list in the same order of ``{"status", "headers",
"t0", "frames": [[t, frame], ...], "body", "t_end"}``: ``t0`` just before
the request was written, ``t`` when the frame's last byte arrived, both
on ``time.monotonic()`` (CLOCK_MONOTONIC, shared by the processes of one
machine); ``frames`` for a chunked (SSE) response, ``body`` (text)
otherwise.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time


async def one(port: int, req: dict, on_frame=None) -> dict:
    """One request; ``on_frame(t, frame)`` is called as each SSE frame
    arrives."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = req["raw"].encode() if "raw" in req else (
        json.dumps(req["body"]).encode() if "body" in req else b"")
    extra = "".join(f"{k}: {v}\r\n" for k, v in req.get("headers", {}).items())
    head = (f"{req.get('method', 'POST')} {req['path']} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
            f"Content-Type: application/json\r\nContent-Length: {len(data)}\r\n"
            f"{extra}Connection: close\r\n\r\n").encode()
    t0 = time.monotonic()
    writer.write(head + data)
    await writer.drain()
    status_line = (await reader.readuntil(b"\r\n")).decode()
    headers = {}
    while (line := (await reader.readuntil(b"\r\n")).decode()) != "\r\n":
        k, _, v = line.partition(":")
        headers[k.strip().lower()] = v.strip()
    out = {"status": int(status_line.split(" ")[1]), "headers": headers, "t0": t0,
           "frames": [], "body": None}
    close_after = req.get("close_after")
    if headers.get("transfer-encoding") == "chunked":
        buf = ""
        while True:
            size = int((await reader.readuntil(b"\r\n")).split(b";")[0], 16)
            if size == 0:
                await reader.readuntil(b"\r\n")
                break
            buf += (await reader.readexactly(size)).decode()
            await reader.readexactly(2)
            t = time.monotonic()
            while "\n\n" in buf:
                frame, buf = buf.split("\n\n", 1)
                out["frames"].append([t, frame])
                if on_frame is not None:
                    on_frame(t, frame)
            if close_after is not None and len(out["frames"]) >= close_after:
                break
    else:
        out["body"] = (await reader.readexactly(int(headers.get("content-length", 0)))).decode()
    out["t_end"] = time.monotonic()
    writer.close()
    return out


async def main(port: int, reqs: list) -> list:
    return await asyncio.gather(*(one(port, r) for r in reqs))


if __name__ == "__main__":
    json.dump(asyncio.run(main(int(sys.argv[1]), json.load(sys.stdin))), sys.stdout)
