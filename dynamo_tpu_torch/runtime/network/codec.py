"""Two-part wire codec: (header msgpack, payload msgpack) length-prefixed —
the port's copy of dynamo_tpu/runtime/network/codec.py, on the pure-Python
msgpack subset (network/msgpack_lite.py): the card's machine has no
``msgpack``, and the frames are byte for byte the JAX package's.

Reference parity: lib/runtime/src/pipeline/network/codec/two_part.rs — each
frame is a small control header plus an opaque payload, so routing/stream
bookkeeping never deserializes user data. Layout per frame:

    u32 header_len | u32 payload_len | header bytes | payload bytes

Both parts are msgpack.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Any, Optional, Tuple

from dynamo_tpu_torch.runtime.network import msgpack_lite

_LEN = struct.Struct("<II")
MAX_FRAME = 256 * 1024 * 1024  # defensive cap


def _default(obj: Any):
    to_dict = getattr(obj, "to_dict", None)
    if callable(to_dict):
        return to_dict()
    raise TypeError(f"unserializable type {type(obj).__name__}")


def pack_frame(header: Any, payload: Any) -> bytes:
    h = msgpack_lite.packb(header, default=_default)
    p = msgpack_lite.packb(payload, default=_default)
    return _LEN.pack(len(h), len(p)) + h + p


class FrameWriter:
    def __init__(self, writer: asyncio.StreamWriter) -> None:
        self._writer = writer
        self._lock = asyncio.Lock()  # frames from concurrent streams interleave

    async def send(self, header: Any, payload: Any = None) -> None:
        frame = pack_frame(header, payload)
        async with self._lock:
            self._writer.write(frame)
            await self._writer.drain()

    def close(self) -> None:
        self._writer.close()


class FrameReader:
    def __init__(self, reader: asyncio.StreamReader) -> None:
        self._reader = reader

    async def recv(self) -> Optional[Tuple[Any, Any]]:
        """Next (header, payload), or None on clean EOF."""
        try:
            lens = await self._reader.readexactly(_LEN.size)
        except (asyncio.IncompleteReadError, ConnectionResetError):
            return None
        hlen, plen = _LEN.unpack(lens)
        if hlen > MAX_FRAME or plen > MAX_FRAME:
            raise ValueError(f"frame too large: {hlen}+{plen}")
        body = await self._reader.readexactly(hlen + plen)
        header = msgpack_lite.unpackb(body[:hlen])
        # strict_map_key=False: request payloads legitimately carry int-keyed
        # maps (OpenAI logit_bias is token-id → bias) between our own
        # processes; the strict default exists for untrusted internet input.
        payload = (
            msgpack_lite.unpackb(body[hlen:], strict_map_key=False)
            if plen
            else None
        )
        return header, payload
