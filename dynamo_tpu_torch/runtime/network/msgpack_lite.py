"""The msgpack subset the runtime's planes put on the wire, in pure Python.

The JAX package frames its request plane, discd and the event plane with the
``msgpack`` package (dynamo_tpu/runtime/network/codec.py:20,
runtime/events/zmq_plane.py:20), which the card's machine does not have.
This module writes the same bytes as ``msgpack.packb(obj,
use_bin_type=True)`` and reads them back as ``msgpack.unpackb(data,
raw=False)`` does, so a port process and a JAX process share one wire.

Packed: nil, bool, every int width (uint64 up to 2**64-1, int64 down to
-2**63), float64, str8/16/32, bin8/16/32, fixarray/array16/array32 (lists
and tuples), fixmap/map16/map32, and whatever ``default(obj)`` turns an
unknown object into. As in msgpack, subclasses of int, float, str, bytes,
dict, list and tuple pack as their base type (a ``str`` Enum member packs
as its value), an int out of range raises OverflowError, and any other
object without ``default`` raises TypeError. Unpacked: every type above
plus float32 and the raw (str-less) forms msgpack also reads; ext types
raise ValueError.

``Unpacker`` streams objects from a file or a ``feed()``-ed buffer; a
partial object at the end of a file ends the iteration (msgpack's
behaviour, which the event broker's torn-tail recovery relies on) and
``tell()`` is the offset after the last whole object.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Iterator, List, Optional, Tuple

__all__ = ["packb", "unpackb", "Unpacker", "ExtraData", "FormatError"]

_RECURSE_LIMIT = 511  # msgpack's DEFAULT_RECURSE_LIMIT

_B = struct.Struct(">B").pack
_BB = struct.Struct(">BB").pack
_BH = struct.Struct(">BH").pack
_BI = struct.Struct(">BI").pack
_BQ = struct.Struct(">BQ").pack
_Bb = struct.Struct(">Bb").pack
_Bh = struct.Struct(">Bh").pack
_Bi = struct.Struct(">Bi").pack
_Bq = struct.Struct(">Bq").pack
_Bd = struct.Struct(">Bd").pack

_FIXINT = [bytes((i,)) for i in range(128)]
_NEGFIXINT = {i: bytes((i & 0xFF,)) for i in range(-32, 0)}


class ExtraData(ValueError):
    """unpackb() found bytes after the object (msgpack.exceptions.ExtraData)."""

    def __init__(self, unpacked: Any, extra: bytes) -> None:
        super().__init__("unpack(b) received extra data.")
        self.unpacked = unpacked
        self.extra = extra


class FormatError(ValueError):
    """Bytes that are not msgpack (msgpack.exceptions.FormatError)."""


def _pack_int(o: int, out: List[bytes]) -> bool:
    """Append ``o``'s encoding; False when it fits no msgpack int."""
    if o >= 0:
        if o < 128:
            out.append(_FIXINT[o])
        elif o <= 0xFF:
            out.append(_BB(0xCC, o))
        elif o <= 0xFFFF:
            out.append(_BH(0xCD, o))
        elif o <= 0xFFFFFFFF:
            out.append(_BI(0xCE, o))
        elif o <= 0xFFFFFFFFFFFFFFFF:
            out.append(_BQ(0xCF, o))
        else:
            return False
    elif o >= -32:
        out.append(_NEGFIXINT[o])
    elif o >= -0x80:
        out.append(_Bb(0xD0, o))
    elif o >= -0x8000:
        out.append(_Bh(0xD1, o))
    elif o >= -0x80000000:
        out.append(_Bi(0xD2, o))
    elif o >= -0x8000000000000000:
        out.append(_Bq(0xD3, o))
    else:
        return False
    return True


def _pack_str(o: str, out: List[bytes]) -> None:
    b = o.encode("utf-8")
    n = len(b)
    if n < 32:
        out.append(_B(0xA0 | n))
    elif n <= 0xFF:
        out.append(_BB(0xD9, n))
    elif n <= 0xFFFF:
        out.append(_BH(0xDA, n))
    elif n <= 0xFFFFFFFF:
        out.append(_BI(0xDB, n))
    else:
        raise ValueError("String is too large")
    out.append(b)


def _pack_bin(o: Any, out: List[bytes]) -> None:
    b = bytes(o)
    n = len(b)
    if n <= 0xFF:
        out.append(_BB(0xC4, n))
    elif n <= 0xFFFF:
        out.append(_BH(0xC5, n))
    elif n <= 0xFFFFFFFF:
        out.append(_BI(0xC6, n))
    else:
        raise ValueError("Bytes object is too large")
    out.append(b)


def _container_header(n: int, fix: int, h16: int, h32: int, out: List[bytes]) -> None:
    if n < 16:
        out.append(_B(fix | n))
    elif n <= 0xFFFF:
        out.append(_BH(h16, n))
    elif n <= 0xFFFFFFFF:
        out.append(_BI(h32, n))
    else:
        raise ValueError("list or dict is too large")


def _pack(o: Any, out: List[bytes], default: Optional[Callable[[Any], Any]], depth: int) -> None:
    if depth < 0:
        raise ValueError("recursion limit exceeded.")
    default_used = False
    while True:
        t = type(o)
        # exact types first: the frames' hot path
        if t is str:
            _pack_str(o, out)
        elif t is int:
            if not _pack_int(o, out):
                if not default_used and default is not None:
                    o, default_used = default(o), True
                    continue
                raise OverflowError("Integer value out of range")
        elif o is None:
            out.append(b"\xc0")
        elif o is True:
            out.append(b"\xc3")
        elif o is False:
            out.append(b"\xc2")
        elif t is dict:
            _container_header(len(o), 0x80, 0xDE, 0xDF, out)
            for k, v in o.items():
                _pack(k, out, default, depth - 1)
                _pack(v, out, default, depth - 1)
        elif t is list or t is tuple:
            _container_header(len(o), 0x90, 0xDC, 0xDD, out)
            for v in o:
                _pack(v, out, default, depth - 1)
        elif t is float:
            out.append(_Bd(0xCB, o))
        # subclasses, in msgpack's order of checks
        elif isinstance(o, int):
            if not _pack_int(int(o), out):
                if not default_used and default is not None:
                    o, default_used = default(o), True
                    continue
                raise OverflowError("Integer value out of range")
        elif isinstance(o, float):
            out.append(_Bd(0xCB, float(o)))
        elif isinstance(o, (bytes, bytearray)):
            _pack_bin(o, out)
        elif isinstance(o, str):
            _pack_str(str.__str__(o), out)
        elif isinstance(o, dict):
            _container_header(len(o), 0x80, 0xDE, 0xDF, out)
            for k, v in dict.items(o):
                _pack(k, out, default, depth - 1)
                _pack(v, out, default, depth - 1)
        elif isinstance(o, (list, tuple)):
            _container_header(len(o), 0x90, 0xDC, 0xDD, out)
            for v in o:
                _pack(v, out, default, depth - 1)
        elif isinstance(o, memoryview):
            _pack_bin(o, out)
        elif not default_used and default is not None:
            o, default_used = default(o), True
            continue
        else:
            raise TypeError(f"can not serialize {type(o).__name__!r} object")
        return


def packb(o: Any, default: Optional[Callable[[Any], Any]] = None) -> bytes:
    """``msgpack.packb(o, default=default, use_bin_type=True)``."""
    out: List[bytes] = []
    _pack(o, out, default, _RECURSE_LIMIT)
    return b"".join(out)


# ---------------------------------------------------------------------------
# Unpacking
# ---------------------------------------------------------------------------


class _Incomplete(Exception):
    """The buffer ends inside an object."""


_U16 = struct.Struct(">H").unpack_from
_U32 = struct.Struct(">I").unpack_from
_U64 = struct.Struct(">Q").unpack_from
_I8 = struct.Struct(">b").unpack_from
_I16 = struct.Struct(">h").unpack_from
_I32 = struct.Struct(">i").unpack_from
_I64 = struct.Struct(">q").unpack_from
_F32 = struct.Struct(">f").unpack_from
_F64 = struct.Struct(">d").unpack_from

# (struct reader, width) of the length that follows a sized header byte
_LEN = {0xC4: (None, 1), 0xC5: (_U16, 2), 0xC6: (_U32, 4),
        0xD9: (None, 1), 0xDA: (_U16, 2), 0xDB: (_U32, 4),
        0xDC: (_U16, 2), 0xDD: (_U32, 4), 0xDE: (_U16, 2), 0xDF: (_U32, 4)}
_FIXED = {0xCA: (_F32, 4), 0xCB: (_F64, 8), 0xCC: (None, 1), 0xCD: (_U16, 2),
          0xCE: (_U32, 4), 0xCF: (_U64, 8), 0xD0: (_I8, 1), 0xD1: (_I16, 2),
          0xD2: (_I32, 4), 0xD3: (_I64, 8)}


class _Reader:
    __slots__ = ("buf", "end", "strict_map_key")

    def __init__(self, buf: bytes, end: int, strict_map_key: bool) -> None:
        self.buf = buf
        self.end = end
        self.strict_map_key = strict_map_key

    def read(self, pos: int, depth: int = _RECURSE_LIMIT) -> Tuple[Any, int]:
        """(object, offset after it) of the object at ``pos``."""
        buf, end = self.buf, self.end
        if pos >= end:
            raise _Incomplete
        b = buf[pos]
        pos += 1
        if b < 0x80:
            return b, pos
        if b >= 0xE0:
            return b - 0x100, pos
        if b < 0x90:
            return self._map(b & 0x0F, pos, depth)
        if b < 0xA0:
            return self._array(b & 0x0F, pos, depth)
        if b < 0xC0:
            return self._str(b & 0x1F, pos)
        if b == 0xC0:
            return None, pos
        if b == 0xC2:
            return False, pos
        if b == 0xC3:
            return True, pos
        fixed = _FIXED.get(b)
        if fixed is not None:
            fn, width = fixed
            if pos + width > end:
                raise _Incomplete
            return (buf[pos] if fn is None else fn(buf, pos)[0]), pos + width
        sized = _LEN.get(b)
        if sized is None:
            if b == 0xC1:
                raise FormatError("Unpack failed: error = -2")
            raise ValueError(f"msgpack ext type 0x{b:02x} is not supported")
        fn, width = sized
        if pos + width > end:
            raise _Incomplete
        n = buf[pos] if fn is None else fn(buf, pos)[0]
        pos += width
        if b <= 0xC6:
            if pos + n > end:
                raise _Incomplete
            return bytes(buf[pos:pos + n]), pos + n
        if b <= 0xDB:
            return self._str(n, pos)
        if b <= 0xDD:
            return self._array(n, pos, depth)
        return self._map(n, pos, depth)

    def _str(self, n: int, pos: int) -> Tuple[str, int]:
        if pos + n > self.end:
            raise _Incomplete
        return bytes(self.buf[pos:pos + n]).decode("utf-8"), pos + n

    def _array(self, n: int, pos: int, depth: int) -> Tuple[list, int]:
        if depth <= 0:
            raise ValueError("recursion limit exceeded")
        out = []
        for _ in range(n):
            v, pos = self.read(pos, depth - 1)
            out.append(v)
        return out, pos

    def _map(self, n: int, pos: int, depth: int) -> Tuple[dict, int]:
        if depth <= 0:
            raise ValueError("recursion limit exceeded")
        out = {}
        for _ in range(n):
            k, pos = self.read(pos, depth - 1)
            if self.strict_map_key and type(k) not in (str, bytes):
                raise ValueError(
                    f"{type(k).__name__} is not allowed for map key when "
                    "strict_map_key=True")
            if type(k) is list:  # msgpack turns an array key into a tuple
                k = tuple(k)
            v, pos = self.read(pos, depth - 1)
            out[k] = v
        return out, pos


def unpackb(data: Any, *, strict_map_key: bool = True) -> Any:
    """``msgpack.unpackb(data, raw=False, strict_map_key=...)``: one object
    filling ``data`` exactly."""
    buf = bytes(data)
    try:
        obj, pos = _Reader(buf, len(buf), strict_map_key).read(0)
    except _Incomplete:
        raise ValueError("Unpack failed: incomplete input") from None
    if pos < len(buf):
        raise ExtraData(obj, buf[pos:])
    return obj


class Unpacker:
    """``msgpack.Unpacker(file_like, raw=False, strict_map_key=...)``: the
    objects of a file (read ``read_size`` bytes at a time) or of the bytes
    given to ``feed()``, in order."""

    def __init__(self, file_like: Any = None, *, strict_map_key: bool = True,
                 read_size: int = 1 << 20) -> None:
        self._file = file_like
        self._strict = strict_map_key
        self._read_size = read_size
        self._buf = b""
        self._head = 0
        self._consumed = 0  # stream offset of self._buf[0]

    def feed(self, data: Any) -> None:
        if self._file is not None:
            raise AssertionError("unpacker.feed() is not be able to use with `file_like`.")
        self._append(bytes(data))

    def _append(self, data: bytes) -> None:
        # drop what was unpacked before growing the buffer
        self._consumed += self._head
        self._buf = self._buf[self._head:] + data
        self._head = 0

    def tell(self) -> int:
        """Stream offset after the last object unpacked."""
        return self._consumed + self._head

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        while True:
            if self._head < len(self._buf):
                try:
                    obj, pos = _Reader(self._buf, len(self._buf), self._strict).read(self._head)
                except _Incomplete:
                    pass
                else:
                    self._head = pos
                    return obj
            if self._file is None:
                raise StopIteration
            chunk = self._file.read(self._read_size)
            if not chunk:
                self._file = None  # end of file: a partial tail ends the iteration
                raise StopIteration
            self._append(chunk)
