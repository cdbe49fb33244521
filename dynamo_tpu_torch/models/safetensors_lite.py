"""The safetensors file format without the ``safetensors`` package (the
card's machine has none): what PEFT adapters (lora/loader.py) and, later,
checkpoints are stored in.

A file is an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...}`` plus an
optional ``__metadata__`` of strings), then the byte buffer the offsets
index. ``load_file`` reads F32, F16 and BF16 tensors onto the CPU and
raises on any other dtype, on a size that disagrees with the shape, and on
offsets that overlap or run past the file; ``save_file`` writes the same
form (the header padded with spaces to 8 bytes, as the library pads it).
Little-endian hosts only, as the format's data is little-endian.
"""

from __future__ import annotations

import json
import math
import struct
from typing import Dict, Mapping, Optional

import torch

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}
_TAGS = {dtype: tag for tag, dtype in DTYPES.items()}


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the file at ``path``, as CPU tensors of its dtype."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 8:
        raise ValueError(f"{path}: {len(raw)} bytes, too short for a safetensors header")
    (n,) = struct.unpack("<Q", raw[:8])
    if 8 + n > len(raw):
        raise ValueError(f"{path}: header of {n} bytes runs past the file ({len(raw)} bytes)")
    header = json.loads(raw[8 : 8 + n].decode("utf-8"))
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the header is not a JSON object")
    header.pop("__metadata__", None)
    buf = bytearray(raw[8 + n :])  # writable: frombuffer shares it
    spans = []
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        tag, shape = info["dtype"], [int(s) for s in info["shape"]]
        if tag not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {tag}; "
                             f"only {', '.join(DTYPES)} are read")
        begin, end = (int(o) for o in info["data_offsets"])
        dtype = DTYPES[tag]
        size = math.prod(shape) * dtype.itemsize
        if not 0 <= begin <= end <= len(buf):
            raise ValueError(f"{path}: tensor {name!r} at bytes {begin}-{end} runs past "
                             f"the {len(buf)}-byte buffer")
        if end - begin != size:
            raise ValueError(f"{path}: tensor {name!r} spans {end - begin} bytes, its "
                             f"{tag} shape {shape} needs {size}")
        spans.append((begin, end, name))
        if size == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=size // dtype.itemsize,
                                         offset=begin).reshape(shape)
    spans.sort()
    for (b0, e0, n0), (b1, e1, n1) in zip(spans, spans[1:]):
        if b1 < e0:
            raise ValueError(f"{path}: tensors {n0!r} ({b0}-{e0}) and {n1!r} ({b1}-{e1}) "
                             "overlap")
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (F32, F16 or BF16, any device) to ``path``, in
    name order."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    chunks = []
    offset = 0
    for name in sorted(tensors):
        t = tensors[name]
        if t.dtype not in _TAGS:
            raise ValueError(f"tensor {name!r} has dtype {t.dtype}; only "
                             f"{', '.join(str(d) for d in _TAGS)} are written")
        data = t.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _TAGS[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        chunks.append(data)
        offset += len(data)
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for data in chunks:
            f.write(data)
