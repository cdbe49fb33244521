"""KV wire format v2 — the port's copy of dynamo_tpu/disagg/wire.py:
pool-native multi-tensor block transfer.

A quantized pool ships ``{q8, scales}`` (about 0.53x the dense bf16 bytes
at head_dim 64), a dense pool ships its storage dtype, and the importer
installs whatever arrives into whatever pool it runs:

    exporter pool -> importer pool   install path
    int8  -> int8    verbatim q8/s scatter (bit-exact pool transfer)
    int8  -> dense   dequant on the importer's device at scatter
    dense -> int8    requant on the importer's device at scatter
    dense -> dense   unchanged

Schema (one streamed chunk's ``kv`` field; ``pack_array`` dicts go over
msgpack and the process-local plane alike):

    {"version": 2,
     "dtype": "int8" | "<dense dtype>",
     "k": pack_array, "v": pack_array,            # [n, L, BS, KH, D]
     "k_scale": pack_array, "v_scale": pack_array}  # [n, L, KH, BS] f32,
                                                    # quantized only

Negotiation: the importer's pull request carries
``{"wire": {"version": 2, "accept": [dtypes...]}}``. An exporter that sees
no ``wire`` key answers in the v1 shape (dense ``k``/``v`` fields); a v2
importer accepts both (``unpack_reply``). ``accept`` lets an importer veto
the quantized encoding (the exporter densifies before shipping).

Divergence from the JAX module: the payloads are torch tensors on the host,
not numpy arrays. numpy has no bfloat16 without ``ml_dtypes``, which the
card's machine lacks, so ``pack_array`` writes a tensor's bytes through a
``uint8`` view and ``unpack_array`` rebuilds the tensor with
``torch.frombuffer`` under the dtype tag. The bytes, shapes and tags are
JAX's, so a chunk packed by either package unpacks in the other. The KVBM
helpers ``dense_tier_block`` and ``tier_block_wire`` come with the tiers
(ROADMAP A10).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

WIRE_VERSION = 2

# Wire dtype tag for quantized payloads (payload int8 + f32 scales).
WIRE_DTYPE_Q8 = "int8"

# The wire's dtype tags (numpy's names, as the JAX package writes them).
_DTYPES: Dict[str, torch.dtype] = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
    "int8": torch.int8,
}

DTypeLike = Union[str, torch.dtype]


def torch_dtype(name: DTypeLike) -> torch.dtype:
    """The torch dtype of a wire tag (or a torch dtype, passed through)."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unknown wire dtype {name!r} (one of {sorted(_DTYPES)})") from None


def dtype_tag(dtype: DTypeLike) -> str:
    """The wire tag of a torch dtype: its numpy name (``torch.bfloat16`` ->
    ``"bfloat16"``)."""
    return str(torch_dtype(dtype)).removeprefix("torch.")


def pack_array(t: torch.Tensor) -> Dict[str, Any]:
    """Serialize a host tensor zero-copy: ``b`` is a memoryview over the
    tensor's own bytes (through a uint8 view, which holds any dtype). A copy
    happens only when the input is not already contiguous."""
    t = t.detach().contiguous()
    raw = t.reshape(-1).view(torch.uint8) if t.numel() else torch.empty(0, dtype=torch.uint8)
    return {"b": raw.numpy().data, "shape": list(t.shape), "dtype": dtype_tag(t.dtype)}


def unpack_array(d: Dict[str, Any]) -> torch.Tensor:
    """Inverse of pack_array; a view over the received buffer (read-only
    buffers such as ``bytes`` are viewed, not copied: the wire's tensors
    are only read)."""
    dtype = torch_dtype(d["dtype"])
    shape = [int(x) for x in d["shape"]]
    buf = d["b"]
    if not len(buf):
        return torch.empty(shape, dtype=dtype)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given buffer is not writable")
        return torch.frombuffer(buf, dtype=dtype).reshape(shape)


def packed_nbytes(d: Optional[Dict[str, Any]]) -> int:
    """Serialized payload bytes of one pack_array dict."""
    if not d:
        return 0
    buf = d["b"]
    return buf.nbytes if isinstance(buf, memoryview) else len(buf)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class KvWireBlocks:
    """``n`` KV blocks in wire form (host tensors).

    Dense: ``k``/``v`` are [n, L, BS, KH, D] in ``dtype``; scales are None.
    Quantized (``dtype == "int8"``): ``k``/``v`` are int8 payloads of the
    same shape and ``k_scale``/``v_scale`` are [n, L, KH, BS] float32 —
    the pool's own per-(token, head) scales (ops/kv_quant.py layout with
    block_size last), shipped verbatim so an int8 -> int8 transfer is
    bit-exact."""

    dtype: str
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @classmethod
    def dense(cls, k: torch.Tensor, v: torch.Tensor) -> "KvWireBlocks":
        return cls(dtype=dtype_tag(k.dtype), k=k, v=v)

    @property
    def quantized(self) -> bool:
        return self.dtype == WIRE_DTYPE_Q8

    def __len__(self) -> int:
        return int(self.k.shape[0])

    @property
    def nbytes(self) -> int:
        """Wire bytes: payloads + scales (what serialization ships)."""
        n = _nbytes(self.k) + _nbytes(self.v)
        for s in (self.k_scale, self.v_scale):
            if s is not None:
                n += _nbytes(s)
        return n

    def take(self, sel: Sequence[int]) -> "KvWireBlocks":
        """Row subset (an importer installing only the non-resident blocks).
        Returns self when ``sel`` is the identity — the common whole-chunk
        install stays copy-free."""
        if len(sel) == len(self) and list(sel) == list(range(len(self))):
            return self
        idx = torch.as_tensor(list(sel), dtype=torch.int64)

        def pick(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
            return None if t is None else t.index_select(0, idx)

        return KvWireBlocks(dtype=self.dtype, k=pick(self.k), v=pick(self.v),
                            k_scale=pick(self.k_scale), v_scale=pick(self.v_scale))

    @staticmethod
    def _dequant(q8: torch.Tensor, s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        # [n, L, KH, BS] -> [n, L, BS, KH, 1] against [n, L, BS, KH, D]
        s_t = torch.swapaxes(s, -1, -2)[..., None]
        return (q8.to(torch.float32) * s_t).to(dtype)

    def to_dense(self, dtype: Optional[DTypeLike] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dense [n, L, BS, KH, D] (k, v). Quantized payloads dequantize on
        the host to ``dtype`` (default bfloat16 — the v1 wire dtype); dense
        payloads pass through untouched unless ``dtype`` asks for a cast
        (negotiated-down exports)."""
        if not self.quantized:
            if dtype is None or torch_dtype(dtype) == self.k.dtype:
                return self.k, self.v
            out = torch_dtype(dtype)
            return self.k.to(out), self.v.to(out)
        out_dtype = torch_dtype(dtype or "bfloat16")
        return (self._dequant(self.k, self.k_scale, out_dtype),
                self._dequant(self.v, self.v_scale, out_dtype))


def wire_block_bytes(
    n_layers: int,
    block_size: int,
    n_kv_heads: int,
    head_dim: int,
    wire_dtype: str,
) -> int:
    """Exact wire bytes of ONE block (k + v, scales included) for chunk
    sizing and router transfer-cost estimates."""
    elems = n_layers * block_size * n_kv_heads * head_dim
    if wire_dtype == WIRE_DTYPE_Q8:
        scale_bytes = n_layers * n_kv_heads * block_size * 4  # f32 scales
        return 2 * (elems + scale_bytes)
    return 2 * elems * torch_dtype(wire_dtype).itemsize


def pack_kv(wire: KvWireBlocks) -> Dict[str, Any]:
    """One chunk's ``kv`` field (schema v2)."""
    d: Dict[str, Any] = {
        "version": WIRE_VERSION,
        "dtype": wire.dtype,
        "k": pack_array(wire.k),
        "v": pack_array(wire.v),
    }
    if wire.quantized:
        d["k_scale"] = pack_array(wire.k_scale)
        d["v_scale"] = pack_array(wire.v_scale)
    return d


def unpack_kv(d: Dict[str, Any]) -> KvWireBlocks:
    return KvWireBlocks(
        dtype=str(d["dtype"]),
        k=unpack_array(d["k"]),
        v=unpack_array(d["v"]),
        k_scale=unpack_array(d["k_scale"]) if d.get("k_scale") else None,
        v_scale=unpack_array(d["v_scale"]) if d.get("v_scale") else None,
    )


def unpack_reply(reply: Dict[str, Any]) -> Optional[KvWireBlocks]:
    """Decode one streamed transfer reply — v2 (``kv`` field) or the v1
    dense shape (separate ``k``/``v`` pack_array fields)."""
    if reply.get("kv"):
        return unpack_kv(reply["kv"])
    if reply.get("k") is not None and reply.get("v") is not None:
        return KvWireBlocks.dense(unpack_array(reply["k"]), unpack_array(reply["v"]))
    return None


def reply_wire_nbytes(reply: Dict[str, Any]) -> int:
    """Serialized KV payload bytes of one reply message (either schema)."""
    kv = reply.get("kv")
    if kv:
        return sum(packed_nbytes(kv.get(f)) for f in ("k", "v", "k_scale", "v_scale"))
    return packed_nbytes(reply.get("k")) + packed_nbytes(reply.get("v"))
