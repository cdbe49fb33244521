"""Disaggregated prefill/decode serving — the port's copy of
dynamo_tpu/disagg/: the failure taxonomy (errors.py), the frontend's
PrefillRouter operator (prefill_router.py), the KV wire (wire.py) and the
worker-side handlers (handlers.py). A prefill worker computes the prompt's
KV and first token; the decode worker pulls the committed blocks by their
chained hashes from the prefill worker's ``kv`` endpoint, installs them in
its pools as cached blocks, and prefix-cached admission reuses them (the
partial tail block is recomputed locally).

Not ported: the live handoff (``disagg/handoff.py``: ``HandoffHandler``,
``HANDOFF_ENDPOINT`` and the rest of that module's names), which comes
with the drain plane (ROADMAP A11).
"""

from dynamo_tpu_torch.disagg.errors import DisaggTransferError, classify_failure
from dynamo_tpu_torch.disagg.handlers import (
    CircuitBreaker,
    DecodeHandler,
    KvTransferHandler,
    PrefillHandler,
    pack_array,
    unpack_array,
)
from dynamo_tpu_torch.disagg.prefill_router import PrefillRouter
from dynamo_tpu_torch.disagg.wire import (
    WIRE_VERSION,
    KvWireBlocks,
    pack_kv,
    unpack_kv,
    unpack_reply,
    wire_block_bytes,
)

__all__ = [
    "CircuitBreaker",
    "DecodeHandler",
    "DisaggTransferError",
    "KvTransferHandler",
    "PrefillHandler",
    "PrefillRouter",
    "classify_failure",
    "pack_array",
    "unpack_array",
]
