"""Chained positional block hashing — the port's copy of
dynamo_tpu/tokens/blocks.py.

Each complete block's hash chains over (parent hash, token bytes), so equal
prefixes give equal hash chains and the prefix cache can match them. The
JAX package chains xxh3_64; this copy does too when ``xxhash`` can be
imported. Where it cannot (the machine with the card does not list it), it
chains an 8-byte BLAKE2b digest over the same structure. The hashes are then
different numbers from the JAX package's — harmless while they only key
this engine's own prefix cache, but they must agree once the port publishes
KV events to the router.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence

try:
    import xxhash
except ImportError:  # the stdlib digest below takes its place
    xxhash = None

BLOCK_HASH_SEED = 0xD1A0_0000_0000_0001
_M64 = 0xFFFF_FFFF_FFFF_FFFF


def _digest(seed: int, data: bytes) -> int:
    if xxhash is not None:
        return xxhash.xxh3_64(data, seed=seed).intdigest()
    h = hashlib.blake2b(data, digest_size=8, key=seed.to_bytes(8, "little"))
    return int.from_bytes(h.digest(), "little")


def _hash_block(parent_hash: int, tokens: Sequence[int], extra_salt: int = 0) -> int:
    # Fixed-width little-endian encoding; tokens are < 2^32 for any real vocab.
    data = b"".join(int(t).to_bytes(4, "little", signed=False) for t in tokens)
    return _digest((parent_hash ^ extra_salt) & _M64, data)


def compute_block_hashes(
    tokens: Sequence[int],
    block_size: int,
    *,
    salt: int = 0,
    parent_hash: Optional[int] = None,
) -> List[int]:
    """Hashes for every *complete* block of ``tokens``.

    ``parent_hash`` allows incremental extension: pass the last hash of an
    already-hashed prefix and only the new tokens.
    """
    if block_size <= 0:
        raise ValueError("block_size must be positive")
    prev = parent_hash if parent_hash is not None else BLOCK_HASH_SEED
    out: List[int] = []
    for start in range(0, len(tokens) - block_size + 1, block_size):
        prev = _hash_block(prev, tokens[start : start + block_size], extra_salt=salt)
        out.append(prev)
    return out


def adapter_salt(lora_name: Optional[str]) -> int:
    """Hash-space salt for LoRA requests: K/V computed under an adapter are
    not interchangeable with base-model K/V, so the block chain is salted
    per adapter (no adapter, salt 0)."""
    if not lora_name:
        return 0
    return _digest(0x10A, lora_name.encode())
