"""Chained positional block hashing — the port's copy of
dynamo_tpu/tokens/blocks.py.

Each complete block's hash chains over (parent hash, token bytes), so equal
prefixes give equal hash chains and the prefix cache can match them. Like
the JAX package it chains XXH3-64, computed by the pure-Python
``tokens/xxh3.py`` (the machine with the card has no ``xxhash``), so its
hashes are the JAX package's numbers: a router of either package can look
a prompt's blocks up among the KV events of a worker of the other.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from dynamo_tpu_torch.tokens.xxh3 import xxh3_64

BLOCK_HASH_SEED = 0xD1A0_0000_0000_0001
_M64 = 0xFFFF_FFFF_FFFF_FFFF


def _hash_block(parent_hash: int, tokens: Sequence[int], extra_salt: int = 0) -> int:
    # Fixed-width little-endian encoding; tokens are < 2^32 for any real vocab.
    data = b"".join(int(t).to_bytes(4, "little", signed=False) for t in tokens)
    return xxh3_64(data, (parent_hash ^ extra_salt) & _M64)


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


def compute_block_hash_for_seq(
    tokens: Sequence[int], block_size: int, *, salt: int = 0
) -> List[int]:
    """Reference-named alias (kv_router.rs:50) for compute_block_hashes."""
    return compute_block_hashes(tokens, block_size, salt=salt)


def adapter_salt(lora_name: Optional[str]) -> int:
    """Hash-space salt for LoRA requests: K/V computed under an adapter are
    not interchangeable with base-model K/V, so the block chain is salted
    per adapter (no adapter, salt 0)."""
    if not lora_name:
        return 0
    return xxh3_64(lora_name.encode(), 0x10A)
