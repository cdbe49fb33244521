"""Token-block hashing and radix structures — the port's copy of
dynamo_tpu/tokens/__init__.py.

Token sequences are chunked into fixed-size blocks; each block gets a
chained positional hash that commits to every token before it, so a block
hash names a prefix of the sequence. Equal hashes mean equal prefixes
(modulo 64-bit collisions), which is what KV-aware routing and prefix
reuse rest on.
"""

from dynamo_tpu_torch.tokens.blocks import (
    BLOCK_HASH_SEED,
    compute_block_hash_for_seq,
    compute_block_hashes,
)
from dynamo_tpu_torch.tokens.radix import OverlapScores, RadixTree

__all__ = [
    "BLOCK_HASH_SEED",
    "OverlapScores",
    "RadixTree",
    "compute_block_hash_for_seq",
    "compute_block_hashes",
]
