"""The port's pure-Python XXH3-64 (dynamo_tpu_torch/tokens/xxh3.py) against
the ``xxhash`` library, and the port's block hashes against the JAX
package's (dynamo_tpu/tokens/blocks.py, which chains xxhash):

  - every input length 0-1,100 (each branch: 0, 1-3, 4-8, 9-16, 17-128,
    129-240 bytes and the long path with its block boundaries at 1,024),
    and lengths sampled to 8,192, under seeds 0, 1, BLOCK_HASH_SEED,
    2**64-1 and hypothesis-drawn 64-bit seeds;
  - ``compute_block_hashes``, ``adapter_salt`` and
    ``compute_block_hash_for_seq`` at block sizes 1, 16, 64 and 128, with
    ``xxhash`` blocked for the port (it never imports it);
  - chip_smoke.py's hash constants, which the card checks without xxhash.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import xxhash
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.tokens import blocks as jblocks
from dynamo_tpu_torch.tokens import blocks as tblocks
from dynamo_tpu_torch.tokens.xxh3 import xxh3_64

ROOT = Path(__file__).resolve().parents[1]
SEEDS = (0, 1, jblocks.BLOCK_HASH_SEED, 2**64 - 1)


def _data(n: int, salt: int = 0) -> bytes:
    return np.random.default_rng(n * 7 + salt).integers(0, 256, n, dtype=np.uint8).tobytes()


def _want(data: bytes, seed: int) -> int:
    return xxhash.xxh3_64(data, seed=seed).intdigest()


@pytest.mark.parametrize("lo", range(0, 1101, 100))
def test_every_length_to_1100_equals_xxhash(lo):
    bad = []
    for n in range(lo, min(lo + 100, 1101)):
        data = _data(n)
        for seed in SEEDS + (int(np.random.default_rng(n).integers(0, 2**63)) * 2 + 1,):
            if xxh3_64(data, seed) != _want(data, seed):
                bad.append((n, hex(seed)))
    assert bad == []


def test_sampled_lengths_to_8192_equal_xxhash():
    rng = np.random.default_rng(11)
    # block boundaries of the long path (1,024 bytes) and stripe edges
    lengths = sorted({1024, 1025, 1087, 1088, 1089, 2048, 2049, 4096, 8192}
                     | set(int(n) for n in rng.integers(1101, 8193, 40)))
    for n in lengths:
        data = _data(n, 1)
        for seed in SEEDS:
            assert xxh3_64(data, seed) == _want(data, seed), (n, hex(seed))


@settings(max_examples=200, deadline=None, derandomize=True)
@given(data=st.binary(min_size=0, max_size=600), seed=st.integers(0, 2**64 - 1))
def test_hypothesis_seeds_equal_xxhash(data, seed):
    assert xxh3_64(data, seed) == _want(data, seed)


def test_seed_is_taken_modulo_2_64_and_inputs_any_bytes_like():
    data = _data(300)
    assert xxh3_64(data, 2**64 + 5) == _want(data, 5)
    assert xxh3_64(bytearray(data), 7) == xxh3_64(memoryview(data), 7) == _want(data, 7)


@pytest.mark.parametrize("block_size", [1, 16, 64, 128])
def test_block_hashes_equal_jax(block_size):
    rng = np.random.default_rng(block_size)
    for n in (0, block_size - 1, block_size, 3 * block_size + 5, 700):
        tokens = [int(t) for t in rng.integers(0, 151_936, n)]
        for lora in (None, "lora-a", "an-adapter-name-of-some-length" * 5):
            salt = jblocks.adapter_salt(lora)
            assert tblocks.adapter_salt(lora) == salt
            want = jblocks.compute_block_hashes(tokens, block_size, salt=salt)
            assert tblocks.compute_block_hashes(tokens, block_size, salt=salt) == want
            assert tblocks.compute_block_hash_for_seq(tokens, block_size, salt=salt) == (
                jblocks.compute_block_hash_for_seq(tokens, block_size, salt=salt))
            if want:  # extension from a parent hash, as the engine commits blocks
                more = [int(t) for t in rng.integers(0, 151_936, 2 * block_size)]
                assert tblocks.compute_block_hashes(
                    more, block_size, salt=salt, parent_hash=want[-1]
                ) == jblocks.compute_block_hashes(more, block_size, salt=salt,
                                                  parent_hash=want[-1])


def test_block_hashes_with_xxhash_blocked_equal_jax():
    """The port's hashes in a process where ``import xxhash`` fails: the
    exact code the card runs."""
    tokens = [(i * 31 + 7) % 50_000 for i in range(300)]
    code = (
        "import sys; sys.modules['xxhash'] = None; sys.path.insert(0, %r)\n"
        "from dynamo_tpu_torch.tokens.blocks import compute_block_hashes, adapter_salt\n"
        "t = %r\n"
        "print([compute_block_hashes(t, b, salt=adapter_salt(s)) for b in (16, 64)"
        " for s in (None, 'lora-a')], adapter_salt('lora-a'))\n" % (str(ROOT), tokens)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60, check=True).stdout
    want = [jblocks.compute_block_hashes(tokens, b, salt=jblocks.adapter_salt(s))
            for b in (16, 64) for s in (None, "lora-a")]
    assert out.strip() == f"{want} {jblocks.adapter_salt('lora-a')}"


def test_block_hash_module_has_no_fallback():
    src = (ROOT / "dynamo_tpu_torch" / "tokens" / "blocks.py").read_text()
    assert "xxhash" not in src.replace("``xxhash``", "") and "blake2" not in src


def test_chip_smoke_hash_constants_equal_xxhash():
    spec = importlib.util.spec_from_file_location("chip_smoke_consts", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert len(smoke.HASH_TOKENS) == 256
    assert set(smoke.HASH_CONSTANTS) == {(16, None), (16, "lora-a"), (64, None), (64, "lora-a")}
    for (block_size, lora), hashes in smoke.HASH_CONSTANTS.items():
        salt = jblocks.adapter_salt(lora)
        assert hashes == jblocks.compute_block_hashes(smoke.HASH_TOKENS, block_size, salt=salt)
        assert len(hashes) == 256 // block_size
    # the JAX package's chain is xxhash's own: the first block by hand
    first = xxhash.xxh3_64(b"".join(t.to_bytes(4, "little") for t in smoke.HASH_TOKENS[:16]),
                           seed=jblocks.BLOCK_HASH_SEED).intdigest()
    assert smoke.HASH_CONSTANTS[(16, None)][0] == first
