"""XXH3-64 with a seed, in pure Python — bit for bit
``xxhash.xxh3_64(data, seed=s).intdigest()`` for every input length and
every 64-bit seed, so that the port's block hashes are the JAX package's
numbers on a machine without the ``xxhash`` library.

The algorithm is XXH3's 64-bit variant as the xxHash project's
``doc/xxhash_spec.md`` states it, with the scalar accumulator:

  - 0 bytes: the seed folded with 16 bytes of the secret, XXH64's avalanche;
  - 1-3, 4-8, 9-16 bytes: each its own mix of the input with the seed;
  - 17-128 and 129-240 bytes: sums of 16-byte mixes (``_mix16``);
  - past 240 bytes: a custom secret derived from a non-zero seed, then
    64-byte stripes into eight accumulators, a scramble after each
    1,024-byte block, the last stripe, and the merge.

Python integers do not wrap, so every add, subtract, multiply and left
shift is masked to 64 bits.
"""

from __future__ import annotations

import struct

_M32 = 0xFFFF_FFFF
_M64 = 0xFFFF_FFFF_FFFF_FFFF

_P32_1 = 0x9E3779B1
_P32_2 = 0x85EBCA77
_P32_3 = 0xC2B2AE3D
_P64_1 = 0x9E3779B185EBCA87
_P64_2 = 0xC2B2AE3D27D4EB4F
_P64_3 = 0x165667B19E3779F9
_P64_4 = 0x85EBCA77C2B2AE63
_P64_5 = 0x27D4EB2F165667C5
_PMX1 = 0x165667919E3779F9
_PMX2 = 0x9FB21C651E98DF25

# The default secret (kSecret), 192 bytes.
_SECRET = bytes.fromhex(
    "b8fe6c3923a44bbe7c01812cf721ad1cded46de9839097db7240a4a4b7b3671f"
    "cb79e64eccc0e578825ad07dccff7221b8084674f743248ee03590e6813a264c"
    "3c2852bb91c300cb88d0658b1b532ea371644897a20df94e3819ef46a9deacd8"
    "a8fa763fe39c343ff9dcbbc7c70b4f1d8a51e04bcdb45931c89f7ec9d9787364"
    "eac5ac8334d3ebc3c581a0fffa1363eb170ddd51b7f0da49d316552629d4689e"
    "2b16be587d47a1fc8ff8b8d17ad031ce45cb3a8f95160428afd7fbcabb4b407e"
)
_SECRET_SIZE = len(_SECRET)
_STRIPE = 64
_STRIPES_PER_BLOCK = (_SECRET_SIZE - _STRIPE) // 8  # 16
_BLOCK = _STRIPE * _STRIPES_PER_BLOCK  # 1,024 bytes

_u32 = struct.Struct("<I").unpack_from
_u64 = struct.Struct("<Q").unpack_from
_u64x2 = struct.Struct("<2Q").unpack_from
_u64x8 = struct.Struct("<8Q").unpack_from
_SECRET_WORDS = struct.unpack("<24Q", _SECRET)


def _fold(a: int, b: int) -> int:
    """The 128-bit product of two 64-bit words, its halves xor-ed."""
    p = a * b
    return (p ^ (p >> 64)) & _M64


def _avalanche(h: int) -> int:
    h ^= h >> 37
    h = (h * _PMX1) & _M64
    return h ^ (h >> 32)


def _xxh64_avalanche(h: int) -> int:
    h ^= h >> 33
    h = (h * _P64_2) & _M64
    h ^= h >> 29
    h = (h * _P64_3) & _M64
    return h ^ (h >> 32)


def _rrmxmx(h: int, length: int) -> int:
    h ^= ((h << 49 | h >> 15) ^ (h << 24 | h >> 40)) & _M64
    h = (h * _PMX2) & _M64
    h ^= ((h >> 35) + length) & _M64
    h = (h * _PMX2) & _M64
    return h ^ (h >> 28)


def _swap32(x: int) -> int:
    return int.from_bytes(x.to_bytes(4, "little"), "big")


def _swap64(x: int) -> int:
    return int.from_bytes(x.to_bytes(8, "little"), "big")


def _mix16(data: bytes, off: int, soff: int, seed: int) -> int:
    lo, hi = _u64x2(data, off)
    s_lo, s_hi = _u64x2(_SECRET, soff)
    return _fold(lo ^ ((s_lo + seed) & _M64), hi ^ ((s_hi - seed) & _M64))


def _len_0to16(data: bytes, n: int, seed: int) -> int:
    if n > 8:
        flip1 = ((_SECRET_WORDS[3] ^ _SECRET_WORDS[4]) + seed) & _M64
        flip2 = ((_SECRET_WORDS[5] ^ _SECRET_WORDS[6]) - seed) & _M64
        lo = _u64(data, 0)[0] ^ flip1
        hi = _u64(data, n - 8)[0] ^ flip2
        acc = (n + _swap64(lo) + hi + _fold(lo, hi)) & _M64
        return _avalanche(acc)
    if n >= 4:
        seed ^= _swap32(seed & _M32) << 32
        in1 = _u32(data, 0)[0]
        in2 = _u32(data, n - 4)[0]
        flip = ((_SECRET_WORDS[1] ^ _SECRET_WORDS[2]) - seed) & _M64
        return _rrmxmx((in2 + (in1 << 32)) ^ flip, n)
    if n:
        combined = (data[0] << 16) | (data[n >> 1] << 24) | data[n - 1] | (n << 8)
        flip = ((_u32(_SECRET, 0)[0] ^ _u32(_SECRET, 4)[0]) + seed) & _M64
        return _xxh64_avalanche(combined ^ flip)
    return _xxh64_avalanche(seed ^ _SECRET_WORDS[7] ^ _SECRET_WORDS[8])


def _len_17to128(data: bytes, n: int, seed: int) -> int:
    acc = n * _P64_1
    if n > 32:
        if n > 64:
            if n > 96:
                acc += _mix16(data, 48, 96, seed) + _mix16(data, n - 64, 112, seed)
            acc += _mix16(data, 32, 64, seed) + _mix16(data, n - 48, 80, seed)
        acc += _mix16(data, 16, 32, seed) + _mix16(data, n - 32, 48, seed)
    acc += _mix16(data, 0, 0, seed) + _mix16(data, n - 16, 16, seed)
    return _avalanche(acc & _M64)


def _len_129to240(data: bytes, n: int, seed: int) -> int:
    acc = n * _P64_1
    for i in range(8):
        acc += _mix16(data, 16 * i, 16 * i, seed)
    acc = _avalanche(acc & _M64)
    # The last 16 bytes against the secret's bytes 119-134 (136 - 17).
    acc_end = _mix16(data, n - 16, 136 - 17, seed)
    for i in range(8, n // 16):
        acc_end += _mix16(data, 16 * i, 16 * (i - 8) + 3, seed)
    return _avalanche((acc + acc_end) & _M64)


def _custom_secret_words(seed: int) -> tuple:
    """The secret's 24 words with the seed added to even and taken from odd
    ones (XXH3_initCustomSecret)."""
    if seed == 0:
        return _SECRET_WORDS
    w = _SECRET_WORDS
    return tuple(
        ((w[i] + seed) if i % 2 == 0 else (w[i] - seed)) & _M64 for i in range(24)
    )


def _hash_long(data: bytes, n: int, seed: int) -> int:
    words = _custom_secret_words(seed)
    secret = struct.pack("<24Q", *words)
    acc = [_P32_3, _P64_1, _P64_2, _P64_3, _P64_4, _P32_2, _P64_5, _P32_1]

    def stripe(off: int, soff: int) -> None:
        d = _u64x8(data, off)
        k = _u64x8(secret, soff)
        for i in range(8):
            v = d[i]
            key = v ^ k[i]
            acc[i ^ 1] += v
            acc[i] = (acc[i] + (key & _M32) * (key >> 32)) & _M64
        for i in range(8):
            acc[i] &= _M64

    n_blocks = (n - 1) // _BLOCK
    scramble = _u64x8(secret, _SECRET_SIZE - _STRIPE)
    for b in range(n_blocks):
        base = b * _BLOCK
        for s in range(_STRIPES_PER_BLOCK):
            stripe(base + s * _STRIPE, s * 8)
        for i in range(8):
            a = acc[i]
            a ^= a >> 47
            a ^= scramble[i]
            acc[i] = (a * _P32_1) & _M64
    base = n_blocks * _BLOCK
    for s in range(((n - 1) - base) // _STRIPE):
        stripe(base + s * _STRIPE, s * 8)
    # The last stripe, against the secret 7 bytes before its last 64.
    stripe(n - _STRIPE, _SECRET_SIZE - _STRIPE - 7)
    result = n * _P64_1
    for i in range(4):
        s_lo, s_hi = _u64x2(secret, 11 + 16 * i)
        result += _fold(acc[2 * i] ^ s_lo, acc[2 * i + 1] ^ s_hi)
    return _avalanche(result & _M64)


def xxh3_64(data: bytes, seed: int = 0) -> int:
    """XXH3-64 of ``data`` under ``seed`` (taken modulo 2**64)."""
    data = bytes(data)
    seed &= _M64
    n = len(data)
    if n <= 16:
        return _len_0to16(data, n, seed)
    if n <= 128:
        return _len_17to128(data, n, seed)
    if n <= 240:
        return _len_129to240(data, n, seed)
    return _hash_long(data, n, seed)
