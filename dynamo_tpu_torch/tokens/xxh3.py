"""XXH3-64 with a 64-bit seed, in Python integers.

The content address of a token block (tokens/blocks.py) is XXH3-64 over
its little-endian u32 tokens, seeded by its parent's hash, and must equal
python-xxhash's `xxh3_64_intdigest` bit for bit: the JAX package, its KV
router and its native pool chain blocks with that library. The card
machine has no xxhash, so this is an implementation of the public XXH3
specification (https://github.com/Cyan4973/xxHash/blob/dev/doc/xxhash_spec.md)
following the readable C++ one in native/xxh3.h: six length classes (0,
1-3, 4-8, 9-16, 17-128, 129-240) and the long path (64-byte stripes over
a secret derived from the seed, a scramble every 1,024 bytes, then the
merge). Every value is reduced modulo 2^64 where the C code wraps.
"""

from __future__ import annotations

import struct

M64 = (1 << 64) - 1
M32 = (1 << 32) - 1

PRIME32_1 = 0x9E3779B1
PRIME32_2 = 0x85EBCA77
PRIME32_3 = 0xC2B2AE3D
PRIME64_1 = 0x9E3779B185EBCA87
PRIME64_2 = 0xC2B2AE3D27D4EB4F
PRIME64_3 = 0x165667B19E3779F9
PRIME64_4 = 0x85EBCA77C2B2AE63
PRIME64_5 = 0x27D4EB2F165667C5
PRIME_MX1 = 0x165667919E3779F9
PRIME_MX2 = 0x9FB21C651E98DF25

#: the specification's default 192-byte secret
SECRET = bytes.fromhex(
    "b8fe6c3923a44bbe7c01812cf721ad1cded46de9839097db7240a4a4b7b3671f"
    "cb79e64eccc0e578825ad07dccff7221b8084674f743248ee03590e6813a264c"
    "3c2852bb91c300cb88d0658b1b532ea371644897a20df94e3819ef46a9deacd8"
    "a8fa763fe39c343ff9dcbbc7c70b4f1d8a51e04bcdb45931c89f7ec9d9787364"
    "eac5ac8334d3ebc3c581a0fffa1363eb170ddd51b7f0da49d316552629d4689e"
    "2b16be587d47a1fc8ff8b8d17ad031ce45cb3a8f95160428afd7fbcabb4b407e"
)
SECRET_SIZE = 192
STRIPE_LEN = 64
#: stripes between two scrambles, and the bytes they cover
STRIPES_PER_BLOCK = (SECRET_SIZE - STRIPE_LEN) // 8  # 16
BLOCK_LEN = STRIPE_LEN * STRIPES_PER_BLOCK  # 1024
#: secret offsets of the last stripe and of the merge
SECRET_LASTACC_START = 7
SECRET_MERGEACCS_START = 11

_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")
_LANES = struct.Struct("<8Q")
_SECRET_WORDS = struct.Struct(f"<{SECRET_SIZE // 8}Q")


def _r64(b: bytes, off: int) -> int:
    return _U64.unpack_from(b, off)[0]


def _r32(b: bytes, off: int) -> int:
    return _U32.unpack_from(b, off)[0]


def _mul128_fold64(a: int, b: int) -> int:
    m = a * b
    return (m ^ (m >> 64)) & M64


def _xxh64_avalanche(h: int) -> int:
    h ^= h >> 33
    h = (h * PRIME64_2) & M64
    h ^= h >> 29
    h = (h * PRIME64_3) & M64
    return h ^ (h >> 32)


def _avalanche(h: int) -> int:
    h ^= h >> 37
    h = (h * PRIME_MX1) & M64
    return h ^ (h >> 32)


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & M64


def _rrmxmx(h: int, length: int) -> int:
    h ^= _rotl64(h, 49) ^ _rotl64(h, 24)
    h = (h * PRIME_MX2) & M64
    h ^= ((h >> 35) + length) & M64
    h = (h * PRIME_MX2) & M64
    return h ^ (h >> 28)


def _swap32(x: int) -> int:
    return int.from_bytes(x.to_bytes(4, "little"), "big")


def _swap64(x: int) -> int:
    return int.from_bytes(x.to_bytes(8, "little"), "big")


def _mix16b(data: bytes, off: int, sec: bytes, soff: int, seed: int) -> int:
    lo = _r64(data, off) ^ ((_r64(sec, soff) + seed) & M64)
    hi = _r64(data, off + 8) ^ ((_r64(sec, soff + 8) - seed) & M64)
    return _mul128_fold64(lo, hi)


def _len_1to3(data: bytes, n: int, seed: int) -> int:
    c1, c2, c3 = data[0], data[n >> 1], data[n - 1]
    combined = (c1 << 16) | (c2 << 24) | c3 | (n << 8)
    bitflip = ((_r32(SECRET, 0) ^ _r32(SECRET, 4)) + seed) & M64
    return _xxh64_avalanche(combined ^ bitflip)


def _len_4to8(data: bytes, n: int, seed: int) -> int:
    seed ^= _swap32(seed & M32) << 32
    in1 = _r32(data, 0)
    in2 = _r32(data, n - 4)
    bitflip = ((_r64(SECRET, 8) ^ _r64(SECRET, 16)) - seed) & M64
    return _rrmxmx((in2 + (in1 << 32)) ^ bitflip, n)


def _len_9to16(data: bytes, n: int, seed: int) -> int:
    bf1 = ((_r64(SECRET, 24) ^ _r64(SECRET, 32)) + seed) & M64
    bf2 = ((_r64(SECRET, 40) ^ _r64(SECRET, 48)) - seed) & M64
    lo = _r64(data, 0) ^ bf1
    hi = _r64(data, n - 8) ^ bf2
    return _avalanche((n + _swap64(lo) + hi + _mul128_fold64(lo, hi)) & M64)


def _len_17to128(data: bytes, n: int, seed: int) -> int:
    acc = n * PRIME64_1
    if n > 32:
        if n > 64:
            if n > 96:
                acc += _mix16b(data, 48, SECRET, 96, seed)
                acc += _mix16b(data, n - 64, SECRET, 112, seed)
            acc += _mix16b(data, 32, SECRET, 64, seed)
            acc += _mix16b(data, n - 48, SECRET, 80, seed)
        acc += _mix16b(data, 16, SECRET, 32, seed)
        acc += _mix16b(data, n - 32, SECRET, 48, seed)
    acc += _mix16b(data, 0, SECRET, 0, seed)
    acc += _mix16b(data, n - 16, SECRET, 16, seed)
    return _avalanche(acc & M64)


def _len_129to240(data: bytes, n: int, seed: int) -> int:
    acc = n * PRIME64_1
    for i in range(8):
        acc += _mix16b(data, 16 * i, SECRET, 16 * i, seed)
    acc = _avalanche(acc & M64)
    for i in range(8, n // 16):
        acc += _mix16b(data, 16 * i, SECRET, 16 * (i - 8) + 3, seed)
    acc += _mix16b(data, n - 16, SECRET, 136 - 17, seed)
    return _avalanche(acc & M64)


def _accumulate(acc: list[int], data: bytes, off: int, sec: bytes, soff: int) -> None:
    """One 64-byte stripe into the eight lanes (left unreduced: the caller
    reduces them modulo 2^64)."""
    vals = _LANES.unpack_from(data, off)
    keys = _LANES.unpack_from(sec, soff)
    for i in range(8):
        v = vals[i]
        k = v ^ keys[i]
        acc[i ^ 1] += v
        acc[i] += (k & M32) * (k >> 32)


def _hash_long(data: bytes, n: int, seed: int) -> int:
    if seed == 0:
        sec = SECRET
    else:
        words = _SECRET_WORDS.unpack(SECRET)
        sec = _SECRET_WORDS.pack(*(
            (w + seed if i % 2 == 0 else w - seed) & M64 for i, w in enumerate(words)))
    acc = [PRIME32_3, PRIME64_1, PRIME64_2, PRIME64_3,
           PRIME64_4, PRIME32_2, PRIME64_5, PRIME32_1]
    nb_blocks = (n - 1) // BLOCK_LEN
    scramble = _LANES.unpack_from(sec, SECRET_SIZE - STRIPE_LEN)
    for b in range(nb_blocks):
        base = b * BLOCK_LEN
        for s in range(STRIPES_PER_BLOCK):
            _accumulate(acc, data, base + s * STRIPE_LEN, sec, s * 8)
        for i in range(8):
            a = acc[i] & M64
            a ^= a >> 47
            a ^= scramble[i]
            acc[i] = (a * PRIME32_1) & M64
    base = nb_blocks * BLOCK_LEN
    for s in range(((n - 1) - base) // STRIPE_LEN):
        _accumulate(acc, data, base + s * STRIPE_LEN, sec, s * 8)
    _accumulate(acc, data, n - STRIPE_LEN, sec, SECRET_SIZE - STRIPE_LEN - SECRET_LASTACC_START)
    acc = [a & M64 for a in acc]
    merge = _LANES.unpack_from(sec, SECRET_MERGEACCS_START)
    result = n * PRIME64_1
    for i in range(4):
        result += _mul128_fold64(acc[2 * i] ^ merge[2 * i], acc[2 * i + 1] ^ merge[2 * i + 1])
    return _avalanche(result & M64)


def xxh3_64(data: bytes, seed: int = 0) -> int:
    """XXH3-64 of `data` under a 64-bit `seed` (taken modulo 2^64), as
    xxhash.xxh3_64_intdigest(data, seed=seed) gives it."""
    seed &= M64
    n = len(data)
    if n == 0:
        return _xxh64_avalanche(seed ^ _r64(SECRET, 56) ^ _r64(SECRET, 64))
    if n <= 3:
        return _len_1to3(data, n, seed)
    if n <= 8:
        return _len_4to8(data, n, seed)
    if n <= 16:
        return _len_9to16(data, n, seed)
    if n <= 128:
        return _len_17to128(data, n, seed)
    if n <= 240:
        return _len_129to240(data, n, seed)
    return _hash_long(data, n, seed)
