"""MurmurHash3 x64 128-bit, compatible with ``mmh3.hash128`` (seed 0).

The reference hashes sorted predicate sets with ``mmh3.hash128``
(createAttributeSum.py:25,29) to form summary node ids; mmh3 (a C
extension) is not available here, so this is a from-scratch implementation
of the public MurmurHash3_x64_128 algorithm (Austin Appleby, public
domain). Output layout matches mmh3: ``h1 | (h2 << 64)`` as an unsigned
128-bit int.
"""

from __future__ import annotations

_MASK = 0xFFFFFFFFFFFFFFFF
_C1 = 0x87C37B91114253D5
_C2 = 0x4CF5AD432745937F


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _MASK


def _fmix64(k: int) -> int:
    k ^= k >> 33
    k = (k * 0xFF51AFD7ED558CCD) & _MASK
    k ^= k >> 33
    k = (k * 0xC4CEB9FE1A85EC53) & _MASK
    k ^= k >> 33
    return k


def hash128(key: bytes | str, seed: int = 0) -> int:
    if isinstance(key, str):
        key = key.encode("utf8")
    length = len(key)
    nblocks = length // 16
    h1 = seed & _MASK
    h2 = seed & _MASK

    for i in range(nblocks):
        k1 = int.from_bytes(key[i * 16:i * 16 + 8], "little")
        k2 = int.from_bytes(key[i * 16 + 8:i * 16 + 16], "little")

        k1 = (k1 * _C1) & _MASK
        k1 = _rotl64(k1, 31)
        k1 = (k1 * _C2) & _MASK
        h1 ^= k1
        h1 = _rotl64(h1, 27)
        h1 = (h1 + h2) & _MASK
        h1 = (h1 * 5 + 0x52DCE729) & _MASK

        k2 = (k2 * _C2) & _MASK
        k2 = _rotl64(k2, 33)
        k2 = (k2 * _C1) & _MASK
        h2 ^= k2
        h2 = _rotl64(h2, 31)
        h2 = (h2 + h1) & _MASK
        h2 = (h2 * 5 + 0x38495AB5) & _MASK

    tail = key[nblocks * 16:]
    k1 = k2 = 0
    tl = len(tail)
    if tl > 8:
        k2 = int.from_bytes(tail[8:], "little")
        k2 = (k2 * _C2) & _MASK
        k2 = _rotl64(k2, 33)
        k2 = (k2 * _C1) & _MASK
        h2 ^= k2
    if tl > 0:
        k1 = int.from_bytes(tail[:min(8, tl)], "little")
        k1 = (k1 * _C1) & _MASK
        k1 = _rotl64(k1, 31)
        k1 = (k1 * _C2) & _MASK
        h1 ^= k1

    h1 ^= length
    h2 ^= length
    h1 = (h1 + h2) & _MASK
    h2 = (h2 + h1) & _MASK
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    h1 = (h1 + h2) & _MASK
    h2 = (h2 + h1) & _MASK
    return h1 | (h2 << 64)
