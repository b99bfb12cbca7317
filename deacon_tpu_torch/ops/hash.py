"""XXH3-64 (seed 0) of u64 and u128 values held in int64 tensors.

The device twins of ``utils.xxh3.xxh3_64_u64`` and ``xxh3_64_u128``
(ref: src/minimizers.rs:179-188, src/filter_common.rs:296-305). torch has no unsigned 64-bit arithmetic (its
``uint64`` lacks ``>>``, ``+`` and ``<``), so values travel as int64 bit
patterns: ``*`` and ``+`` wrap modulo 2**64 exactly as the unsigned ops
do, and every right shift is made logical with an explicit mask.
"""

from __future__ import annotations

import torch

from ..utils.xxh3 import BITFLIP_4TO8, BITFLIP_HI_9TO16, BITFLIP_LO_9TO16

_PRIME_MX2 = 0x9FB21C651E98DF25
_PRIME64_3 = 0x165667919E3779F9
_MASK32 = 0xFFFFFFFF


def as_i64(v: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v


def lsr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by a static 0 < n < 64."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x << n) | lsr(x, 64 - n)


def _rrmxmx(h: torch.Tensor, length: int) -> torch.Tensor:
    h = h ^ (rotl(h, 49) ^ rotl(h, 24))
    h = h * as_i64(_PRIME_MX2)
    h = h ^ (lsr(h, 35) + length)
    h = h * as_i64(_PRIME_MX2)
    return h ^ lsr(h, 28)


def xxh3_64(values: torch.Tensor) -> torch.Tensor:
    """XXH3-64 of each value's 8 little-endian bytes; int64 in and out."""
    v = values.to(torch.int64)
    # XXH3_len_4to8: input64 = last4 | first4 << 32, i.e. the halves swapped
    input64 = lsr(v, 32) | ((v & _MASK32) << 32)
    return _rrmxmx(input64 ^ as_i64(int(BITFLIP_4TO8)), 8)



def _bswap64(x: torch.Tensor) -> torch.Tensor:
    """Byte order of each 64-bit pattern reversed."""
    out = (x & 0xFF) << 56
    for i in range(1, 8):
        out = out | ((lsr(x, 8 * i) & 0xFF) << (56 - 8 * i))
    return out


def _mul128_fold64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """lo64(a * b) ^ hi64(a * b) of the full 128-bit product, from 32-bit
    limbs (each limb product fits in 64 bits; sums wrap as u64 ones do)."""
    a_lo, a_hi = a & _MASK32, lsr(a, 32)
    b_lo, b_hi = b & _MASK32, lsr(b, 32)
    ll, lh, hl, hh = a_lo * b_lo, a_lo * b_hi, a_hi * b_lo, a_hi * b_hi
    mid = lsr(ll, 32) + (lh & _MASK32) + (hl & _MASK32)
    lo = (ll & _MASK32) | (mid << 32)
    hi = hh + lsr(lh, 32) + lsr(hl, 32) + lsr(mid, 32)
    return lo ^ hi


def xxh3_64_u128(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """XXH3-64 of each u128 value's 16 little-endian bytes (XXH3_len_9to16),
    the value given as its low and high 64-bit halves; int64 in and out."""
    in_lo = lo.to(torch.int64) ^ as_i64(int(BITFLIP_LO_9TO16))
    in_hi = hi.to(torch.int64) ^ as_i64(int(BITFLIP_HI_9TO16))
    acc = 16 + _bswap64(in_lo) + in_hi + _mul128_fold64(in_lo, in_hi)
    acc = acc ^ lsr(acc, 37)
    acc = acc * as_i64(_PRIME64_3)
    return acc ^ lsr(acc, 32)
