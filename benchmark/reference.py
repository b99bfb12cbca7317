"""The plain reference of a filter job: every read unit's minimizers, the
distinct hashes among them that the index holds, and its keep decision,
computed from the generated reads and the sorted key array.

A frozen copy of the filter-side minimizer rules that the repository's
``chip_smoke.py`` phase 4 held against the port at panhuman scale
(canonical k-mer values built base by base, fmix32 selection keys of the
xor of their 32-bit limbs, the leftmost minimum of every whole window of
w k-mers, or of all k-mers of a read with fewer than w, ACGT-valid
k-mers only; XXH3-64 of the value's little-endian bytes, seed 0), with a
frozen copy of the NumPy XXH3 it hashes with. Plain torch and NumPy
only: nothing of the program under test is imported, and nothing the
program made (its radix table, its packed rows) is read.
"""

from __future__ import annotations

import numpy as np
import torch

I64_MIN = -(1 << 63)

# ---------------------------------------------------------------------------
# XXH3-64 (seed 0) of 8- and 16-byte inputs, NumPy uint64 arithmetic
# ---------------------------------------------------------------------------

_KSECRET = bytes.fromhex(
    "b8fe6c3923a44bbe7c01812cf721ad1c"
    "ded46de9839097db7240a4a4b7b3671f"
    "cb79e64eccc0e578825ad07dccff7221"
    "b8084674f743248ee03590e6813a264c")
_U64 = np.uint64


def _sec64(offset: int) -> np.uint64:
    return np.frombuffer(_KSECRET, dtype="<u8", count=1, offset=offset)[0]


_BITFLIP_4TO8 = _U64(_sec64(8) ^ _sec64(16))
_BITFLIP_LO_9TO16 = _U64(_sec64(24) ^ _sec64(32))
_BITFLIP_HI_9TO16 = _U64(_sec64(40) ^ _sec64(48))
_PRIME_MX2 = _U64(0x9FB21C651E98DF25)
_PRIME64_3 = _U64(0x165667919E3779F9)


def _rotl64(x, n: int):
    return (x << _U64(n)) | (x >> _U64(64 - n))


def xxh3_64_u64(values: np.ndarray) -> np.ndarray:
    """XXH3-64 of each uint64's 8 little-endian bytes."""
    v = np.asarray(values, dtype=np.uint64)
    with np.errstate(over="ignore"):
        h = (v >> _U64(32)) | ((v & _U64(0xFFFFFFFF)) << _U64(32))
        h = h ^ _BITFLIP_4TO8
        h = h ^ (_rotl64(h, 49) ^ _rotl64(h, 24))
        h = h * _PRIME_MX2
        h = h ^ ((h >> _U64(35)) + _U64(8))
        h = h * _PRIME_MX2
        return h ^ (h >> _U64(28))


def xxh3_64_u128(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """XXH3-64 of each u128's 16 little-endian bytes (lo, hi halves)."""
    lo = np.asarray(lo, dtype=np.uint64)
    hi = np.asarray(hi, dtype=np.uint64)
    m32 = _U64(0xFFFFFFFF)
    with np.errstate(over="ignore"):
        a, b = lo ^ _BITFLIP_LO_9TO16, hi ^ _BITFLIP_HI_9TO16
        a_lo, a_hi, b_lo, b_hi = a & m32, a >> _U64(32), b & m32, b >> _U64(32)
        ll, lh, hl, hh = a_lo * b_lo, a_lo * b_hi, a_hi * b_lo, a_hi * b_hi
        mid = (ll >> _U64(32)) + (lh & m32) + (hl & m32)
        prod_lo = (ll & m32) | (mid << _U64(32))
        prod_hi = hh + (lh >> _U64(32)) + (hl >> _U64(32)) + (mid >> _U64(32))
        fold = prod_lo ^ prod_hi
        acc = _U64(16) + a.byteswap() + b + fold
        acc = acc ^ (acc >> _U64(37))
        acc = acc * _PRIME64_3
        return acc ^ (acc >> _U64(32))


# ---------------------------------------------------------------------------
# Minimizers and counts
# ---------------------------------------------------------------------------

#: 1 for a byte that is not an ACGT base (either case), else 0
_INVALID = np.ones(256, np.int64)
_INVALID[list(b"ACGTacgt")] = 0


def lsr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by 0 < n < 64."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _fmix32(x):
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    return x ^ (x >> 16)


def minimizers(arena: np.ndarray, starts: np.ndarray, lens: np.ndarray,
               dev, k: int, w: int):
    """Minimizers of every sequence ``arena[starts[i]:starts[i] + lens[i]]``,
    the sequences laid end to end, on ``dev``. Returns (sequence of each
    minimizer, its XXH3-64 hash as int64), one entry a distinct position
    of each sequence."""
    n_seq = lens.size
    lo_b = int(starts[0]) if n_seq else 0
    n = int(lens.sum())
    if n_seq and not np.array_equal(starts - lo_b,
                                    np.cumsum(lens) - lens):
        raise ValueError("the sequences are not laid end to end")
    block = arena[lo_b:lo_b + n]
    rel_starts = starts - lo_b
    code = torch.from_numpy(((block >> 1) & 3).astype(np.int64)).to(dev)
    bad = torch.from_numpy(_INVALID[block]).to(dev)
    read = torch.from_numpy(np.repeat(np.arange(n_seq), lens)).to(dev)
    start = torch.from_numpy(rel_starts.astype(np.int64)).to(dev)[read]
    m_of = torch.from_numpy((lens - k + 1).astype(np.int64)).to(dev)[read]
    rel = torch.arange(n, device=dev) - start

    def shifted(x, s, fill=0):
        return torch.cat([x[s:], torch.full((min(s, n),), fill,
                                            dtype=x.dtype, device=dev)])[:n]

    zero = torch.zeros_like(code)
    f_lo, f_hi, r_lo, r_hi = code, zero, code ^ 2, zero
    for i in range(1, k):
        c = shifted(code, i)
        if i < 32:
            f_lo = f_lo | (c << (2 * i))
        else:
            f_hi = f_hi | (c << (2 * (i - 32)))
        r_hi = (r_hi << 2) | lsr(r_lo, 62)
        r_lo = (r_lo << 2) | (c ^ 2)
    fh, rh = f_hi ^ I64_MIN, r_hi ^ I64_MIN
    take_f = (fh < rh) | ((fh == rh) & ((f_lo ^ I64_MIN) <= (r_lo ^ I64_MIN)))
    lo = torch.where(take_f, f_lo, r_lo)
    hi = torch.where(take_f, f_hi, r_hi)
    del f_lo, f_hi, r_lo, r_hi, fh, rh, take_f
    fold = zero
    for v in (lo, hi):
        fold = fold ^ (v & 0xFFFFFFFF) ^ lsr(v, 32)
    key = _fmix32(fold)
    key = (key >> 16) << 40 | rel  # priority, then leftmost position
    is_kmer = rel < m_of
    big = torch.iinfo(torch.int64).max
    key = torch.where(is_kmer, key, big)
    wmin = key.clone()
    for j in range(1, w):
        wmin = torch.minimum(wmin, shifted(key, j, big))
    whole = is_kmer & (rel + w <= m_of)  # a window of w k-mers in the read
    sel = torch.full((n,), -1, dtype=torch.int64, device=dev)
    sel[whole] = start[whole] + (wmin[whole] & ((1 << 40) - 1))
    short = torch.from_numpy(lens - k + 1 <= w).to(dev)  # one window
    short_read = short[read] & is_kmer
    if bool(short_read.any()):
        smin = torch.full((n_seq,), big, dtype=torch.int64, device=dev)
        smin.scatter_reduce_(0, read[short_read], key[short_read], "amin")
        first_pos = short_read & (rel == 0)
        sel[first_pos] = start[first_pos] + (smin[read[first_pos]]
                                             & ((1 << 40) - 1))
    pos = torch.unique(sel[sel >= 0])  # distinct minimizer positions
    csum = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      bad.cumsum(0)])
    ok = (csum[pos + k] - csum[pos]) == 0
    pos = pos[ok]
    v_lo = lo[pos].cpu().numpy().view(np.uint64)
    if k <= 32:
        h = xxh3_64_u64(v_lo)
    else:
        h = xxh3_64_u128(v_lo, hi[pos].cpu().numpy().view(np.uint64))
    return read[pos], torch.from_numpy(h.view(np.int64)).to(dev)


def member_exact(keys_flipped: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Whether each hash is one of the index's keys (``keys_flipped``: the
    keys with their sign bit flipped, ascending as int64)."""
    q = h ^ I64_MIN
    i = torch.searchsorted(keys_flipped, q).clamp(max=keys_flipped.numel() - 1)
    return keys_flipped[i] == q


def unit_counts(arena, starts, lens, unit_of_seq, n_units, keys_flipped,
                dev, k: int, w: int, member=member_exact,
                block_bases: int = 1 << 24):
    """(hits, totals) of every read unit (a read, or a pair): the distinct
    hashes among its minimizers that ``member`` finds in the index, and
    its minimizers (distinct positions of each read, summed over a
    pair's mates). Computed in blocks of whole units of about
    ``block_bases`` bases, so that the temporaries stay a few GB."""
    hits = np.zeros(n_units, np.int64)
    totals = np.zeros(n_units, np.int64)
    ends = np.cumsum(lens)
    i = 0
    n_seq = lens.size
    while i < n_seq:
        base = ends[i - 1] if i else 0
        j = int(np.searchsorted(ends, base + block_bases, side="right"))
        j = max(j, i + 1)
        # never split a unit between blocks
        while j < n_seq and unit_of_seq[j] == unit_of_seq[j - 1]:
            j += 1
        seq, h = minimizers(arena, starts[i:j], lens[i:j], dev, k, w)
        u = torch.from_numpy(unit_of_seq[i:j]).to(dev)[seq]
        totals += torch.bincount(u, minlength=n_units).cpu().numpy()
        hit = member(keys_flipped, h)
        distinct = torch.unique(torch.stack([u[hit], h[hit]], dim=1), dim=0)
        hits += torch.bincount(distinct[:, 0],
                               minlength=n_units).cpu().numpy()
        i = j
    return hits, totals


def keep_mask(hits: np.ndarray, totals: np.ndarray, abs_threshold: int,
              rel_threshold: float, deplete: bool) -> np.ndarray:
    """A unit is kept when hits < required (deplete) or hits >= required
    (search); required = max(abs, total == 0 ? 0 : max(1, round half away
    from zero of rel * total))."""
    totals = np.asarray(totals, np.int64)
    rel = np.floor(rel_threshold * totals.astype(np.float64) + 0.5)
    rel = np.where(totals == 0, 0, np.maximum(rel.astype(np.int64), 1))
    required = np.maximum(np.int64(abs_threshold), rel)
    hits = np.asarray(hits, np.int64)
    return hits < required if deplete else hits >= required
