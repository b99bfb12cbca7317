"""The reference against a brute-force count in pure Python, one read and
one k-mer at a time, on tiny seeded inputs: N bases, reads shorter than
k and than one window, mates that share minimizers, k-mers that straddle
invalid bases. The brute force is checked against the xxhash library and
the port's NumPy minimizer oracle, which both state the same rules."""

import numpy as np
import pytest
import torch

from benchmark import reference

M64 = (1 << 64) - 1
M32 = (1 << 32) - 1
SECRET = bytes.fromhex("b8fe6c3923a44bbe7c01812cf721ad1c"
                       "ded46de9839097db7240a4a4b7b3671f"
                       "cb79e64eccc0e578825ad07dccff7221")


def le64(off):
    return int.from_bytes(SECRET[off:off + 8], "little")


def rotl(x, n):
    return ((x << n) | (x >> (64 - n))) & M64


def xxh3_8(v: int) -> int:
    """XXH3-64, seed 0, of the 8 little-endian bytes of v (len 4-8 path)."""
    in1, in2 = v & M32, v >> 32
    h = (in2 + (in1 << 32)) ^ (le64(8) ^ le64(16))
    h ^= rotl(h, 49) ^ rotl(h, 24)
    h = (h * 0x9FB21C651E98DF25) & M64
    h ^= (h >> 35) + 8
    h = (h * 0x9FB21C651E98DF25) & M64
    return h ^ (h >> 28)


def fmix32(x):
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & M32
    return x ^ (x >> 16)


def brute(seq: bytes, k: int, w: int) -> dict:
    """{position: hash} of the read's minimizers: the leftmost k-mer of
    least selection key in each window of w k-mers (one window over all
    k-mers when there are fewer), kept when all its bases are ACGT."""
    code = [(b >> 1) & 3 for b in seq]
    m = len(seq) - k + 1
    if m <= 0:
        return {}
    keys, vals = [], []
    for i in range(m):
        f = sum(code[i + j] << (2 * j) for j in range(k))
        r = sum((code[i + k - 1 - j] ^ 2) << (2 * j) for j in range(k))
        v = min(f, r)
        lo, hi = v & M64, v >> 64
        keys.append(fmix32((lo & M32) ^ (lo >> 32) ^ (hi & M32) ^ (hi >> 32))
                    >> 16)
        vals.append(lo)
    spans = [(0, m)] if m <= w else [(i, i + w) for i in range(m - w + 1)]
    picked = {min(range(a, b), key=lambda i: (keys[i], i)) for a, b in spans}
    return {p: xxh3_8(vals[p]) for p in sorted(picked)
            if all(c in b"ACGTacgt" for c in seq[p:p + k])}


def reads(seed: int, k: int, w: int):
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGTacgtN", np.uint8)

    def rand(n, alphabet=4):
        return bases[rng.integers(0, alphabet, n)].tobytes()

    out = [rand(150), rand(k - 1), rand(k), rand(k + w - 2), rand(k + w),
           rand(300, 8)]  # lowercase too
    r = bytearray(rand(200))
    r[40] = ord("N")
    r[100:103] = b"NNN"
    out.append(bytes(r))                     # k-mers straddling N
    out.append(b"G" * 80 + rand(60))          # a poly-G run
    out.append(rand(120, 9))                  # N anywhere
    return out


def units_and_counts(seqs, unit_of_seq, index, k, w):
    n_units = int(unit_of_seq.max()) + 1
    hits = np.zeros(n_units, np.int64)
    totals = np.zeros(n_units, np.int64)
    seen = [set() for _ in range(n_units)]
    for s, u in zip(seqs, unit_of_seq):
        mins = brute(s, k, w)
        totals[u] += len(mins)
        seen[u] |= {h for h in mins.values() if h in index}
    for u in range(n_units):
        hits[u] = len(seen[u])
    return hits, totals


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_reference_matches_brute_force(seed):
    k, w = 31, 15
    single = reads(seed, k, w)
    shared = single[0]
    # a pair whose mates are the same read: every minimizer twice
    pairs = [(shared, shared), (single[4], single[6])]
    seqs = single + [s for p in pairs for s in p]
    unit_of_seq = np.concatenate([np.arange(len(single)),
                                  len(single) + np.repeat(np.arange(2), 2)])
    every = set()
    for s in seqs:
        every |= set(brute(s, k, w).values())
    every = sorted(every)
    rng = np.random.default_rng(seed)
    index = set(every[::2]) | set(rng.integers(0, 1 << 63, 50).tolist())
    want_h, want_t = units_and_counts(seqs, unit_of_seq, index, k, w)
    assert want_h[len(single)] > 0  # the shared pair has hits

    lens = np.array([len(s) for s in seqs], np.int64)
    arena = np.frombuffer(b"".join(seqs), np.uint8)
    starts = np.cumsum(lens) - lens
    keys = np.array(sorted(index), np.uint64)
    flipped = torch.from_numpy(keys.view(np.int64)) ^ reference.I64_MIN
    flipped = torch.sort(flipped).values
    got_h, got_t = reference.unit_counts(
        arena, starts, lens, unit_of_seq, int(unit_of_seq.max()) + 1,
        flipped, torch.device("cpu"), k, w, block_bases=400)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_h, want_h)


def test_brute_force_hash_is_xxh3():
    xxhash = pytest.importorskip("xxhash")
    rng = np.random.default_rng(9)
    for v in rng.integers(0, 1 << 63, 20).tolist() + [0, M64]:
        assert xxh3_8(v) == xxhash.xxh3_64_intdigest(v.to_bytes(8, "little"))
        assert int(reference.xxh3_64_u64(np.array([v], np.uint64))[0]) == (
            xxh3_8(v))


def test_brute_force_matches_the_ports_oracle():
    from deacon_tpu_torch.ops.minimizers_np import (
        get_minimizer_hashes_and_positions,
    )

    k, w = 31, 15
    for s in reads(4, k, w):
        h, pos, _ = get_minimizer_hashes_and_positions(s, 0, k, w)
        assert dict(zip(pos.tolist(), h.tolist())) == brute(s, k, w)


def test_keep_rule():
    hits = np.array([0, 1, 2, 2, 3, 0])
    totals = np.array([0, 10, 10, 250, 250, 0])
    # required: max(2, round(0.01 * total) at least 1; 0 for no minimizers)
    want_deplete = np.array([True, True, False, True, False, True])
    np.testing.assert_array_equal(
        reference.keep_mask(hits, totals, 2, 0.01, True), want_deplete)
    np.testing.assert_array_equal(
        reference.keep_mask(hits, totals, 2, 0.01, False), ~want_deplete)


def test_xxh3_of_u128():
    xxhash = pytest.importorskip("xxhash")
    rng = np.random.default_rng(10)
    lo = rng.integers(0, 1 << 63, 30).astype(np.uint64)
    hi = rng.integers(0, 1 << 63, 30).astype(np.uint64)
    got = reference.xxh3_64_u128(lo, hi)
    for g, a, b in zip(got.tolist(), lo.tolist(), hi.tolist()):
        data = a.to_bytes(8, "little") + b.to_bytes(8, "little")
        assert g == xxhash.xxh3_64_intdigest(data)
