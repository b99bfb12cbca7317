"""deacon_tpu_torch ops against the JAX package on the CPU, exact.

The same numpy-seeded inputs go through the JAX function (its Pallas
kernels in interpret mode, or its XLA emulation) and through the port's
counterpart (the kernels' plain PyTorch versions, which the wrappers run
for CPU tensors). Every output is an integer, so the tolerance is 0.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from deacon_tpu.ops import engine as jeng  # noqa: E402
from deacon_tpu.ops import minimizers_np as jmnp  # noqa: E402
from deacon_tpu.ops import pallas_kernels as jpk  # noqa: E402
from deacon_tpu.ops import radix_probe as jrp  # noqa: E402
from deacon_tpu.ops import u64pair  # noqa: E402
from deacon_tpu.utils import xxh3 as jxxh3  # noqa: E402
from deacon_tpu_torch.ops import engine as teng  # noqa: E402
from deacon_tpu_torch.ops import kernels as tk  # noqa: E402
from deacon_tpu_torch.ops import pack as tpack  # noqa: E402
from deacon_tpu_torch.ops import radix_probe as trp  # noqa: E402
from deacon_tpu_torch.ops.hash import xxh3_64, xxh3_64_u128  # noqa: E402

_B = np.frombuffer(b"ACGT", np.uint8)


def _i64(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint64).view(np.int64))


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


# ---------------------------------------------------------------------------
# XXH3
# ---------------------------------------------------------------------------

def test_xxh3_matches_numpy_and_u32_pair_versions():
    rng = np.random.default_rng(11)
    v = rng.integers(0, 2**64, 50_000, dtype=np.uint64)
    v[:6] = [0, 1, 2**32 - 1, 2**32, 2**63, 2**64 - 1]
    got = _u64(xxh3_64(_i64(v)))
    np.testing.assert_array_equal(got, jxxh3.xxh3_64_u64(v))
    lo, hi = u64pair.xxh3_64_pair_u64(
        jnp.asarray((v & 0xFFFFFFFF).astype(np.uint32)),
        jnp.asarray((v >> np.uint64(32)).astype(np.uint32)),
    )
    pair = np.asarray(lo).astype(np.uint64) | (
        np.asarray(hi).astype(np.uint64) << np.uint64(32)
    )
    np.testing.assert_array_equal(got, pair)


def _u32_pair(v: np.ndarray):
    return (jnp.asarray((v & 0xFFFFFFFF).astype(np.uint32)),
            jnp.asarray((v >> np.uint64(32)).astype(np.uint32)))


def test_xxh3_u128_matches_numpy_and_u32_pair_versions():
    rng = np.random.default_rng(12)
    lo = rng.integers(0, 2**64, 50_000, dtype=np.uint64)
    hi = rng.integers(0, 2**64, 50_000, dtype=np.uint64)
    lo[:6] = [0, 2**64 - 1, 0, 2**63, 1, 2**32]
    hi[:6] = [0, 2**64 - 1, 2**63, 0, 2**32 - 1, 0]
    got = _u64(xxh3_64_u128(_i64(lo), _i64(hi)))
    np.testing.assert_array_equal(got, jxxh3.xxh3_64_u128(lo, hi))
    plo, phi = u64pair.xxh3_64_pair_u128(_u32_pair(lo), _u32_pair(hi))
    pair = np.asarray(plo).astype(np.uint64) | (
        np.asarray(phi).astype(np.uint64) << np.uint64(32)
    )
    np.testing.assert_array_equal(got, pair)


# ---------------------------------------------------------------------------
# host packing
# ---------------------------------------------------------------------------

def test_rows_and_packing_byte_identical_to_jax():
    rng = np.random.default_rng(5)
    k, w, L = 31, 15, 512
    l = k + w - 1
    stride = L - l + 1
    seqs = [rng.choice(_B, size=int(n)).tobytes()
            for n in rng.integers(20, 2000, 40)]
    seqs += [b"ACGTN" * 30 + b"\n", b"acgtRYKM" * 20, b"A" * 31, b"C" * 30]
    trows, jrows = [], []
    for i, s in enumerate(seqs):
        for prefix in (0, 100):
            a = tpack.rows_for_read(i, i % 2, s, prefix, k=k, l=l,
                                    stride=stride, max_len=L)
            b = jeng.rows_for_read(i, i % 2, s, prefix, k=k, l=l,
                                   stride=stride, max_len=L)
            assert [(r.rid, r.mate, r.chunk_start, r.seq) for r in a] == [
                (r.rid, r.mate, r.chunk_start, r.seq) for r in b]
            trows += a
            jrows += b
    R = len(trows) + 5
    got = tpack.pack_rows_packed(trows, R, L, k, l)
    want = jeng.pack_rows_packed(jrows, R, L, k, l)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype
        np.testing.assert_array_equal(g, x)
    assert tpack.v4_row_budget(L, w, tpack.default_budget_frac(w)) == (
        jeng.v4_row_budget(L, w, jeng.default_budget_frac(w)))


# ---------------------------------------------------------------------------
# K1: extraction + compaction
# ---------------------------------------------------------------------------

def _random_tile(rng, R, L, k, w):
    codes = rng.integers(0, 4, (R, L)).astype(np.uint8)
    validb = rng.random((R, L)) > 0.03
    mlen = rng.integers(-1, L - k + 2, (R,)).astype(np.int32)
    mlen[0] = L - k + 1
    mlen[1] = 0
    mlen[2] = max(1, w - 2)  # short read: one window via allow_short
    allow_short = rng.random(R) > 0.5
    allow_short[2] = True
    codes[3, 40:200] = codes[3, 40]  # low complexity
    return codes, validb, mlen, allow_short


def _port_k1(pc, pv, mlen, allow, k, w, Br):
    return tk.select_compact(
        torch.from_numpy(pc), torch.from_numpy(pv), torch.from_numpy(mlen),
        torch.from_numpy(allow), k=k, w=w, Br=Br,
    )


def _assert_k1_equal(got, want_pos, want_v0, want_v1, want_tot, Br):
    pos, val, tot = (x.numpy() for x in got)
    want_tot = np.asarray(want_tot).reshape(-1)
    np.testing.assert_array_equal(tot, want_tot)
    v = val.view(np.uint64)
    for r in range(tot.size):
        n = min(int(tot[r]), Br)
        np.testing.assert_array_equal(pos[r, :n], np.asarray(want_pos)[r, :n])
        np.testing.assert_array_equal(
            (v[r, :n] & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            np.asarray(want_v0)[r, :n])
        np.testing.assert_array_equal(
            (v[r, :n] >> np.uint64(32)).astype(np.uint32),
            np.asarray(want_v1)[r, :n])


@pytest.mark.parametrize("k,w,L", [(31, 15, 256), (32, 7, 128),
                                   (17, 21, 256), (5, 3, 128)])
def test_k1_plain_matches_pallas_interpret(k, w, L):
    rng = np.random.default_rng(k * 101 + w)
    R, Br = 8, 128
    codes, validb, mlen, allow = _random_tile(rng, R, L, k, w)
    pc, pv = jeng.host_pack_bits(codes, validb)
    pci, pvi = jeng.host_interleave_packed(pc, pv)
    wpos, (wv0, wv1), wtot = jpk.select_compact_packed(
        jnp.asarray(pci), jnp.asarray(pvi), jnp.asarray(mlen),
        jnp.asarray(allow), k=k, w=w, Br=Br, interpret=True,
    )
    got = _port_k1(pc, pv, mlen, allow, k, w, Br)
    _assert_k1_equal(got, wpos, wv0, wv1, wtot, Br)


@pytest.mark.parametrize("k,w", [(31, 15), (32, 15), (21, 7), (16, 16),
                                 (13, 11), (31, 25), (15, 63), (2, 15)])
def test_k1_plain_matches_xla_emulation(k, w, monkeypatch):
    monkeypatch.setenv("DEACON_PALLAS", "0")
    rng = np.random.default_rng(k * 7 + w)
    R, L = 16, 512
    Br = 128 if w > 7 else 256
    codes, validb, mlen, allow = _random_tile(rng, R, L, k, w)
    pc, pv = jeng.host_pack_bits(codes, validb)
    wpos, (wv0, wv1), wtot = jeng._values_compact(
        jnp.asarray(pc), jnp.asarray(pv), None, None, jnp.asarray(mlen),
        jnp.asarray(allow), k=k, w=w, Br=Br,
    )
    got = _port_k1(pc, pv, mlen, allow, k, w, Br)
    _assert_k1_equal(got, wpos, wv0, wv1, wtot, Br)


def test_k1_chunked_long_reads_match_oracle():
    """Rows of chunked long reads (with N runs) through the plain K1 give
    the oracle's minimizers of every chunk, position for position."""
    rng = np.random.default_rng(9)
    k, w, L = 31, 15, 512
    l = k + w - 1
    stride = L - l + 1
    reads = [rng.choice(_B, size=3000).tobytes(),
             rng.choice(_B, size=1200).tobytes() + b"N" * 300
             + rng.choice(_B, size=700).tobytes()]
    rows = [r for i, s in enumerate(reads)
            for r in tpack.rows_for_read(i, 0, s, 0, k=k, l=l,
                                         stride=stride, max_len=L)]
    arrs = tpack.pack_rows_packed(rows, len(rows), L, k, l)
    pos, val, tot = _port_k1(*arrs[:4], k, w, 256)
    hashes = _u64(xxh3_64(val))
    for i, row in enumerate(rows):
        h, p, _ = jmnp.get_minimizer_hashes_and_positions(row.seq, 0, k, w)
        assert int(tot[i]) == p.size
        np.testing.assert_array_equal(pos[i, :p.size].numpy(), p)
        np.testing.assert_array_equal(hashes[i, :p.size], h)


# ---------------------------------------------------------------------------
# K3: wide-k selection, and the index-side entropy filter
# ---------------------------------------------------------------------------

def _k3_tile(k, w):
    """The dirty, short and unused rows of tests/test_pallas_kernels.py's
    values_select_fused case."""
    rng = np.random.default_rng(3)
    R, L = 16, 640
    codes = rng.integers(0, 4, (R, L)).astype(np.uint8)
    validb = rng.random((R, L)) > 0.05
    mlen = rng.integers(-1, L - k + 2, (R,)).astype(np.int32)
    mlen[0] = L - k + 1
    mlen[1] = 0
    allow = rng.random(R) > 0.5
    mlen[2] = k + w - 1 - k  # short read: single window via allow_short
    allow[2] = True
    mlen[3] = -1
    return codes, validb, mlen, allow


@pytest.mark.parametrize("k,w", [(31, 15), (21, 7), (41, 15), (56, 9)])
def test_k3_plain_matches_pallas_interpret(k, w):
    codes, validb, mlen, allow = _k3_tile(k, w)
    want_v, want_wpf = jpk.values_select_fused(
        jnp.asarray(codes), jnp.asarray(validb), jnp.asarray(mlen),
        jnp.asarray(allow), k=k, w=w, interpret=True,
    )
    pc, pv = jeng.host_pack_bits(codes, validb)
    lo, hi, wpf = tk.values_select(
        torch.from_numpy(pc), torch.from_numpy(pv), torch.from_numpy(mlen),
        torch.from_numpy(allow), k=k, w=w,
    )
    want_wpf = np.asarray(want_wpf)
    np.testing.assert_array_equal(wpf.numpy(), want_wpf)
    flagged = (want_wpf >> 16) != 0
    assert flagged.sum() > 0
    v = [np.asarray(x).astype(np.uint64) for x in want_v]
    np.testing.assert_array_equal(
        _u64(lo)[flagged], (v[0] | (v[1] << np.uint64(32)))[flagged])
    want_hi = (v[2] | (v[3] << np.uint64(32))) if k > 32 else 0 * v[0]
    np.testing.assert_array_equal(_u64(hi)[flagged], want_hi[flagged])


@pytest.mark.parametrize("k,w", [(41, 15), (57, 9)])
def test_k3_slots_match_oracle(k, w):
    """K3's plain version, compacted into the slot grid and hashed, gives
    the oracle's index-side minimizers of every row (k = 57 included,
    where the JAX package has no kernel)."""
    rng = np.random.default_rng(k)
    L = 512
    l = k + w - 1
    seqs = [rng.choice(_B, size=int(n)).tobytes()
            for n in rng.integers(k, L + 1, 12)]
    seqs[1] = seqs[1][:100] + b"NRYK" * 5 + seqs[1][120:].lower()
    seqs[2] = seqs[2][:l - 1]  # short row: one window
    rows = [tpack._Row(i, 0, 0, s) for i, s in enumerate(seqs)]
    arrs = tpack.pack_rows_packed(rows, len(rows), L, k, l,
                                  code_table=tpack.INDEX_CODE)
    pos, planes, tot = teng.select_slots(
        *(torch.from_numpy(a) for a in arrs[:4]), k=k, w=w, Br=L,
        route="K3")
    h = _u64(teng.hash_planes(planes))
    for i, s in enumerate(seqs):
        want = jmnp.compute_minimizer_hashes(s, k, w)
        np.testing.assert_array_equal(h[i, :int(tot[i])], want)


def _entropy_slots(rng, k, n=400, L=256):
    """Rows holding k-mers of skewed compositions at known positions."""
    seqs, pos = [], []
    for _ in range(n):
        p = rng.dirichlet(np.full(4, 0.4))
        kmer = rng.choice(_B, size=k, p=p).tobytes()
        off = int(rng.integers(0, L - k + 1))
        seqs.append(rng.choice(_B, size=off).tobytes() + kmer
                    + rng.choice(_B, size=L - off - k).tobytes())
        pos.append(off)
    return seqs, np.array(pos, np.int32)


@pytest.mark.parametrize("k", [31, 41])
def test_entropy_step_matches_jax_stages(k):
    rng = np.random.default_rng(k + 5)
    L = 256
    seqs, pos = _entropy_slots(rng, k, L=L)
    rows = [tpack._Row(i, 0, 0, s) for i, s in enumerate(seqs)]
    pc = tpack.pack_rows_packed(rows, len(rows), L, k, k + 14,
                                code_table=tpack.INDEX_CODE)[0]
    arena = np.frombuffer(b"".join(seqs), np.uint8).reshape(len(seqs), L)
    codes = jmnp.PACK_CODE[arena]
    R = len(seqs)
    for thr in (0.5, 0.8, 0.9):
        got = teng.entropy_keep(
            torch.from_numpy(pc), torch.from_numpy(pos)[:, None],
            torch.from_numpy(teng.entropy_keep_table(k, thr)), k)[:, 0]
        want = jeng._stage_entropy(
            jnp.asarray(codes), jnp.asarray(np.ones((R, L), bool)),
            jnp.arange(R, dtype=jnp.int32), jnp.asarray(pos),
            jnp.ones(R, bool), jnp.float32(thr), k=k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < int(got.sum()) < R
        if k <= 32:
            lo, _ = jmnp.canonical_values(codes.reshape(-1),
                                          np.arange(R) * L + pos, k)
            v0, v1 = _u32_pair(lo)
            limbs = jeng._entropy_from_limbs(v0, v1, jnp.float32(thr), k=k)
            np.testing.assert_array_equal(got.numpy(), np.asarray(limbs))


@pytest.mark.parametrize("k", [13, 41, 57])
def test_entropy_keep_is_the_oracle_at_every_composition(k):
    """The float sum of the four entropy terms depends on their order, so
    a composition and its reverse complement can differ in the last bit.
    With the threshold set to such values, entropy_keep still decides
    every k-mer, on either strand, as the oracle does on its bytes."""
    rng = np.random.default_rng(k)
    n = k + 1
    comps = [(a, c, g, k - a - c - g) for a in range(n)
             for c in range(n - a) for g in range(n - a - c)]
    L = 128
    seqs, pos = [], []
    for a, c, g, t in comps[::max(1, len(comps) // 500)]:
        kmer = bytearray(b"A" * a + b"C" * c + b"G" * g + b"T" * t)
        rng.shuffle(kmer)
        off = int(rng.integers(0, L - k + 1))
        seqs.append(rng.choice(_B, size=off).tobytes() + bytes(kmer)
                    + rng.choice(_B, size=L - off - k).tobytes())
        pos.append(off)
    ent = jmnp.scaled_entropy(np.frombuffer(b"".join(seqs), np.uint8),
                              np.arange(len(seqs)) * L + np.array(pos), k)
    rows = [tpack._Row(i, 0, 0, s) for i, s in enumerate(seqs)]
    pc = torch.from_numpy(tpack.pack_rows_packed(
        rows, len(rows), L, k, k + 14, code_table=tpack.INDEX_CODE)[0])
    cuts = np.unique(ent)[::7]
    assert cuts.size > 5
    for cut in cuts:
        got = teng.entropy_keep(pc, torch.tensor(pos)[:, None],
                                torch.from_numpy(
                                    teng.entropy_keep_table(k, float(cut))),
                                k)[:, 0]
        np.testing.assert_array_equal(got.numpy(), ent >= cut)


# ---------------------------------------------------------------------------
# radix table and K2
# ---------------------------------------------------------------------------

def _index_with_spill(rng, n=120_000):
    keys = np.unique(rng.integers(0, 2**64, n, dtype=np.uint64))
    h = int(keys[len(keys) // 2])
    top = np.uint64(h & ~0x3FFFFFFFF)
    lows = rng.integers(0, h & 0x3FFFFFFFF, 160, dtype=np.uint64)
    return np.unique(np.concatenate([keys, top | lows])), h


def _assert_tables_equal(t, j):
    assert (t.p, t.sp, t.n_keys) == (j.p, j.sp, j.n_keys)
    assert torch.equal(t.slots, j.slots)
    if t.sp:
        assert torch.equal(t.spill, j.spill)


@pytest.mark.parametrize("case", ["small", "plain", "spill"])
def test_radix_table_matches_jax_builder(case):
    rng = np.random.default_rng(3)
    if case == "small":
        keys = rng.integers(0, 2**64, 40, dtype=np.uint64)
    elif case == "plain":
        keys = rng.integers(0, 2**64, 150_000, dtype=np.uint64)
        keys = np.concatenate([keys, keys[:500]])  # duplicates
    else:
        keys, _ = _index_with_spill(rng)
    jt = jrp.build_radix_table(keys)
    assert (case == "spill") == (jt.sp > 0)
    t = trp.build_radix_table(_i64(rng.permutation(keys)))
    _assert_tables_equal(
        t, trp.radix_table_from_jax(jt.planes, jt.p, jt.k, jt.spill, jt.sp))
    assert t.n_keys == np.unique(keys).size


def _grid_case(rng, keys, R, Br, nseg):
    qk = np.where(
        rng.random((R, Br)) < 0.5,
        rng.choice(keys, size=(R, Br)),
        rng.integers(0, 2**64, (R, Br), dtype=np.uint64),
    )
    qk[1, :] = qk[0, :]          # whole-row duplicate within a unit
    qk[2, :16] = qk[2, 0]        # in-row duplicates
    return qk, np.repeat(np.arange(nseg, dtype=np.int32), R // nseg)


def _bruteforce_hits(keys, qk, valid, rid_rows, nseg):
    kset = set(keys.tolist())
    return np.array([
        len({int(qk[r, j]) for r in np.nonzero(rid_rows == u)[0]
             for j in range(qk.shape[1])
             if valid[r, j] and int(qk[r, j]) in kset})
        for u in range(nseg)])


def _jax_hits(jt, qk, valid, rid_rows, nseg, mode):
    R, Br = qk.shape
    hits, ov = jrp.radix_probe_hits(
        jnp.asarray(jt.planes), jt.p, jt.k, jt.nplanes,
        jnp.asarray((qk & 0xFFFFFFFF).astype(np.uint32)),
        jnp.asarray((qk >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray(valid),
        jnp.asarray(np.broadcast_to(rid_rows[:, None], (R, Br)).copy()),
        jnp.asarray(np.zeros((R, Br), np.int32)),
        num_segments=nseg, mode=mode,
        spill=jnp.asarray(jt.spill) if jt.sp else None, sp=jt.sp,
    )
    return np.asarray(hits), bool(np.asarray(ov))


def _port_hits(t, qk, valid, rid_rows, nseg):
    R, Br = qk.shape
    return trp.radix_probe_hits(
        [t], _i64(qk), torch.from_numpy(valid),
        torch.from_numpy(rid_rows)[:, None].expand(R, Br),
        num_segments=nseg,
    ).numpy()


@pytest.mark.parametrize("density", [1.0, 0.67, 0.3])
def test_k2_plain_matches_emulation_and_bruteforce(density):
    rng = np.random.default_rng(int(density * 100))
    keys, h = _index_with_spill(rng)
    jt = jrp.build_radix_table(keys)
    assert jt.sp > 0
    t = trp.build_radix_table(_i64(keys))
    R, Br, nseg = 32, 128, 16
    cnt = np.clip((density * Br + rng.integers(-8, 9, R)).astype(int), 1, Br)
    valid = np.arange(Br)[None, :] < cnt[:, None]
    qk, rid_rows = _grid_case(rng, keys, R, Br, nseg)
    qk[5, :4] = h          # a key that spilled, counted once per unit
    valid[5, :4] = True
    want = _bruteforce_hits(keys, qk, valid, rid_rows, nseg)
    jh, jov = _jax_hits(jt, qk, valid, rid_rows, nseg, "emulate")
    assert not jov
    np.testing.assert_array_equal(jh, want)
    np.testing.assert_array_equal(_port_hits(t, qk, valid, rid_rows, nseg),
                                  want)
    member = jrp.oracle_member(jt, qk.reshape(-1))
    tm = tk._member_plain(t.slots, t.p, _i64(qk.reshape(-1))) | \
        tk._member_plain(t.spill, t.sp, _i64(qk.reshape(-1)))
    np.testing.assert_array_equal(tm.numpy(), member)


def test_k2_exact_where_jax_kernel_overflows():
    """The ultra-sparse and split-bound batches that raise the JAX kernel's
    overflow flag (and force its emulation rerun) give exact counts from
    the port's probe in one pass."""
    rng = np.random.default_rng(5)
    keys = np.unique(rng.integers(0, 2**64, 200_000, dtype=np.uint64))
    jt = jrp.build_radix_table(keys)
    t = trp.build_radix_table(_i64(keys))
    # ultra-sparse: 4 valid slots of 128 per row
    R, Br, nseg = 32, 128, 16
    qk = rng.choice(keys, size=(R, Br))
    valid = np.zeros((R, Br), bool)
    valid[:, :4] = True
    rid_rows = np.repeat(np.arange(nseg, dtype=np.int32), 2)
    _, ov = _jax_hits(jt, qk, valid, rid_rows, nseg, "interpret")
    assert ov
    want, _ = _jax_hits(jt, qk, valid, rid_rows, nseg, "emulate")
    np.testing.assert_array_equal(_port_hits(t, qk, valid, rid_rows, nseg),
                                  want)
    # split bound: every slot valid, above the 0.78 compaction bound
    keys4 = np.unique(rng.integers(0, 2**64, 400_000, dtype=np.uint64))
    jt4 = jrp.build_radix_table(keys4)
    t4 = trp.build_radix_table(_i64(keys4))
    R, Br, nseg = 64, 128, 32
    qk = np.where(rng.random((R, Br)) < 0.5, rng.choice(keys4, size=(R, Br)),
                  rng.integers(0, 2**64, (R, Br), dtype=np.uint64))
    valid = np.ones((R, Br), bool)
    rid_rows = np.repeat(np.arange(nseg, dtype=np.int32), 2)
    _, ov = _jax_hits(jt4, qk, valid, rid_rows, nseg, "interpret")
    assert ov
    want, _ = _jax_hits(jt4, qk, valid, rid_rows, nseg, "emulate")
    np.testing.assert_array_equal(_port_hits(t4, qk, valid, rid_rows, nseg),
                                  want)


def test_totals_grid_matches_jax():
    rng = np.random.default_rng(12)
    k, w, L = 31, 15, 64
    l = k + w - 1
    stride = L - l + 1
    R, Br, nseg = 24, 16, 6
    rid = np.repeat(np.arange(nseg, dtype=np.int32), 4)
    mate = np.tile(np.array([0, 0, 1, 1], np.int32), nseg)
    cstart = np.tile(np.array([0, stride, 0, stride], np.int32), nseg)
    slot_pos = np.sort(rng.integers(0, L - k + 1, (R, Br)), axis=1).astype(
        np.int32)
    valid = rng.random((R, Br)) < 0.7
    for r in range(1, R):  # plant overlap duplicates of the previous row
        slot_pos[r, 0] = max(0, slot_pos[r - 1, -1] + cstart[r - 1]
                             - cstart[r])
    for dedup in (True, False):
        want = jrp.totals_grid(
            jnp.asarray(slot_pos), jnp.asarray(valid), jnp.asarray(rid),
            jnp.asarray(mate), jnp.asarray(cstart), num_segments=nseg, k=k,
            l=l, stride=stride, dedup_positions=dedup,
        )
        got = trp.totals_grid(
            torch.from_numpy(slot_pos), torch.from_numpy(valid),
            torch.from_numpy(rid), torch.from_numpy(mate),
            torch.from_numpy(cstart), num_segments=nseg, k=k, l=l,
            stride=stride, dedup_positions=dedup,
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrappers_reject_bad_input_and_other_devices():
    pc = torch.zeros((8, 64), dtype=torch.uint8)
    pv = torch.zeros((8, 32), dtype=torch.uint8)
    mlen = torch.zeros(8, dtype=torch.int32)
    allow = torch.zeros(8, dtype=torch.bool)
    with pytest.raises(ValueError):
        tk.select_compact(pc, pv, mlen.to(torch.int64), allow, k=31, w=15,
                          Br=128)
    with pytest.raises(ValueError):
        tk.select_compact(pc, pv, mlen, allow, k=33, w=15, Br=128)
    with pytest.raises(ValueError):
        tk.select_compact(pc.to("meta"), pv.to("meta"), mlen.to("meta"),
                          allow.to("meta"), k=31, w=15, Br=128)
    with pytest.raises(ValueError):
        tk.values_select(pc, pv, mlen, allow, k=58, w=15)
    with pytest.raises(ValueError):
        tk.values_select(pc[:, :40], pv[:, :20], mlen, allow, k=41, w=15)
    with pytest.raises(ValueError):
        tk.values_select(pc.to("meta"), pv.to("meta"), mlen.to("meta"),
                         allow.to("meta"), k=41, w=15)
    t = trp.build_radix_table(torch.arange(100, dtype=torch.int64))
    q = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        tk.probe_hits(t.slots, None, q, q.to(torch.int32), q, p=t.p, sp=0,
                      num_segments=1)
