"""The read-pool generator: the same bytes for the same seed, other bytes
for another, and every size fixed by the traffic's parameters."""

import gzip
import json
import os

import numpy as np
import pytest

from benchmark.generators import reads
from benchmark.seeds import rng

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def params(traffic: str, units: int) -> dict:
    with open(os.path.join(HERE, "traffic", f"{traffic}.json")) as f:
        p = json.load(f)["pool"]
    p["units"] = units
    return p


GENOME = reads.random_bases(rng(1, "genome"), 200_000)


def pool(traffic, units, seed):
    return reads.make_pool(params(traffic, units), GENOME, rng(seed, "pool"))


@pytest.mark.parametrize("traffic,units", [("pe150", 2000), ("ont", 300),
                                           ("pe150-gz", 1000)])
def test_same_seed_same_bytes(traffic, units):
    a, b, c = (pool(traffic, units, s) for s in (5, 5, 6))
    for fa, fb, fc in zip(a.files, b.files, c.files):
        assert np.array_equal(fa.data, fb.data)
        assert not np.array_equal(fa.data, fc.data)
    # sizes do not depend on the seed
    assert np.array_equal(np.sort(a.lens), np.sort(c.lens))
    assert [f.data.size for f in a.files] == [f.data.size for f in c.files]


def test_seed_beyond_32_bits():
    a = pool("pe150", 200, 2**31 + 12345)
    b = pool("pe150", 200, 12345)
    assert not np.array_equal(a.files[0].data, b.files[0].data)


def fastq_records(data: bytes):
    lines = data.split(b"\n")
    assert lines[-1] == b""
    return [lines[i:i + 4] for i in range(0, len(lines) - 1, 4)]


def host_units(p, genome: bytes) -> int:
    """Units whose first read's first or last 60 bases occur in the genome
    on either strand (a low-complexity stretch, at most half a read,
    covers one end at most)."""
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    n = 0
    for u in range(p.n_units):
        s = int(np.nonzero(p.unit_of_seq == u)[0][0])
        a, b = int(p.starts[s]), int(p.starts[s] + p.lens[s])
        ends = (p.arena[a:a + 60].tobytes(), p.arena[b - 60:b].tobytes())
        if any(r in genome or r.translate(comp)[::-1] in genome
               for r in ends):
            n += 1
    return n


def test_illumina_pairs():
    p = pool("pe150", 1000, 7)
    assert p.paired and p.n_units == 1000 and len(p.files) == 2
    assert np.all(p.lens == 150)
    r1, r2 = (fastq_records(f.data.tobytes()) for f in p.files)
    assert len(r1) == len(r2) == 1000
    assert r1[0][0].endswith(b" 1:N:0:1") and r2[0][0].endswith(b" 2:N:0:1")
    assert all(len(r[1]) == len(r[3]) == 150 and r[2] == b"+" for r in r1)
    assert set(b"".join(r[3] for r in r1)) <= set(b"#-8F")
    # host pairs: exactly a fifth; the mates come from one fragment
    assert host_units(p, GENOME.tobytes()) == 200
    # poly-G tails: 1 read in 20, 20-100 bases
    seqs = [r[1] for r in r1 + r2]
    tails = [len(s) - len(s.rstrip(b"G")) for s in seqs]
    long_tails = [t for t in tails if t >= 20]
    # (a random G before a tail may lengthen it by a base or two)
    assert len(long_tails) == 100 and max(tails) <= 105


def test_ont_reads():
    p = pool("ont", 3000, 8)
    assert not p.paired and len(p.files) == 1
    assert p.lens.min() >= 1000 and p.lens.max() <= 100_000
    assert 5000 < p.lens.mean() < 6000
    assert 3600 < np.median(p.lens) < 4400
    recs = fastq_records(p.files[0].data.tobytes())
    assert [len(r[1]) for r in recs] == p.lens.tolist()
    assert host_units(p, GENOME.tobytes()) == 600
    # low-complexity stretches: 1 read in 15
    seqs = [r[1] for r in recs]
    lc = sum(1 for s in seqs if any(u * 50 in s for u in
                                     (b"A" * 6, b"G" * 6, b"AC" * 3,
                                      b"CAG" * 2, b"TTAGGG")))
    assert 190 <= lc <= 215


def test_gzip_one_member():
    """A gzip file is one member (no BGZF extra field), whose body
    repeated stays one valid member: what the window's stream reads."""
    import zlib

    p = pool("pe150-gz", 300, 9)
    ext, files = reads.pool_bytes(p, params("pe150-gz", 300), 2)
    assert ext == ".fastq.gz" and len(files) == 2
    for f, fb in zip(p.files, files):
        raw = fb.whole()
        assert raw[:2] == b"\x1f\x8b" and not raw[3] & 4  # no FEXTRA: no BGZF
        d = zlib.decompressobj(wbits=31)
        assert d.decompress(raw) == f.data.tobytes()
        assert d.eof and d.unused_data == b""  # one member
        assert gzip.decompress(fb.whole(3)) == f.data.tobytes() * 3


def test_records_of_kept_units():
    p = pool("pe150", 50, 10)
    recs = fastq_records(p.files[1].data.tobytes())
    got = fastq_records(p.files[1].records(np.array([3, 7, 49])).tobytes())
    assert got == [recs[3], recs[7], recs[49]]
