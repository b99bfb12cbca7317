"""``deacon_tpu_torch.io.split`` and the host library's range reader
against ``deacon_tpu.io.split``.

For every case of tests/test_split.py the port's ranges equal the JAX
package's (plain FASTQ, FASTQ with '@' quality lines, multiline FASTA,
more ranks than records, an empty file; paired files with FASTA mates, a
shorter mate file, no trailing newline, the rank-capped split; BGZF FASTQ
and FASTA, an empty BGZF file), and the port's range reader
(NativeFastxReader with ``byte_range``) yields, range by range, the
records the JAX package's FastxReader reads over its RangeStream or
BgzfRangeStream. The rejections (stdin, serial gzip, garbage) raise the
JAX package's SplitError messages. The record scans of the paired split
equal the JAX package's Python scans; the port's plain range streams
read what its host reader reads.
"""

import gzip

import numpy as np
import pytest

pytest.importorskip("jax")

from helpers import BGZF_EOF, bgzf_compress  # noqa: E402

from deacon_tpu.io import split as jsplit  # noqa: E402
from deacon_tpu.io.fastx import FastxReader as JaxReader  # noqa: E402
from deacon_tpu_torch.io import split as tsplit  # noqa: E402
from deacon_tpu_torch.io.fastx import FastxReader  # noqa: E402
from deacon_tpu_torch.io.native_loader import (  # noqa: E402
    NativeFastxReader,
    offsets_at_records,
    records_at_offsets,
)

_B = np.frombuffer(b"ACGT", np.uint8)


def _recs(reader):
    return [(r.id, r.seq, r.qual) for r in reader]


def _jax_range(path, br):
    if isinstance(br, jsplit.BgzfRange):
        return _recs(JaxReader(jsplit.BgzfRangeStream(path, *br)))
    return _recs(JaxReader(jsplit.RangeStream(path, *br)))


def _port_range(path, br):
    """The port's host reader over one range (small batches, so a range
    spans several)."""
    reader = NativeFastxReader(path, byte_range=tuple(br))
    out = []
    while len(batch := reader.read_batch(7)):
        out.extend((r.id, r.seq, r.qual)
                   for r in (batch.record(i) for i in range(len(batch))))
    return out


def _fastq_bytes(rng, n_rec, qual=b"I", desc=b""):
    out = bytearray()
    for i in range(n_rec):
        n = int(rng.integers(20, 200))
        seq = rng.choice(_B, n).tobytes()
        out += b"@read%d%s\n%s\n+\n%s\n" % (i, desc, seq, qual * n)
    return bytes(out)


def _fasta_bytes(rng, n_rec, width=60):
    out = bytearray()
    for i in range(n_rec):
        n = int(rng.integers(50, 500))
        seq = rng.choice(_B, n).tobytes()
        out += b">contig%d\n" % i
        for j in range(0, n, width):
            out += seq[j:j + width] + b"\n"
    return bytes(out)


PLAIN = {
    "fastq": (lambda rng: _fastq_bytes(rng, 101, desc=b" some desc"),
              (1, 2, 3, 5, 16)),
    "fastq_at_quals": (lambda rng: _fastq_bytes(rng, 60, qual=b"@"),
                       (2, 3, 7)),
    "fasta_multiline": (lambda rng: _fasta_bytes(rng, 40), (1, 2, 4, 9)),
    "more_ranks_than_records": (
        lambda rng: b"@a\nACGT\n+\nIIII\n@b\nTTTT\n+\nIIII\n", (8,)),
    "empty": (lambda rng: b"", (3,)),
}


@pytest.mark.parametrize("case", sorted(PLAIN))
def test_split_fastx_ranges_match_jax(tmp_path, case):
    make, ns = PLAIN[case]
    path = str(tmp_path / "in.fx")
    with open(path, "wb") as f:
        f.write(make(np.random.default_rng(7)))
    whole = _recs(JaxReader(open(path, "rb")))
    for n in ns:
        ranges = tsplit.split_fastx_ranges(path, n)
        assert ranges == jsplit.split_fastx_ranges(path, n)
        joined = []
        for br in ranges:
            got = _port_range(path, br)
            assert got == _jax_range(path, br)
            joined.extend(got)
        assert joined == whole


@pytest.mark.parametrize("content", [None, "gzip", "garbage"])
def test_split_rejections_match_jax(tmp_path, content):
    if content is None:
        path = "-"
    else:
        path = str(tmp_path / "x")
        with open(path, "wb") as f:
            f.write(gzip.compress(b"@a\nACGT\n+\nIIII\n")
                    if content == "gzip" else b"\x00\x01\x02")
    with pytest.raises(tsplit.SplitError) as port:
        tsplit.split_fastx_ranges(path, 2)
    with pytest.raises(jsplit.SplitError) as ref:
        jsplit.split_fastx_ranges(path, 2)
    assert str(port.value) == str(ref.value)


def _mates(rng, n, lo=20, hi=300):
    return [rng.choice(_B, int(rng.integers(lo, hi))).tobytes()
            for _ in range(n)]


def _write_fastq(path, seqs, tag=b"r"):
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b"@%s%d\n%s\n+\n%s\n" % (tag, i, s, b"I" * len(s)))


def _write_fasta(path, seqs, width=60):
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b">m%d\n" % i)
            for j in range(0, len(s), width):
                f.write(s[j:j + width] + b"\n")


def _paired_fastq(p1, p2, rng):
    seqs = _mates(rng, 97)
    _write_fastq(p1, seqs, b"a")
    _write_fastq(p2, [s[::-1] * 2 for s in seqs], b"b")
    return (1, 2, 3, 5, 16)


def _paired_fasta_mate2(p1, p2, rng):
    seqs = _mates(rng, 41, 50, 400)
    _write_fastq(p1, seqs)
    _write_fasta(p2, seqs)
    return (2, 3, 7)


def _paired_shorter_mate2(p1, p2, rng):
    seqs = _mates(rng, 50, 100, 101)
    _write_fastq(p1, seqs, b"a")
    _write_fastq(p2, seqs[:13], b"b")
    return (2, 4, 8)


def _paired_more_ranks(p1, p2, rng):
    _write_fastq(p1, [b"ACGT", b"TTTT"])
    _write_fastq(p2, [b"GGGG", b"CCCC"])
    return (8,)


def _paired_no_trailing_newline(p1, p2, rng):
    with open(p1, "wb") as f:
        f.write(b"@a0\nACGT\n+\nIIII\n@a1\nACGT\n+\nIIII")
    _write_fastq(p2, [b"GGGG", b"CCCC"])
    return (2, 4, 8)


def _paired_rank_capped(p1, p2, rng):
    seqs = _mates(rng, 67, 30, 200)
    _write_fastq(p1, seqs)
    with open(p2, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b">m%d\n%s\n" % (i, s))
    return (1, 3, 5)


PAIRED = {f.__name__[len("_paired_"):]: f for f in (
    _paired_fastq, _paired_fasta_mate2, _paired_shorter_mate2,
    _paired_more_ranks, _paired_no_trailing_newline, _paired_rank_capped)}


@pytest.mark.parametrize("case", sorted(PAIRED))
@pytest.mark.parametrize("swap", [False, True])
def test_split_paired_ranges_match_jax(tmp_path, case, swap):
    p1, p2 = str(tmp_path / "a.fx"), str(tmp_path / "b.fx")
    ns = PAIRED[case](p1, p2, np.random.default_rng(41))
    if swap:
        p1, p2 = p2, p1
    want = list(zip(_recs(JaxReader(open(p1, "rb"))),
                    _recs(JaxReader(open(p2, "rb")))))
    for n in ns:
        ranges = tsplit.split_paired_ranges(p1, p2, n)
        assert ranges == jsplit.split_paired_ranges(p1, p2, n)
        got = []
        for r1, r2 in ranges:
            a, b = _port_range(p1, r1), _port_range(p2, r2)
            assert a == _jax_range(p1, r1) and b == _jax_range(p2, r2)
            got.extend(zip(a, b))
        assert got == want
        for r in range(n):
            capped = tsplit.split_paired_ranges(p1, p2, n, rank=r)
            assert capped == jsplit.split_paired_ranges(p1, p2, n, rank=r)
            assert capped[r] == ranges[r]


def test_paired_stdin_rejected(tmp_path):
    p1 = str(tmp_path / "a.fq")
    _write_fastq(p1, [b"ACGT"])
    for args in ((p1, "-"), ("-", p1)):
        with pytest.raises(tsplit.SplitError) as port:
            tsplit.split_paired_ranges(*args, 2)
        with pytest.raises(jsplit.SplitError) as ref:
            jsplit.split_paired_ranges(*args, 2)
        assert str(port.value) == str(ref.value)


BGZF = {
    "fastq": (lambda rng: _fastq_bytes(rng, 101, desc=b" desc"), 256,
              (1, 2, 3, 5, 16)),
    "fasta_multiline": (lambda rng: _fasta_bytes(rng, 40), 512,
                        (1, 2, 4, 9)),
    "empty": (lambda rng: b"", 0, (3,)),
}


@pytest.mark.parametrize("case", sorted(BGZF))
def test_split_bgzf_ranges_match_jax(tmp_path, case):
    make, block, ns = BGZF[case]
    raw = make(np.random.default_rng(61))
    path = str(tmp_path / "in.fx.gz")
    with open(path, "wb") as f:
        f.write(bgzf_compress(raw, block=block) if raw else BGZF_EOF)
    with open(tmp_path / "in.fx", "wb") as f:
        f.write(raw)
    whole = _recs(JaxReader(open(tmp_path / "in.fx", "rb")))
    assert tsplit.is_bgzf(path) and jsplit.is_bgzf(path)
    for n in ns:
        ranges = tsplit.split_bgzf_ranges(path, n)
        assert [tuple(r) for r in ranges] == [
            tuple(r) for r in jsplit.split_bgzf_ranges(path, n)]
        joined = []
        for br in ranges:
            got = _port_range(path, br)
            assert got == _jax_range(path, jsplit.BgzfRange(*br))
            # the plain version of the host reader's BGZF range
            assert got == _recs(FastxReader(tsplit.BgzfRangeStream(path,
                                                                   *br)))
            joined.extend(got)
        assert joined == whole
        for r in range(n):
            capped = tsplit.split_bgzf_ranges(path, n, rank=r)
            assert capped[r] == ranges[r]
            assert [c and tuple(c) for c in capped] == [
                c and tuple(c)
                for c in jsplit.split_bgzf_ranges(path, n, rank=r)]


def test_range_reader_refuses_serial_codecs(tmp_path):
    """Only plain and BGZF files have mid-stream entry points: the host
    library refuses a range of a serial gzip file, and a BGZF range that
    does not start at a block."""
    path = tmp_path / "r.fq.gz"
    path.write_bytes(gzip.compress(b"@a\nACGT\n+\nIIII\n"))
    assert not tsplit.is_bgzf(str(path))
    with pytest.raises(tsplit.SplitError):
        tsplit.split_fastx_ranges(str(path), 2)
    with pytest.raises(OSError, match="no BGZF block starts"):
        NativeFastxReader(str(path), byte_range=(0, 0, -1))
    bg = tmp_path / "b.fq.gz"
    bg.write_bytes(bgzf_compress(b"@a\nACGT\n+\nIIII\n" * 50, block=64))
    with pytest.raises(OSError, match="no BGZF block starts"):
        NativeFastxReader(str(bg), byte_range=(5, 0, -1))
    zst = tmp_path / "r.fq.zst"
    zst.write_bytes(b"\x28\xb5\x2f\xfd" + b"\x00" * 16)
    with pytest.raises(OSError, match="only plain and BGZF"):
        NativeFastxReader(str(zst), byte_range=(0, 4))


@pytest.mark.parametrize("fmt", ["fastq", "fastq_unterminated", "fasta"])
def test_record_scans_match_jax(tmp_path, fmt):
    """The host library's scans behind split_paired_ranges against the
    JAX package's chunked Python scans."""
    rng = np.random.default_rng(71)
    path = tmp_path / "s.fx"
    raw = (_fasta_bytes(rng, 53) if fmt == "fasta"
           else _fastq_bytes(rng, 53, qual=b"@"))
    if fmt == "fastq_unterminated":
        raw = raw[:-1]
    path.write_bytes(raw)
    is_fq = fmt != "fasta"
    size = len(raw)
    offs = sorted(set(s for s, _ in jsplit.split_fastx_ranges(str(path), 9)))
    offs.append(size)
    with open(path, "rb") as f:
        want = jsplit._records_at_offsets(f, size, offs, is_fq)
    assert records_at_offsets(str(path), offs, is_fq) == want
    recs = [0, 1, 5, 17, 52, 53, 60]
    with open(path, "rb") as f:
        want = jsplit._offsets_at_records(f, size, recs, is_fq)
    assert offsets_at_records(str(path), recs, is_fq) == want
    if is_fq:
        with pytest.raises(ValueError, match="not a FASTQ record boundary"):
            records_at_offsets(str(path), [raw.index(b"\n", offs[1]) + 1],
                               True)


def test_plain_range_stream_matches_host_reader(tmp_path):
    path = str(tmp_path / "r.fq")
    with open(path, "wb") as f:
        f.write(_fastq_bytes(np.random.default_rng(3), 77))
    for br in tsplit.split_fastx_ranges(path, 4):
        assert _port_range(path, br) == _recs(
            FastxReader(tsplit.RangeStream(path, *br)))
