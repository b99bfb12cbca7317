"""The port's host library (deacon_tpu_torch/io/native/host.cpp) against
the JAX package's native library (deacon_tpu/io/native) and against the
port's own plain versions.

The cases of tests/test_native_io.py and tests/test_native_extract.py,
merged into parametrised tests: the reader on every input format (plain,
gzip, BGZF, zstd, xz, bzip2; FASTQ, multi-line FASTA, CRLF; from a file
and from stdin), a blank line at a batch cut, truncated and corrupt
streams; batches kept in flight; the tile packer with the filter's and
the index build's codes; the varint codec at its boundaries; the sorted
merges; the writers; the batch formatter; the index store; host
extraction. Every comparison is exact.
"""

import bz2
import gzip
import lzma
import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from deacon_tpu.io import native_loader as jnl
from deacon_tpu.io.fastx import FastxReader as JaxPlainReader
from deacon_tpu.ops import engine as jeng
from deacon_tpu.ops import host_extract as jhx
from deacon_tpu_torch.index import store
from deacon_tpu_torch.index.build import _merge_sorted_unique_plain
from deacon_tpu_torch.io import native_loader as nl
from deacon_tpu_torch.io import writers, zstd
from deacon_tpu_torch.io.fastx import (
    FastxParseError,
    FastxReader,
    Record,
    RecordBatch,
    open_maybe_compressed,
)
from deacon_tpu_torch.ops import host_extract
from deacon_tpu_torch.ops import minimizers_np as mnp
from deacon_tpu_torch.ops import pack
from deacon_tpu_torch.utils import bincode, trace
from helpers import bgzf_compress

REPO = Path(__file__).resolve().parent.parent
_B = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(scope="module")
def jlib():
    lib = jnl.get_lib()
    assert lib is not None, "the JAX package's native library did not build"
    return lib


def _rs(rng, n, alphabet=_B):
    return rng.choice(alphabet, size=n).tobytes()


def _fastq(rng, n, crlf=False):
    nl_ = b"\r\n" if crlf else b"\n"
    out = []
    for i in range(n):
        s = _rs(rng, 60 + i % 90)
        out.append(b"@read_%d desc %d" % (i, i) + nl_ + s + nl_ + b"+" + nl_
                   + b"I" * len(s) + nl_)
    return b"".join(out)


def _fasta(rng, n, crlf=False):
    nl_ = b"\r\n" if crlf else b"\n"
    out = []
    for i in range(n):
        s = _rs(rng, 100 + i % 130)
        out.append(b">ctg_%d" % i + nl_)
        out += [s[j:j + 60] + nl_ for j in range(0, len(s), 60)]
    return b"".join(out)


def _zst(data: bytes) -> bytes:
    import io

    buf = io.BytesIO()
    w = zstd.Writer(buf, 3, "<memory>")
    w.write(data)
    w.close()
    return buf.getvalue()


COMPRESS = {
    "plain": lambda d: d,
    "gz": gzip.compress,
    "bgzf": lambda d: bgzf_compress(d, block=4096),
    "zst": _zst,
    "xz": lzma.compress,
    "bz2": bz2.compress,
}


def _recs(reader):
    return [(r.id, r.seq, r.qual, r.is_fastq) for r in reader]


def _plain(path):
    return _recs(FastxReader(open_maybe_compressed(path)))


@pytest.mark.parametrize("kind", ["fastq", "fasta", "fastq_crlf",
                                  "fasta_crlf"])
@pytest.mark.parametrize("codec", sorted(COMPRESS))
def test_reader_matches_jax_native_and_plain(tmp_path, jlib, codec, kind):
    rng = np.random.default_rng(len(codec) * 7 + len(kind))
    text = (_fastq if kind.startswith("fastq") else _fasta)(
        rng, 300, crlf=kind.endswith("crlf"))
    path = tmp_path / f"in.{codec}"
    path.write_bytes(COMPRESS[codec](text))
    got = _recs(FastxReader.from_path(path))
    assert got == _plain(path)
    assert got == _recs(jnl.NativeFastxReader(str(path)))
    assert len(got) == 300
    # the batch form: batches of 7 records, the last one short
    reader = FastxReader.from_path(path)
    batches = []
    while len(b := reader.read_batch(7)):
        batches.append(b)
    assert [len(b) for b in batches] == [7] * 42 + [6]
    assert _recs(r for b in batches for r in b.records()) == got


@pytest.mark.parametrize("codec", ["plain", "gz", "bgzf", "zst"])
def test_reader_from_stdin(tmp_path, codec):
    rng = np.random.default_rng(3)
    text = _fastq(rng, 200)
    path = tmp_path / "in"
    path.write_bytes(COMPRESS[codec](text))
    code = ("import sys\n"
            "from deacon_tpu_torch.io.fastx import FastxReader\n"
            "recs = list(FastxReader.from_path('-'))\n"
            "sys.stdout.buffer.write(b''.join(b'@%s\\n%s\\n+\\n%s\\n' % "
            "(r.id, r.seq, r.qual) for r in recs))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    with open(path, "rb") as stdin:
        proc = subprocess.run([sys.executable, "-c", code], stdin=stdin,
                              capture_output=True, cwd=REPO, env=env,
                              timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()
    assert proc.stdout == text


def test_blank_lines_at_batch_cuts(tmp_path, jlib):
    rng = np.random.default_rng(4)
    recs = [_fastq(rng, 1).replace(b"read_0", b"r%d" % i) for i in range(40)]
    text = b"".join(r + (b"\n\n" if i % 3 == 0 else b"") for i, r in
                    enumerate(recs))
    path = tmp_path / "blank.fq"
    path.write_bytes(text)
    want = _plain(path)
    assert len(want) == 40
    for size in (1, 2, 3, 5):
        reader = FastxReader.from_path(path)
        got = []
        while len(b := reader.read_batch(size)):
            got += b.records()
        assert _recs(got) == want
    assert _recs(jnl.NativeFastxReader(str(path))) == want


def _truncated(codec, text):
    full = COMPRESS[codec](text)
    return full[: len(full) // 2 - 7]


def _corrupt(codec, text):
    raw = bytearray(COMPRESS[codec](text))
    if codec == "gz":
        raw[-8] ^= 0xFF  # the trailer's CRC32
    else:
        raw[len(raw) // 3] ^= 0xFF  # a payload byte of a middle block
    return bytes(raw)


@pytest.mark.parametrize("case", [
    ("truncated", "gz"), ("truncated", "bgzf"), ("truncated", "zst"),
    ("truncated", "bz2"), ("corrupt", "gz"), ("corrupt", "bgzf"),
    ("truncated_record", "plain"), ("bad_marker", "plain"),
    ("bad_quality", "plain")])
def test_bad_streams_raise_the_same_error(tmp_path, jlib, case):
    what, codec = case
    rng = np.random.default_rng(5)
    text = _fastq(rng, 600)
    if what == "truncated":
        raw = _truncated(codec, text)
    elif what == "corrupt":
        raw = _corrupt(codec, text)
    elif what == "truncated_record":
        raw = text + b"@last\nACGT\n"
    elif what == "bad_marker":
        raw = b"%" + text
    else:
        raw = text + b"@bad\nACGT\n+\nIII\n"
    path = tmp_path / "bad"
    path.write_bytes(raw)
    with pytest.raises(FastxParseError):
        list(FastxReader.from_path(path))
    with pytest.raises(ValueError) as jax_err:
        list(jnl.NativeFastxReader(str(path)))
    assert type(jax_err.value).__name__ == "FastxParseError"
    with pytest.raises(Exception):
        _plain(path)


def test_batches_in_flight_keep_their_reads(tmp_path):
    rng = np.random.default_rng(6)
    path = tmp_path / "in.fq.gz"
    path.write_bytes(gzip.compress(_fastq(rng, 90)))
    want = _plain(path)
    reader = FastxReader.from_path(path)
    first = reader.read_batch(30)
    second = reader.read_batch(30)
    third = reader.read_batch(30)
    assert len(reader.read_batch(30)) == 0
    # the first batch is read after the third: its bytes are its own
    assert _recs(first.records()) == want[:30]
    assert _recs(second.records() + third.records()) == want[30:]
    assert first.arena.flags.owndata and first.meta.flags.owndata


def test_unknown_zstd_library_names_itself(tmp_path, monkeypatch):
    path = tmp_path / "in.zst"
    path.write_bytes(_zst(b"@r\nACGT\n+\nIIII\n"))
    monkeypatch.setattr(zstd, "LIBRARY", "libzstd-absent.so.9")
    with pytest.raises(OSError, match="libzstd-absent.so.9"):
        FastxReader.from_path(path)
    out = tmp_path / "out.fq.zst"
    with pytest.raises(OSError, match="libzstd-absent.so.9"):
        writers.get_writer(str(out), 3)
    assert not out.exists()


# ---------------------------------------------------------------------------
# Tile packer
# ---------------------------------------------------------------------------

_DIRTY = np.frombuffer(b"ACGTacgtNnRYSWKMBDHVryswkmbdhv-.X", np.uint8)


@pytest.mark.parametrize("code", ["filter", "index"])
@pytest.mark.parametrize("L,R", [(256, 64), (2048, 8), (384, 16)])
def test_pack_tile_matches_plain_and_jax(jlib, code, L, R):
    rng = np.random.default_rng(L + R)
    k, l = 31, 45
    lens = [0, L, L - 1, 1, 7, 8, 9] + [int(rng.integers(0, L + 1))
                                        for _ in range(R // 2)]
    seqs = [_rs(rng, n, _DIRTY) for n in lens[:R - 2]]  # two rows unused
    rows = [pack._Row(i, i % 2, 3 * i, s) for i, s in enumerate(seqs)]
    table = pack.PACK_CODE if code == "filter" else pack.INDEX_CODE
    got = pack.pack_rows_packed(rows, R, L, k, l, table)
    want = pack.pack_rows_packed_plain(rows, R, L, k, l, table)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # the JAX package packs the filter's code; the index build's codes are
    # those of the IUPAC-canonicalised bytes, validity that of the bytes
    canon = [bytes(mnp.IUPAC_CANON[np.frombuffer(s, np.uint8)])
             for s in seqs] if code == "index" else seqs
    jrows = [jeng._Row(i, i % 2, 3 * i, s) for i, s in enumerate(canon)]
    jc = jeng.pack_rows_packed(jrows, R, L, k, l)
    jv = jeng.pack_rows_packed(
        [jeng._Row(i, i % 2, 3 * i, s) for i, s in enumerate(seqs)],
        R, L, k, l)
    assert np.array_equal(got[0], np.asarray(jc[0]))
    assert np.array_equal(got[1], np.asarray(jv[1]))
    arena = np.frombuffer(b"".join(seqs), np.uint8)
    starts = np.concatenate([[0], np.cumsum([len(s) for s in seqs])[:-1]])
    if code == "filter":
        jn = jnl.native_pack_tile(arena, starts, np.array(lens[:R - 2]), R, L)
        assert np.array_equal(got[0], jn[0]) and np.array_equal(got[1], jn[1])
    assert not got[0][R - 2:].any() and not got[1][R - 2:].any()


def test_pack_tile_rejects_rows_outside_the_tile():
    arena = np.zeros(100, np.uint8)
    with pytest.raises(ValueError):
        nl.pack_tile(arena, np.array([0]), np.array([300]), 4, 256,
                     pack.PACK_CODE)
    with pytest.raises(ValueError):
        nl.pack_tile(arena, np.array([90]), np.array([20]), 4, 256,
                     pack.PACK_CODE)


# ---------------------------------------------------------------------------
# Index codec, store and sorted sets
# ---------------------------------------------------------------------------

_EDGES = [0, 1, 127, 128, 250, 251, 252, 16383, 16384, 0xFFFF, 0x10000,
          (1 << 21) - 1, 1 << 21, (1 << 28) - 1, 1 << 28, 0xFFFFFFFF,
          1 << 32, (1 << 35) - 1, 1 << 35, (1 << 49) - 1, 1 << 49,
          (1 << 56) - 1, 1 << 56, (1 << 63) - 1, 1 << 63, (1 << 64) - 1]


@pytest.mark.parametrize("case", ["edges", "small", "fixed9", "mixed_big"])
def test_varint_codec_matches_plain_and_jax(jlib, case):
    rng = np.random.default_rng(8)
    if case == "edges":
        vals = np.array(_EDGES, dtype=np.uint64)
    elif case == "small":
        vals = np.unique(rng.integers(0, 1 << 17, 5000, dtype=np.uint64))
    else:  # past FIXED9_MIN: the parallel paths, or their refusal
        n = nl.FIXED9_MIN + 1000
        vals = np.unique(rng.integers(1 << 32, 1 << 64, n, dtype=np.uint64,
                                      endpoint=False))
        if case == "mixed_big":
            vals[vals.size // 2] = 300  # one short record (not sorted)
    enc = nl.encode_u64_varint(vals)
    plain = np.frombuffer(bytes(bincode.encode_sorted_u64_array(np.sort(
        vals))), np.uint8)
    if case != "mixed_big":
        assert bytes(enc) == plain.tobytes()
    assert bytes(enc) == bytes(jnl.native_encode_u64_varint(vals))
    buf = np.concatenate([np.array([7, 7], np.uint8), enc, [9]])
    got, end = nl.decode_u64_varint(buf, 2, vals.size)
    assert np.array_equal(got, vals) and end == buf.size - 1
    jgot, jend = jnl.native_decode_u64_varint(buf, 2, vals.size)
    assert np.array_equal(jgot, vals) and jend == end
    pgot, pend = bincode.decode_u64_array(buf, 2, vals.size)
    assert np.array_equal(pgot, vals) and pend == end


@pytest.mark.parametrize("bad", [b"\xfe" + bytes(16), b"\xfd\x01\x02",
                                 b"\xfb\x01", b""])
def test_varint_decode_rejects_malformed(bad):
    with pytest.raises(ValueError):
        nl.decode_u64_varint(np.frombuffer(bad, np.uint8), 0, 1)


_SETS = {
    "empty_empty": ([], []),
    "empty_left": ([], [1, 5, 9]),
    "empty_right": ([2, 3], []),
    "disjoint": ([1, 3, 5], [2, 4, 6, 1 << 63]),
    "equal": ([4, 8, (1 << 64) - 1], [4, 8, (1 << 64) - 1]),
    "overlap": ([1, 2, 3, 10, 1 << 40], [2, 3, 4, 1 << 40, 1 << 41]),
}


@pytest.mark.parametrize("case", sorted(_SETS))
def test_merge_and_diff_match_numpy_and_jax(jlib, case):
    a, b = (np.array(x, dtype=np.uint64) for x in _SETS[case])
    union = nl.u64_merge_sorted_unique(a, b)
    assert np.array_equal(union, np.union1d(a, b).astype(np.uint64))
    assert np.array_equal(union, _merge_sorted_unique_plain(a, b))
    assert np.array_equal(union, jnl.native_u64_merge_sorted_unique(a, b))
    diff = nl.u64_diff_sorted_unique(a, b)
    assert np.array_equal(diff, np.setdiff1d(a, b).astype(np.uint64))
    assert np.array_equal(diff, jnl.native_u64_diff_sorted_unique(a, b))
    assert union.dtype == diff.dtype == np.uint64


def test_sort_unique_and_sorted_check():
    rng = np.random.default_rng(9)
    vals = rng.integers(0, 1000, 200_000, dtype=np.uint64)
    assert not nl.u64_sorted_unique(vals)
    got = nl.u64_sort_unique(vals.copy())
    assert np.array_equal(got, np.unique(vals))
    assert nl.u64_sorted_unique(got)


@pytest.mark.parametrize("scheme", [store.SCHEME_DXTP_FMIX32_V1, None])
@pytest.mark.parametrize("n", [0, 3, 70_000])
def test_index_store_matches_plain_and_jax(tmp_path, scheme, n):
    from deacon_tpu.index.store import IndexHeader as JaxHeader
    from deacon_tpu.index.store import write_index as jax_write_index

    rng = np.random.default_rng(n)
    keys = rng.integers(0, 1 << 64, n, dtype=np.uint64, endpoint=False)
    keys[: n // 10] %= 300  # some short records
    keys = np.concatenate([keys, keys[: n // 5]])  # duplicates, unsorted
    head = store.IndexHeader.new(31, 15)
    store.write_index(keys, head, tmp_path / "t.idx", scheme=scheme)
    store.write_index_plain(keys, head, tmp_path / "p.idx", scheme=scheme)
    jax_write_index(keys, JaxHeader.new(31, 15), tmp_path / "j.idx",
                    scheme=scheme)
    got = (tmp_path / "t.idx").read_bytes()
    assert got == (tmp_path / "p.idx").read_bytes()
    assert got == (tmp_path / "j.idx").read_bytes()
    idx = store.load_index(tmp_path / "t.idx")
    assert np.array_equal(idx.hashes, np.unique(keys))
    assert not list(tmp_path.glob("*.tmp*"))


def test_index_store_to_stdout(tmp_path):
    code = ("import numpy as np\n"
            "from deacon_tpu_torch.index import store\n"
            "print('no text before', flush=True)\n"
            "store.write_index(np.arange(1000, 5000, 7, dtype=np.uint64),\n"
            "                  store.IndexHeader.new(21, 11), '-')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()
    store.write_index_plain(np.arange(1000, 5000, 7, dtype=np.uint64),
                            store.IndexHeader.new(21, 11), tmp_path / "p")
    assert proc.stdout == b"no text before\n" + (tmp_path / "p").read_bytes()


# ---------------------------------------------------------------------------
# Writers and record formatting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ext,level", [("", 1), (".gz", 6), (".zst", 3),
                                       (".xz", 2)])
def test_writer_round_trip_matches_jax(tmp_path, jlib, ext, level):
    rng = np.random.default_rng(11)
    data = _fastq(rng, 400)
    out, jout = tmp_path / f"t.fq{ext}", tmp_path / f"j.fq{ext}"
    w = writers.get_writer(str(out), level)
    assert isinstance(w, nl.NativeWriter)
    w.write(data[:1000])
    w.write(np.frombuffer(data[1000:], np.uint8))
    w.finish()
    jw = jnl.NativeWriter(str(jout), writers.resolve_codec(str(out), level),
                          level)
    jw.write(data)
    jw.finish()
    assert out.read_bytes() == jout.read_bytes()
    with open_maybe_compressed(out) as f:
        assert f.read() == data
    pout = tmp_path / f"p.fq{ext}"  # the plain version, Python's codecs
    pw = writers.python_writer(str(pout), level)
    pw.write(data)
    pw.finish()
    with open_maybe_compressed(pout) as f:
        assert f.read() == data


@pytest.mark.parametrize("ext,level", [(".gz", 0), (".zst", 23), (".xz", 10)])
def test_writer_levels_are_checked(tmp_path, ext, level):
    with pytest.raises(writers.WriterError, match="compression level"):
        writers.get_writer(str(tmp_path / f"o{ext}"), level)
    assert not (tmp_path / f"o{ext}").exists()


#: the gzip writer's input block (kGzBlock in host.cpp)
_GZ_BLOCK = 1 << 20


def _fastq_of_size(seed, n):
    """2x150-like FASTQ of exactly n bytes (blank lines below a record)."""
    if n < 400:
        return b"\n" * n
    rng = np.random.default_rng(seed)
    m = n // 300 + 1
    seqs = _B[rng.integers(0, 4, (m, 150))]
    quals = np.frombuffer(b"#,:F", np.uint8)[
        rng.choice(4, (m, 150), p=[0.05, 0.05, 0.1, 0.8])]
    recs = [b"@r%d/1\n%s\n+\n%s\n" % (i, s.tobytes(), q.tobytes())
            for i, (s, q) in enumerate(zip(seqs, quals))]
    out, size = [], 0
    for r in recs:
        if size + len(r) > n:
            break
        out.append(r)
        size += len(r)
    last = out.pop()  # pad the last record's id to the size
    out.append(last[:2] + b"x" * (n - size) + last[2:])
    return b"".join(out)


def _write_straddling(w, data):
    """Writes of 1 byte, 777, a block less 5, over 3 blocks, 100 kB, ...:
    every size crosses block edges somewhere."""
    sizes = [1, 777, _GZ_BLOCK - 5, 3 * _GZ_BLOCK + 11, 100_000]
    i = k = 0
    while i < len(data):
        n = sizes[k % len(sizes)]
        w.write(data[i:i + n] if k % 2 else
                np.frombuffer(data[i:i + n], np.uint8))
        i += n
        k += 1


def _one_member(raw):
    d = zlib.decompressobj(31)
    out = d.decompress(raw)
    assert d.eof and d.unused_data == b"", "not exactly one gzip member"
    return out


def _threads():
    return len(os.listdir("/proc/self/task"))


@pytest.fixture
def tracing():
    """Tracing on with an empty registry; as it was again after."""
    was = trace.enabled()
    trace.reset()
    trace.enable()
    try:
        yield
    finally:
        if not was:
            trace.disable()
        trace.reset()


@pytest.mark.parametrize("ext", [".gz", ""])
@pytest.mark.parametrize("n", [0, 1, 5000, _GZ_BLOCK, _GZ_BLOCK + 1,
                               4 * _GZ_BLOCK + 12_345])
def test_writer_blocks_inflate_to_the_input(tmp_path, tracing, ext, n):
    data = _fastq_of_size(n, n)
    assert len(data) == n
    out = tmp_path / f"o.fq{ext}"
    w = writers.get_writer(str(out), 2)
    _write_straddling(w, data)
    w.finish()
    raw = out.read_bytes()
    c = trace.snapshot()["counters"]
    assert c["output.bytes_in"] == n and c["output.bytes_out"] == len(raw)
    if ext:
        assert _one_member(raw) == data
        assert gzip.decompress(raw) == data
        if n <= _GZ_BLOCK:  # one block: zlib's serial gzip stream
            z = zlib.compressobj(2, zlib.DEFLATED, 31)
            assert raw == z.compress(data) + z.flush()
        assert c["encode.blocks"] == max(1, -(-n // _GZ_BLOCK))
        assert c["encode.busy_ns"] > 0
    else:
        assert raw == data
        assert c["encode.blocks"] == c["encode.busy_ns"] == 0
        assert c["encode.full_wait_ns"] == 0
    plain = tmp_path / "p.fq"
    plain.write_bytes(data)
    assert (list(nl.NativeFastxReader(str(out)))
            == list(nl.NativeFastxReader(str(plain))))


@pytest.mark.parametrize("level", [1, 2, 6])
def test_gzip_writer_keeps_the_serial_ratio(tmp_path, level):
    data = _fastq_of_size(level, 5 * _GZ_BLOCK + 777)
    out = tmp_path / "o.fq.gz"
    w = nl.NativeWriter(str(out), 1, level)
    _write_straddling(w, data)
    w.finish()
    raw = out.read_bytes()
    assert _one_member(raw) == data
    z = zlib.compressobj(level, zlib.DEFLATED, 31)
    serial = len(z.compress(data) + z.flush())
    assert abs(len(raw) / serial - 1) < 0.005


def test_gzip_pair_writers_open_at_once(tmp_path):
    r1 = _fastq_of_size(1, 3 * _GZ_BLOCK + 4321)
    r2 = _fastq_of_size(2, 3 * _GZ_BLOCK + 8765)
    o1, o2 = tmp_path / "o1.fq.gz", tmp_path / "o2.fq.gz"
    w1 = writers.get_writer(str(o1), 2)
    w2 = writers.get_writer(str(o2), 6)  # one pool, two levels
    step = 300_001
    for i in range(0, max(len(r1), len(r2)), step):
        w1.write(r1[i:i + step])
        w2.write(r2[i:i + step])
    w1.finish()
    w2.finish()
    assert _one_member(o1.read_bytes()) == r1
    assert _one_member(o2.read_bytes()) == r2


@pytest.mark.parametrize("n", [5000, 6 * _GZ_BLOCK])
def test_gzip_writer_failure_raises_and_joins(n):
    data = _fastq_of_size(n, n)
    before = _threads()
    w = nl.NativeWriter("/dev/full", 1, 2)
    assert _threads() > before  # the output thread (and the pool's)
    with pytest.raises(OSError):
        try:
            for i in range(0, n, 65_536):
                w.write(data[i:i + 65_536])
        finally:
            w.finish()
    assert _threads() == before


def test_dropped_gzip_writer_joins_its_threads(tmp_path):
    before = _threads()
    w = nl.NativeWriter(str(tmp_path / "o.fq.gz"), 1, 2)
    w.write(_fastq_of_size(3, 2 * _GZ_BLOCK + 1))
    del w
    assert _threads() == before
    assert _one_member((tmp_path / "o.fq.gz").read_bytes())


@pytest.mark.parametrize("rename", [False, True])
@pytest.mark.parametrize("kind", ["fastq", "fasta", "mixed"])
def test_format_batch_matches_format_record(kind, rename):
    rng = np.random.default_rng(12)
    recs = []
    for i in range(30):
        s = _rs(rng, int(rng.integers(0, 50)))
        is_fq = kind == "fastq" or (kind == "mixed" and i % 2)
        recs.append(Record(b"id%d x" % i, s, b"#" * len(s) if is_fq else None,
                           is_fq))
    batch = RecordBatch.from_records(recs)
    idx = np.array([0, 3, 4, 9, 17, 29])
    numbers = np.arange(41, 41 + idx.size)
    got = writers.format_batch(batch, idx, numbers if rename else None)
    want = bytearray()
    for n, i in zip(numbers.tolist(), idx.tolist()):
        r = recs[i]
        writers.format_record(r.id, r.seq, r.qual, r.is_fastq, rename, n,
                              want)
    assert got.tobytes() == bytes(want)


# ---------------------------------------------------------------------------
# Host extraction
# ---------------------------------------------------------------------------

_ALPHABETS = [b"ACGT", b"ACGTacgt", b"ACGTNRYSWKMBDHVn", b"ACGT\nX-",
              b"AAAC"]


@pytest.mark.parametrize("k,w", [(15, 5), (31, 15), (56, 9)])
@pytest.mark.parametrize("alphabet", _ALPHABETS)
def test_filter_extraction_matches_oracle_and_jax(jlib, k, w, alphabet):
    rng = np.random.default_rng(k * 100 + len(alphabet))
    a = np.frombuffer(alphabet, np.uint8)
    seqs = [_rs(rng, int(rng.integers(0, 400)), a) for _ in range(60)]
    seqs += [_rs(rng, 20_000, _B), b"A" * 3000, b""]
    for prefix in (0, 70):
        got = host_extract.extract_filter_batch(seqs, prefix, k, w)
        want = host_extract.extract_filter_batch_plain(seqs, prefix, k, w)
        jax = jhx.extract_filter_batch(seqs, prefix, k, w)
        assert len(got) == len(want) == len(jax) == len(seqs)
        for g, p, j in zip(got, want, jax):
            for x, y, z in zip(g[:2], p[:2], j[:2]):
                assert np.array_equal(x, y) and np.array_equal(x, z)
            assert g[2] == p[2] == j[2]


@pytest.mark.parametrize("k,w,entropy,thp", [(15, 5, 0.0, "0"),
                                             (31, 15, 0.5, "1"),
                                             (57, 15, 0.0, "0"),
                                             (41, 15, 0.9, "0")])
def test_index_extraction_matches_oracle_and_jax(jlib, monkeypatch, k, w,
                                                 entropy, thp):
    # DEACON_THP=1: the output buffers get huge-page advice
    monkeypatch.setenv("DEACON_THP", thp)
    rng = np.random.default_rng(k + w)
    a = np.frombuffer(b"ACGTNRYacgtn", np.uint8)
    seqs = [_rs(rng, int(rng.integers(0, 3000)), a) for _ in range(20)]
    seqs.append(b"ACGT" * 2000)
    seqs.append(_rs(rng, 3_000_000))  # buffers past the 4 MB of the advice
    arena = np.frombuffer(b"".join(seqs), np.uint8)
    lens = np.array([len(s) for s in seqs], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    h, _, counts = nl.extract_batch(arena, starts, lens, k, w, True, entropy)
    jh, _, jcounts = jnl.native_extract_batch(arena, starts, lens, k, w, True,
                                              entropy)
    assert np.array_equal(h, jh) and np.array_equal(counts, jcounts)
    off = 0
    for s, c in zip(seqs, counts.tolist()):
        want = mnp.compute_minimizer_hashes(s, k, w, entropy)
        assert np.array_equal(h[off:off + c], want)
        off += c


def test_extraction_k_above_the_filter_limit_raises():
    with pytest.raises(ValueError, match="k<=56, but it is 57"):
        host_extract.extract_filter_batch([b"ACGT" * 30], 0, 57, 15)


# ---------------------------------------------------------------------------
# The binding
# ---------------------------------------------------------------------------

def test_binding_loads_the_ports_own_library():
    lib = nl.library()
    path = Path(lib._name).resolve()
    assert path == (REPO / "deacon_tpu_torch" / "_build" /
                    "libdeacon_host.so").resolve()
    code = ("from deacon_tpu_torch.io.fastx import FastxReader\n"
            "from deacon_tpu_torch.ops import pack\n"
            "pack.pack_rows_packed([pack._Row(0, 0, 0, b'ACGT')], 8, 256,"
            " 31, 45)\n"
            "maps = open('/proc/self/maps').read()\n"
            "print('libdeacon_host.so' in maps, 'libdeacon_io' in maps)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["True", "False"]


def test_plain_parser_is_not_the_jax_one():
    # the port's plain parser is its own copy (no import of deacon_tpu)
    assert FastxReader is not JaxPlainReader


# ---------------------------------------------------------------------------
# Row planning over a batch's arena
# ---------------------------------------------------------------------------

def _planned_batches(tiles, k, l, stride, max_len, seqs, paired, prefix):
    """The per-read planning the arena path replaces: rows_for_read per
    sequence, each unit to the first tile class holding its longest row,
    units filling batches of R rows in order."""
    per_tile = {}
    step = 2 if paired else 1
    for u in range(len(seqs) // step):
        rows = []
        for m in range(step):
            rows += pack.rows_for_read(u, m, seqs[u * step + m], prefix, k=k,
                                       l=l, stride=stride, max_len=max_len)
        if rows:
            longest = max(len(r.seq) for r in rows)
            tile = next((t for t in tiles if longest <= t[0]), tiles[-1])
            per_tile.setdefault(tile, []).append(rows)
    out = []
    for (L, R), groups in per_tile.items():
        batch, gids = [], []
        for rows in groups + [None]:
            if rows is None or (batch and len(batch) + len(rows) > R):
                if batch:
                    out.append((L, gids, [(r.mate, r.chunk_start, r.seq)
                                          for r in batch]))
                batch, gids = [], []
            if rows is not None:
                batch += rows
                gids.append(rows[0].rid)
    return out


@pytest.mark.parametrize("tiles", [((256, 8), (2048, 4), (4096, 2)),
                                   ((2048, 3), (256, 5), (4096, 1))])
@pytest.mark.parametrize("paired,prefix", [(False, 0), (True, 0),
                                           (False, 300)])
def test_launch_planning_matches_per_read_rows(tiles, paired, prefix):
    from deacon_tpu_torch.ops.engine import DevicePipeline

    rng = np.random.default_rng(len(tiles[0]) + prefix + paired)
    n_seqs = 60
    seqs = [_rs(rng, int(rng.choice([10, 40, 200, 1500, 3000, 9000])))
            for _ in range(n_seqs)]
    seqs[5] = seqs[5][:-1] + b"\n"  # a trailing newline is stripped
    keys = np.arange(1, 100, dtype=np.uint64)
    pipe = DevicePipeline(keys, 31, 15, tiles=tiles, device="cpu")
    seen = []
    launch = pipe._launch_batch

    def spy(rows, L, n_units, budget):
        seen.append((L, rows))
        return launch(rows, L, n_units, budget)

    pipe._launch_batch = spy
    arena, start, length = pack.join_seqs(seqs)
    unit = np.arange(n_seqs) // (2 if paired else 1)
    mate = np.arange(n_seqs) % (2 if paired else 1)
    resolve = pipe.launch_counts(arena, start, length, unit, mate,
                                 n_seqs // (2 if paired else 1), prefix)
    resolve()
    want = _planned_batches(pipe.tiles, 31, pipe.l, pipe._stride,
                            pipe.L_max, seqs, paired, prefix)
    assert len(seen) == len(want) > 3
    for (L, block), (wL, gids, rows) in zip(seen, want):
        assert L == wL and len(block) == len(rows)
        got = [(int(m), int(c), block.arena[s:s + n].tobytes())
               for m, c, s, n in zip(block.mate, block.cstart, block.start,
                                     block.length)]
        assert got == rows
        assert sorted(set(block.rid.tolist())) == list(range(len(gids)))
