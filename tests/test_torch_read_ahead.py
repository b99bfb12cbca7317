"""The filter's read-ahead (deacon_tpu_torch/filter/engine._read_batches):
the batches a thread reads ahead of the loop are the batches, bytes and
order that reading the same readers serially gives, for plain, gzip,
paired, byte-range and BGZF-range input at batch sizes 1, 7 and 10,000;
a read error comes after the batches before it; closing the generator
stops and joins the thread and closes an input pipe at once; and with
tracing on the read-ahead's counters account for every batch."""

import gzip
import os
import threading
import time

import numpy as np
import pytest

from deacon_tpu_torch.config import FilterConfig
from deacon_tpu_torch.filter import engine
from deacon_tpu_torch.io import split
from deacon_tpu_torch.io.fastx import FastxParseError, FastxReader, RecordBatch
from deacon_tpu_torch.io.native_loader import NativeFastxReader
from deacon_tpu_torch.utils import trace

from helpers import bgzf_compress

_B = np.frombuffer(b"ACGT", np.uint8)
#: records of the generated files: two batches at the largest batch size
N_RECORDS = 10_007
BATCH_SIZES = (1, 7, 10_000)
#: seconds any one blocking case may take
LIMIT_S = 60.0


def _fastq(n: int, seed: int, prefix: str = "r") -> bytes:
    rng = np.random.default_rng(seed)
    lens = rng.integers(20, 90, n)
    seqs = _B[rng.integers(0, 4, int(lens.sum()))].tobytes()
    out, at = [], 0
    for i, n_bp in enumerate(lens.tolist()):
        seq = seqs[at:at + n_bp]
        at += n_bp
        out.append(b"@%s%d x=%d\n%s\n+\n%s\n" % (
            prefix.encode(), i, n_bp, seq, b"I" * n_bp))
    return b"".join(out)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("read_ahead")
    r1 = _fastq(N_RECORDS, 1, "a")
    (d / "r1.fq").write_bytes(r1)
    (d / "r2.fq").write_bytes(_fastq(N_RECORDS - 1_007, 2, "b"))
    (d / "r1.fq.gz").write_bytes(gzip.compress(r1, compresslevel=1))
    (d / "r1.bgzf.fq.gz").write_bytes(bgzf_compress(r1, block=30_000))
    return d


def _cfg(size: int, input_path, input2_path=None) -> FilterConfig:
    return FilterConfig(minimizers_path=None, input_path=str(input_path),
                        input2_path=None if input2_path is None
                        else str(input2_path), batch_size=size)


#: case -> (input type, function of the files' directory giving the
#: config's inputs and the byte range)
CASES = {
    "single": ("single", lambda d: ((d / "r1.fq",), None)),
    "paired_unequal": ("paired", lambda d: ((d / "r1.fq", d / "r2.fq"),
                                             None)),
    "gzip": ("single", lambda d: ((d / "r1.fq.gz",), None)),
    "plain_range": ("single", lambda d: (
        (d / "r1.fq",), split.split_fastx_ranges(d / "r1.fq", 3)[1])),
    "bgzf_range": ("single", lambda d: (
        (d / "r1.bgzf.fq.gz",),
        split.split_bgzf_ranges(d / "r1.bgzf.fq.gz", 3)[1])),
}


def _serial(cfg: FilterConfig, input_type: str, byte_range) -> list:
    """The batches of the same readers read one after another on the
    caller's thread, as the loop read them before the read-ahead."""
    size = cfg.batch_size
    br1, br2 = engine._split_byte_range(byte_range)
    r1 = FastxReader.from_path(cfg.input_path, byte_range=br1)
    out = []
    try:
        if input_type == "single":
            while len(b := r1.read_batch(size)):
                out.append(b)
            return out
        r2 = FastxReader.from_path(cfg.input2_path, byte_range=br2)
        try:
            while len(b1 := r1.read_batch(size)):
                b2 = r2.read_batch(len(b1))
                if len(b2):
                    out.append(RecordBatch.interleave(b1.head(len(b2)), b2))
                if len(b2) < len(b1):
                    break
        finally:
            r2.close()
        return out
    finally:
        r1.close()


def _read_ahead_threads() -> set:
    return {t for t in threading.enumerate()
            if t.name == engine.READ_AHEAD_THREAD}


@pytest.fixture
def started():
    """A function giving the read-ahead threads alive now that were not
    alive as the test began."""
    before = _read_ahead_threads()
    return lambda: _read_ahead_threads() - before


def _bounded(fn, *args, limit: float = LIMIT_S):
    """``fn(*args)`` on a thread of its own, failing the test if it has
    not returned within ``limit`` seconds; returns what it returned and
    raises what it raised."""
    out: dict = {}

    def run():
        try:
            out["value"] = fn(*args)
        except BaseException as e:  # handed to the test's thread
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(limit)
    assert not t.is_alive(), f"still running after {limit} s"
    if "error" in out:
        raise out["error"]
    return out.get("value")


def _case(files, case, size):
    input_type, make = CASES[case]
    inputs, byte_range = make(files)
    return _cfg(size, *inputs), input_type, byte_range


@pytest.mark.parametrize("size", BATCH_SIZES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_read_ahead_yields_the_serial_batches(files, case, size, started):
    cfg, input_type, byte_range = _case(files, case, size)
    want = _serial(cfg, input_type, byte_range)
    got = _bounded(lambda: list(engine._read_batches(cfg, input_type,
                                                     byte_range)))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert np.array_equal(g.meta, w.meta)
        assert g.arena.tobytes() == w.arena.tobytes()
    if case == "paired_unequal":  # stops at the shorter file
        assert sum(map(len, got)) == 2 * (N_RECORDS - 1_007)
    assert not started()


def test_read_ahead_batches_stay_valid_while_later_ones_are_read(files):
    cfg = _cfg(7, files / "r1.fq")
    batches = engine._read_batches(cfg, "single")
    first = next(batches)
    meta, arena = first.meta.copy(), first.arena.copy()
    later = [next(batches) for _ in range(20)]
    assert np.array_equal(first.meta, meta)
    assert np.array_equal(first.arena, arena)
    assert all(b.arena is not first.arena for b in later)
    batches.close()


def _bad_fastq(n: int, bad: int) -> bytes:
    """n records, record ``bad`` with a quality shorter than its bases."""
    recs = [b"@q%d\nACGTACGTAC\n+\n%s\n" % (i, b"I" * (4 if i == bad else 10))
            for i in range(n)]
    return b"".join(recs)


@pytest.mark.parametrize("where", ["single", "paired_r1", "paired_r2"])
def test_a_parse_error_in_the_third_batch_comes_after_two_batches(
        tmp_path, where, started):
    good = tmp_path / "good.fq"
    bad = tmp_path / "bad.fq"
    good.write_bytes(_bad_fastq(20, -1))
    bad.write_bytes(_bad_fastq(20, 9))  # in records 8-11: the third batch
    if where == "single":
        cfg, input_type = _cfg(4, bad), "single"
    elif where == "paired_r1":
        cfg, input_type = _cfg(4, bad, good), "paired"
    else:
        cfg, input_type = _cfg(4, good, bad), "paired"

    def read():
        got = []
        with pytest.raises(FastxParseError, match="Quality length"):
            for batch in engine._read_batches(cfg, input_type):
                got.append(batch)
        return got

    got = _bounded(read)
    per = 1 if input_type == "single" else 2
    assert [len(b) for b in got] == [4 * per, 4 * per]
    assert not started()


@pytest.mark.parametrize("size", [1, 3])
def test_an_odd_interleaved_count_raises_after_the_batches_before_it(
        tmp_path, monkeypatch, size, started):
    path = tmp_path / "inter.fq"
    path.write_bytes(_bad_fastq(13, -1))
    # the interleaved stream is stdin: read the file in its place
    monkeypatch.setattr(engine.FastxReader, "from_path", staticmethod(
        lambda p, byte_range=None: NativeFastxReader(
            path if str(p) == "-" else p, byte_range=byte_range)))
    cfg = _cfg(size, "-", "-")

    def read():
        got = []
        with pytest.raises(ValueError) as err:
            for batch in engine._read_batches(cfg, "interleaved"):
                got.append(batch)
        return got, str(err.value)

    got, message = _bounded(read)
    assert message == ("Uneven number of interleaved sequence pairs. "
                       "Found 13 records.")
    assert sum(map(len, got)) == 12
    assert all(len(b) == 2 * size for b in got)
    assert not started()


@pytest.mark.parametrize("missing", ["single", "paired_r1", "paired_r2"])
def test_a_missing_input_raises_oserror_at_the_first_next(
        files, tmp_path, missing, started):
    gone = tmp_path / "missing.fq"
    cfg = {"single": _cfg(7, gone),
           "paired_r1": _cfg(7, gone, files / "r2.fq"),
           "paired_r2": _cfg(7, files / "r1.fq", gone)}[missing]
    batches = engine._read_batches(
        cfg, "single" if missing == "single" else "paired")
    with pytest.raises(OSError, match="missing.fq"):
        _bounded(next, batches)
    assert not started()


class _EndlessFeed:
    """A thread writing FASTQ records into a named pipe until its reader
    closes it (then ``broken`` is set) or ``stop`` is set."""

    def __init__(self, path, seed: int):
        os.mkfifo(path)
        self.path = path
        self.body = _fastq(2_000, seed)
        self.broken = threading.Event()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._feed, daemon=True)
        self.thread.start()

    def _feed(self):
        fd = os.open(self.path, os.O_WRONLY)
        try:
            while not self.stop.is_set():
                os.write(fd, self.body)
        except BrokenPipeError:
            self.broken.set()
        finally:
            os.close(fd)

    def end(self):
        """Unblock a feed whose reader never opened or drained the pipe."""
        self.stop.set()
        while self.thread.is_alive():
            fd = os.open(self.path, os.O_RDONLY | os.O_NONBLOCK)
            try:
                while os.read(fd, 1 << 20):
                    pass
            except BlockingIOError:
                pass
            finally:
                os.close(fd)
            self.thread.join(0.05)


@pytest.mark.parametrize("input_type", ["single", "paired"])
def test_closing_mid_stream_on_a_pipe_returns_at_once(tmp_path, input_type,
                                                       started):
    feeds = [_EndlessFeed(tmp_path / f"in{i}.fq", i)
             for i in range(1 if input_type == "single" else 2)]
    cfg = _cfg(100, *(f.path for f in feeds))
    try:
        batches = engine._read_batches(cfg, input_type)
        first = _bounded(next, batches)
        assert len(first) == (100 if input_type == "single" else 200)
        time.sleep(0.2)  # the thread fills its queue and waits for room
        t0 = time.perf_counter()
        _bounded(batches.close)
        assert time.perf_counter() - t0 < 1.0
        assert not started()
        for f in feeds:
            assert f.broken.wait(LIMIT_S)
    finally:
        for f in feeds:
            f.end()


@pytest.fixture
def tracing():
    was = trace.enabled()
    trace.reset()
    trace.enable()
    try:
        yield
    finally:
        if not was:
            trace.disable()
        trace.reset()


@pytest.mark.parametrize("size", BATCH_SIZES)
@pytest.mark.parametrize("case", ["single", "paired_unequal", "gzip"])
def test_traced_counters_account_for_every_batch(files, tracing, case, size):
    cfg, input_type, byte_range = _case(files, case, size)
    got = _bounded(lambda: list(engine._read_batches(cfg, input_type,
                                                     byte_range)))
    snap = trace.snapshot()
    c = snap["counters"]
    assert set(engine.AHEAD_COUNTERS) <= set(c)
    assert c["reader.ahead_ready"] + c["reader.ahead_waits"] == len(got)
    assert (c["reader.ahead_wait_ns"] > 0) == (c["reader.ahead_waits"] > 0)
    # the read-ahead thread's spans sit under the reader layer
    assert set(snap["spans"]["reader.parse"]) == {"reader"}


@pytest.mark.parametrize("case", ["single", "paired_unequal"])
def test_untraced_read_ahead_records_no_counter(files, case):
    was = trace.enabled()
    trace.disable()
    trace.reset()
    try:
        cfg, input_type, byte_range = _case(files, case, 7)
        assert _bounded(lambda: len(list(engine._read_batches(
            cfg, input_type, byte_range)))) > 0
        snap = trace.snapshot()
    finally:
        if was:
            trace.enable()
    assert not set(engine.AHEAD_COUNTERS) & set(snap["counters"])
    assert not snap["spans"]


def test_read_ahead_paces_to_a_slow_loop(files, tracing, monkeypatch):
    """A loop slower than the reader finds each batch ready (after the
    first) and the thread waits for room: beyond the batches the loop
    has taken it holds READ_AHEAD_BATCHES queued and one in hand."""
    cfg = _cfg(1_000, files / "r1.fq")
    produced = []
    assembled = engine._assembled_batches

    def counted(*args):
        for batch in assembled(*args):
            produced.append(len(batch))
            yield batch

    monkeypatch.setattr(engine, "_assembled_batches", counted)

    def read():
        n = ahead = 0
        for _ in engine._read_batches(cfg, "single"):
            n += 1
            time.sleep(0.05)
            ahead = max(ahead, len(produced) - n)
        return n, ahead

    n, ahead = _bounded(read)
    c = trace.snapshot()["counters"]
    assert n == 11
    assert ahead == engine.READ_AHEAD_BATCHES + 1
    assert c["reader.ahead_ready"] >= n - 2
    assert c["reader.ahead_full_ns"] > 0
