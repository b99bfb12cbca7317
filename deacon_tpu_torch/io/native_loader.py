"""ctypes binding of the port's host library, ``io/native/host.cpp``.

The library is required: the reader, the writers, the tile packer, the
index codec, the sorted-set merges and the client's extraction all run
through it, on the card's host and on the CPU alike, and nothing falls
back to the plain versions (io/fastx.FastxReader, ops/pack.
pack_rows_packed_plain, utils/bincode, ops/minimizers_np), which only
the tests and chip_smoke.py's parity checks call.

``g++`` builds it at first use into ``_build/libdeacon_host.so`` inside
the package (git-ignored), and again whenever a hash of the source and
flags changes; a file lock lets one process compile while the others
wait, and the library appears under its name only when complete
(``os.replace``). A failed build raises NativeBuildError with the
compiler's output. Nothing here runs at import time.

The host engine of ``--device host`` is bound here too: the probe table
(NativeProbe) with its ``<index>.probe`` sidecar, the whole filter
pipeline (native_filter_run), and the index build's accumulators
(NativeRunAcc, NativeCountingSet).

Thread contract: ctypes releases the GIL for every call. A reader or a
writer handle is used by one thread at a time; distinct handles, and
every stateless function (packing, codec, merges, extraction), may run
concurrently; so may queries of one NativeProbe. The filter loop's
readers are opened on the loop's thread and then owned by the read-ahead
thread of filter/engine._read_batches, which alone reads them; they are
closed on the loop's thread once that thread has been joined.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from ..utils import trace
from . import zstd
from .fastx import FastxParseError, Record, RecordBatch

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG / "io" / "native" / "host.cpp"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libdeacon_host.so"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared")
LIBS = ("-lz", "-ldl")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: wall seconds of this process's build of the library, None if it found
#: an up-to-date one
build_seconds: float | None = None


class NativeBuildError(RuntimeError):
    """g++ failed to build the host library; the message holds its
    command and output."""


def _digest(src: Path) -> str:
    h = hashlib.sha256(" ".join((*CXX_FLAGS, *LIBS)).encode())
    h.update(src.read_bytes())
    return h.hexdigest()


def build(src: Path | None = None,
          build_dir: Path | None = None) -> float | None:
    """Compile ``src`` (default SRC) into ``build_dir`` (default BUILD_DIR)
    as libdeacon_host.so unless an up-to-date library is there. Returns
    the build's wall seconds, or None when the existing library was kept.
    Raises NativeBuildError."""
    src = SRC if src is None else src
    build_dir = BUILD_DIR if build_dir is None else build_dir
    build_dir.mkdir(parents=True, exist_ok=True)
    lib_path = build_dir / LIB_NAME
    stamp = build_dir / "libdeacon_host.sha256"
    digest = _digest(src)
    with open(build_dir / ".host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
            return None
        tmp = build_dir / f"libdeacon_host.{os.getpid()}.tmp.so"
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(src), *LIBS]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
        except FileNotFoundError as e:
            raise NativeBuildError(
                f"g++ not found ({e}): deacon_tpu_torch builds its host "
                "library with g++ at first use") from None
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise NativeBuildError(
                f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}")
        os.replace(tmp, lib_path)
        stamp.write_text(digest)
    print(f"deacon_tpu_torch: g++ built {LIB_NAME} in {seconds:.2f} s",
          file=sys.stderr)
    return seconds


def library() -> ctypes.CDLL:
    """The loaded host library, built first if needed."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            build_seconds = build()
            _lib = _bind(ctypes.CDLL(str(BUILD_DIR / LIB_NAME)))
    return _lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
    sig = {
        "dx_open": (vp, [ctypes.c_char_p, ctypes.c_char_p]),
        "dx_open_range": (vp, [ctypes.c_char_p, i64, i64, i64]),
        "dx_records_at_offsets": (ctypes.c_int, [ctypes.c_char_p, vp, i64,
                                                 ctypes.c_int, vp]),
        "dx_offsets_at_records": (ctypes.c_int, [ctypes.c_char_p, vp, i64,
                                                 ctypes.c_int, vp]),
        "dx_open_error": (ctypes.c_char_p, []),
        "dx_close": (None, [vp]),
        "dx_is_fastq": (ctypes.c_int, [vp]),
        "dx_error": (ctypes.c_char_p, [vp]),
        "dx_next_batch_view": (i64, [vp, i64, i64, vp, vp, vp]),
        "dx_reader_stats": (None, [vp, vp]),
        "dx_writer_stats": (None, [vp, vp]),
        "dx_writer_open": (vp, [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_char_p]),
        "dx_writer_write": (ctypes.c_int, [vp, vp, i64]),
        "dx_writer_close": (ctypes.c_int, [vp]),
        "dx_pack_tile": (None, [vp, vp, vp, i64, i64, i64, vp, vp, vp]),
        "dx_gather": (None, [vp, vp, i64, vp]),
        "dx_decode_u64_varint": (i64, [vp, i64, i64, vp]),
        "dx_decode_u64_fixed9": (i64, [vp, i64, i64, vp, i32]),
        "dx_encode_u64_varint": (i64, [vp, i64, vp]),
        "dx_encode_u64_fixed9": (i64, [vp, i64, vp, i32]),
        "dx_u64_merge_sorted_unique": (i64, [vp, i64, vp, i64, vp]),
        "dx_u64_diff_sorted_unique": (i64, [vp, i64, vp, i64, vp]),
        "dx_u64_sorted_unique": (ctypes.c_int, [vp, i64]),
        "dx_u64_sort_unique": (i64, [vp, i64, i32]),
        "dx_index_write_sorted": (ctypes.c_int, [
            vp, i64, ctypes.c_char_p, i32, i32, i32, ctypes.c_char_p, i64,
            i32, ctypes.c_char_p, i64]),
        "dx_extract_batch": (i64, [
            vp, vp, vp, i64, i32, i32, i32, ctypes.c_float, vp, vp, vp, i64,
            i32]),
        "dx_deflate_raw": (i64, [vp, i64, vp, i64]),
        "dx_inflate_raw": (ctypes.c_int, [vp, i64, vp, i64]),
        "dx_runacc_new": (vp, [i64]),
        "dx_runacc_free": (None, [vp]),
        "dx_runacc_add": (None, [vp, vp, i64]),
        "dx_runacc_finish_write": (i64, [
            vp, ctypes.c_char_p, i32, i32, i32, ctypes.c_char_p, i64, i32,
            ctypes.c_char_p, i64]),
        "dx_runacc_unique_count": (i64, [vp]),
        "dx_runacc_export_sorted": (None, [vp, vp]),
        "dx_cset_new": (vp, [i64]),
        "dx_cset_free": (None, [vp]),
        "dx_cset_size": (i64, [vp]),
        "dx_cset_insert": (i64, [vp, vp, i64, i32]),
        "dx_cset_export_sorted": (i64, [vp, vp, i32]),
        "dx_probe_build": (vp, [vp, i64]),
        "dx_probe_save": (ctypes.c_int, [vp, ctypes.c_char_p, i64, i64,
                                         i64]),
        "dx_probe_load": (vp, [ctypes.c_char_p, i64, i64, i64]),
        "dx_probe_free": (None, [vp]),
        "dx_probe_query": (None, [vp, vp, i64, vp]),
        "dx_filter_run": (ctypes.c_int, [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, vp, i32, i32, i64, i64, ctypes.c_double, i32, i32,
            i32, vp, ctypes.c_char_p, i64, i64, i64, i64, i64,
            ctypes.c_char_p]),
    }
    for name, (res, args) in sig.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _threads(n_threads: int) -> int:
    return n_threads if n_threads > 0 else (os.cpu_count() or 1)


_MADV_HUGEPAGE = 14  # linux


def empty_huge(n: int, dtype) -> np.ndarray:
    """np.empty, with MADV_HUGEPAGE advice on buffers of 4 MB and more
    when DEACON_THP=1 (2 MB pages cut first-touch page faults on
    GB-scale scratch; the advice is opt-in because compaction can cost
    more than it saves)."""
    arr = np.empty(n, dtype=dtype)
    if arr.nbytes >= (4 << 20) and os.environ.get("DEACON_THP") == "1":
        libc = ctypes.CDLL(None, use_errno=True)
        base = arr.ctypes.data & ~0xFFF
        libc.madvise(ctypes.c_void_p(base),
                     ctypes.c_size_t(arr.nbytes + arr.ctypes.data - base),
                     _MADV_HUGEPAGE)
    return arr


# ---------------------------------------------------------------------------
# Tile packing, extraction
# ---------------------------------------------------------------------------

def pack_tile(arena: np.ndarray, starts: np.ndarray, lens: np.ndarray,
              R: int, L: int, code_table: np.ndarray):
    """Row slices ``arena[starts[i]:starts[i] + lens[i]]`` -> the tile's
    (R, L/4) 2-bit code plane (codes from the 256-entry ``code_table``)
    and (R, L/8) validity plane; rows past len(lens) are zero."""
    arena = np.ascontiguousarray(arena, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    table = np.ascontiguousarray(code_table, dtype=np.uint8)
    n = lens.size
    if L % 8 or n > R or starts.size != n or table.size != 256:
        raise ValueError(f"pack_tile: bad shapes (n={n}, R={R}, L={L})")
    if n and (lens.min() < 0 or lens.max() > L or starts.min() < 0
              or int((starts + lens).max()) > arena.size):
        raise ValueError("pack_tile: a row lies outside the arena or tile")
    codes4 = np.empty((R, L // 4), dtype=np.uint8)
    valid8 = np.empty((R, L // 8), dtype=np.uint8)
    library().dx_pack_tile(_ptr(arena), _ptr(starts), _ptr(lens), n, R, L,
                           _ptr(table), _ptr(codes4), _ptr(valid8))
    return codes4, valid8


def gather(addrs: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The byte ranges at addresses ``addrs`` of lengths ``lens``,
    concatenated. The caller keeps the memory they lie in alive and
    valid."""
    addrs = np.ascontiguousarray(addrs, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    if addrs.size != lens.size or (lens.size and lens.min() < 0):
        raise ValueError("gather: bad ranges")
    out = np.empty(int(lens.sum()), dtype=np.uint8)
    library().dx_gather(_ptr(addrs), _ptr(lens), lens.size, _ptr(out))
    return out


def extract_batch(arena: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                  k: int, w: int, index_mode: bool,
                  entropy_threshold: float = 0.0, n_threads: int = 0,
                  scratch: dict | None = None):
    """Minimizers of every sequence ``arena[starts[i]:starts[i] +
    lens[i]]``, bit-identical to the NumPy oracle (ops/minimizers_np;
    filter side, or index side with IUPAC canonicalisation and the
    entropy filter). Returns (hashes u64, positions u32, counts i64).
    ``scratch``: a dict the caller keeps to reuse the output buffers
    across calls (the results are then views of them, valid until the
    next call with the same dict)."""
    arena = np.ascontiguousarray(arena, dtype=np.uint8)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    n = lens.size
    if n and (lens.min() < 0 or starts.min() < 0
              or int((starts + lens).max()) > arena.size):
        raise ValueError("extract_batch: a sequence lies outside the arena")
    counts = np.empty(n, dtype=np.int64)
    # ~2m/(w+1) expected; start with a margin and double on overflow
    cap = max(1024, int(lens.sum()) * 2 // (w + 1) + 64 * n)
    lib = library()
    while True:
        if scratch is None:
            hashes = empty_huge(cap, np.uint64)
            pos = empty_huge(cap, np.uint32)
        else:
            if scratch.get("hashes") is None or scratch["hashes"].size < cap:
                scratch["hashes"] = empty_huge(cap, np.uint64)
                scratch["pos"] = empty_huge(cap, np.uint32)
            hashes, pos = scratch["hashes"], scratch["pos"]
            cap = hashes.size
        total = lib.dx_extract_batch(
            _ptr(arena), _ptr(starts), _ptr(lens), n, k, w,
            1 if index_mode else 0, ctypes.c_float(entropy_threshold),
            _ptr(hashes), _ptr(pos), _ptr(counts), cap, _threads(n_threads))
        if total >= 0:
            return hashes[:total], pos[:total], counts
        cap *= 2


# ---------------------------------------------------------------------------
# Index codec and sorted sets
# ---------------------------------------------------------------------------

#: key counts from which decode tries the parallel fixed 9-byte layout
FIXED9_MIN = 1_000_000


def decode_u64_varint(buf: np.ndarray, offset: int, count: int):
    """``count`` bincode varint u64s from ``buf[offset:]`` -> (values,
    new offset). From FIXED9_MIN keys the parallel decoder of the
    all-9-byte layout (a real index's) runs first; any shorter record
    sends the whole array to the sequential decoder. Raises ValueError on
    truncated or malformed input."""
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    if not 0 <= offset <= buf.size or count < 0:
        raise ValueError("Truncated or malformed bincode u64 stream")
    out = empty_huge(count, np.uint64)
    lib = library()
    base, avail = buf.ctypes.data + offset, buf.size - offset
    if count >= FIXED9_MIN:
        used = lib.dx_decode_u64_fixed9(base, avail, count, _ptr(out),
                                        _threads(0))
        if used >= 0:
            return out, offset + int(used)
    used = lib.dx_decode_u64_varint(base, avail, count, _ptr(out))
    if used < 0:
        raise ValueError("Truncated or malformed bincode u64 stream")
    return out, offset + int(used)


def encode_u64_varint(vals: np.ndarray) -> np.ndarray:
    """bincode varint encoding of a u64 array, as a uint8 array; the
    parallel encoder when every value takes 9 bytes (from FIXED9_MIN
    keys)."""
    vals = np.ascontiguousarray(vals, dtype=np.uint64)
    out = empty_huge(vals.size * 9, np.uint8)
    lib = library()
    if vals.size >= FIXED9_MIN and int(vals.min()) > 0xFFFFFFFF:
        n = lib.dx_encode_u64_fixed9(_ptr(vals), vals.size, _ptr(out),
                                     _threads(0))
    else:
        n = lib.dx_encode_u64_varint(_ptr(vals), vals.size, _ptr(out))
    return out[:n]


def index_write_sorted(keys: np.ndarray, path: str, format_version: int,
                       k: int, w: int, trailer: bytes) -> None:
    """Write an index stream (header, count, varint keys, trailer) from
    sorted-unique keys to ``path`` ("-" = stdout): parallel chunk encode,
    sequential write. Raises OSError."""
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    err = ctypes.create_string_buffer(256)
    rc = library().dx_index_write_sorted(
        _ptr(keys), keys.size, str(path).encode(), format_version, k, w,
        trailer, len(trailer), _threads(0), err, len(err))
    if rc != 0:
        raise OSError(err.value.decode("utf-8", "replace")
                      or "index write failed")


def _sorted_pair(a, b):
    return (np.ascontiguousarray(a, dtype=np.uint64),
            np.ascontiguousarray(b, dtype=np.uint64))


def u64_merge_sorted_unique(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Union of two sorted-unique u64 arrays, one linear pass."""
    a, b = _sorted_pair(a, b)
    out = np.empty(a.size + b.size, dtype=np.uint64)
    n = library().dx_u64_merge_sorted_unique(_ptr(a), a.size, _ptr(b),
                                             b.size, _ptr(out))
    # a slice would pin the whole a+b buffer: copy once overlap halves it
    return out[:n].copy() if n < out.size // 2 else out[:n]


def u64_diff_sorted_unique(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """A minus B for sorted-unique u64 arrays, one linear pass."""
    a, b = _sorted_pair(a, b)
    out = np.empty(a.size, dtype=np.uint64)
    n = library().dx_u64_diff_sorted_unique(_ptr(a), a.size, _ptr(b),
                                            b.size, _ptr(out))
    return out[:n].copy() if n < out.size // 2 else out[:n]


def u64_sorted_unique(vals: np.ndarray) -> bool:
    """Whether a u64 array is strictly increasing."""
    vals = np.ascontiguousarray(vals, dtype=np.uint64)
    return bool(library().dx_u64_sorted_unique(_ptr(vals), vals.size))


def u64_sort_unique(vals: np.ndarray) -> np.ndarray:
    """Sort and deduplicate a u64 array in place (parallel); returns the
    sorted unique prefix, a view of ``vals``."""
    if vals.dtype != np.uint64 or not vals.flags.c_contiguous \
            or not vals.flags.writeable:
        raise ValueError("u64_sort_unique needs a writeable contiguous "
                         "uint64 array")
    n = library().dx_u64_sort_unique(_ptr(vals), vals.size, _threads(0))
    return vals[:n]


def records_at_offsets(path, offsets, is_fastq: bool) -> list[int]:
    """The record index at each byte offset of a plain FASTX file (offsets
    ascending, each a record start or the file size), by one scan. Raises
    ValueError when an offset is not a FASTQ record boundary, OSError when
    the file cannot be read."""
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    out = np.empty(offs.size, dtype=np.int64)
    rc = library().dx_records_at_offsets(os.fsencode(path), _ptr(offs),
                                         offs.size, int(is_fastq), _ptr(out))
    if rc == -2:
        raise ValueError("offset is not a FASTQ record boundary (records "
                         "must be exactly 4 lines)")
    if rc != 0:
        raise OSError(f"cannot scan {path}")
    return out.tolist()


def offsets_at_records(path, records, is_fastq: bool) -> list[int]:
    """The byte offset where each record index starts in a plain FASTX
    file (ascending; the file size past its last record), by one scan.
    Raises OSError when the file cannot be read."""
    recs = np.ascontiguousarray(records, dtype=np.int64)
    out = np.empty(recs.size, dtype=np.int64)
    rc = library().dx_offsets_at_records(os.fsencode(path), _ptr(recs),
                                         recs.size, int(is_fastq), _ptr(out))
    if rc != 0:
        raise OSError(f"cannot scan {path}")
    return out.tolist()


# ---------------------------------------------------------------------------
# Reader and writer
# ---------------------------------------------------------------------------

def _open_error(lib) -> str:
    return lib.dx_open_error().decode("utf-8", "replace")


#: the counters of a reader's dx_reader_stats slots, in their order: the
#: decode-ahead thread's nanoseconds reading and decoding and blocked on
#: a full queue, the bytes it decoded, and the reader's nanoseconds
#: waiting on an empty queue
READER_COUNTERS = ("decode.busy_ns", "decode.full_wait_ns", "decode.bytes",
                   "reader.empty_wait_ns")
#: the counters of a writer's dx_writer_stats slots: the caller's
#: nanoseconds in the encoder (for gzip: the copy into blocks, the waits
#: for a free block, the close's drain) and in fwrite/fclose (for gzip on
#: its output thread), bytes given and bytes written; for gzip, the
#: deflate workers' nanoseconds, the caller's waits for a free block and
#: the blocks deflated
WRITER_COUNTERS = ("encode.ns", "output.io_ns", "output.bytes_in",
                   "output.bytes_out", "encode.busy_ns",
                   "encode.full_wait_ns", "encode.blocks")


def _stats_sink(register, handle, n: int) -> np.ndarray | None:
    """With tracing on: an int64 array the library counts into from now
    on (``register`` is dx_reader_stats or dx_writer_stats); else None,
    and the library counts nothing."""
    if not trace.enabled():
        return None
    stats = np.zeros(n, np.int64)
    register(handle, stats.ctypes.data)
    return stats


def _add_counters(names, stats) -> None:
    if stats is not None:
        for name, v in zip(names, stats.tolist()):
            trace.count(name, v)


class NativeFastxReader:
    """FASTA/FASTQ reader over the host library: plain, gzip and BGZF,
    zstd (through io/zstd.LIBRARY), xz and bzip2, from a path or stdin
    (None or "-"); or, with ``byte_range``, one range of a plain or BGZF
    file: (start, end) raw bytes of a plain file, or io/split.BgzfRange
    (comp_off, dskip, dlen): from the BGZF block at comp_off, dskip
    decoded bytes dropped, then dlen delivered (-1: to the end).

    ``read_batch`` returns owned RecordBatches (the filter loop's form);
    ``read_batch_raw`` returns views of the reader's own buffers, which
    the next call on the reader invalidates; iteration yields Records.
    One thread at a time may use a reader. With tracing on (utils/trace)
    the library counts the decode-ahead thread's work and waits into
    ``_stats`` (dx_reader_stats), which close() adds to the counters
    READER_COUNTERS."""

    def __init__(self, path: str | os.PathLike | None,
                 batch_mb: int = 64, byte_range=None):
        self._h = None
        self._lib = library()
        p = b"-" if path is None or str(path) == "-" else os.fsencode(path)
        if byte_range is None:
            self._h = self._lib.dx_open(p, zstd.LIBRARY.encode())
        elif len(byte_range) == 3:  # a BgzfRange
            self._h = self._lib.dx_open_range(p, *(int(x) for x in
                                                   byte_range))
        else:
            start, end = (int(x) for x in byte_range)
            self._h = self._lib.dx_open_range(p, start, 0, end - start)
        if not self._h:
            raise OSError(f"Failed to open {path!r}: {_open_error(self._lib)}")
        self._stats = _stats_sink(self._lib.dx_reader_stats, self._h,
                                  len(READER_COUNTERS))
        self._max_batch_bytes = max(1, batch_mb) << 20
        self._done = False
        self._queue: RecordBatch | None = None
        self._qi = 0

    def close(self) -> None:
        if self._h:
            self._lib.dx_close(self._h)
            self._h = None
            _add_counters(READER_COUNTERS, self._stats)

    def __del__(self):
        self.close()

    @property
    def is_fastq(self) -> bool:
        return self._lib.dx_is_fastq(self._h) == 1

    def read_batch_raw(self, max_records: int):
        """(meta int64 (n, 6), arena uint8) for up to max_records records,
        views of the reader's buffers valid until its next call; n == 0
        at end of input. A meta row is (id offset, id length, seq offset,
        seq length, qual offset or -1, qual length). Raises
        FastxParseError."""
        if self._done or max_records <= 0:
            return np.empty((0, 6), np.int64), np.empty(0, np.uint8)
        arena_p = ctypes.POINTER(ctypes.c_uint8)()
        arena_len = ctypes.c_int64()
        meta_p = ctypes.POINTER(ctypes.c_int64)()
        with trace.span("reader.parse"):
            n = self._lib.dx_next_batch_view(
                self._h, max_records, self._max_batch_bytes,
                ctypes.byref(arena_p), ctypes.byref(arena_len),
                ctypes.byref(meta_p))
        if n < 0:
            err = self._lib.dx_error(self._h).decode("utf-8", "replace")
            raise FastxParseError(err or "FASTX parse error")
        if n == 0:
            self._done = True
            return np.empty((0, 6), np.int64), np.empty(0, np.uint8)
        meta = np.ctypeslib.as_array(meta_p, shape=(int(n), 6))
        arena = np.ctypeslib.as_array(arena_p,
                                      shape=(int(arena_len.value),))
        return meta, arena

    def read_batch(self, n_records: int) -> RecordBatch:
        """The next ``n_records`` records (fewer only at end of input) as
        a RecordBatch that owns its bytes: each piece of the reader's
        buffers is copied once, so batches stay valid while later ones
        are read."""
        metas, arenas, base = [], [], 0
        got = 0
        while got < n_records:
            meta, arena = self.read_batch_raw(n_records - got)
            if meta.shape[0] == 0:
                break
            with trace.span("reader.assemble"):
                m = meta.copy()
                m[:, 0] += base
                m[:, 2] += base
                m[:, 4] = np.where(m[:, 4] >= 0, m[:, 4] + base, -1)
                metas.append(m)
                arenas.append(arena.copy())
            base += arena.size
            got += m.shape[0]
        if not metas:
            return RecordBatch(np.empty((0, 6), np.int64),
                               np.empty(0, np.uint8))
        if len(metas) == 1:
            return RecordBatch(metas[0], arenas[0])
        with trace.span("reader.assemble"):
            return RecordBatch(np.concatenate(metas), np.concatenate(arenas))

    def __iter__(self):
        return self

    def __next__(self) -> Record:
        if self._queue is None or self._qi >= len(self._queue):
            self._queue = self.read_batch(8192)
            self._qi = 0
            if not len(self._queue):
                raise StopIteration
        rec = self._queue.record(self._qi)
        self._qi += 1
        return rec


#: output codec by file extension (0 plain, 1 gzip, 2 zstd, 3 xz)
CODEC_BY_EXT = {".gz": 1, ".zst": 2, ".xz": 3}


class NativeWriter:
    """Output stream over the host library's encoders (io/writers.
    get_writer picks it for every codec). One thread at a time may use
    a writer. A .gz output is deflated in 1 MiB blocks on the library's
    pool of worker threads and written, in order, as one gzip member by
    a thread of the writer's own; write() only copies. With tracing on (utils/trace) the library counts its
    encoding and output into ``_stats`` (dx_writer_stats), which finish()
    adds to the counters WRITER_COUNTERS."""

    def __init__(self, path: str, codec: int, level: int):
        self._h = None
        self._lib = library()
        if path == "-":
            sys.stdout.flush()
            sys.stdout.buffer.flush()
        self._h = self._lib.dx_writer_open(path.encode(), codec, level,
                                           zstd.LIBRARY.encode())
        if not self._h:
            raise OSError(f"Failed to create output file: {path}: "
                          f"{_open_error(self._lib)}")
        self._stats = _stats_sink(self._lib.dx_writer_stats, self._h,
                                  len(WRITER_COUNTERS))

    def __del__(self):
        # a writer dropped unfinished still joins its encoder's threads
        if self._h:
            self._lib.dx_writer_close(self._h)
            self._h = None

    def write(self, data) -> None:
        """Append bytes (or a contiguous uint8 array)."""
        if isinstance(data, np.ndarray):
            ptr, n = np.ascontiguousarray(data).ctypes.data, data.nbytes
        else:
            ptr = data = bytes(data)  # no copy when data is bytes
            n = len(data)
        with trace.span("writer.write"):
            rc = self._lib.dx_writer_write(self._h, ptr, n)
        if rc != 0:
            raise OSError("write failed")

    def flush(self) -> None:
        pass

    def finish(self) -> None:
        if self._h:
            with trace.span("writer.finish"):
                rc = self._lib.dx_writer_close(self._h)
            self._h = None
            _add_counters(WRITER_COUNTERS, self._stats)
            if rc != 0:
                raise OSError("closing the output failed")


# ---------------------------------------------------------------------------
# The host engine: probe table and its sidecar, filter pipeline, index
# build accumulators
# ---------------------------------------------------------------------------

class NativeProbe:
    """Membership table over sorted unique u64 keys (dx_probe_*): one
    linear-probing pass at build, about one cache line per query. The
    table owns a copy of the keys, so the caller may free them. Built
    from keys (``NativeProbe(keys)``) or mapped from a sidecar
    (``load_sidecar``). Queries may run from any number of threads."""

    def __init__(self, keys: np.ndarray):
        self._lib = library()
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        self._h = self._lib.dx_probe_build(_ptr(keys), keys.size)
        if not self._h:
            raise MemoryError(
                f"probe table build failed for {keys.size} keys")

    @classmethod
    def _wrap(cls, handle) -> "NativeProbe":
        self = cls.__new__(cls)
        self._lib = library()
        self._h = handle
        return self

    def query(self, q: np.ndarray) -> np.ndarray:
        """Whether each of ``q`` is a key (bool array)."""
        q = np.ascontiguousarray(q, dtype=np.uint64)
        out = np.empty(q.size, dtype=np.uint8)
        self._lib.dx_probe_query(self._h, _ptr(q), q.size, _ptr(out))
        return out.view(bool)

    __call__ = query

    def close(self) -> None:
        if self._h:
            self._lib.dx_probe_free(self._h)
            self._h = None

    def __del__(self):
        self.close()


def native_probe(keys: np.ndarray) -> NativeProbe:
    """The probe table of sorted unique ``keys``."""
    return NativeProbe(keys)


def sidecar_path(index_path) -> str:
    """Where the probe table of ``index_path`` is cached."""
    return str(index_path) + ".probe"


def _sidecar_identity(index_path) -> tuple[str, int, int]:
    """(sidecar path, index size, index mtime_ns): a sidecar is valid only
    for the index file with this size and mtime (and its key count)."""
    st = os.stat(index_path)
    return sidecar_path(index_path), int(st.st_size), int(st.st_mtime_ns)


def load_probe_sidecar(index_path, key_count: int) -> NativeProbe | None:
    """The table mapped read-only from ``<index>.probe``, or None when the
    sidecar is missing, malformed or stale (written for an index file of
    another key count, size or mtime). The JAX package writes and reads
    the same format."""
    path, size, mtime_ns = _sidecar_identity(index_path)
    h = library().dx_probe_load(path.encode(), key_count, size, mtime_ns)
    return NativeProbe._wrap(h) if h else None


def save_probe_sidecar(probe: NativeProbe, index_path,
                       key_count: int) -> bool:
    """Write ``probe`` to ``<index>.probe`` (a temporary file, then a
    rename); False when the file cannot be written."""
    path, size, mtime_ns = _sidecar_identity(index_path)
    return library().dx_probe_save(probe._h, path.encode(), key_count, size,
                                   mtime_ns) == 0


#: key count from which a built table is saved as a sidecar by default
SIDECAR_MIN_KEYS = 4_000_000


def sidecar_wanted(key_count: int) -> bool:
    """The DEACON_PROBE_CACHE policy: 0 never saves, 1 always, unset (or
    anything else) from SIDECAR_MIN_KEYS keys (a ~40 MB sidecar)."""
    cache = os.environ.get("DEACON_PROBE_CACHE", "")
    return cache != "0" and (cache == "1" or key_count >= SIDECAR_MIN_KEYS)


def maybe_save_probe_sidecar(probe: NativeProbe, index_path,
                             key_count: int) -> bool:
    """Save the sidecar when the policy wants it (sidecar_wanted). True
    when it was written, False when the policy declined; raises OSError
    when a wanted sidecar cannot be written."""
    if not sidecar_wanted(key_count):
        return False
    if not save_probe_sidecar(probe, index_path, key_count):
        raise OSError(f"cannot write {sidecar_path(index_path)}")
    return True


#: progress slots of native_filter_run: six stats, then the cancel flag
PROGRESS_SLOTS = 7
CANCEL = 6


def native_filter_run(input_path: str, input2_path: str | None,
                      output_path: str, output2_path: str | None,
                      out_codec: int, out2_codec: int, level: int,
                      probe: NativeProbe, k: int, w: int,
                      prefix_length: int, abs_threshold: int,
                      rel_threshold: float, deplete: bool, rename: bool,
                      n_threads: int, progress: np.ndarray) -> None:
    """The host library's whole filter pipeline (dx_filter_run): a reader
    thread, a pool of ``n_threads`` workers (0 = one per core) that
    extract, probe and decide, and an ordered writer; workers compress
    output members in parallel (BGZF for .gz at levels 1-3) unless
    ``rename`` numbers records in writer order. ``input2_path`` == "-"
    with ``input_path`` == "-" reads interleaved pairs from stdin.
    ``progress`` is int64[PROGRESS_SLOTS]: total_seqs, filtered_seqs,
    total_bp, output_bp, filtered_bp, output_seq_counter, updated per
    batch (final values are the run's totals), and [CANCEL], which the
    caller sets to stop the run with "Interrupted". The whole of each
    input is read (the C entry's byte ranges are left at -1). Blocks, without the GIL, until the run ends; raises ValueError with
    the pipeline's message when it fails."""
    if progress.dtype != np.int64 or progress.size != PROGRESS_SLOTS \
            or not progress.flags.c_contiguous:
        raise ValueError("progress must be a contiguous int64[7] array")
    err = ctypes.create_string_buffer(512)
    rc = library().dx_filter_run(
        os.fsencode(input_path),
        None if input2_path is None else os.fsencode(input2_path),
        os.fsencode(output_path),
        None if output2_path is None else os.fsencode(output2_path),
        out_codec, level, out2_codec, level, probe._h, k, w, prefix_length,
        abs_threshold, rel_threshold, int(deplete), int(rename), n_threads,
        _ptr(progress), err, len(err), -1, -1, -1, -1,
        zstd.LIBRARY.encode())
    if rc != 0:
        raise ValueError(err.value.decode("utf-8", "replace")
                         or "host filter pipeline failed")


class NativeRunAcc:
    """The quiet index build's accumulator (dx_runacc_*): raw hash batches
    are bucketed by their top byte as they arrive; finish_write sorts and
    deduplicates the 256 buckets in parallel while it streams the index
    to disk."""

    def __init__(self, capacity_hint: int = 0):
        self._lib = library()
        self._h = self._lib.dx_runacc_new(int(capacity_hint))
        if not self._h:
            raise MemoryError("dx_runacc_new failed")

    def add(self, hashes: np.ndarray) -> None:
        hashes = np.ascontiguousarray(hashes, dtype=np.uint64)
        if hashes.size:
            self._lib.dx_runacc_add(self._h, _ptr(hashes), hashes.size)

    def finish_write(self, path: str, format_version: int, k: int, w: int,
                     trailer: bytes, n_threads: int = 0) -> int | None:
        """Write the index to ``path``; returns the distinct count, or None
        (and no file) when the count has no 4-byte varint form (at most
        0xFFFF keys, or more than 2^32): then export_sorted gives the
        keys. Raises OSError."""
        rc = self._lib.dx_runacc_finish_write(
            self._h, os.fsencode(path), format_version, k, w, trailer,
            len(trailer), _threads(n_threads), None, 0)
        if rc == -1:
            raise OSError(f"index write failed: {path}")
        return None if rc == -2 else int(rc)

    def export_sorted(self) -> np.ndarray:
        """The sorted unique keys, after finish_write returned None."""
        out = np.empty(int(self._lib.dx_runacc_unique_count(self._h)),
                       dtype=np.uint64)
        if out.size:
            self._lib.dx_runacc_export_sorted(self._h, _ptr(out))
        return out

    def close(self) -> None:
        if self._h:
            self._lib.dx_runacc_free(self._h)
            self._h = None

    def __del__(self):
        self.close()


class NativeCountingSet:
    """u64 set whose batch insert returns how many keys were new (the
    reference's FxHashSet at index build, ref: src/index.rs:96-107,
    266-284): 256 partitions by top byte, open addressing, threads on
    disjoint partitions."""

    def __init__(self, capacity_hint: int = 0):
        self._lib = library()
        self._h = self._lib.dx_cset_new(int(capacity_hint))
        if not self._h:
            raise MemoryError("dx_cset_new failed")

    def insert(self, keys: np.ndarray, n_threads: int = 0) -> int:
        """Add ``keys``; returns how many were not present before."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        if keys.size == 0:
            return 0
        return int(self._lib.dx_cset_insert(self._h, _ptr(keys), keys.size,
                                            _threads(n_threads)))

    def __len__(self) -> int:
        return int(self._lib.dx_cset_size(self._h))

    def export_sorted(self, n_threads: int = 0) -> np.ndarray:
        """The keys, ascending."""
        out = np.empty(len(self), dtype=np.uint64)
        n = self._lib.dx_cset_export_sorted(self._h, _ptr(out),
                                            _threads(n_threads))
        return out[:n]

    def close(self) -> None:
        if self._h:
            self._lib.dx_cset_free(self._h)
            self._h = None

    def __del__(self):
        self.close()
