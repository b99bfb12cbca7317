"""FASTA/FASTQ streaming reader with compression auto-detection.

Plays the role of needletail/paraseq + niffler in the reference (ref:
src/local_filter.rs:41-55, src/index.rs:205-209): format detected from the
first record byte ('>' FASTA, '@' FASTQ), compression detected from magic
bytes (gzip, zstd, xz, bzip2). Sequences are returned newline-free; FASTA
records may span multiple lines (ref behavior: needletail normalizes,
exercised by tests/filter_tests.rs:1132-1187).

Every path of the port reads through the host library's reader
(``FastxReader.from_path`` returns io/native_loader.NativeFastxReader),
in batches of records that share one byte arena (RecordBatch). The
pure-Python parser here (FastxReader over a stream from
open_maybe_compressed) is its plain version, which the tests hold it
against; its codecs are imported only when a stream needs them (zstd
through the system's libzstd, io/zstd.py).
"""

from __future__ import annotations

import io
import os
import sys
from dataclasses import dataclass
from typing import BinaryIO, Iterator

import numpy as np


@dataclass
class Record:
    id: bytes  # full header after the marker, up to end of line
    seq: bytes  # newline-free sequence
    qual: bytes | None  # None for FASTA
    is_fastq: bool


class FastxParseError(ValueError):
    pass


class RecordBatch:
    """A batch of records as offsets into one byte arena: ``meta`` is
    (n, 6) int64 rows of (id offset, id length, seq offset, seq length,
    qual offset or -1 for FASTA, qual length)."""

    def __init__(self, meta: np.ndarray, arena: np.ndarray):
        self.meta = meta
        self.arena = arena

    def __len__(self) -> int:
        return int(self.meta.shape[0])

    @property
    def seq_starts(self) -> np.ndarray:
        return self.meta[:, 2]

    @property
    def seq_lens(self) -> np.ndarray:
        return self.meta[:, 3]

    def record(self, i: int) -> Record:
        io_, il, so, sl, qo, ql = self.meta[i].tolist()
        a = self.arena
        return Record(a[io_:io_ + il].tobytes(), a[so:so + sl].tobytes(),
                      a[qo:qo + ql].tobytes() if qo >= 0 else None, qo >= 0)

    def records(self) -> list[Record]:
        return [self.record(i) for i in range(len(self))]

    def head(self, n: int) -> "RecordBatch":
        """The first n records (sharing the arena)."""
        return RecordBatch(self.meta[:n], self.arena)

    @classmethod
    def interleave(cls, first: "RecordBatch",
                   second: "RecordBatch") -> "RecordBatch":
        """Records first[0], second[0], first[1], ... of two batches of
        equal length, in one arena."""
        n = len(first)
        meta = np.empty((2 * n, 6), dtype=np.int64)
        meta[0::2] = first.meta
        shifted = second.meta.copy()
        shifted[:, [0, 2]] += first.arena.size
        shifted[:, 4] = np.where(shifted[:, 4] >= 0,
                                 shifted[:, 4] + first.arena.size, -1)
        meta[1::2] = shifted
        return cls(meta, np.concatenate([first.arena, second.arena]))

    @classmethod
    def from_records(cls, records: list[Record]) -> "RecordBatch":
        """The batch of parsed Records (the plain parser's batch form)."""
        parts: list[bytes] = []
        meta = np.zeros((len(records), 6), dtype=np.int64)
        off = 0
        for i, r in enumerate(records):
            fields = (r.id, r.seq, r.qual)
            for j, f in enumerate(fields):
                if f is None:
                    meta[i, 2 * j:2 * j + 2] = (-1, 0)
                    continue
                meta[i, 2 * j:2 * j + 2] = (off, len(f))
                parts.append(f)
                off += len(f)
        arena = np.frombuffer(b"".join(parts), dtype=np.uint8)
        return cls(meta, arena)


_MAGICS = (
    (b"\x1f\x8b", "gz"),
    (b"\x28\xb5\x2f\xfd", "zst"),
    (b"\xfd7zXZ\x00", "xz"),
    (b"BZh", "bz2"),
)


def open_maybe_compressed(path: str | os.PathLike | None) -> BinaryIO:
    """Open a path (or stdin for None/"-") with compression auto-detection."""
    if path is None or str(path) == "-":
        raw: BinaryIO = sys.stdin.buffer
        stream = io.BufferedReader(_UnseekableWrapper(raw), buffer_size=1 << 20)
        name = "<stdin>"
    else:
        stream = open(path, "rb", buffering=1 << 20)
        name = str(path)
    head = stream.peek(8)[:8]
    for magic, kind in _MAGICS:
        if head.startswith(magic):
            return _decompress_stream(stream, kind, name)
    return stream


class _UnseekableWrapper(io.RawIOBase):
    """Wrap stdin so BufferedReader.peek works without seeking."""

    def __init__(self, raw: BinaryIO):
        self._raw = raw

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        data = self._raw.read(len(b))
        b[: len(data)] = data
        return len(data)


def _decompress_stream(stream: BinaryIO, kind: str, name: str) -> BinaryIO:
    if kind == "gz":
        import gzip

        return io.BufferedReader(gzip.GzipFile(fileobj=stream), buffer_size=1 << 20)
    if kind == "zst":
        from . import zstd

        return io.BufferedReader(zstd.Reader(stream, name), buffer_size=1 << 20)
    if kind == "xz":
        import lzma

        return io.BufferedReader(lzma.LZMAFile(stream), buffer_size=1 << 20)
    if kind == "bz2":
        import bz2

        return io.BufferedReader(bz2.BZ2File(stream), buffer_size=1 << 20)
    raise AssertionError(kind)


class FastxReader:
    """Iterator over Records from a (possibly compressed) FASTA/FASTQ stream."""

    def __init__(self, stream: BinaryIO):
        self._stream = stream
        self._pending: bytes | None = None  # pushed-back header line
        self._is_fastq: bool | None = None

    @classmethod
    def from_path(cls, path: str | os.PathLike | None, byte_range=None):
        """The host library's reader over ``path`` (None or "-": stdin),
        or over one range of it (io/split.py's ranges; see
        NativeFastxReader)."""
        from .native_loader import NativeFastxReader

        return NativeFastxReader(path, byte_range=byte_range)

    def _readline(self) -> bytes:
        if self._pending is not None:
            line, self._pending = self._pending, None
            return line
        return self._stream.readline()

    def __iter__(self) -> Iterator[Record]:
        return self

    def __next__(self) -> Record:
        # Skip blank lines between records
        while True:
            line = self._readline()
            if not line:
                raise StopIteration
            stripped = line.rstrip(b"\r\n")
            if stripped:
                break
        marker = stripped[:1]
        if self._is_fastq is None:
            if marker == b">":
                self._is_fastq = False
            elif marker == b"@":
                self._is_fastq = True
            else:
                raise FastxParseError(
                    f"Unrecognized FASTX record start: {stripped[:20]!r}"
                )
        if self._is_fastq:
            if marker != b"@":
                raise FastxParseError(f"Expected '@' FASTQ header, got {stripped[:20]!r}")
            rid = stripped[1:]
            seq = self._readline().rstrip(b"\r\n")
            plus = self._readline()
            if not plus.startswith(b"+"):
                raise FastxParseError(f"Expected '+' separator for record {rid!r}")
            qual = self._readline().rstrip(b"\r\n")
            if len(qual) != len(seq):
                raise FastxParseError(
                    f"Quality length {len(qual)} != sequence length {len(seq)} for {rid!r}"
                )
            return Record(rid, seq, qual, True)
        # FASTA: gather sequence lines until next '>' or EOF
        if marker != b">":
            raise FastxParseError(f"Expected '>' FASTA header, got {stripped[:20]!r}")
        rid = stripped[1:]
        parts: list[bytes] = []
        while True:
            line = self._stream.readline()
            if not line:
                break
            if line.startswith(b">"):
                self._pending = line
                break
            parts.append(line.rstrip(b"\r\n"))
        return Record(rid, b"".join(parts), None, False)
