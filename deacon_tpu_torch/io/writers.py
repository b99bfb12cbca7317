"""Output writers with extension-based compression (ref: src/local_filter.rs:95-151,
src/remote_filter.rs:37-228) and FASTX record formatting (ref:
src/remote_filter.rs:1402-1443, src/local_filter.rs:60-92).

Files are written through the host library's encoders (io/native_loader.
NativeWriter) for every codec, and a batch's output records are gathered
by it in one call (format_batch); stdout stays a Python stream. The
Python writers (python_writer) and format_record are the plain
versions the tests hold them against.
"""

from __future__ import annotations

import sys
from typing import BinaryIO

import numpy as np

from ..utils import trace
from .fastx import RecordBatch

OUTPUT_BUFFER_SIZE = 8 * 1024 * 1024  # ref: src/local_filter.rs:25


class WriterError(ValueError):
    pass


def _validate_level(level: int, lo: int, hi: int, fmt: str) -> None:
    if not (lo <= level <= hi):
        raise WriterError(
            f"Invalid {fmt} compression level {level}. Must be between {lo} and {hi}."
        )


class FastxWriter:
    """Buffered writer with an explicit finish() for compression trailers."""

    def __init__(self, sink: BinaryIO, finisher=None, closer=None):
        self._sink = sink
        self._finisher = finisher
        self._closer = closer
        self._finished = False

    def write(self, data: bytes) -> None:
        with trace.span("writer.write"):
            self._sink.write(data)

    def flush(self) -> None:
        try:
            self._sink.flush()
        except (BrokenPipeError, ValueError):
            pass

    def finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        with trace.span("writer.finish"):
            if self._finisher is not None:
                self._finisher()
            else:
                self.flush()
            if self._closer is not None:
                self._closer()


def resolve_codec(output_path: str, compression_level: int) -> int:
    """Extension -> output codec (0 plain, 1 gz, 2 zst, 3 xz), with the
    level range checked for the format (ref: src/local_filter.rs:95-107)."""
    if output_path == "-":
        return 0
    if output_path.endswith(".gz"):
        _validate_level(compression_level, 1, 9, "gzip")
        return 1
    if output_path.endswith(".zst"):
        _validate_level(compression_level, 1, 22, "zstd")
        return 2
    if output_path.endswith(".xz"):
        _validate_level(compression_level, 0, 9, "xz")
        return 3
    return 0


def get_writer(output_path: str, compression_level: int):
    """stdout for "-"; otherwise the host library's writer, .gz/.zst/.xz
    compression by extension."""
    codec = resolve_codec(output_path, compression_level)
    if output_path == "-":
        return FastxWriter(sys.stdout.buffer)
    from .native_loader import NativeWriter

    return NativeWriter(output_path, codec, compression_level)


def python_writer(output_path: str, compression_level: int) -> FastxWriter:
    """The plain version of get_writer, on Python's codec modules."""
    if output_path == "-":
        return FastxWriter(sys.stdout.buffer)
    if output_path.endswith(".gz"):
        _validate_level(compression_level, 1, 9, "gzip")
        import gzip

        f = open(output_path, "wb", buffering=OUTPUT_BUFFER_SIZE)
        gz = gzip.GzipFile(fileobj=f, mode="wb", compresslevel=compression_level)
        return FastxWriter(
            gz, finisher=gz.close, closer=f.close
        )
    if output_path.endswith(".zst"):
        _validate_level(compression_level, 1, 22, "zstd")
        from . import zstd

        zstd.library(output_path)  # fails before the file is created
        f = open(output_path, "wb", buffering=OUTPUT_BUFFER_SIZE)
        zw = zstd.Writer(f, compression_level, output_path)
        return FastxWriter(zw, finisher=zw.close, closer=f.close)
    if output_path.endswith(".xz"):
        _validate_level(compression_level, 0, 9, "xz")
        import lzma

        f = open(output_path, "wb", buffering=OUTPUT_BUFFER_SIZE)
        xz = lzma.LZMAFile(f, mode="wb", preset=compression_level)
        return FastxWriter(xz, finisher=xz.close, closer=f.close)

    f = open(output_path, "wb", buffering=OUTPUT_BUFFER_SIZE)
    return FastxWriter(f, closer=f.close)


def format_record(
    rid: bytes,
    seq: bytes,
    qual: bytes | None,
    is_fastq: bool,
    rename: bool,
    seq_number: int,
    buffer: bytearray,
) -> None:
    """Append one FASTA/FASTQ record to buffer
    (ref: src/remote_filter.rs:1402-1443)."""
    buffer += b"@" if is_fastq else b">"
    if rename:
        buffer += str(seq_number).encode()
    else:
        buffer += rid
    buffer += b"\n"
    buffer += seq
    if is_fastq:
        buffer += b"\n+\n"
        if qual is not None:
            buffer += qual
        buffer += b"\n"
    else:
        buffer += b"\n"


_SEP = np.frombuffer(b"@>\n+\n", dtype=np.uint8)  # markers, "\n", "\n+\n"


def format_batch(batch: RecordBatch, idx: np.ndarray,
                 numbers: np.ndarray | None = None) -> np.ndarray:
    """Records ``idx`` of a batch formatted as format_record formats them,
    concatenated (uint8); ``numbers`` replaces their ids (--rename)."""
    with trace.span("writer.format"):
        from .native_loader import gather

        idx = np.asarray(idx, dtype=np.int64)
        m = batch.meta[idx]
        arena = np.ascontiguousarray(batch.arena)
        a0, s0 = arena.ctypes.data, _SEP.ctypes.data
        fq = m[:, 4] >= 0
        n = idx.size
        addrs = np.empty((n, 7), dtype=np.int64)
        lens = np.empty((n, 7), dtype=np.int64)
        addrs[:, 0], lens[:, 0] = np.where(fq, s0, s0 + 1), 1
        keep_alive = None
        if numbers is None:
            addrs[:, 1], lens[:, 1] = a0 + m[:, 0], m[:, 1]
        else:
            names = [str(x).encode() for x in np.asarray(numbers).tolist()]
            keep_alive = np.frombuffer(b"".join(names), dtype=np.uint8)
            nl = np.fromiter(map(len, names), np.int64, n)
            addrs[:, 1] = keep_alive.ctypes.data + np.cumsum(nl) - nl
            lens[:, 1] = nl
        addrs[:, 2], lens[:, 2] = s0 + 2, 1
        addrs[:, 3], lens[:, 3] = a0 + m[:, 2], m[:, 3]
        addrs[:, 4], lens[:, 4] = s0 + 2, np.where(fq, 3, 0)
        addrs[:, 5], lens[:, 5] = a0 + np.maximum(m[:, 4], 0), np.where(
            fq, m[:, 5], 0)
        addrs[:, 6], lens[:, 6] = s0 + 2, 1
        out = gather(addrs.reshape(-1), lens.reshape(-1))
        del keep_alive
        return out
