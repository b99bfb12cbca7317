"""Output writers with extension-based compression (ref: src/local_filter.rs:95-151,
src/remote_filter.rs:37-228) and FASTX record formatting (ref:
src/remote_filter.rs:1402-1443, src/local_filter.rs:60-92)."""

from __future__ import annotations

import sys
from typing import BinaryIO

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
        if self._finisher is not None:
            self._finisher()
        else:
            self.flush()
        if self._closer is not None:
            self._closer()


def get_writer(output_path: str, compression_level: int) -> FastxWriter:
    """stdout for "-"; .gz/.zst/.xz compression by extension otherwise,
    with the level range checked for the format
    (ref: src/local_filter.rs:95-107)."""
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
