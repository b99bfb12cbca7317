"""Index container: format-v2 codec and in-memory representation.

On-disk format is byte-compatible with the reference (bincode standard stream:
IndexHeader{format_version=2:u8, k:u8, w:u8}, count:usize varint, then count
u64 hash varints; ref: src/index.rs:17-31, 130-164).

In memory the index is a **sorted** uint64 array (plus count), not a hash set:
membership probes are branchless vectorized binary searches that map directly
onto the device-side sorted-array probe in HBM (SURVEY §2.2 "rustc-hash" row).

The hash payload is decoded and written by the host library
(io/native_loader: the varint decoder, parallel for an all-9-byte
payload, and the parallel-encode index writer); utils/bincode's NumPy
codec is their plain version.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..constants import INDEX_FORMAT_VERSION
from ..io.native_loader import (
    decode_u64_varint,
    index_write_sorted,
    u64_sort_unique,
    u64_sorted_unique,
)
from ..utils import bincode


class IndexFormatError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Provenance footer
#
# deacon-tpu's minimizer *selection scheme* differs from upstream deacon's
# simd-minimizers crate (see ops/minimizers_np.py and INTEROP.md): index
# files are byte-format compatible both ways, but a foreign (reference-built)
# index contains hashes of different selected k-mers, so hit counts against
# it will silently disagree with the tool that built it. Files written by
# this tool therefore carry a 9-byte trailer AFTER the hash payload:
# 8-byte magic + 1-byte scheme id. The reference's bincode decoder reads
# exactly `count` hashes and ignores trailing bytes, so the trailer does not
# break reference-side reads (ref: src/index.rs:80-107); absence of the
# trailer identifies a foreign index at load time.
# ---------------------------------------------------------------------------

PROVENANCE_MAGIC = b"DXTPIDX1"
SCHEME_DXTP_FMIX32_V1 = 1
SCHEME_NAMES = {SCHEME_DXTP_FMIX32_V1: "dxtp-fmix32-v1"}


def read_provenance(path: "str | Path") -> int | None:
    """Scheme id from the provenance trailer, or None for a foreign index
    (reference-built, or any unseekable/short input)."""
    try:
        with open(path, "rb") as f:
            f.seek(0, 2)
            size = f.tell()
            if size < len(PROVENANCE_MAGIC) + 1:
                return None
            f.seek(size - len(PROVENANCE_MAGIC) - 1)
            tail = f.read(len(PROVENANCE_MAGIC) + 1)
    except (OSError, ValueError):
        return None
    if tail[: len(PROVENANCE_MAGIC)] == PROVENANCE_MAGIC:
        return tail[-1]
    return None


_warned_foreign: set = set()


def warn_if_foreign_index(path: "str | Path") -> bool:
    """One-shot stderr warning when ``path`` lacks a deacon-tpu provenance
    trailer (VERDICT r1 #1: nothing detected a foreign index at load time).
    Returns True when the warning fired."""
    key = str(path)
    if key in _warned_foreign:
        return False
    if read_provenance(path) is not None:
        return False
    _warned_foreign.add(key)
    print(
        f"Warning: index '{path}' was not built by deacon-tpu (no provenance "
        "trailer). deacon-tpu's minimizer selection scheme differs from "
        "upstream deacon's (simd-minimizers), so hit counts against a "
        "foreign index will NOT match the tool that built it. Rebuild the "
        "index from its source FASTA with `deacon-tpu index build` for "
        "correct results (see INTEROP.md).",
        file=sys.stderr,
    )
    return True


@dataclass
class IndexHeader:
    """ref: src/index.rs:17-54."""

    format_version: int
    kmer_length: int
    window_size: int

    @classmethod
    def new(cls, kmer_length: int, window_size: int) -> "IndexHeader":
        return cls(INDEX_FORMAT_VERSION, int(kmer_length), int(window_size))

    def validate(self) -> None:
        if self.format_version != INDEX_FORMAT_VERSION:
            raise IndexFormatError(
                f"Unsupported index format version: {self.format_version}"
            )

    def to_dict(self) -> dict:
        """The server's /index_header body (ref: src/server_common.rs)."""
        return {
            "format_version": self.format_version,
            "kmer_length": self.kmer_length,
            "window_size": self.window_size,
        }


@dataclass
class MinimizerIndex:
    header: IndexHeader
    hashes: np.ndarray  # sorted unique uint64

    def __len__(self) -> int:
        return int(self.hashes.size)

    def contains(self, queries: np.ndarray) -> np.ndarray:
        """Vectorized membership of uint64 queries against the sorted array."""
        q = np.asarray(queries, dtype=np.uint64)
        if self.hashes.size == 0 or q.size == 0:
            return np.zeros(q.shape, dtype=bool)
        idx = np.searchsorted(self.hashes, q)
        idx_c = np.minimum(idx, self.hashes.size - 1)
        return self.hashes[idx_c] == q


def _read_header(buf: np.ndarray, pos: int) -> tuple[IndexHeader, int]:
    if buf.size < pos + 3:
        raise IndexFormatError("Failed to deserialise index header (truncated)")
    header = IndexHeader(int(buf[pos]), int(buf[pos + 1]), int(buf[pos + 2]))
    header.validate()
    return header, pos + 3


def load_header_and_count(path: str | Path) -> tuple[IndexHeader, int]:
    """Header and key count only (ref: src/index.rs:57-72)."""
    with open(path, "rb") as f:
        head = f.read(32)
    buf = np.frombuffer(head, dtype=np.uint8)
    header, pos = _read_header(buf, 0)
    count, _ = bincode.decode_uint(memoryview(head), pos)
    return header, count


def load_index(path: str | Path) -> MinimizerIndex:
    """Load a full index file into a sorted uint64 array
    (ref: src/index.rs:80-107). mmap, not read(), so a multi-GB file needs
    no heap copy; read() for non-mmappable inputs (pipes)."""
    try:
        buf = np.memmap(path, dtype=np.uint8, mode="r")
        head = bytes(buf[:32].tobytes())
    except (OSError, ValueError):
        with open(path, "rb") as f:
            data = f.read()
        buf = np.frombuffer(data, dtype=np.uint8)
        head = data[:32]
    header, pos = _read_header(buf, 0)
    count, pos = bincode.decode_uint(memoryview(head), pos)
    hashes, _ = decode_u64_varint(buf, pos, count)
    return MinimizerIndex(header, _sorted_unique(hashes))  # set semantics


def shard_value_range(shard_i: int, n_shards: int) -> tuple[int, int]:
    """Half-open u64 value range [lo, hi) owned by shard ``shard_i`` of
    ``n_shards``: [i * 2**64 // N, (i + 1) * 2**64 // N)."""
    if not 0 <= shard_i < n_shards:
        raise ValueError(f"shard {shard_i} out of range for {n_shards} shards")
    return ((shard_i * (1 << 64)) // n_shards,
            ((shard_i + 1) * (1 << 64)) // n_shards)


def load_index_range(path: str | Path, lo: int, hi: int, *,
                     chunk: int = 8_000_000) -> tuple[IndexHeader, np.ndarray,
                                                      int]:
    """The index file's distinct keys in the u64 value range [lo, hi),
    sorted: the file is mapped and decoded by the host library in pieces
    of ``chunk`` keys, keeping only the keys in range, so the peak host
    memory is the kept keys plus one piece. Works on unsorted files with
    duplicates (the reference writes those). Returns (header, keys, the
    file's key count)."""
    if not 0 <= lo <= hi <= 1 << 64:
        raise ValueError(f"bad u64 value range [{lo}, {hi})")
    buf = np.memmap(path, dtype=np.uint8, mode="r")
    header, pos = _read_header(buf, 0)
    count, pos = bincode.decode_uint(memoryview(buf[:32].tobytes()), pos)
    kept: list[np.ndarray] = []
    lo64, top64 = np.uint64(lo), np.uint64(max(hi, 1) - 1)
    remaining = count
    ascending, last = True, None  # every piece so far strictly ascending
    while remaining and lo < hi:
        n = min(chunk, remaining)
        vals, pos = decode_u64_varint(buf, pos, n)
        remaining -= n
        if u64_sorted_unique(vals):
            # a sorted piece (every piece of a file this tool writes): the
            # range is one slice of it
            a = int(np.searchsorted(vals, lo64))
            sel = vals[a:int(np.searchsorted(vals, top64, side="right"))]
            ascending &= last is None or vals[0] > last
            last = vals[-1]
        else:
            sel = vals[(vals >= lo64) & (vals <= top64)]
            ascending = False
        if sel.size:
            kept.append(sel)
    del buf
    if not kept:
        return header, np.empty(0, np.uint64), count
    merged = np.concatenate(kept) if len(kept) > 1 else kept[0]
    kept.clear()
    if ascending or merged.size < 2 or u64_sorted_unique(merged):
        return header, merged, count
    out = u64_sort_unique(merged)  # merged is ours: sorted in place
    return header, out.copy() if out.size < merged.size // 2 else out, count


def load_index_shard(path: str | Path, shard_i: int, n_shards: int, *,
                     chunk: int = 8_000_000):
    """Value-range shard ``shard_i`` of ``n_shards`` of an index file
    (shard_value_range; load_index_range decodes it). Returns (header,
    sorted distinct keys of the shard, the file's key count)."""
    lo, hi = shard_value_range(shard_i, n_shards)
    return load_index_range(path, lo, hi, chunk=chunk)


def _sorted_unique(hashes: np.ndarray) -> np.ndarray:
    """Sorted unique keys, the sort skipped when the array is already
    strictly increasing (files this framework writes are)."""
    if hashes.size < 2 or u64_sorted_unique(hashes):
        return hashes
    # a copy: the sort works in place, and ``hashes`` is the caller's
    return u64_sort_unique(np.array(hashes, dtype=np.uint64))


def write_index(
    hashes: np.ndarray,
    header: IndexHeader,
    output_path: str | Path | None,
    scheme: int | None = SCHEME_DXTP_FMIX32_V1,
) -> None:
    """Serialize header, count, hashes (ref: src/index.rs:130-164), then the
    provenance trailer (``scheme=None`` omits it — used when composing with
    foreign-index content whose scheme is unknown).

    ``output_path`` of None or "-" writes to stdout. A file is written
    under a temporary name and renamed when complete.
    """
    uniq = _sorted_unique(np.asarray(hashes, dtype=np.uint64))
    trailer = (
        PROVENANCE_MAGIC + bytes([scheme]) if scheme is not None else b""
    )
    fields = (header.format_version, header.kmer_length, header.window_size)
    if output_path is None or str(output_path) == "-":
        sys.stdout.flush()
        sys.stdout.buffer.flush()
        index_write_sorted(uniq, "-", *fields, trailer)
        return
    tmp = str(output_path) + f".tmp{os.getpid()}"
    try:
        index_write_sorted(uniq, tmp, *fields, trailer)
    except OSError:
        Path(tmp).unlink(missing_ok=True)
        raise
    os.replace(tmp, output_path)


def write_index_plain(
    hashes: np.ndarray,
    header: IndexHeader,
    output_path: str | Path,
    scheme: int | None = SCHEME_DXTP_FMIX32_V1,
) -> None:
    """The plain version of write_index (to a file), on utils/bincode."""
    uniq = np.unique(np.asarray(hashes, dtype=np.uint64))
    trailer = (
        PROVENANCE_MAGIC + bytes([scheme]) if scheme is not None else b""
    )
    head = (
        bytes([header.format_version, header.kmer_length, header.window_size])
        + bincode.encode_uint(int(uniq.size))
    )
    with open(output_path, "wb") as f:
        f.write(head)
        f.write(bincode.encode_sorted_u64_array(uniq))
        f.write(trailer)
