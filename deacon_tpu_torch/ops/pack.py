"""Host-side row packing for the device pipeline.

Reads become fixed-length rows of a tile (L, R): long reads are split into
chunks at stride L - l + 1 (l = k + w - 1), so that every w-window of a
read lands in exactly one chunk, and each row is packed into 2-bit codes
(L/4 bytes, code j at bits 2(j%4) of byte j//4) plus a validity bitmask
(L/8 bytes, little-endian bit order). The extraction kernel reads these
linear planes directly.

The packer is the host library's ``dx_pack_tile`` (io/native_loader.
pack_tile) over rows that are slices of one byte arena (RowBlock), such
as a reader batch's; ``pack_rows_packed_plain`` is its NumPy plain
version, which the tests hold it against.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.native_loader import pack_tile
from .minimizers_np import IUPAC_CANON, PACK_CODE, VALID_BASE

#: index-side codes: IUPAC bytes canonicalised to ACGT, then packed
#: (ref: src/minimizers.rs:24-43)
INDEX_CODE = PACK_CODE[IUPAC_CANON]


@dataclass
class _Row:
    rid: int
    mate: int
    chunk_start: int
    seq: bytes  # effective chunk bytes


def chunk_rows(rid: int, mate: int, seq: bytes, *, k: int, l: int,
               stride: int, max_len: int) -> list[_Row]:
    """Rows of one sequence as given: none below k bases, one row up to
    max_len bases, else chunks of max_len bases starting every ``stride``
    bases while a whole window (l = k + w - 1 bases) remains, so every
    w-window lands in exactly one chunk. The filter (rows_for_read) and
    index build (engine.IndexBuildPipeline) both chunk here."""
    n = len(seq)
    if n < k:
        return []
    if n <= max_len:
        return [_Row(rid, mate, 0, seq)]
    rows = []
    s = 0
    while s <= n - l:
        rows.append(_Row(rid, mate, s, seq[s : s + max_len]))
        s += stride
    return rows


def rows_for_read(rid: int, mate: int, seq: bytes, prefix_length: int,
                  *, k: int, l: int, stride: int, max_len: int):
    """Split one read into device rows: prefix truncation, one trailing
    newline stripped (ref: src/filter_common.rs:222-229), then
    chunk_rows."""
    if len(seq) < k:
        return []
    eff = seq
    if prefix_length > 0 and len(eff) > prefix_length:
        eff = eff[:prefix_length]
    if eff.endswith(b"\n"):
        eff = eff[:-1]
    return chunk_rows(rid, mate, eff, k=k, l=l, stride=stride,
                      max_len=max_len)


@dataclass
class RowBlock:
    """Device rows as slices of one byte arena: row i is
    ``arena[start[i]:start[i] + length[i]]``, chunk ``cstart[i]`` of mate
    ``mate[i]`` of read unit ``rid[i]``."""

    arena: np.ndarray  # uint8
    start: np.ndarray  # int64
    length: np.ndarray  # int64
    rid: np.ndarray  # int64
    mate: np.ndarray  # int64
    cstart: np.ndarray  # int64

    def __len__(self) -> int:
        return int(self.length.size)

    def take(self, idx) -> "RowBlock":
        """The rows ``idx`` (indices or a mask), on the same arena."""
        return RowBlock(self.arena, self.start[idx], self.length[idx],
                        self.rid[idx], self.mate[idx], self.cstart[idx])

    @classmethod
    def from_rows(cls, rows: list[_Row]) -> "RowBlock":
        n = len(rows)
        return cls(*join_seqs([r.seq for r in rows]),
                   np.fromiter((r.rid for r in rows), np.int64, n),
                   np.fromiter((r.mate for r in rows), np.int64, n),
                   np.fromiter((r.chunk_start for r in rows), np.int64, n))


def join_seqs(seqs: list[bytes]):
    """Sequences -> (arena, start, length): their bytes in one arena."""
    length = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
    start = np.zeros(length.size, dtype=np.int64)
    if length.size > 1:
        np.cumsum(length[:-1], out=start[1:])
    return np.frombuffer(b"".join(seqs), np.uint8), start, length


def effective_lengths(arena: np.ndarray, start: np.ndarray,
                      length: np.ndarray, prefix_length: int,
                      k: int) -> np.ndarray:
    """rows_for_read's effective length of every sequence: 0 below k
    bases, else the prefix cut and one trailing newline stripped."""
    eff = length.copy()
    if prefix_length > 0:
        np.minimum(eff, prefix_length, out=eff)
    last = np.nonzero(eff > 0)[0]
    nl = last[arena[start[last] + eff[last] - 1] == ord("\n")]
    eff[nl] -= 1
    eff[length < k] = 0
    return eff


def chunk_spans(start: np.ndarray, length: np.ndarray, *, k: int, l: int,
                stride: int, max_len: int):
    """chunk_rows of every sequence at once: (sequence index, row start,
    row length, chunk start) of each row, in sequence order."""
    n_rows = np.where(length < k, 0, np.where(
        length <= max_len, 1, (length - l) // stride + 1))
    seq = np.repeat(np.arange(length.size, dtype=np.int64), n_rows)
    first = np.zeros(length.size, dtype=np.int64)
    if length.size > 1:
        np.cumsum(n_rows[:-1], out=first[1:])
    cstart = (np.arange(seq.size, dtype=np.int64) - first[seq]) * stride
    row_len = np.minimum(max_len, length[seq] - cstart)
    return seq, start[seq] + cstart, row_len, cstart


def pack_block(block: RowBlock, R: int, L: int, k: int, l: int,
               code_table: np.ndarray = PACK_CODE):
    """A RowBlock -> (packed_codes (R, L/4) u8, packed_valid (R, L/8) u8,
    mlen, allow_short, rid, mate, cstart) through the host library's
    packer (ref: src/filter_common.rs:238). Codes come from
    ``code_table`` (byte -> 2-bit code; index build passes INDEX_CODE),
    validity from the bytes themselves. Unused rows have mlen -1."""
    n = len(block)
    pc, pv = pack_tile(block.arena, block.start, block.length, R, L,
                       code_table)
    mlen = np.full(R, -1, dtype=np.int32)
    mlen[:n] = block.length - (k - 1)
    allow_short = np.zeros(R, dtype=bool)
    allow_short[:n] = block.length < l
    rid, mate, cstart = (np.zeros(R, dtype=np.int32) for _ in range(3))
    rid[:n], mate[:n], cstart[:n] = block.rid, block.mate, block.cstart
    return pc, pv, mlen, allow_short, rid, mate, cstart


def pack_rows_packed(rows: list[_Row], R: int, L: int, k: int, l: int,
                     code_table: np.ndarray = PACK_CODE):
    """pack_block of a list of rows (their bytes joined into one
    arena)."""
    return pack_block(RowBlock.from_rows(rows), R, L, k, l, code_table)


def pack_rows_packed_plain(rows: list[_Row], R: int, L: int, k: int, l: int,
                           code_table: np.ndarray = PACK_CODE):
    """The plain version of pack_rows_packed, in NumPy: one arena concat,
    two table lookups and one flat scatter."""
    n = len(rows)
    codes = np.zeros((R, L), dtype=np.uint8)
    validb = np.zeros((R, L), dtype=bool)
    mlen = np.full(R, -1, dtype=np.int32)
    allow_short = np.zeros(R, dtype=bool)
    rid = np.zeros(R, dtype=np.int32)
    mate = np.zeros(R, dtype=np.int32)
    cstart = np.zeros(R, dtype=np.int32)
    if n:
        lens = np.fromiter((len(r.seq) for r in rows), dtype=np.int64, count=n)
        arena = np.frombuffer(b"".join(r.seq for r in rows), dtype=np.uint8)
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        row_of = np.repeat(np.arange(n, dtype=np.int64), lens)
        offs = np.arange(arena.size, dtype=np.int64) - np.repeat(starts, lens)
        dest = row_of * L + offs
        codes.reshape(-1)[dest] = code_table[arena]
        validb.reshape(-1)[dest] = VALID_BASE[arena]
        mlen[:n] = lens - (k - 1)
        allow_short[:n] = lens < l
        rid[:n] = np.fromiter((r.rid for r in rows), dtype=np.int32, count=n)
        mate[:n] = np.fromiter((r.mate for r in rows), dtype=np.int32, count=n)
        cstart[:n] = np.fromiter(
            (r.chunk_start for r in rows), dtype=np.int32, count=n
        )
    c = codes.reshape(R, L // 4, 4)
    packed_codes = c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4) | (
        c[:, :, 3] << 6
    )
    packed_valid = np.packbits(validb, axis=1, bitorder="little")
    return packed_codes, packed_valid, mlen, allow_short, rid, mate, cstart


def v4_row_budget(L: int, w: int, budget_frac: float) -> int:
    """Per-row slot budget Br: the budget fraction of the row, rounded up
    to a multiple of 128 (floor 128)."""
    return max(128, (int(budget_frac * L) + 127) // 128 * 128)


def default_budget_frac(w: int) -> float:
    """Minimizer-slot budget as a fraction of the row's positions: a 1.5x
    margin on the selection density 2/(w+1), clamped to [0.15, 0.5]
    (0.1875 at w=15). A row whose minimizers exceed it has its unit rerun
    on the device with a larger budget."""
    return min(0.5, max(0.15, 1.5 * 2.0 / (w + 1)))
