"""Host-side row packing for the device pipeline.

Reads become fixed-length rows of a tile (L, R): long reads are split into
chunks at stride L - l + 1 (l = k + w - 1), so that every w-window of a
read lands in exactly one chunk, and each row is packed into 2-bit codes
(L/4 bytes, code j at bits 2(j%4) of byte j//4) plus a validity bitmask
(L/8 bytes, little-endian bit order). The extraction kernel reads these
linear planes directly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

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


def pack_rows_packed(rows: list[_Row], R: int, L: int, k: int, l: int,
                     code_table: np.ndarray = PACK_CODE):
    """Rows -> (packed_codes (R, L/4) u8, packed_valid (R, L/8) u8,
    mlen, allow_short, rid, mate, cstart), vectorized: one arena concat,
    two table lookups and one flat scatter (ref: src/filter_common.rs:238).
    Codes come from ``code_table`` (byte -> 2-bit code; index build passes
    INDEX_CODE), validity from the bytes themselves. Unused rows have
    mlen -1."""
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
