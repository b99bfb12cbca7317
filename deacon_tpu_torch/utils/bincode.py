"""Byte-compatible codec for the reference index file format.

The reference serializes its index with bincode 2 "standard" configuration
(little-endian, variable-length integer encoding): an ``IndexHeader`` struct of
three u8 fields, a ``usize`` count, then ``count`` u64 hashes
(ref: src/index.rs:130-164, src/index.rs:57-72).

bincode standard varint encoding for unsigned integers:
  * u8 struct fields are written as a single raw byte;
  * wider unsigned ints: value < 251 -> 1 byte; <= u16::MAX -> 0xFB + u16 LE;
    <= u32::MAX -> 0xFC + u32 LE; <= u64::MAX -> 0xFD + u64 LE
    (0xFE + u128 LE for u128); usize is encoded as u64.

For a uniform-random u64 hash stream almost every record is 9 bytes
(0xFD prefix): the encoder writes an index's ascending keys as one byte
matrix per length class, and the decoder scans runs of one class, dropping
to Python only at the rare class transitions.
"""

from __future__ import annotations

import numpy as np

_BYTE_MAX = 250
_U16_MARK = 251
_U32_MARK = 252
_U64_MARK = 253

_LEN_BY_MARK = {_U16_MARK: 3, _U32_MARK: 5, _U64_MARK: 9}


def encode_uint(value: int) -> bytes:
    """Encode one unsigned integer in bincode-standard varint form."""
    if value <= _BYTE_MAX:
        return bytes([value])
    if value <= 0xFFFF:
        return bytes([_U16_MARK]) + int(value).to_bytes(2, "little")
    if value <= 0xFFFFFFFF:
        return bytes([_U32_MARK]) + int(value).to_bytes(4, "little")
    return bytes([_U64_MARK]) + int(value).to_bytes(8, "little")


def decode_uint(buf: memoryview, offset: int) -> tuple[int, int]:
    """Decode one varint at ``offset``; returns (value, new_offset)."""
    first = buf[offset]
    if first <= _BYTE_MAX:
        return first, offset + 1
    if first == _U16_MARK:
        return int.from_bytes(buf[offset + 1 : offset + 3], "little"), offset + 3
    if first == _U32_MARK:
        return int.from_bytes(buf[offset + 1 : offset + 5], "little"), offset + 5
    if first == _U64_MARK:
        return int.from_bytes(buf[offset + 1 : offset + 9], "little"), offset + 9
    raise ValueError(f"Unsupported bincode varint marker {first} at offset {offset}")


def encode_sorted_u64_array(values: np.ndarray) -> "bytes | np.ndarray":
    """Bincode-standard encoding of an ascending uint64 array (an index's
    keys). Ascending values fall into at most four contiguous runs of one
    record length each (1, 3, 5, 9 bytes), so each run is written as one
    (n, length) byte matrix: its marker column, then the low bytes of
    each value. Returns a bytes-like object (a uint8 array)."""
    v = np.ascontiguousarray(values, dtype=np.uint64)
    n = v.size
    if n == 0:
        return b""
    cuts = [0, *np.searchsorted(
        v, np.array([_BYTE_MAX + 1, 0x10000, 1 << 32], dtype=np.uint64)
    ).tolist(), n]
    runs = list(zip(cuts[:-1], cuts[1:], (1, 3, 5, 9),
                    (None, _U16_MARK, _U32_MARK, _U64_MARK)))
    out = np.empty(sum((b - a) * ln for a, b, ln, _ in runs), dtype=np.uint8)
    off = 0
    for a, b, ln, mark in runs:
        if b == a:
            continue
        rec = out[off:off + (b - a) * ln].reshape(b - a, ln)
        le = v[a:b].view(np.uint8).reshape(b - a, 8)  # little-endian hosts
        if mark is None:
            rec[:, 0] = le[:, 0]
        else:
            rec[:, 0] = mark
            rec[:, 1:] = le[:, :ln - 1]
        off += (b - a) * ln
    return out


def decode_u64_array(buf: np.ndarray, offset: int, count: int) -> tuple[np.ndarray, int]:
    """Vectorized decode of ``count`` bincode varint u64s from a uint8 array.

    Scans runs of same-length records: within a run all offsets are regular so
    decode is pure NumPy; transitions between length classes cost one Python
    iteration each (rare for hash data).
    """
    out = np.empty(count, dtype=np.uint64)
    pos = offset
    done = 0
    n_buf = buf.size
    while done < count:
        if pos >= n_buf:
            raise ValueError("Truncated index: ran out of bytes while decoding hashes")
        first = int(buf[pos])
        if first <= _BYTE_MAX:
            rec_len = 1
        else:
            rec_len = _LEN_BY_MARK.get(first)
            if rec_len is None:
                raise ValueError(f"Unsupported bincode varint marker {first}")
        remaining = count - done
        max_run = min(remaining, (n_buf - pos) // rec_len)
        if max_run <= 0:
            raise ValueError("Truncated index: ran out of bytes while decoding hashes")
        prefixes = buf[pos : pos + max_run * rec_len : rec_len]
        if rec_len == 1:
            run = int(np.argmax(prefixes > _BYTE_MAX)) if (prefixes > _BYTE_MAX).any() else max_run
            if run == 0:
                run = 1  # safeguard; shouldn't happen since first byte matched
            out[done : done + run] = prefixes[:run].astype(np.uint64)
        else:
            mism = prefixes != first
            run = int(np.argmax(mism)) if mism.any() else max_run
            if run == 0:
                raise AssertionError("run scan inconsistency")
            body = buf[pos : pos + run * rec_len].reshape(run, rec_len)[:, 1:]
            padded = np.zeros((run, 8), dtype=np.uint8)
            padded[:, : rec_len - 1] = body
            out[done : done + run] = padded.view("<u8").ravel()
        done += run
        pos += run * rec_len
    return out, pos
