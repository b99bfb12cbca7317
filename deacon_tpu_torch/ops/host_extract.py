"""Host-side batched filter extraction for the host decider and the
client.

Same contract as ``minimizers_np.get_minimizer_hashes_and_positions``
(ref: src/filter_common.rs:211-310), through the host library's batched
extraction (io/native_loader.extract_batch, bit-identical to the NumPy
oracle, which stays as its plain version: extract_filter_batch_plain).
"""

from __future__ import annotations

import numpy as np

from ..constants import MAX_K_FILTER
from ..io.native_loader import extract_batch
from . import minimizers_np as mnp
from .pack import effective_lengths, join_seqs


def _check_k(k: int) -> None:
    if k > MAX_K_FILTER:
        raise ValueError(
            "Indexing the bitmask of invalid characters requires "
            f"k<={MAX_K_FILTER}, but it is {k}"
        )


def extract_filter_arena(
    arena: np.ndarray, start: np.ndarray, length: np.ndarray,
    prefix_length: int, k: int, w: int,
) -> list[tuple[np.ndarray, np.ndarray, bytes]]:
    """Per sequence ``arena[start[i]:start[i] + length[i]]``: (hashes
    u64, positions u32, effective_seq bytes), the effective sequence
    being the prefix cut with one trailing newline stripped (b"" below k
    bases)."""
    _check_k(k)
    eff = effective_lengths(arena, start, length, prefix_length, k)
    hashes, pos, counts = extract_batch(arena, start, eff, k, w,
                                        index_mode=False)
    ab = np.ascontiguousarray(arena).tobytes()
    ends = np.cumsum(counts)
    return [
        (hashes[e - c:e], pos[e - c:e], ab[s:s + n])
        for s, n, c, e in zip(start.tolist(), eff.tolist(), counts.tolist(),
                              ends.tolist())
    ]


def extract_filter_batch(
    seqs: list[bytes], prefix_length: int, k: int, w: int
) -> list[tuple[np.ndarray, np.ndarray, bytes]]:
    """Per sequence: (hashes u64, positions u32, effective_seq bytes)."""
    return extract_filter_arena(*join_seqs(seqs), prefix_length, k, w)


def extract_filter_batch_plain(
    seqs: list[bytes], prefix_length: int, k: int, w: int
) -> list[tuple[np.ndarray, np.ndarray, bytes]]:
    """The plain version of extract_filter_batch: the NumPy oracle, one
    sequence at a time."""
    _check_k(k)
    return [
        mnp.get_minimizer_hashes_and_positions(s, prefix_length, k, w)
        for s in seqs
    ]
