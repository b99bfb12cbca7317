"""The plain check of the server cell's answers: the binary response
frame decoded from the protocol's layout, each request's units mapped to
the pool's, and every answer compared with the reference's hits, totals
and keep (reference.py's ``unit_counts`` and ``keep_mask``, computed by
the driver after the window).

Response frame (little-endian): the magic ``DXR1``, ``n`` u32, then
``keep`` u8[n], ``hits`` u32[n], ``totals`` u32[n]. NumPy and struct
only: nothing of the program is imported.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"DXR1"
HEAD = 8


def decode_response(body: bytes) -> tuple:
    """(keep bool[n], hits int64[n], totals int64[n]) of a response frame;
    ValueError for a bad magic or a frame shorter or longer than its
    ``n`` says."""
    if len(body) < HEAD or body[:4] != MAGIC:
        raise ValueError("not a response frame")
    (n,) = struct.unpack_from("<I", body, 4)
    if len(body) != HEAD + 9 * n:
        raise ValueError(f"a frame of {n} units holds {len(body)} bytes")
    keep = np.frombuffer(body, np.uint8, n, HEAD)
    hits = np.frombuffer(body, "<u4", n, HEAD + n)
    totals = np.frombuffer(body, "<u4", n, HEAD + 5 * n)
    return keep != 0, hits.astype(np.int64), totals.astype(np.int64)


def frame_spans(n_units: int, per_frame: int) -> list:
    """The pool's units cut into requests of at most ``per_frame``: the
    (first, end) units of each request, in order."""
    return [(a, min(a + per_frame, n_units))
            for a in range(0, n_units, per_frame)]


def compare(spans: list, answers: dict, failed: int, hits: np.ndarray,
            totals: np.ndarray, keep: np.ndarray) -> dict:
    """The numbers that decide ``correct``, each with its limit 0.

    ``answers`` maps a request (an index into ``spans``) to the distinct
    response bodies it got in the window, each with the number of times
    it came back. ``units_wrong``: units of those responses whose keep,
    hits or totals differ from the reference's for their pool unit (every
    unit of a response of the wrong length). ``requests_failed``:
    ``failed`` (HTTP errors and timeouts, counted by the clients) plus
    the responses that are no frame or a short one."""
    wrong = 0
    bad = failed
    for f, bodies in answers.items():
        a, b = spans[f]
        want = (keep[a:b], hits[a:b], totals[a:b])
        for body, times in bodies:
            try:
                got = decode_response(body)
            except ValueError:
                bad += times
                continue
            if got[0].size != b - a:
                wrong += times * (b - a)
                continue
            diff = np.zeros(b - a, bool)
            for g, x in zip(got, want):
                diff |= g != x
            wrong += times * int(diff.sum())
    return {"units_wrong": {"value": wrong, "limit": 0},
            "requests_failed": {"value": bad, "limit": 0}}
