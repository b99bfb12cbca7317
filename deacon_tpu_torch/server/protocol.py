"""RPC protocol types, wire-compatible with the reference's JSON schema
(ref: src/server_common.rs:8-58) and with the JAX package's server and
client, binary frame included.

UnpairedFilterRequest.input: list of [hashes: [u64], positions: [u32],
seq: [u8]] triples; PairedFilterRequest.input uses seqs: [[u8], ...].
FilterResponse.should_output: list of [keep, hit_count, total, [kmers]].

The client sends pre-hashed minimizers — minimizer computation stays
client-side; the server does set membership + thresholds only.

Binary frame (deacon-tpu extension, negotiated): the JSON wire spends
~40 bytes of decimal text per hash.  A client MAY instead POST
`application/x-deacon-binary` (magic "DXB1"): little-endian packed
struct-of-arrays, ~12.5 bytes/hash + sequence bytes.  The server
answers in kind with a "DXR1" frame.  JSON remains the default and the
only wire a reference server/client ever sees; debug-kmer requests always
use JSON (the debug path is not performance-relevant).

  request:  "DXB1" | flags u8 (1=paired 2=deplete 4=debug) | k u8 |
            reserved u16 | abs u32 | rel f64 | n_units u32 |
            counts u32[n] | seqlens u32[n or 2n] |
            hashes u64[sum] | positions u32[sum] | seq bytes
  response: "DXR1" | n u32 | keep u8[n] | hits u32[n] | totals u32[n]
"""

from __future__ import annotations

import json

import numpy as np

BINARY_CTYPE = "application/x-deacon-binary"
_REQ_MAGIC = b"DXB1"
_RESP_MAGIC = b"DXR1"


def encode_unpaired_request(
    batch: list[tuple[np.ndarray, np.ndarray, bytes]],
    abs_threshold: int,
    rel_threshold: float,
    deplete: bool,
    kmer_length: int,
    debug: bool,
) -> bytes:
    payload = {
        "input": [
            [h.tolist(), p.tolist(), list(s)] for h, p, s in batch
        ],
        "abs_threshold": abs_threshold,
        "rel_threshold": rel_threshold,
        "deplete": deplete,
        "kmer_length": kmer_length,
        "debug": debug,
    }
    return json.dumps(payload).encode()


def encode_paired_request(
    batch: list[tuple[np.ndarray, np.ndarray, tuple]],
    abs_threshold: int,
    rel_threshold: float,
    deplete: bool,
    kmer_length: int,
    debug: bool,
) -> bytes:
    payload = {
        "input": [
            [h.tolist(), p.tolist(), [list(s) for s in seqs]]
            for h, p, seqs in batch
        ],
        "abs_threshold": abs_threshold,
        "rel_threshold": rel_threshold,
        "deplete": deplete,
        "kmer_length": kmer_length,
        "debug": debug,
    }
    return json.dumps(payload).encode()


def is_binary_request(body: bytes) -> bool:
    return body[:4] == _REQ_MAGIC


def encode_binary_request(
    batch, abs_threshold, rel_threshold, deplete, kmer_length, debug,
    paired: bool,
) -> bytes:
    import struct

    n = len(batch)
    flags = (1 if paired else 0) | (2 if deplete else 0) | (4 if debug else 0)
    head = _REQ_MAGIC + struct.pack(
        "<BBHIdI", flags, kmer_length, 0, abs_threshold, rel_threshold, n
    )
    counts = np.fromiter(
        (len(h) for h, _, _ in batch), dtype=np.uint32, count=n
    )
    if paired:
        seqlens = np.fromiter(
            (len(s) for _, _, ss in batch for s in ss),
            dtype=np.uint32, count=2 * n,
        )
        seqs = b"".join(s for _, _, ss in batch for s in ss)
    else:
        seqlens = np.fromiter(
            (len(s) for _, _, s in batch), dtype=np.uint32, count=n
        )
        seqs = b"".join(s for _, _, s in batch)
    hashes = (
        np.concatenate([np.asarray(h, dtype=np.uint64) for h, _, _ in batch])
        if n else np.zeros(0, np.uint64)
    )
    positions = (
        np.concatenate([np.asarray(p, dtype=np.uint32) for _, p, _ in batch])
        if n else np.zeros(0, np.uint32)
    )
    return b"".join([
        head, counts.tobytes(), seqlens.tobytes(),
        hashes.astype("<u8").tobytes(), positions.astype("<u4").tobytes(),
        seqs,
    ])


def decode_binary_request(body: bytes):
    """-> (batch, abs, rel, deplete, k, debug, paired)."""
    import struct

    if body[:4] != _REQ_MAGIC:
        raise ValueError("bad binary request magic")
    flags, k, _res, abs_t, rel_t, n = struct.unpack_from("<BBHIdI", body, 4)
    paired = bool(flags & 1)
    off = 4 + struct.calcsize("<BBHIdI")
    counts = np.frombuffer(body, dtype="<u4", count=n, offset=off)
    off += 4 * n
    nsl = 2 * n if paired else n
    seqlens = np.frombuffer(body, dtype="<u4", count=nsl, offset=off)
    off += 4 * nsl
    total = int(counts.sum())
    hashes = np.frombuffer(body, dtype="<u8", count=total, offset=off)
    off += 8 * total
    positions = np.frombuffer(body, dtype="<u4", count=total, offset=off)
    off += 4 * total
    hsplit = np.cumsum(counts)[:-1].astype(np.int64)
    hs = np.split(hashes.astype(np.uint64), hsplit)
    ps = np.split(positions.astype(np.uint32), hsplit)
    batch = []
    spos = off
    if paired:
        for i in range(n):
            l1, l2 = int(seqlens[2 * i]), int(seqlens[2 * i + 1])
            s1 = body[spos:spos + l1]
            s2 = body[spos + l1:spos + l1 + l2]
            spos += l1 + l2
            batch.append((hs[i], ps[i], (s1, s2)))
    else:
        for i in range(n):
            ln = int(seqlens[i])
            batch.append((hs[i], ps[i], body[spos:spos + ln]))
            spos += ln
    return (
        batch, int(abs_t), float(rel_t), bool(flags & 2), int(k),
        bool(flags & 4), paired,
    )


def encode_binary_response(decisions) -> bytes:
    import struct

    n = len(decisions)
    keep = np.fromiter((k for k, _, _, _ in decisions), dtype=np.uint8,
                       count=n)
    hits = np.fromiter((h for _, h, _, _ in decisions), dtype=np.uint32,
                       count=n)
    tot = np.fromiter((t for _, _, t, _ in decisions), dtype=np.uint32,
                      count=n)
    return (
        _RESP_MAGIC + struct.pack("<I", n)
        + keep.tobytes() + hits.tobytes() + tot.tobytes()
    )


def decode_binary_response(body: bytes):
    import struct

    if body[:4] != _RESP_MAGIC:
        raise ValueError("bad binary response magic")
    (n,) = struct.unpack_from("<I", body, 4)
    off = 8
    keep = np.frombuffer(body, dtype=np.uint8, count=n, offset=off)
    off += n
    hits = np.frombuffer(body, dtype="<u4", count=n, offset=off)
    off += 4 * n
    tot = np.frombuffer(body, dtype="<u4", count=n, offset=off)
    return [
        (bool(keep[i]), int(hits[i]), int(tot[i]), [])
        for i in range(n)
    ]


def decode_request(body: bytes, paired: bool):
    """Returns (batch, abs, rel, deplete, k, debug) where batch entries are
    (hashes u64 array, positions u32 array, seq bytes or list of seq bytes)."""
    obj = json.loads(body)
    batch = []
    for entry in obj["input"]:
        h = np.asarray(entry[0], dtype=np.uint64)
        p = np.asarray(entry[1], dtype=np.uint32)
        if paired:
            seqs = tuple(bytes(s) for s in entry[2])
        else:
            seqs = bytes(entry[2])
        batch.append((h, p, seqs))
    return (
        batch,
        int(obj["abs_threshold"]),
        float(obj["rel_threshold"]),
        bool(obj["deplete"]),
        int(obj["kmer_length"]),
        bool(obj["debug"]),
    )


def encode_response(decisions) -> bytes:
    return json.dumps(
        {"should_output": [[k, h, t, km] for k, h, t, km in decisions]}
    ).encode()


def decode_response(body: bytes):
    obj = json.loads(body)
    return [
        (bool(k), int(h), int(t), list(km))
        for k, h, t, km in obj["should_output"]
    ]
