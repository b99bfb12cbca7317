"""Read pools for filter traffic: Illumina-like pairs or ONT-like single
reads, a share of them drawn from the host stand-in genome, written as
FASTQ files (plain or gzip).

Every size is fixed by the traffic's parameters and does not depend on
the seed: read lengths are quantiles of their distribution, the number
of host units, poly-G tails and low-complexity stretches are exact
counts, their lengths are evenly spaced over their ranges, and which
read of which length gets what, and the order of the reads, are fixed
too. The seed draws every base, position and quality.

Parameters (a traffic file's ``pool``):

- ``layout``: ``paired_files`` (R1 and R2, one pair a unit) or
  ``single`` (one read a unit);
- ``units``: the number of pairs or reads;
- ``read_len``: fixed read length, or ``lengths``: ``{"lognormal":
  {"median", "mean", "min", "max"}}`` for single reads;
- ``fragment``: ``[lo, hi]`` insert sizes of host pairs;
- ``host_share``: the share of units drawn from the host genome;
- ``poly_g``: ``{"share", "min", "max"}``: reads whose tail is G;
- ``low_complexity``: ``{"share", "min", "max"}``: reads with a stretch
  of a short repeat, at most half the read;
- ``quality``: a name of QUALITY;
- ``gzip_level``: absent for plain FASTQ, else each file is one gzip
  member, as pigz writes it: pieces of ``GZIP_CHUNK`` input bytes
  deflated apart, each ended by a sync flush (no BGZF extra field, so a
  reader inflates it serially). The pieces end byte-aligned and never
  final, so the body can be repeated inside the one member.
"""

from __future__ import annotations

import statistics
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
COMP = np.arange(256, dtype=np.uint8)
COMP[list(b"ACGT")] = list(b"TGCA")
REPEATS = (b"A", b"G", b"AC", b"CAG", b"TTAGGG")
GZIP_CHUNK = 8 << 20
GZIP_HEADER = b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\xff"
_PLUS = np.frombuffer(b"\n+\n", np.uint8)

#: quality symbols and their shares: NovaSeq's four bins (Q2, 12, 23, 37)
#: and a spread of ONT-like Phred scores (Q5-Q30, most near Q15)
QUALITY = {
    "novaseq_binned": {"#": 0.01, "-": 0.03, "8": 0.08, "F": 0.88},
    "ont": {chr(33 + q): float(np.exp(-0.5 * ((q - 15) / 5.0) ** 2))
            for q in range(5, 31)},
}


def quality_table(name: str) -> np.ndarray:
    """256 quality symbols whose shares follow QUALITY[name]; a random
    byte indexes it."""
    shares = QUALITY[name]
    sym = np.frombuffer("".join(shares).encode(), np.uint8)
    edges = np.cumsum(np.array(list(shares.values()), np.float64))
    edges = edges / edges[-1] * 256
    return sym[np.minimum(np.searchsorted(edges, np.arange(256) + 0.5),
                          sym.size - 1)]


def random_bases(rng, n: int) -> np.ndarray:
    return ACGT[rng.integers(0, 256, n, dtype=np.uint8) & 3]


def spaced(lo: int, hi: int, n: int) -> np.ndarray:
    """n lengths evenly spaced over [lo, hi]."""
    return np.rint(np.linspace(lo, hi, n)).astype(np.int64) if n else (
        np.zeros(0, np.int64))


def lognormal_lengths(n: int, median: float, mean: float, lo: int,
                      hi: int) -> np.ndarray:
    """The n quantiles (i + 1/2) / n of a log-normal with this median and
    mean, clipped to [lo, hi]."""
    mu = np.log(median)
    sigma = np.sqrt(2 * np.log(mean / median))
    z = np.array([statistics.NormalDist().inv_cdf((i + 0.5) / n)
                  for i in range(n)])
    return np.clip(np.rint(np.exp(mu + sigma * z)), lo, hi).astype(np.int64)


@dataclass
class FastqFile:
    """One FASTQ file of the pool: its bytes (plain) and each record's
    start (``rec_off``, with the end as the last entry)."""

    data: np.ndarray
    rec_off: np.ndarray

    def records(self, idx: np.ndarray) -> np.ndarray:
        """The plain bytes of records ``idx`` (ascending), in order."""
        lens = np.diff(self.rec_off)
        mask = np.zeros(lens.size, bool)
        mask[idx] = True
        return self.data[np.repeat(mask, lens)]


@dataclass
class Pool:
    """Sequences in unit order (a pair's mates adjacent), laid end to end
    in ``arena``; ``files`` hold the records, file f the mates f."""

    arena: np.ndarray
    starts: np.ndarray
    lens: np.ndarray
    unit_of_seq: np.ndarray
    n_units: int
    paired: bool
    files: list = field(default_factory=list)


def _fill_from_genome(arena, starts, lens, seqs, src, rev, genome) -> None:
    """Sequences ``seqs`` copied from ``genome[src:src + len]``, reverse
    complemented where ``rev``."""
    L = lens[seqs]
    if L.size == 0:
        return
    j = np.arange(int(L.sum())) - np.repeat(np.cumsum(L) - L, L)
    rev_b = np.repeat(rev, L)
    at = np.where(rev_b, np.repeat(src + L - 1, L) - j, np.repeat(src, L) + j)
    b = genome[at]
    arena[np.repeat(starts[seqs], L) + j] = np.where(rev_b, COMP[b], b)


def _fastq(arena, starts, lens, names: np.ndarray, qual_lut, rng) -> FastqFile:
    """FASTQ records ``names[i]`` (fixed-width, '@' and '\\n' included),
    the sequence and a quality string of its length."""
    n, h = names.shape
    if n == 0:
        return FastqFile(np.zeros(0, np.uint8), np.zeros(1, np.int64))
    rec_len = h + 2 * lens + 4
    rec_off = np.concatenate([[0], np.cumsum(rec_len)])
    total_bases = int(lens.sum())
    qual = qual_lut[rng.integers(0, 256, total_bases, dtype=np.uint8)]
    if np.all(lens == lens[0]):  # fixed length: one row a record
        L = int(lens[0])
        out = np.empty((n, h + 2 * L + 4), np.uint8)
        out[:, :h] = names
        seq = arena[(starts[:, None] + np.arange(L)).ravel()]
        out[:, h:h + L] = seq.reshape(n, L)
        out[:, h + L:h + L + 3] = _PLUS
        out[:, h + L + 3:h + 2 * L + 3] = qual.reshape(n, L)
        out[:, -1] = ord("\n")
        return FastqFile(out.ravel(), rec_off)
    # variable lengths: few, long records, copied one by one
    out = np.empty(int(rec_off[-1]), np.uint8)
    q = 0
    for i, (a, s, L) in enumerate(zip(rec_off[:-1].tolist(), starts.tolist(),
                                      lens.tolist())):
        out[a:a + h] = names[i]
        a += h
        out[a:a + L] = arena[s:s + L]
        out[a + L:a + L + 3] = _PLUS
        out[a + L + 3:a + 2 * L + 3] = qual[q:q + L]
        out[a + 2 * L + 3] = ord("\n")
        q += L
    return FastqFile(out, rec_off)


def _names(prefix: bytes, n: int, suffix: bytes) -> np.ndarray:
    """Fixed-width headers ``@<prefix><9 digits><suffix>\\n``."""
    i = np.arange(n, dtype=np.int64)
    digits = (i[:, None] // 10 ** np.arange(8, -1, -1)) % 10 + ord("0")
    head = np.frombuffer(b"@" + prefix, np.uint8)
    tail = np.frombuffer(suffix + b"\n", np.uint8)
    return np.concatenate([np.broadcast_to(head, (n, head.size)),
                           digits.astype(np.uint8),
                           np.broadcast_to(tail, (n, tail.size))], axis=1)


def _ranks(n: int, count: int, phase: float) -> np.ndarray:
    """``count`` ranks evenly spread over ``range(n)``."""
    return ((np.arange(count) + phase) * n / max(count, 1)).astype(np.int64)


def make_pool(params: dict, genome: np.ndarray, rng) -> Pool:
    """The pool's sequences and FASTQ bytes (not yet written).

    Every unit's shape (its read lengths, whether it is from the host,
    its fragment, poly-G tail and low-complexity stretch) and its place
    in the pool are the same for every seed; the seed draws the bases,
    the host positions and strands, where a stretch lies in its read,
    and the qualities."""
    paired = params["layout"] == "paired_files"
    n_units = int(params["units"])
    mates = 2 if paired else 1
    n_seq = n_units * mates
    fixed = np.random.default_rng(0)  # the shapes and order every seed shares
    if "read_len" in params:
        lens_r = np.full(n_seq, int(params["read_len"]), np.int64)
    else:
        ln = params["lengths"]["lognormal"]
        lens_r = lognormal_lengths(n_seq, ln["median"], ln["mean"],
                                   ln["min"], ln["max"])
    # shapes by rank (sequence s of rank unit s // mates)
    host_r = np.zeros(n_units, bool)
    frag_r = np.zeros(n_units, np.int64)
    n_host = int(round(n_units * float(params["host_share"])))
    host_ranks = _ranks(n_units, n_host, 0.5)
    host_r[host_ranks] = True
    if paired:
        lo, hi = params["fragment"]
        frag_r[host_ranks] = fixed.permutation(spaced(lo, hi, n_host))
    tail_r = np.zeros(n_seq, np.int64)
    if "poly_g" in params:
        p = params["poly_g"]
        n_g = int(round(n_seq * float(p["share"])))
        tail_r[_ranks(n_seq, n_g, 0.25)] = fixed.permutation(
            spaced(p["min"], p["max"], n_g))
    lc_r = np.zeros(n_seq, np.int64)
    kind_r = np.zeros(n_seq, np.int64)
    if "low_complexity" in params:
        p = params["low_complexity"]
        n_lc = int(round(n_seq * float(p["share"])))
        at = _ranks(n_seq, n_lc, 0.75)
        lc_r[at] = np.minimum(fixed.permutation(
            spaced(p["min"], p["max"], n_lc)), lens_r[at] // 2)
        kind_r[at] = np.arange(n_lc) % len(REPEATS)

    # one order of the units for every seed; the seed draws their bases
    unit_perm = fixed.permutation(n_units)
    seq_perm = (mates * unit_perm[:, None] + np.arange(mates)).ravel()
    lens = lens_r[seq_perm]
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    arena = random_bases(rng, int(lens.sum()))
    unit_of_seq = np.repeat(np.arange(n_units, dtype=np.int64), mates)

    host = np.nonzero(host_r[unit_perm])[0]
    rev = rng.random(host.size) < 0.5
    if paired:
        frag = frag_r[unit_perm][host]
        src = rng.integers(0, genome.size - frag, dtype=np.int64)
        L = int(params["read_len"])
        # the fragment's left end read forward, its right end reverse
        # complemented; the other strand swaps the mates
        left, right = src, src + frag - L
        first = np.where(rev, right, left)
        second = np.where(rev, left, right)
        _fill_from_genome(arena, starts, lens, 2 * host, first, rev, genome)
        _fill_from_genome(arena, starts, lens, 2 * host + 1, second, ~rev,
                          genome)
    else:
        L = lens[host]
        src = (rng.random(host.size) * (genome.size - L)).astype(np.int64)
        _fill_from_genome(arena, starts, lens, host, src, rev, genome)

    tails = tail_r[seq_perm]
    which = np.nonzero(tails)[0]
    t = np.minimum(tails[which], lens[which])
    end = starts[which] + lens[which]
    j = np.arange(int(t.sum())) - np.repeat(np.cumsum(t) - t, t)
    arena[np.repeat(end - t, t) + j] = ord("G")

    lc, kind = lc_r[seq_perm], kind_r[seq_perm]
    for s in np.nonzero(lc)[0].tolist():
        m, unit = int(lc[s]), REPEATS[int(kind[s])]
        a = int(starts[s]) + int(rng.integers(0, int(lens[s]) - m + 1))
        arena[a:a + m] = np.frombuffer((unit * (m // len(unit) + 1))[:m],
                                       np.uint8)

    pool = Pool(arena, starts, lens, unit_of_seq, n_units, paired)
    qual_lut = quality_table(params["quality"])
    tag = b"P" if paired else b"O"
    for f in range(mates):
        seqs = np.arange(f, n_seq, mates)
        suffix = f" {f + 1}:N:0:1".encode() if paired else b""
        pool.files.append(_fastq(arena, starts[seqs], lens[seqs],
                                 _names(tag, n_units, suffix), qual_lut, rng))
    return pool


def _deflate_pieces(data: np.ndarray, level: int, threads: int) -> bytes:
    """Raw deflate of GZIP_CHUNK-byte pieces of ``data``, each compressed
    apart on ``threads`` threads (zlib releases the interpreter lock) and
    ended by a sync flush: byte-aligned, never final."""
    view = memoryview(data)
    parts = [view[i:i + GZIP_CHUNK] for i in range(0, data.size, GZIP_CHUNK)]

    def deflate(part):
        c = zlib.compressobj(level, zlib.DEFLATED, -15)
        return c.compress(part) + c.flush(zlib.Z_SYNC_FLUSH)

    with ThreadPoolExecutor(max(1, threads)) as ex:
        return b"".join(ex.map(deflate, parts))


@dataclass
class FileBytes:
    """A pool file's bytes: ``head``, then ``body`` once or over and
    over, then ``tail(repeat)``. A plain file is its body alone; a gzip
    file is one member, its body deflate pieces and its tail the final
    empty block and the trailer of the body's data repeated."""

    head: bytes
    body: bytes
    data: np.ndarray
    gzip: bool

    def tail(self, repeat: int) -> bytes:
        if not self.gzip:
            return b""
        crc = 0
        for _ in range(repeat):
            crc = zlib.crc32(self.data, crc)
        size = (repeat * self.data.size) & 0xFFFFFFFF
        end = zlib.compressobj(6, zlib.DEFLATED, -15).flush(zlib.Z_FINISH)
        return end + crc.to_bytes(4, "little") + size.to_bytes(4, "little")

    def whole(self, repeat: int = 1) -> bytes:
        return self.head + self.body * repeat + self.tail(repeat)


def pool_bytes(pool: Pool, params: dict,
               threads: int = 8) -> tuple[str, list[FileBytes]]:
    """The pool's FASTQ files as written (plain, or gzip at
    ``gzip_level``) and their extension (``.fastq`` or ``.fastq.gz``)."""
    level = params.get("gzip_level")
    if level is None:
        return ".fastq", [FileBytes(b"", fq.data.tobytes(), fq.data, False)
                          for fq in pool.files]
    return ".fastq.gz", [
        FileBytes(GZIP_HEADER, _deflate_pieces(fq.data, int(level), threads),
                  fq.data, True) for fq in pool.files]

