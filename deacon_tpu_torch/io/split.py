"""Record-aligned byte-range splitting of FASTX inputs for the
multi-process modes (``filter --mesh pod-data`` and ``pod-2d``, ``index
build --mesh pod-data``); a copy of the JAX package's io/split.py.

Each rank streams only its own contiguous slice of the input file, so
aggregate reads/s scales with the number of ranks, the scaling axis the
reference cannot offer (its engines are single-process; ref:
src/local_filter.rs:575, src/remote_filter.rs:431). Ranges are exact
record starts, so every range is a whole number of records and rank
outputs concatenate to the single-process result.

Plain (uncompressed) FASTA/FASTQ files split in raw byte space, and
BGZF-compressed files (bgzip/htslib framing, the port's own gzip output
among them) split in decompressed space via their block table
(``split_bgzf_ranges``). Serial codecs (plain gz/zst/xz/bz2) have no
mid-stream entry points; those inputs should be decompressed first or run
through ``--mesh pod``.

The host library reads every range (io/native_loader.NativeFastxReader
with ``byte_range``) and counts records for the paired split
(records_at_offsets, offsets_at_records); nothing here falls back to a
Python scan. RangeStream and BgzfRangeStream are the plain versions of
the range reader, for the tests.
"""

from __future__ import annotations

import bisect
import collections
import os
import zlib

from .fastx import _MAGICS

_CHUNK = 1 << 20


class SplitError(ValueError):
    pass


def _read_at(f, off: int, n: int) -> bytes:
    f.seek(off)
    return f.read(n)


def _line_starts_from(f, off: int, size: int):
    """Yield offsets of line starts at/after ``off`` (first yield is ``off``
    itself when it is a line start, i.e. off==0 or preceded by a newline)."""
    if off == 0:
        yield 0
    else:
        prev = _read_at(f, off - 1, 1)
        if prev == b"\n":
            yield off
    pos = off
    while pos < size:
        chunk = _read_at(f, pos, _CHUNK)
        if not chunk:
            return
        idx = -1
        while True:
            idx = chunk.find(b"\n", idx + 1)
            if idx < 0:
                break
            if pos + idx + 1 < size:
                yield pos + idx + 1
        pos += len(chunk)


def _readline_at(f, off: int, size: int) -> tuple[bytes, int]:
    """Read one newline-terminated line starting at ``off``; returns
    (line_without_newline, offset_after_newline). EOF counts as a line end."""
    parts = []
    pos = off
    while pos < size:
        chunk = _read_at(f, pos, min(_CHUNK, size - pos))
        if not chunk:  # actual EOF before the nominal size (lazy views)
            break
        nl = chunk.find(b"\n")
        if nl >= 0:
            parts.append(chunk[:nl])
            return b"".join(parts).rstrip(b"\r"), pos + nl + 1
        parts.append(chunk)
        pos += len(chunk)
    return b"".join(parts).rstrip(b"\r"), pos


def _validate_fastq_start(f, off: int, size: int, depth: int = 3) -> bool:
    """True when ``off`` parses as a FASTQ record start for ``depth``
    consecutive records (or a clean EOF). A quality line that begins with
    '@' cannot validate: parsing from it reads the next header as the
    sequence and the next sequence as the '+' line, and sequence lines
    never start with '+'."""
    pos = off
    for _ in range(depth):
        if pos >= size:
            return True
        hdr, pos2 = _readline_at(f, pos, size)
        if not hdr and pos2 == pos:
            return True  # clean EOF before the nominal size (lazy views)
        pos = pos2
        if not hdr.startswith(b"@"):
            return False
        seq, pos = _readline_at(f, pos, size)
        plus, pos = _readline_at(f, pos, size)
        if not plus.startswith(b"+"):
            return False
        qual, pos = _readline_at(f, pos, size)
        if len(qual) != len(seq):
            return False
    return True


def _boundary_at(f, target: int, size: int, is_fastq: bool) -> int:
    """First exact record-start offset at/after ``target`` (or ``size``)."""
    if target <= 0:
        return 0
    if target >= size:
        return size
    if not is_fastq:
        # FASTA: a '>' at a line start is always a record start (sequence
        # and header lines never start with '>')
        for ls in _line_starts_from(f, target, size):
            if _read_at(f, ls, 1) == b">":
                return ls
        return size
    for ls in _line_starts_from(f, target, size):
        if _read_at(f, ls, 1) == b"@" and _validate_fastq_start(f, ls, size):
            return ls
    return size


def _sniff_plain(f) -> tuple[bool | None, int]:
    """(is_fastq, size) for an open plain FASTX file; is_fastq is None for
    an empty file. Raises SplitError for compressed or unrecognized input."""
    f.seek(0)
    head = f.read(8)
    for magic, kind in _MAGICS:
        if head.startswith(magic):
            raise SplitError(
                f"--mesh pod-data cannot range-split {kind}-compressed "
                "input; decompress first, re-compress with bgzip (BGZF "
                "splits fine), or use --mesh pod"
            )
    size = os.fstat(f.fileno()).st_size
    if not head:
        return None, size
    if head[:1] not in (b">", b"@"):
        raise SplitError(f"Unrecognized FASTX record start: {head[:1]!r}")
    return head[:1] == b"@", size


def split_fastx_ranges(path: str | os.PathLike, n: int) -> list[tuple[int, int]]:
    """Split ``path`` into ``n`` contiguous byte ranges, each an exact whole
    number of FASTX records (possibly empty). Raises SplitError for stdin
    or compressed inputs."""
    if path is None or str(path) == "-":
        raise SplitError(
            "--mesh pod-data requires a seekable input file (stdin cannot "
            "be range-split across ranks)"
        )
    with open(path, "rb") as f:
        is_fastq, size = _sniff_plain(f)
        if is_fastq is None:
            return [(0, 0)] * n
        bounds = [0]
        for r in range(1, n):
            target = max(size * r // n, bounds[-1])
            bounds.append(_boundary_at(f, target, size, is_fastq))
        bounds.append(size)
    return [(bounds[r], bounds[r + 1]) for r in range(n)]


def _native_records_at_offsets(path, offsets, is_fastq):
    """The record index at each offset (the host library's
    dx_records_at_offsets, one scan of the mapped file); raises
    SplitError on a non-boundary offset."""
    from .native_loader import records_at_offsets

    if not offsets:
        return []
    try:
        return records_at_offsets(path, offsets, is_fastq)
    except ValueError as e:
        raise SplitError(str(e)) from None


def _native_offsets_at_records(path, indices, is_fastq):
    """The byte offset of each record index (dx_offsets_at_records)."""
    from .native_loader import offsets_at_records

    if not indices:
        return []
    return offsets_at_records(path, indices, is_fastq)


def split_paired_ranges(path1, path2, n: int, rank: int | None = None):
    """Split a paired-end input (two parallel FASTX files) into ``n``
    rank ranges: file1 is byte-split at record boundaries, then file2 is
    split at the SAME record indices so each rank pairs mate i of file1
    with mate i of file2 exactly as a single-process run would. Returns
    ``[((s1, e1), (s2, e2)), ...]``. When file2 has fewer records than
    file1 (the reference stops pairing at the shorter file,
    ref src/remote_filter.rs:931-955), trailing ranks get empty file2
    ranges and produce no output, matching the global semantics.

    With ``rank`` given, only that rank's entry is computed (the rest are
    None): the counting scans stop at rank's upper boundary instead of the
    last interior boundary, so rank r reads only ~(r+1)/n of each file.
    Aggregate startup I/O drops from ~n scans to ~n/2, and — the wall-clock
    critical path — the slowest rank scans each file at most once."""
    for p in (path1, path2):
        if p is None or str(p) == "-":
            raise SplitError(
                "--mesh pod-data requires seekable input files (stdin "
                "cannot be range-split across ranks)"
            )
    ranges1 = split_fastx_ranges(path1, n)
    interior = [r[0] for r in ranges1[1:]]
    need = len(interior) if rank is None else min(rank + 1, len(interior))
    recs: list[int] = []
    if interior[:need]:
        with open(path1, "rb") as f1:
            is_fq1, size1 = _sniff_plain(f1)
            if is_fq1 is None:
                recs = [0] * need
            else:
                recs = _native_records_at_offsets(
                    path1, interior[:need], is_fq1
                )
    with open(path2, "rb") as f2:
        is_fq2, size2 = _sniff_plain(f2)
        if is_fq2 is None:
            offs2 = [0] * need
            size2 = 0
        else:
            offs2 = _native_offsets_at_records(path2, recs, is_fq2)
    bounds2 = [0] + offs2 + [size2] * (n - need)
    ranges2 = [(bounds2[r], bounds2[r + 1]) for r in range(n)]
    out = list(zip(ranges1, ranges2))
    if rank is not None:
        return [pair if r == rank else None for r, pair in enumerate(out)]
    return out


# ---------------------------------------------------------------------------
# BGZF (blocked gzip) splitting: every block is a complete gzip member whose
# trailer records its decompressed size (ISIZE), so a compressed file walks
# into a (comp_offset, decompressed_offset) block table without inflating
# anything, ranks can start decompressing at any block boundary, and ranges
# are expressed as (comp_off, dskip, dlen): start at block ``comp_off``,
# drop ``dskip`` decompressed bytes (the partial record owned by the
# previous rank), deliver ``dlen`` decompressed bytes (-1 = to EOF). Both
# bgzip/htslib outputs and this tool's own gzip output (BGZF-framed by
# default, io/native deflate writer) split this way; serial gzip streams
# still cannot (no mid-stream entry points).
# ---------------------------------------------------------------------------

#: a pod-data input range over a BGZF file (decompressed-space semantics)
BgzfRange = collections.namedtuple("BgzfRange", ["comp_off", "dskip", "dlen"])


def _parse_bgzf_header(hdr: bytes):
    """Total member length from an 18-byte BGZF header, or None if ``hdr``
    is not a BGZF block header (gzip magic + FEXTRA with a BC subfield at
    the standard position)."""
    if len(hdr) < 18 or hdr[0] != 0x1F or hdr[1] != 0x8B or hdr[2] != 8:
        return None
    if not hdr[3] & 4:  # FEXTRA
        return None
    xlen = hdr[10] | (hdr[11] << 8)
    # scan the extra field for the BC subfield (bgzip puts it first; allow
    # any position within the declared XLEN as the spec does)
    extra = hdr[12:18]
    pos = 0
    # only the first subfield is visible in 18 bytes; BGZF writers put BC
    # first and xlen is almost always 6. Non-standard layouts fall back to
    # "not BGZF" (serial gzip handling).
    if xlen < 6 or len(extra) < 6:
        return None
    if extra[0] == 0x42 and extra[1] == 0x43 and extra[2] == 2 and extra[3] == 0:
        bsize = extra[4] | (extra[5] << 8)
        total = bsize + 1
        if total >= 12 + xlen:
            return total
    return None


def is_bgzf(path) -> bool:
    """True when ``path`` starts with a BGZF block header."""
    try:
        with open(path, "rb") as f:
            return _parse_bgzf_header(f.read(18)) is not None
    except OSError:
        return False


class _BgzfView:
    """Decompressed-space random access over a BGZF file with a lazily
    extended block table (walks compressed headers only — no inflation
    until a read) and a small decompressed-block cache. Provides the
    seek/read protocol ``_read_at`` needs, returning b"" past EOF."""

    def __init__(self, path):
        self._f = open(path, "rb", buffering=1 << 20)
        self._offs: list[int] = []  # compressed offset per block
        self._cums: list[int] = [0]  # cumulative decompressed size
        self._clens: list[int] = []  # compressed length per block
        self._walk_off = 0  # next compressed offset to parse
        self._eof = False
        self._cache: "collections.OrderedDict[int, bytes]" = (
            collections.OrderedDict()
        )
        self._pos = 0

    def close(self):
        self._f.close()

    # -- block table -----------------------------------------------------
    def _walk_one(self) -> bool:
        if self._eof:
            return False
        self._f.seek(self._walk_off)
        hdr = self._f.read(18)
        if not hdr:
            self._eof = True
            return False
        total = _parse_bgzf_header(hdr)
        if total is None:
            raise SplitError(
                f"not a BGZF block at compressed offset {self._walk_off} "
                "(serial gzip cannot be range-split; re-compress with "
                "bgzip or this tool's gzip writer, or use --mesh pod)"
            )
        rest = self._f.read(total - 18)
        if len(rest) < total - 18:
            raise SplitError("truncated BGZF block")
        isize = int.from_bytes(rest[-4:], "little")
        self._offs.append(self._walk_off)
        self._clens.append(total)
        self._cums.append(self._cums[-1] + isize)
        self._walk_off += total
        return True

    def walk_to_comp(self, comp_target: int) -> None:
        """Extend the block table to cover compressed offset ``comp_target``."""
        while not self._eof and self._walk_off <= comp_target:
            self._walk_one()

    def _walk_to_dec(self, doff: int) -> None:
        while not self._eof and self._cums[-1] <= doff:
            self._walk_one()

    def block_at_comp(self, comp_target: int) -> int:
        """Index of the first block at/after compressed ``comp_target``."""
        self.walk_to_comp(comp_target)
        return min(
            bisect.bisect_left(self._offs, comp_target),
            max(len(self._offs) - 1, 0),
        )

    def dsize(self) -> int:
        while self._walk_one():
            pass
        return self._cums[-1]

    # -- decompressed reads ----------------------------------------------
    def _block_bytes(self, i: int) -> bytes:
        got = self._cache.get(i)
        if got is not None:
            self._cache.move_to_end(i)
            return got
        self._f.seek(self._offs[i])
        raw = self._f.read(self._clens[i])
        got = zlib.decompressobj(wbits=31).decompress(raw)
        if len(got) != self._cums[i + 1] - self._cums[i]:
            raise SplitError("BGZF block ISIZE mismatch")
        self._cache[i] = got
        while len(self._cache) > 8:
            self._cache.popitem(last=False)
        return got

    def seek(self, off: int) -> None:
        self._pos = off

    def read(self, n: int) -> bytes:
        doff = self._pos
        self._walk_to_dec(doff + n - 1 if n > 0 else doff)
        out = []
        need = n
        while need > 0:
            if doff >= self._cums[-1] and self._eof:
                break
            i = bisect.bisect_right(self._cums, doff) - 1
            if i >= len(self._offs):
                break
            blk = self._block_bytes(i)
            rel = doff - self._cums[i]
            take = blk[rel : rel + need]
            if not take:
                # zero-length block (e.g. BGZF EOF marker): skip forward
                doff = self._cums[i + 1]
                continue
            out.append(take)
            doff += len(take)
            need -= len(take)
        data = b"".join(out)
        self._pos = doff
        return data


_BGZF_HUGE = 1 << 62


def split_bgzf_ranges(path, n: int, rank: int | None = None):
    """Split a BGZF-compressed FASTX file into ``n`` decompressed-space
    ranges ``BgzfRange(comp_off, dskip, dlen)``, each a whole number of
    records (``dlen`` -1 means to-EOF for the final rank). Boundaries are
    proportional in COMPRESSED space, so with ``rank`` given only that
    rank's prefix of the block table is walked (the rest of the returned
    list is None), mirroring ``split_paired_ranges``'s capped mode."""
    csize = os.path.getsize(path)
    view = _BgzfView(path)
    try:
        head = view.read(1)
        if not head:
            return [BgzfRange(0, 0, 0)] * (n - 1) + [BgzfRange(0, 0, -1)]
        if head not in (b">", b"@"):
            raise SplitError(f"Unrecognized FASTX record start: {head!r}")
        is_fastq = head == b"@"

        need_hi = n - 1 if rank is None else min(rank + 1, n - 1)
        dbounds = [0]
        for r in range(1, need_hi + 1):
            comp_target = csize * r // n
            bi = view.block_at_comp(comp_target)
            dtarget = max(view._cums[bi], dbounds[-1])
            dbounds.append(_boundary_at(view, dtarget, _BGZF_HUGE, is_fastq))
        ranges: list[BgzfRange | None] = []
        for r in range(n):
            if rank is not None and r != rank:
                ranges.append(None)
                continue
            if r >= len(dbounds):
                ranges.append(BgzfRange(0, 0, 0))
                continue
            d0 = dbounds[r]
            dlen = (
                dbounds[r + 1] - d0 if r + 1 < len(dbounds) else -1
            )
            if d0 >= _BGZF_HUGE:  # boundary search hit EOF: empty range
                ranges.append(
                    BgzfRange(0, 0, 0) if dlen != -1 else BgzfRange(0, 0, -1)
                )
                continue
            view._walk_to_dec(d0)
            bi = max(bisect.bisect_right(view._cums, d0) - 1, 0)
            bi = min(bi, len(view._offs) - 1)
            ranges.append(
                BgzfRange(view._offs[bi], d0 - view._cums[bi], dlen)
            )
        return ranges
    finally:
        view.close()


class BgzfRangeStream:
    """Readline/read stream over a BgzfRange of a BGZF file: the plain
    version of the host library's BGZF range reader (io/fastx.FastxReader
    over it yields the same records)."""

    def __init__(self, path, comp_off: int, dskip: int, dlen: int):
        self._f = open(path, "rb", buffering=1 << 20)
        self._f.seek(comp_off)
        self._z = zlib.decompressobj(wbits=31)
        self._left = dlen  # -1 = unbounded
        self._buf = b""
        self._eof = False
        while dskip > 0:
            chunk = self._fill_raw(min(dskip, _CHUNK))
            if not chunk:
                break
            dskip -= len(chunk)

    def _fill_raw(self, n: int) -> bytes:
        """Up to ``n`` decompressed bytes straight from the codec.
        Handles both zlib leftover channels: ``unconsumed_tail`` (input
        withheld by max_length — re-feed to the SAME decompressor) and
        ``unused_data`` (input past a member end — feed to a FRESH one).
        The ``eof`` check must come FIRST: a max_length-limited call that
        ends a member reports the SAME remainder in both channels
        (measured CPython behavior: unconsumed_tail == unused_data), and
        feeding a finished decompressor returns b"" while appending the
        input to unused_data — an infinite loop."""
        out = []
        need = n
        while need > 0:
            if self._z.eof:
                tail = self._z.unused_data
                if not tail:
                    if self._eof:
                        break
                    tail = self._f.read(1 << 16)
                    if not tail:
                        self._eof = True
                        break
                self._z = zlib.decompressobj(wbits=31)
                got = self._z.decompress(tail, need)
            elif self._z.unconsumed_tail:
                got = self._z.decompress(self._z.unconsumed_tail, need)
            else:
                raw = self._f.read(1 << 16)
                if not raw:
                    self._eof = True
                    break
                got = self._z.decompress(raw, need)
            if got:
                out.append(got)
                need -= len(got)
        return b"".join(out)

    def _fill(self, n: int) -> bytes:
        if self._left == 0:
            return b""
        want = n if self._left < 0 else min(n, self._left)
        data = self._fill_raw(want)
        if self._left > 0:
            self._left -= len(data)
        return data

    def readline(self) -> bytes:
        while True:
            nl = self._buf.find(b"\n")
            if nl >= 0:
                line, self._buf = self._buf[: nl + 1], self._buf[nl + 1 :]
                return line
            more = self._fill(_CHUNK)
            if not more:
                line, self._buf = self._buf, b""
                return line
            self._buf += more

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            parts = [self._buf]
            self._buf = b""
            while True:
                got = self._fill(_CHUNK)
                if not got:
                    break
                parts.append(got)
            return b"".join(parts)
        while len(self._buf) < n:
            got = self._fill(max(n - len(self._buf), _CHUNK))
            if not got:
                break
            self._buf += got
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def close(self) -> None:
        self._f.close()


class RangeStream:
    """Binary stream over ``path[start:end)`` (a whole number of records)
    satisfying the readline/read protocol FastxReader needs: the plain
    version of the host library's plain-file range reader."""

    def __init__(self, path: str | os.PathLike, start: int, end: int):
        self._f = open(path, "rb", buffering=1 << 20)
        self._f.seek(start)
        self._left = end - start

    def readline(self) -> bytes:
        if self._left <= 0:
            return b""
        line = self._f.readline(self._left)
        self._left -= len(line)
        return line

    def read(self, n: int = -1) -> bytes:
        if self._left <= 0:
            return b""
        n = self._left if n < 0 else min(n, self._left)
        data = self._f.read(n)
        self._left -= len(data)
        return data

    def close(self) -> None:
        self._f.close()
