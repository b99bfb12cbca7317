"""Index operations: build, info, union and diff
(ref: src/index.rs:167-664).

``build`` extracts every record's minimizer hashes on the device
(ops/engine.IndexBuildPipeline) and keeps the distinct ones on the device
(ops/engine.DistinctHashes); the sorted set goes to disk once, in the
reference's format (index/store.py). ``diff`` against a FASTX stream
takes the same extraction and clears the first index's keys on the device
(ops/engine.KeptKeys). ``union`` and index-minus-index ``diff`` are host
set operations on the sorted keys, one linear pass each in the host
library (io/native_loader.u64_merge_sorted_unique, u64_diff_sorted_unique).
Input is read in batches by the host library's reader; a Python object
is made per record only for the lines printed. Their standard-error
lines are those of the JAX package's commands.

``build --device host`` is the JAX package's host route (_build_host):
the host library extracts each batch while a thread reads the next,
and the distinct keys gather in its counting set (printing per-record
running totals) or, in a quiet build, in its accumulator, which sorts
while it writes the index.
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time

from pathlib import Path

import numpy as np

from ..config import IndexConfig
from ..constants import DIFF_STREAM_BATCH, INDEX_BUILD_BATCH, TOOL_NAME, VERSION
from ..device import resolve_device
from ..io.fastx import FastxReader, RecordBatch
from ..io.native_loader import (
    NativeCountingSet,
    NativeRunAcc,
    empty_huge,
    extract_batch,
    u64_diff_sorted_unique,
    u64_merge_sorted_unique,
    u64_sort_unique,
)
from ..ops.engine import DistinctHashes, IndexBuildPipeline, KeptKeys
from . import store


#: ``index diff`` against FASTX reports its progress every this many bases
PROGRESS_BP = 1_000_000_000


def _eprint(*args) -> None:
    print(*args, file=sys.stderr)


def build(config: IndexConfig, _byte_range=None, _return_stats=False):
    """ref: src/index.rs:167-308.

    ``_byte_range`` and ``_return_stats`` serve ``index build --mesh
    pod-data`` (index/pod_build.py): build from one record-aligned byte
    range of the input (io/split.py) and return (distinct keys, sequences,
    bases) without the banner and the summary lines."""
    if config.mesh is not None and config.mesh != "pod-data":
        raise ValueError(
            f"index build supports --mesh pod-data only, got {config.mesh!r}"
        )
    if config.mesh == "pod-data" and _byte_range is None:
        from .pod_build import run_pod_build

        return run_pod_build(config)
    start = time.monotonic()
    if not _return_stats:
        options = [f"capacity={config.capacity_millions}M"]
        if config.threads > 0:
            options.append(f"threads={config.threads}")
        _eprint(
            f"{TOOL_NAME} v{VERSION}; mode: build; input: single; "
            f"options: {', '.join(options)}"
        )
    k, w = config.kmer_length, config.window_size
    # l = k + w - 1 must be odd (canonical tie-break; ref: src/index.rs:186-194)
    if (k + w - 1) % 2 == 0:
        raise ValueError(
            f"Constraint violated: k + w - 1 must be odd (k={k}, w={w})"
        )
    if config.device == "host":
        return _build_host(config, start, _byte_range, _return_stats)
    pipe = IndexBuildPipeline(k, w, config.entropy_threshold,
                              device=config.device)
    reader = FastxReader.from_path(config.input_path, byte_range=_byte_range)
    if not _return_stats:
        _eprint(f"Building index (k={k}, w={w})")
        _eprint(f"Engine: device extraction pipeline ({pipe.device})")
    distinct = DistinctHashes(pipe.device)
    seq_count = total_bp = 0
    while len(batch := reader.read_batch(INDEX_BUILD_BATCH)):
        hashes, seq = pipe.extract_arena(batch.arena, batch.seq_starts,
                                         batch.seq_lens)
        running = distinct.add(hashes, seq, len(batch))
        seq_count += len(batch)
        total_bp += int(batch.seq_lens.sum())
        if not config.quiet:
            for i, total in enumerate(running.tolist()):
                _eprint(f"  {_rid(batch, i)} ({int(batch.seq_lens[i])}bp), "
                        f"total minimizers: {total}")
    keys = distinct.sorted_u64()
    if _return_stats:
        store.write_index(keys, store.IndexHeader.new(k, w),
                          config.output_path)
        return keys.size, seq_count, total_bp
    _eprint(
        f"Indexed {keys.size} minimizers from {seq_count} sequence(s) "
        f"({total_bp}bp)"
    )
    store.write_index(keys, store.IndexHeader.new(k, w), config.output_path)
    _eprint(f"Completed in {time.monotonic() - start:.2f}s")


#: raw hashes held by a quiet build to stdout before they are folded into
#: the sorted keys
MERGE_WATERMARK = 500_000_000


def _prefetched_batches(reader):
    """(meta, arena) of each batch of ``reader``, read by a thread one
    batch ahead of the caller: read_batch_raw's views die at the next
    read, so the thread copies each batch once into buffers that come
    back for reuse when the caller asks for the next batch (recycled, not
    freed: fresh batch-sized allocations fault their pages in again). A
    read error is raised here; closing the generator ends the thread."""
    stop = threading.Event()
    batches: queue.Queue = queue.Queue(maxsize=2)
    free: queue.Queue = queue.Queue()

    def put(item) -> None:
        while not stop.is_set():
            try:
                batches.put(item, timeout=0.2)
                return
            except queue.Full:
                pass

    def detach(meta, arena):
        try:
            m, a = free.get_nowait()
        except queue.Empty:
            m = a = None
        if m is None or m.size < meta.size:
            m = empty_huge(max(meta.size, 1), np.int64)
        if a is None or a.size < arena.size:
            a = empty_huge(max(arena.size, 1), np.uint8)
        m[:meta.size] = meta.ravel()
        a[:arena.size] = arena
        return m[:meta.size].reshape(meta.shape), a[:arena.size], (m, a)

    def produce():
        try:
            while not stop.is_set():
                meta, arena = reader.read_batch_raw(INDEX_BUILD_BATCH)
                put(detach(meta, arena) if meta.shape[0] else None)
                if not meta.shape[0]:
                    return
        except Exception as e:  # raised on the consumer's side
            put(e)

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()
    try:
        while (item := batches.get()) is not None:
            if isinstance(item, BaseException):
                raise item
            yield item[0], item[1]
            free.put(item[2])
    finally:
        stop.set()
        thread.join()


def _build_host(config: IndexConfig, start: float, byte_range,
                return_stats: bool):
    """``index build --device host`` (the JAX package's host route): the
    host library extracts; a counting set yields each record's running
    total, or, quiet, an accumulator takes whole batches and writes the
    index to a file while it sorts. A quiet build to stdout sorts and
    deduplicates its raw hashes (u64_sort_unique) and writes them
    (index_write_sorted). Same index bytes and lines as the device
    route."""
    k, w = config.kmer_length, config.window_size
    reader = FastxReader.from_path(config.input_path, byte_range=byte_range)
    if not return_stats:
        _eprint(f"Building index (k={k}, w={w})")
        _eprint("Engine: host extraction (native C++)")
    hint = config.capacity_millions * 1_000_000
    to_file = config.output_path not in (None, "-")
    cset = None if config.quiet else NativeCountingSet(hint)
    runacc = NativeRunAcc(hint) if config.quiet and to_file else None
    keys = np.empty(0, dtype=np.uint64)
    pending: list[np.ndarray] = []
    pending_size = 0

    def fold_pending() -> None:
        nonlocal keys, pending, pending_size
        if pending:
            raw = np.concatenate(pending)
            keys = u64_merge_sorted_unique(keys, u64_sort_unique(raw))
            pending, pending_size = [], 0

    # the hashes are consumed before the next batch is extracted, except
    # by a quiet build to stdout, which keeps them in `pending`
    scratch = None if config.quiet and runacc is None else {}
    seq_count = total_bp = 0
    batches = _prefetched_batches(reader)
    try:
        for meta, arena in batches:
            lens = meta[:, 3].copy()
            hashes, _, counts = extract_batch(
                arena, meta[:, 2].copy(), lens, k, w, index_mode=True,
                entropy_threshold=config.entropy_threshold,
                n_threads=config.threads, scratch=scratch)
            seq_count += lens.size
            total_bp += int(lens.sum())
            if runacc is not None:
                runacc.add(hashes)
            elif cset is None:
                pending.append(hashes)
                pending_size += hashes.size
                if pending_size > MERGE_WATERMARK:
                    fold_pending()
            else:
                ends = np.cumsum(counts).tolist()
                for i, end in enumerate(ends):
                    cset.insert(hashes[end - int(counts[i]):end],
                                n_threads=config.threads)
                    off, n = meta[i, :2].tolist()
                    rid = arena[off:off + n].tobytes().decode("utf-8",
                                                              "replace")
                    _eprint(f"  {rid} ({int(lens[i])}bp), total minimizers: "
                            f"{len(cset)}")
    finally:
        batches.close()  # the reading thread ends before the reader
        reader.close()
    header = store.IndexHeader.new(k, w)
    if runacc is not None:
        trailer = store.PROVENANCE_MAGIC + bytes([store.SCHEME_DXTP_FMIX32_V1])
        tmp = f"{config.output_path}.tmp{os.getpid()}"
        try:
            count = runacc.finish_write(tmp, header.format_version, k, w,
                                        trailer, config.threads)
        except OSError:
            Path(tmp).unlink(missing_ok=True)
            raise
        if count is not None:
            os.replace(tmp, config.output_path)
            runacc.close()
            if return_stats:
                return count, seq_count, total_bp
            _eprint(f"Indexed {count} minimizers from {seq_count} "
                    f"sequence(s) ({total_bp}bp)")
            _eprint(f"Completed in {time.monotonic() - start:.2f}s")
            return None
        # a count with no 4-byte varint form: the generic writer
        keys = runacc.export_sorted()
        runacc.close()
    elif cset is not None:
        keys = cset.export_sorted(config.threads)
        cset.close()
    else:
        fold_pending()
    if return_stats:
        store.write_index(keys, header, config.output_path)
        return keys.size, seq_count, total_bp
    _eprint(f"Indexed {keys.size} minimizers from {seq_count} sequence(s) "
            f"({total_bp}bp)")
    store.write_index(keys, header, config.output_path)
    _eprint(f"Completed in {time.monotonic() - start:.2f}s")
    return None


def _rid(batch: RecordBatch, i: int) -> str:
    off, n = batch.meta[i, :2].tolist()
    return batch.arena[off:off + n].tobytes().decode("utf-8", "replace")


def info(index_path: str) -> None:
    """ref: src/index.rs:539-560. Reads the header and count only."""
    start = time.monotonic()
    header, count = store.load_header_and_count(index_path)
    scheme = store.read_provenance(index_path)
    _eprint("Index information:")
    _eprint(f"  Format version: {header.format_version}")
    _eprint(f"  K-mer length (k): {header.kmer_length}")
    _eprint(f"  Window size (w): {header.window_size}")
    _eprint(f"  Distinct minimizer count: {count}")
    if scheme is not None:
        name = store.SCHEME_NAMES.get(scheme, f"id {scheme}")
        _eprint(f"  Origin: deacon-tpu (selection scheme: {name})")
    else:
        _eprint(
            "  Origin: unknown (no deacon-tpu provenance trailer — likely "
            "built by upstream deacon; selection schemes differ, see INTEROP.md)"
        )
    _eprint(f"Retrieved index info in {time.monotonic() - start:.2f}s")


def _merge_sorted_unique(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Union of two sorted-unique u64 arrays, one linear pass in the host
    library."""
    return u64_merge_sorted_unique(a, b)


def _merge_sorted_unique_plain(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The plain version of _merge_sorted_unique: their concatenation is
    two ascending runs, which a stable sort (timsort) merges in one pass,
    and the duplicates are then adjacent."""
    c = np.concatenate([a, b])
    c.sort(kind="stable")
    first = np.ones(c.size, dtype=bool)
    first[1:] = c[1:] != c[:-1]
    return c[first]


def union(inputs: list[str], output: str | None,
          capacity_millions: int | None) -> None:
    """ref: src/index.rs:563-664."""
    start = time.monotonic()
    if not inputs:
        raise ValueError("No input files provided for union operation")
    headers_and_counts = [store.load_header_and_count(p) for p in inputs]
    header = headers_and_counts[0][0]
    total_capacity = (
        capacity_millions * 1_000_000
        if capacity_millions is not None
        else sum(c for _, c in headers_and_counts)
    )
    _eprint(
        f"Performing union of indexes (k={header.kmer_length}, "
        f"w={header.window_size})"
    )
    if capacity_millions is not None:
        _eprint(f"Pre-allocating user-specified capacity for {total_capacity} "
                "minimizers")
    else:
        _eprint(
            f"No capacity specified, pre-allocating worst-case capacity for "
            f"{total_capacity} minimizers from {len(inputs)} indexes"
        )
    for i, (file_header, _) in enumerate(headers_and_counts):
        if (file_header.kmer_length != header.kmer_length
                or file_header.window_size != header.window_size):
            raise ValueError(
                f"Incompatible headers: index {i} has "
                f"k={file_header.kmer_length}, w={file_header.window_size}, "
                f"but first index has k={header.kmer_length}, "
                f"w={header.window_size}"
            )
    # the output is ours only if EVERY input carries our trailer
    out_scheme = store.SCHEME_DXTP_FMIX32_V1
    for path in inputs:
        if store.read_provenance(path) != store.SCHEME_DXTP_FMIX32_V1:
            store.warn_if_foreign_index(path)
            out_scheme = None
    merged = np.empty(0, dtype=np.uint64)
    for i, path in enumerate(inputs):
        before = merged.size
        merged = _merge_sorted_unique(merged, store.load_index(path).hashes)
        _eprint(
            f"Index {i + 1}: expected {headers_and_counts[i][1]} minimizers, "
            f"added {merged.size - before} new, total: {merged.size}"
        )
    store.write_index(merged, header, output, scheme=out_scheme)
    _eprint(
        f"United {len(inputs)} indexes with {merged.size} total minimizers "
        f"in {time.monotonic() - start:.2f}s"
    )


def _stream_diff_fastx(fastx_path: str, k: int, w: int,
                       first_header: store.IndexHeader,
                       first_hashes: np.ndarray, device) -> np.ndarray:
    """The first index's keys less the minimizers of a FASTX stream
    (ref: src/index.rs:311-418): each batch's minimizers are extracted on
    ``device`` and clear the keys they hit there. The progress line after
    each gigabase reports the keys removed up to that record exactly."""
    if k != first_header.kmer_length or w != first_header.window_size:
        raise ValueError(
            f"FASTX parameters (k={k}, w={w}) must match first index "
            f"(k={first_header.kmer_length}, w={first_header.window_size})"
        )
    src = "stdin" if str(fastx_path) == "-" else "file"
    _eprint(f"Second index: processing FASTX from {src} (k={k}, w={w})…")
    reader = FastxReader.from_path(fastx_path)
    pipe = IndexBuildPipeline(k, w, 0.0, device=device)
    keys = KeptKeys(first_hashes, pipe.device)
    seq_count = total_bp = 0
    while len(batch := reader.read_batch(DIFF_STREAM_BATCH)):
        lens = batch.seq_lens
        hashes, seq = pipe.extract_arena(batch.arena, batch.seq_starts, lens)
        # the bases after each record, and the records at which a
        # gigabase ends (each such record prints a progress line)
        cum = total_bp + np.cumsum(lens)
        gb = cum // PROGRESS_BP
        ends = np.nonzero(gb > np.concatenate(
            [[total_bp // PROGRESS_BP], gb[:-1]]))[0]
        # running counts only for a batch in which a gigabase ends
        running = keys.remove(hashes, seq if ends.size else None, len(batch))
        for j in ends.tolist():
            _eprint(f"  Processed {seq_count + j + 1} sequences "
                    f"({int(cum[j])}bp), removed {int(running[j])} "
                    "minimizers")
        seq_count += len(batch)
        total_bp = int(cum[-1])
    _eprint(f"Processed {seq_count} sequences ({total_bp}bp) from FASTX file")
    return keys.remaining()


def diff(first: str, second: str, kmer_length: int | None,
         window_size: int | None, output: str | None,
         device: str = "cuda") -> None:
    """Set difference A - B; B is an index or a FASTX stream, whose
    minimizers are extracted on ``device`` (ref: src/index.rs:421-536)."""
    start = time.monotonic()
    device = resolve_device(device)
    first_idx = store.load_index(first)
    _eprint(f"First index: loaded {len(first_idx)} minimizers")
    before = len(first_idx)
    # the output is a subset of the first index: it keeps its provenance
    out_scheme = store.read_provenance(first)
    if out_scheme is None:
        store.warn_if_foreign_index(first)

    def finish(remaining: np.ndarray) -> None:
        _eprint(f"Removed {before - remaining.size} minimizers, "
                f"{remaining.size} remaining")
        store.write_index(remaining, first_idx.header, output,
                          scheme=out_scheme)
        _eprint(f"Completed difference operation in "
                f"{time.monotonic() - start:.2f}s")

    header = first_idx.header
    if kmer_length is not None and window_size is not None:
        finish(_stream_diff_fastx(second, kmer_length, window_size, header,
                                  first_idx.hashes, device))
        return
    try:
        second_idx = store.load_index(second)
    except Exception:
        # not an index: a FASTX stream at the first index's k and w
        finish(_stream_diff_fastx(second, header.kmer_length,
                                  header.window_size, header,
                                  first_idx.hashes, device))
        return
    _eprint(f"Second index: loaded {len(second_idx)} minimizers")
    store.warn_if_foreign_index(second)
    if (second_idx.header.kmer_length != header.kmer_length
            or second_idx.header.window_size != header.window_size):
        raise ValueError(
            f"Incompatible headers: second index has "
            f"k={second_idx.header.kmer_length}, "
            f"w={second_idx.header.window_size}, but first index has "
            f"k={header.kmer_length}, w={header.window_size}"
        )
    finish(u64_diff_sorted_unique(first_idx.hashes, second_idx.hashes))
