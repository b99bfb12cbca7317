"""Index operations: build and info (ref: src/index.rs:167-308, 539-560).

``build`` extracts every record's minimizer hashes on the device
(ops/engine.IndexBuildPipeline) and keeps the distinct ones on the device
(ops/engine.DistinctHashes); the sorted set goes to disk once, in the
reference's format (index/store.py). Its standard-error lines are those of
the JAX package's ``index build``.
"""

from __future__ import annotations

import sys
import time

from ..config import IndexConfig
from ..constants import INDEX_BUILD_BATCH, TOOL_NAME, VERSION
from ..io.fastx import FastxReader, read_batch
from ..ops.engine import DistinctHashes, IndexBuildPipeline
from . import store


def _eprint(*args) -> None:
    print(*args, file=sys.stderr)


def build(config: IndexConfig) -> None:
    """ref: src/index.rs:167-308."""
    start = time.monotonic()
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
    pipe = IndexBuildPipeline(k, w, config.entropy_threshold,
                              device=config.device)
    reader = FastxReader.from_path(config.input_path)
    _eprint(f"Building index (k={k}, w={w})")
    _eprint(f"Engine: device extraction pipeline ({pipe.device})")
    distinct = DistinctHashes(pipe.device)
    seq_count = total_bp = 0
    while True:
        batch = read_batch(reader, INDEX_BUILD_BATCH)
        if not batch:
            break
        hashes, seq = pipe.extract_batch([r.seq for r in batch])
        running = distinct.add(hashes, seq, len(batch))
        for rec, total in zip(batch, running):
            seq_count += 1
            total_bp += len(rec.seq)
            if not config.quiet:
                _eprint(
                    f"  {rec.id.decode('utf-8', 'replace')} "
                    f"({len(rec.seq)}bp), total minimizers: {int(total)}"
                )
    keys = distinct.sorted_u64()
    _eprint(
        f"Indexed {keys.size} minimizers from {seq_count} sequence(s) "
        f"({total_bp}bp)"
    )
    store.write_index(keys, store.IndexHeader.new(k, w), config.output_path)
    _eprint(f"Completed in {time.monotonic() - start:.2f}s")


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
