"""``index build --mesh pod-data``: multi-process data-parallel index
build (a copy of the JAX package's index/pod_build.py).

The reference builds an index in one process (ref: src/index.rs:167-308).
Here the input FASTX is split into record-aligned byte ranges (io/split.py,
the splitter of the filter's pod-data mode), each rank extracts the
minimizers of its own range on its card (IndexBuildPipeline: K1, or K3 at
k > 32) into a partial index ``<output>.podN``, and rank 0 merges the
sorted-unique partials, one linear pass per part in the host library,
into the final index. Minimizer selection is per record, so the union of
the per-record sets does not depend on which rank took which record: the
merged index is byte-identical to a one-process build.

Granularity is whole records: one chromosome-scale record is one unit of
work, so balance is best for multi-record inputs (pangenomes). Rank
identity comes from ``DEACON_NUM_PROC``/``DEACON_PROC_ID`` as in the
filter's pod-data mode; no coordinator is needed, and a missing part is
an error when DEACON_POD_TIMEOUT (seconds, default 86400) runs out.
``DEACON_POD_PARTS=keep`` leaves the per-rank partial indexes in place
for clusters without a shared output filesystem (merge them later with
``index union``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np

from ..constants import TOOL_NAME, VERSION
from ..filter.pod_data import _input_token, pod_rank


def _part_path(output_path: str, rank: int) -> str:
    return f"{output_path}.pod{rank}"


def _eprint(*args) -> None:
    import sys

    print(*args, file=sys.stderr)


def run_pod_build(config) -> None:
    """Entry point called by index.build.build for ``--mesh pod-data``."""
    from ..io.split import split_fastx_ranges
    from . import store
    from .build import _merge_sorted_unique, build

    if config.output_path is None or str(config.output_path) == "-":
        raise ValueError(
            "index build --mesh pod-data writes per-rank partial indexes "
            "and merges them; give -o a file path"
        )
    start = time.monotonic()
    nproc, rank = pod_rank()
    ranges = split_fastx_ranges(config.input_path, nproc)
    token = _input_token(config.input_path)
    run_id = os.environ.get("DEACON_POD_RUN_ID")
    if run_id:
        token = token + [run_id]
    part = _part_path(str(config.output_path), rank)
    # drop this rank's own leftover sidecar before building: a sidecar from
    # a completed earlier run on the same unchanged input would otherwise
    # release rank 0's barrier early (see filter/pod_data.py for the full
    # rationale and the DEACON_POD_RUN_ID escape hatch)
    try:
        os.unlink(part + ".stats.json")
    except FileNotFoundError:
        pass

    if rank == 0 and not config.quiet:
        _eprint(
            f"{TOOL_NAME} v{VERSION}; mode: build (pod-data, {nproc} "
            f"rank(s)); input: single; options: "
            f"capacity={config.capacity_millions}M, threads={config.threads}"
        )
        _eprint(
            f"Building index (k={config.kmer_length}, w={config.window_size})"
        )

    sub = dataclasses.replace(
        config, mesh=None, output_path=part, quiet=True
    )
    count, seq_count, total_bp = build(
        sub, _byte_range=ranges[rank], _return_stats=True
    )

    keep_parts = os.environ.get("DEACON_POD_PARTS") == "keep"
    payload = {
        "count": int(count),
        "seq_count": int(seq_count),
        "total_bp": int(total_bp),
        "input": token,
    }
    if keep_parts:
        if rank == 0 and not config.quiet:
            _eprint(
                "DEACON_POD_PARTS=keep: per-rank partial indexes left in "
                "place (merge with `index union`); stats below are rank "
                "0's shard only"
            )
            _eprint(
                f"Indexed {count} minimizers from {seq_count} sequence(s) "
                f"({total_bp}bp)"
            )
            _eprint(f"Completed in {time.monotonic() - start:.2f}s")
        return

    tmp = part + ".stats.json.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, part + ".stats.json")  # atomic: barrier signal

    if rank != 0:
        return

    # rank 0: wait for every partial, merge linearly, clean up
    timeout = float(os.environ.get("DEACON_POD_TIMEOUT", "86400"))
    deadline = time.monotonic() + timeout
    payloads: list[dict | None] = [None] * nproc
    while not all(p is not None for p in payloads):
        for r in range(nproc):
            if payloads[r] is not None:
                continue
            p = _part_path(str(config.output_path), r) + ".stats.json"
            try:
                with open(p) as f:
                    data = json.load(f)
            except (OSError, ValueError):
                continue
            if data.get("input") != token:
                raise RuntimeError(
                    f"stale pod-build sidecar {p}: it was written for a "
                    "different input file; remove leftover .pod* files"
                )
            payloads[r] = data
        if time.monotonic() > deadline:
            missing = [r for r in range(nproc) if payloads[r] is None]
            raise RuntimeError(
                f"pod-build barrier timeout ({timeout:.0f}s): no stats "
                f"sidecar from rank(s) {missing}. If ranks run on hosts "
                "without a shared filesystem, set DEACON_POD_PARTS=keep."
            )
        time.sleep(0.05)

    seq_count = sum(p["seq_count"] for p in payloads)
    total_bp = sum(p["total_bp"] for p in payloads)
    header = store.IndexHeader.new(config.kmer_length, config.window_size)
    merged = np.empty(0, dtype=np.uint64)
    for r in range(nproc):
        p = _part_path(str(config.output_path), r)
        merged = _merge_sorted_unique(merged, store.load_index(p).hashes)
    store.write_index(merged, header, config.output_path)
    for r in range(nproc):
        p = _part_path(str(config.output_path), r)
        os.unlink(p)
        os.unlink(p + ".stats.json")
    if not config.quiet:
        _eprint(
            f"Indexed {merged.size} minimizers from {seq_count} "
            f"sequence(s) ({total_bp}bp)"
        )
        _eprint(f"Completed in {time.monotonic() - start:.2f}s")
