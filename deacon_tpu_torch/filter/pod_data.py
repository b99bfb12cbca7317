"""``--mesh pod-data`` and ``--mesh pod-2d``: multi-process
data-parallel filtering (a copy of the JAX package's filter/pod_data.py).

Where ``--mesh pod`` cuts the INDEX across processes (memory scaling;
every rank streams the same input), pod-data cuts the INPUT: each rank
filters its own record-aligned byte range of the input file (for paired
two-file inputs, both files are split at the SAME record indices, io/
split.py ``split_paired_ranges``, so every rank pairs mate i with mate i
exactly as a single process would) with rank-local compute only (the
device pipeline on its card, or a rank-local sharded mesh via
DEACON_POD_ENGINE/DEACON_POD_LOCAL_MESH; never a collective), so
aggregate reads/s scales with the number of ranks. The reference cannot
scale this way: its engines are single-process and the index is
replicated per process (ref: src/index.rs:96-107).

Rank identity comes from ``DEACON_NUM_PROC`` / ``DEACON_PROC_ID``
directly: pod-data runs no collective, so it works with any launcher
(mpirun, GNU parallel, k8s) and needs no coordinator.

Per-rank outputs are written as ``<output>.podN[.gz|.zst|.xz]`` part files
whose compressed members concatenate to a valid stream. Completion is
signaled through ``<part>.stats.json`` sidecars on the shared filesystem
(written atomically after the part is finished); rank 0 waits for all of
them, aggregates the stats, concatenates the parts into the final output,
and cleans up, so the result is byte-identical to a single-process run.
A missing sidecar is an error when DEACON_POD_TIMEOUT (seconds, default
86400) runs out. On clusters without a shared filesystem set
``DEACON_POD_PARTS=keep`` to leave each rank's part in place and skip the
merge (rank 0 then reports rank-local stats only).

``--mesh pod-2d`` combines both: groups of ``DEACON_POD_SHARDS`` ranks,
each group a pod (ops/engine.DevicePipeline over a PodMesh of the group's
process group) over its own byte range.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

from ..config import FilterConfig
from ..parallel.multihost import maybe_init_distributed
from ..parallel.multihost import world as pod_rank

_STATS_FIELDS = (
    "total_seqs", "filtered_seqs", "total_bp", "output_bp", "filtered_bp",
    "output_seq_counter",
)


def _codec_suffix(output_path: str) -> str:
    for ext in (".gz", ".zst", ".xz"):
        if output_path.endswith(ext):
            return ext
    return ""


def part_path(output_path: str, rank: int) -> str:
    """Per-rank part file; keeps the compression extension last so the
    part is encoded with the final output's codec (gz/zst/xz members
    concatenate to a valid stream)."""
    return f"{output_path}.pod{rank}{_codec_suffix(output_path)}"


def _validate(config: FilterConfig) -> None:
    if config.minimizers_path is None:
        raise ValueError("--mesh pod-data requires a local index file")
    if config.rename:
        raise ValueError(
            "--rename is not supported with --mesh pod-data: output "
            "sequence numbers are global but ranks write their parts "
            "concurrently; use --mesh pod"
        )
    if config.input_path == "-" or config.input2_path == "-":
        raise ValueError(
            "--mesh pod-data requires seekable input files (stdin cannot "
            "be range-split across ranks); use --mesh pod"
        )
    if config.output_path == "-" or config.output2_path == "-":
        raise ValueError(
            "--mesh pod-data writes per-rank part files and concatenates "
            "them; give -o/-O a file path"
        )
    if (
        config.output2_path is not None
        and os.path.abspath(config.output2_path)
        == os.path.abspath(config.output_path)
    ):
        raise ValueError("-o and -O must name different files")


def _input_token(path: str) -> list[int]:
    st = os.stat(path)
    return [int(st.st_size), int(st.st_mtime_ns)]


def _write_stats_sidecar(part: str, stats, token: list[int]) -> None:
    payload = {f: getattr(stats, f) for f in _STATS_FIELDS}
    payload["input"] = token
    tmp = part + ".stats.json.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, part + ".stats.json")  # atomic: barrier signal


def _await_stats(output_path: str, nproc: int, token: list[int],
                 timeout: float):
    """Rank 0: wait for every rank's stats sidecar (the completion barrier),
    validating each against this run's input token (guards against stale
    sidecars from a different input)."""
    deadline = time.monotonic() + timeout
    payloads = [None] * nproc
    while True:
        for r in range(nproc):
            if payloads[r] is not None:
                continue
            p = part_path(output_path, r) + ".stats.json"
            try:
                with open(p) as f:
                    data = json.load(f)
            except (OSError, ValueError):
                continue
            if data.get("input") != token:
                raise RuntimeError(
                    f"stale pod-data sidecar {p}: it was written for a "
                    "different input file; remove leftover .pod* files"
                )
            payloads[r] = data
        if all(p is not None for p in payloads):
            return payloads
        if time.monotonic() > deadline:
            missing = [r for r in range(nproc) if payloads[r] is None]
            raise RuntimeError(
                f"pod-data barrier timeout ({timeout:.0f}s): no stats "
                f"sidecar from rank(s) {missing}. If ranks run on hosts "
                "without a shared filesystem, set DEACON_POD_PARTS=keep."
            )
        time.sleep(0.05)


def _compute_ranges(config: FilterConfig, n: int, rank: int):
    """Record-aligned input ranges for ``n`` consumers; only entry ``rank``
    is guaranteed non-None (rank-capped scans). Returns (ranges, token)."""
    from ..io.split import (
        SplitError,
        is_bgzf,
        split_bgzf_ranges,
        split_fastx_ranges,
        split_paired_ranges,
    )

    paired = config.input2_path is not None
    if paired:
        if is_bgzf(config.input_path) or is_bgzf(config.input2_path):
            raise SplitError(
                f"--mesh {config.mesh} supports BGZF input single-end only "
                "(paired splitting needs a record-counting scan in "
                "decompressed space); decompress first or use --mesh pod"
            )
        # rank-capped: rank r's counting scan stops at its own upper
        # boundary (~(r+1)/n of each file), so the slowest rank scans each
        # file at most once and aggregate startup I/O is ~n/2 scans, not ~n
        ranges = split_paired_ranges(
            config.input_path, config.input2_path, n, rank=rank
        )
        token = _input_token(config.input_path) + _input_token(
            config.input2_path
        )
    else:
        if is_bgzf(config.input_path):
            # BGZF (bgzip/htslib framing, incl. this tool's own gzip
            # output): ranks enter at block boundaries and read their
            # decompressed-space slice (io/split.py BgzfRange)
            ranges = split_bgzf_ranges(config.input_path, n, rank=rank)
        else:
            ranges = split_fastx_ranges(config.input_path, n)
        token = _input_token(config.input_path)
    run_id = os.environ.get("DEACON_POD_RUN_ID")
    if run_id:
        token = token + [run_id]
    return ranges, token


def _unlink_quiet(path: str) -> None:
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass


def _merge_parts(config: FilterConfig, n_parts: int, token, stats,
                 part2) -> None:
    """Rank 0: wait on every part's stats sidecar, aggregate stats in place,
    concatenate the parts into the final output(s), clean up."""
    timeout = float(os.environ.get("DEACON_POD_TIMEOUT", "86400"))
    payloads = _await_stats(config.output_path, n_parts, token, timeout)
    for f in _STATS_FIELDS:
        setattr(stats, f, sum(p[f] for p in payloads))
    finals = [config.output_path]
    if part2 is not None:
        finals.append(config.output2_path)
    for fi, final in enumerate(finals):
        with open(final, "wb") as out:
            for r in range(n_parts):
                p = part_path(final, r)
                with open(p, "rb") as src:
                    while True:
                        chunk = src.read(1 << 22)
                        if not chunk:
                            break
                        out.write(chunk)
                os.unlink(p)
                if fi == 0:
                    os.unlink(p + ".stats.json")


def run_pod_2d(config: FilterConfig) -> None:
    """``--mesh pod-2d``: the combined 2D distribution.

    The N ranks form G groups of S = ``DEACON_POD_SHARDS`` consecutive
    processes (N = G*S). Each GROUP owns one record-aligned byte range of
    the input (reads/s scales with G, like pod-data), while WITHIN a group
    the index is value-range sharded across the S hosts' devices and
    membership merges with a psum over the group mesh (index memory scales
    with S, like pod) — so an index too big for one host can still be
    filtered at scaled reads/s. Every rank of a group streams the same
    range (group-SPMD; decisions replicate within the group); the group
    leader (rank % S == 0) writes the group's part, and global rank 0
    concatenates parts exactly like pod-data.

    Requires torch.distributed (``DEACON_COORD`` et al.) for more than one
    rank: the group meshes span processes.
    """
    from . import engine

    _validate(config)
    start_time = time.monotonic()
    nproc, rank = pod_rank()
    try:
        n_shard = int(os.environ.get("DEACON_POD_SHARDS", ""))
    except ValueError:
        n_shard = 0
    if n_shard <= 0 or nproc % n_shard:
        raise ValueError(
            "--mesh pod-2d requires DEACON_POD_SHARDS (index shards per "
            f"group) to divide DEACON_NUM_PROC; got shards="
            f"{os.environ.get('DEACON_POD_SHARDS')!r}, nproc={nproc}"
        )
    if nproc > 1 and not os.environ.get("DEACON_COORD"):
        raise ValueError(
            "--mesh pod-2d needs torch.distributed: set DEACON_COORD, "
            "DEACON_NUM_PROC and DEACON_PROC_ID on every rank"
        )
    maybe_init_distributed()
    n_groups = nproc // n_shard
    group, leader = rank // n_shard, rank % n_shard == 0

    ranges, token = _compute_ranges(config, n_groups, group)
    paired = config.input2_path is not None
    part = part_path(config.output_path, group)
    part2 = (
        part_path(config.output2_path, group)
        if paired and config.output2_path is not None
        else None
    )
    if leader:
        # see run_pod_data: drop this group's leftover sidecar up front
        _unlink_quiet(part + ".stats.json")

    sub = dataclasses.replace(
        config,
        mesh="pod-2d",
        output_path=part if leader else os.devnull,
        output2_path=(part2 if leader else os.devnull)
        if part2 is not None else None,
        summary_path=None,
        quiet=config.quiet or rank != 0,
    )
    stats, k, w = engine.run(sub, _byte_range=ranges[group], _return_stats=True)

    keep_parts = os.environ.get("DEACON_POD_PARTS") == "keep"
    quiet = config.quiet or config.debug
    if keep_parts:
        if rank == 0 and not quiet:
            print(
                "DEACON_POD_PARTS=keep: per-group outputs left in place; "
                "stats below are group 0's shard only",
                file=sys.stderr,
            )
    else:
        if leader:
            _write_stats_sidecar(part, stats, token)
        if rank == 0:
            _merge_parts(config, n_groups, token, stats, part2)

    if rank == 0:
        engine._finish_run(
            config, stats, start_time, quiet,
            f"{engine.TOOL_NAME} {engine.VERSION}",
            str(config.minimizers_path), k, w,
        )


def run_pod_data(config: FilterConfig) -> None:
    """Entry point called by filter.engine.run for ``--mesh pod-data``."""
    from . import engine

    _validate(config)
    start_time = time.monotonic()
    nproc, rank = pod_rank()

    # every rank computes the same split (single-end: boundary probes only —
    # O(1) seeks per boundary, or a compressed-header walk for BGZF input;
    # paired: file1 boundary probes plus one counting scan of each file to
    # align file2 at the same record indices)
    paired = config.input2_path is not None
    ranges, token = _compute_ranges(config, nproc, rank)
    part = part_path(config.output_path, rank)
    part2 = (
        part_path(config.output2_path, rank)
        if paired and config.output2_path is not None
        else None
    )
    # Drop this rank's own leftover sidecar BEFORE filtering: a sidecar
    # from a completed earlier run on the same unchanged input would pass
    # token validation and release rank 0's barrier while this run is
    # still rewriting the part. This closes the race once the rank has
    # started; for straggler ranks that haven't launched yet, set
    # DEACON_POD_RUN_ID to a fresh value on all ranks (it is folded into
    # the token) or remove leftover .pod* files before relaunching.
    _unlink_quiet(part + ".stats.json")

    # Per-rank engine: by default each rank runs the device pipeline on its
    # card over its range, with the whole table. DEACON_POD_ENGINE=sharded
    # (implied by DEACON_POD_LOCAL_MESH) takes the rank-local sharded
    # pipeline instead, its blocks built from the file's keys of their
    # rows: for indexes that outgrow host memory or one card.
    engine_mode = os.environ.get("DEACON_POD_ENGINE", "auto")
    if engine_mode not in ("auto", "sharded"):
        raise ValueError(f"DEACON_POD_ENGINE must be auto|sharded, got {engine_mode!r}")
    sharded = engine_mode == "sharded" or bool(os.environ.get("DEACON_POD_LOCAL_MESH"))
    sub = dataclasses.replace(
        config,
        mesh="pod-data" if sharded else None,
        output_path=part,
        output2_path=part2,
        summary_path=None,
        quiet=config.quiet or rank != 0,
    )
    stats, k, w = engine.run(sub, _byte_range=ranges[rank], _return_stats=True)

    keep_parts = os.environ.get("DEACON_POD_PARTS") == "keep"
    quiet = config.quiet or config.debug
    if keep_parts:
        if rank == 0 and not quiet:
            print(
                "DEACON_POD_PARTS=keep: per-rank outputs left in place; "
                "stats below are rank 0's shard only",
                file=sys.stderr,
            )
    else:
        _write_stats_sidecar(part, stats, token)
        if rank == 0:
            _merge_parts(config, nproc, token, stats, part2)

    if rank == 0:
        engine._finish_run(
            config, stats, start_time, quiet,
            f"{engine.TOOL_NAME} {engine.VERSION}",
            str(config.minimizers_path), k, w,
        )
