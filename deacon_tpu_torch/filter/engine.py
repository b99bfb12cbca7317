"""Filter engine: streaming batch pipeline over FASTX input.

Orchestration mirrors the reference engines' semantics (banner, index load,
three input modes, per-batch decide + ordered write, stats, summary; ref:
src/local_filter.rs:575-824, src/remote_filter.rs:431-693): records are
read in batches, minimizers are extracted, probed and counted for the
whole batch on the device, and the records are written in order. Up to
``resolve_depth`` batches stay in flight while the host reads ahead and
writes behind. In client mode (``server_address``) the host extracts each
batch's minimizers and a server decides (RemoteDecider).
"""

from __future__ import annotations

import sys
import time
from collections import deque

import numpy as np
import torch

from ..config import FilterConfig
from ..constants import TOOL_NAME, VERSION
from ..index.store import load_index, warn_if_foreign_index
from ..io.fastx import FastxReader, Record, read_batch
from ..io.writers import FastxWriter, format_record, get_writer
from ..ops import host_extract
from ..ops.engine import DevicePipeline
from ..parallel.sharded import ShardedPipeline, make_mesh, parse_mesh_spec
from ..server.client import RemoteBackend
from .backend import LocalBackend
from .progress import FilterStats, Spinner
from .summary import build_summary, write_summary
from .thresholds import keep_mask_batch

#: buffered record bytes that force the oldest in-flight batch to resolve
MAX_PENDING_BYTES = 512_000_000


def _eprint(*args) -> None:
    print(*args, file=sys.stderr)


def _fmt_duration(seconds: float) -> str:
    if seconds < 1.0:
        return f"{seconds * 1000:.2f}ms"
    if seconds < 60.0:
        return f"{seconds:.2f}s"
    m, s = divmod(seconds, 60.0)
    return f"{int(m)}m {s:.2f}s"


def _rust_bool(b: bool) -> str:
    return "true" if b else "false"


class HostDecider:
    """Host extraction (NumPy oracle) + sorted-array probe; the --debug
    engine (it lists each record's k-mers)."""

    resolve_depth = 1

    def __init__(self, backend, k: int, w: int):
        self.backend = backend
        self.k, self.w = k, w

    def decide_unpaired(self, seqs, prefix_length, cfg: FilterConfig):
        ext = host_extract.extract_filter_batch(seqs, prefix_length, self.k, self.w)
        return self.backend.decide_unpaired(
            ext, self.k, cfg.abs_threshold, cfg.rel_threshold, cfg.deplete, cfg.debug
        )

    def decide_paired(self, pairs, prefix_length, cfg: FilterConfig):
        flat: list[bytes] = []
        for s1, s2 in pairs:
            flat.append(s1)
            flat.append(s2)
        per = host_extract.extract_filter_batch(flat, prefix_length, self.k, self.w)
        ext = []
        for i in range(0, len(per), 2):
            (h1, p1, e1), (h2, p2, e2) = per[i], per[i + 1]
            ext.append((
                np.concatenate([h1, h2]),
                np.concatenate([p1, p2]),
                (e1, e2),
            ))
        return self.backend.decide_paired(
            ext, self.k, cfg.abs_threshold, cfg.rel_threshold, cfg.deplete, cfg.debug
        )

    def launch_unpaired(self, seqs, prefix_length, cfg):
        result = self.decide_unpaired(seqs, prefix_length, cfg)
        return lambda: result

    def launch_paired(self, pairs, prefix_length, cfg):
        result = self.decide_paired(pairs, prefix_length, cfg)
        return lambda: result


class RemoteDecider(HostDecider):
    """HostDecider whose launches run extraction and the POST to the
    server on a small thread pool (DEACON_CLIENT_INFLIGHT workers, default
    3), overlapping them with the write-back of earlier batches; the
    engine loop resolves batches in order (ref: src/remote_filter.rs:
    731-792 is sequential here)."""

    def __init__(self, backend, k: int, w: int):
        import concurrent.futures
        import os

        super().__init__(backend, k, w)
        workers = max(1, int(os.environ.get("DEACON_CLIENT_INFLIGHT", "3")))
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=workers)
        self.resolve_depth = workers

    def launch_unpaired(self, seqs, prefix_length, cfg):
        return self._pool.submit(self.decide_unpaired, seqs, prefix_length,
                                 cfg).result

    def launch_paired(self, pairs, prefix_length, cfg):
        return self._pool.submit(self.decide_paired, pairs, prefix_length,
                                 cfg).result


def _decisions_from_counts(hits, totals, cfg: FilterConfig):
    """Vectorized (keep, hits, total, kmers=[]) decisions from counts."""
    keep = keep_mask_batch(
        hits, totals, cfg.abs_threshold, cfg.rel_threshold, cfg.deplete
    )
    return [
        (bool(kp), int(h), int(t), [])
        for kp, h, t in zip(keep, hits, totals)
    ]


class DeviceDecider:
    """Fused on-device extract+probe+count (ops/engine.DevicePipeline).
    Every unit is decided on the device, including units wider than a
    tile and rows over their minimizer budget: there is no fallback to
    the host."""

    def __init__(self, index_hashes, k: int, w: int, device):
        self.pipe = DevicePipeline(index_hashes, k, w, device=device)
        self.resolve_depth = DevicePipeline.RESOLVE_DEPTH

    def launch_unpaired(self, seqs, prefix_length, cfg: FilterConfig):
        resolve = self.pipe.launch_single(seqs, prefix_length)
        return lambda: _decisions_from_counts(*resolve(), cfg)

    def launch_paired(self, pairs, prefix_length, cfg: FilterConfig):
        resolve = self.pipe.launch_paired(pairs, prefix_length)
        return lambda: _decisions_from_counts(*resolve(), cfg)


class ShardedDecider(DeviceDecider):
    """DeviceDecider over a mesh (parallel/sharded.ShardedPipeline): read
    batches data-parallel over the mesh's rows, the radix table cut into
    blocks of bucket rows over its shards, per-shard hits summed. Like
    DeviceDecider it has no host fallback and no regrow: a unit wider
    than a tile gets a batch of its own and rows over their budget rerun
    on the card."""

    def __init__(self, index_hashes, k: int, w: int, mesh):
        self.pipe = ShardedPipeline(index_hashes, k, w, mesh)
        self.resolve_depth = ShardedPipeline.RESOLVE_DEPTH


def filter_mesh(mesh_spec: str, device: str):
    """The mesh of ``--mesh DATAxSHARD``: distinct cards on cuda (raises
    "need N devices, have M" when there are too few), the CPU repeated on
    cpu. The multi-host specs are not ported."""
    if mesh_spec in ("pod", "pod-data", "pod-2d"):
        raise ValueError(f"--mesh {mesh_spec} (multi-host) is not ported yet")
    n_data, n_shard = parse_mesh_spec(mesh_spec)
    if torch.device(device).type == "cpu":
        return make_mesh(n_data, n_shard, ["cpu"] * (n_data * n_shard))
    return make_mesh(n_data, n_shard)


def make_decider(index, backend, k: int, w: int, cfg: FilterConfig):
    """The device pipeline on cfg.device, over cfg.mesh when it is set;
    the host decider for --debug (its per-record k-mer dump needs host
    extraction; a mesh is still checked). In client mode (no index) the
    RemoteDecider: host extraction, decisions on the server."""
    if index is None:
        if cfg.mesh:
            print("Warning: --mesh is ignored in client mode (decisions run "
                  "on the server).", file=sys.stderr)
        return RemoteDecider(backend, k, w)
    mesh = filter_mesh(cfg.mesh, cfg.device) if cfg.mesh else None
    if cfg.debug:
        return HostDecider(backend, k, w)
    if mesh is not None:
        return ShardedDecider(index.hashes, k, w, mesh)
    return DeviceDecider(index.hashes, k, w, cfg.device)


def _engine_desc(decider) -> str:
    if isinstance(decider, ShardedDecider):
        shape = decider.pipe.mesh.shape
        return (f"sharded device pipeline (mesh data={shape['data']} x "
                f"shard={shape['shard']})")
    if isinstance(decider, DeviceDecider):
        return f"device pipeline ({decider.pipe.device})"
    if isinstance(decider, RemoteDecider):
        return "remote server decisions (NumPy oracle extraction)"
    return "host batch engine (NumPy oracle extraction)"


def run(config: FilterConfig):
    start_time = time.monotonic()
    tool_version = f"{TOOL_NAME} {VERSION}"
    quiet = config.quiet or config.debug  # ref: src/local_filter.rs:581

    mode = "deplete" if config.deplete else "search"
    paired_stdin = config.input_path == "-" and config.input2_path == "-"
    if paired_stdin:
        input_type = "interleaved"
    elif config.input2_path is not None:
        input_type = "paired"
    else:
        input_type = "single"

    options = [f"abs_threshold={config.abs_threshold}, rel_threshold={config.rel_threshold}"]
    if config.prefix_length > 0:
        options.append(f"prefix_length={config.prefix_length}")
    if config.rename:
        options.append("rename")
    if config.threads > 0:
        options.append(f"threads={config.threads}")

    if not quiet:
        _eprint(
            f"{TOOL_NAME} v{VERSION}; mode: {mode}; input: {input_type}; "
            f"options: {', '.join(options)}"
        )

    if config.minimizers_path is not None:
        warn_if_foreign_index(config.minimizers_path)
        index = load_index(config.minimizers_path)
        header = index.header
        backend = LocalBackend(index)
        summary_index = str(config.minimizers_path)
    elif config.server_address is not None:
        index = None
        backend = RemoteBackend(config.server_address)
        header = backend.header
        summary_index = backend.summary_index()
    else:
        raise ValueError("No index path or server address provided")
    k, w = header.kmer_length, header.window_size
    load_time = time.monotonic() - start_time
    if not quiet:
        _eprint(f"Loaded index (k={k}, w={w}) in {_fmt_duration(load_time)}")

    decider = make_decider(index, backend, k, w, config)
    if not quiet:
        _eprint(f"Engine: {_engine_desc(decider)}")

    stats = FilterStats()
    filtering_start = time.monotonic()
    writer = get_writer(config.output_path, config.compression_level)
    writer2: FastxWriter | None = None
    if config.output2_path is not None and config.input2_path is not None:
        writer2 = get_writer(config.output2_path, config.compression_level)

    spinner = Spinner(not quiet)
    buffer = bytearray()
    buffer2 = bytearray()

    def flush_buffers():
        if buffer:
            writer.write(bytes(buffer))
            buffer.clear()
        if writer2 is not None and buffer2:
            writer2.write(bytes(buffer2))
            buffer2.clear()

    def emit_single(rec: Record):
        stats.output_seq_counter += 1
        format_record(
            rec.id, rec.seq, rec.qual, rec.is_fastq, config.rename,
            stats.output_seq_counter, buffer,
        )

    def emit_pair(rec1: Record, rec2: Record):
        stats.output_seq_counter += 2
        format_record(
            rec1.id, rec1.seq, rec1.qual, rec1.is_fastq, config.rename,
            stats.output_seq_counter - 1, buffer,
        )
        format_record(
            rec2.id, rec2.seq, rec2.qual, rec2.is_fastq, config.rename,
            stats.output_seq_counter,
            buffer2 if writer2 is not None else buffer,
        )

    def process_single(records, decisions):
        for rec, (keep, hits, total, kmers) in zip(records, decisions):
            stats.total_seqs += 1
            stats.total_bp += len(rec.seq)
            if config.debug:
                _eprint(
                    f"DEBUG: {rec.id.decode('utf-8', 'replace')} "
                    f"hits={hits}/{total} keep={_rust_bool(keep)} "
                    f"kmers=[{','.join(kmers)}]"
                )
            if keep:
                stats.output_bp += len(rec.seq)
                emit_single(rec)
            else:
                stats.filtered_seqs += 1
                stats.filtered_bp += len(rec.seq)
        flush_buffers()
        spinner.update(stats, filtering_start)

    def process_pairs(pairs, decisions):
        for (rec1, rec2), (keep, hits, total, kmers) in zip(pairs, decisions):
            pair_bp = len(rec1.seq) + len(rec2.seq)
            stats.total_seqs += 2
            stats.total_bp += pair_bp
            # hits>0 guard matches the reference's paired debug path
            # (ref: src/local_filter.rs:424, :497) — single-end prints all
            if config.debug and hits > 0:
                _eprint(
                    f"DEBUG: {rec1.id.decode('utf-8', 'replace')}/"
                    f"{rec2.id.decode('utf-8', 'replace')} "
                    f"hits={hits}/{total} keep={_rust_bool(keep)} "
                    f"kmers=[{','.join(kmers)}]"
                )
            if keep:
                stats.output_bp += pair_bp
                emit_pair(rec1, rec2)
            else:
                stats.filtered_seqs += 2
                stats.filtered_bp += pair_bp
        flush_buffers()
        spinner.update(stats, filtering_start)

    # up to `depth` launched batches stay in flight (their outputs then
    # come back in one fused device-to-host copy), bounded by
    # MAX_PENDING_BYTES of buffered records
    try:
        depth = max(1, int(decider.resolve_depth))
        pending: deque = deque()
        pending_bytes = 0

        def drain(process_fn, everything=False):
            nonlocal pending_bytes
            while pending and (
                everything or len(pending) > depth
                or pending_bytes > MAX_PENDING_BYTES
            ):
                recs, fut, nb = pending.popleft()
                pending_bytes -= nb
                process_fn(recs, fut())

        if input_type == "single":
            reader = FastxReader.from_path(config.input_path)
            while True:
                records = read_batch(reader, config.batch_size)
                if not records:
                    drain(process_single, everything=True)
                    break
                fut = decider.launch_unpaired(
                    [r.seq for r in records], config.prefix_length, config
                )
                nb = sum(len(r.seq) for r in records)
                pending.append((records, fut, nb))
                pending_bytes += nb
                drain(process_single)
        else:
            if input_type == "interleaved":
                reader = FastxReader.from_path("-")
                pair_iter = _interleaved_pairs(reader)
            else:
                r1 = FastxReader.from_path(config.input_path)
                r2 = FastxReader.from_path(config.input2_path)
                pair_iter = zip(r1, r2)
            while True:
                pairs: list[tuple[Record, Record]] = []
                for _ in range(config.batch_size):
                    try:
                        pairs.append(next(pair_iter))
                    except StopIteration:
                        break
                if not pairs:
                    drain(process_pairs, everything=True)
                    break
                fut = decider.launch_paired(
                    [(a.seq, b.seq) for a, b in pairs],
                    config.prefix_length,
                    config,
                )
                nb = sum(len(a.seq) + len(b.seq) for a, b in pairs)
                pending.append((pairs, fut, nb))
                pending_bytes += nb
                drain(process_pairs)
    finally:
        spinner.finish()

    writer.finish()
    if writer2 is not None:
        writer2.finish()
    _finish_run(config, stats, start_time, quiet, tool_version,
                summary_index, k, w)


def _finish_run(
    config: FilterConfig, stats: FilterStats, start_time: float,
    quiet: bool, tool_version: str, summary_index: str, k: int, w: int,
) -> None:
    """Final stderr stats line + optional summary JSON (C11/C12)."""
    total_time = time.monotonic() - start_time
    output_seqs = stats.total_seqs - stats.filtered_seqs
    seqs_per_sec = stats.total_seqs / total_time if total_time > 0 else 0.0
    mbp_per_sec = stats.total_bp / total_time / 1e6 if total_time > 0 else 0.0
    sp = output_seqs / stats.total_seqs * 100 if stats.total_seqs else 0.0
    bpp = stats.output_bp / stats.total_bp * 100 if stats.total_bp else 0.0

    if not quiet:
        _eprint(
            f"Retained {output_seqs}/{stats.total_seqs} sequences ({sp:.3f}%), "
            f"{stats.output_bp}/{stats.total_bp} bp ({bpp:.3f}%) in "
            f"{_fmt_duration(total_time)}. Speed: {seqs_per_sec:.0f} seqs/s "
            f"({mbp_per_sec:.1f} Mbp/s)"
        )

    if config.summary_path is not None:
        summary = build_summary(
            version=tool_version,
            index=summary_index,
            input=config.input_path,
            input2=config.input2_path,
            output=config.output_path,
            output2=config.output2_path,
            k=k,
            w=w,
            abs_threshold=config.abs_threshold,
            rel_threshold=config.rel_threshold,
            prefix_length=config.prefix_length,
            deplete=config.deplete,
            rename=config.rename,
            seqs_in=stats.total_seqs,
            seqs_out=output_seqs,
            seqs_removed=stats.filtered_seqs,
            bp_in=stats.total_bp,
            bp_out=stats.output_bp,
            bp_removed=stats.filtered_bp,
            time=total_time,
        )
        write_summary(summary, config.summary_path)
        if not quiet:
            _eprint(f'Summary saved to "{config.summary_path}"')


def _interleaved_pairs(reader: FastxReader):
    """Yield record pairs from an interleaved stream; odd count is an error
    (ref: src/remote_filter.rs:1188-1194)."""
    count = 0
    while True:
        try:
            rec1 = next(reader)
        except StopIteration:
            return
        count += 1
        try:
            rec2 = next(reader)
        except StopIteration:
            raise ValueError(
                f"Uneven number of interleaved sequence pairs. Found {count} records."
            ) from None
        count += 1
        yield rec1, rec2
