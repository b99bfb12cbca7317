"""Filter engine: streaming batch pipeline over FASTX input.

Orchestration mirrors the reference engines' semantics (banner, index load,
three input modes, per-batch decide + ordered write, stats, summary; ref:
src/local_filter.rs:575-824, src/remote_filter.rs:431-693): records are
read in batches by the host library's reader (io/fastx.RecordBatch: one
byte arena, no object per read), minimizers are extracted, probed and
counted for the whole batch on the device, and the kept records are
gathered into the output in order by the host library. The reading
runs ahead of the loop on a thread of its own (_read_batches). Up to
``resolve_depth`` batches stay in flight while the host reads ahead and
writes behind; each holds its own copy of its reads. In client mode
(``server_address``) the host extracts each batch's minimizers and a
server decides (RemoteDecider).

``--device host`` hands the whole run to the host library's pipeline
(run_host_pipeline: reader thread, extraction/probe/decision workers,
ordered writer; the JAX package's host engine), whose probe table comes
from the ``<index>.probe`` sidecar when one is valid, so the index's keys
are never decoded, and is built from them otherwise. Under --debug the
host path is HostDecider's, as in the JAX package. ``--device auto``
picks ``host`` or ``cuda`` by the JAX package's rule (choose_device).

Every device run, on one card, on a ``--mesh DATAxSHARD`` or in a
multi-process mode, decides through one DeviceDecider over one
ops/engine.DevicePipeline; only the mesh it is given differs
(make_decider). The multi-process modes (parallel/multihost.py) enter
here too: ``--mesh pod`` runs this loop in every rank on the same input,
over a pipeline whose mesh's shard axis spans the ranks; ``--mesh
pod-data`` and ``pod-2d`` split the input into byte ranges first
(filter/pod_data.py), and each rank (or rank group) runs this loop over
its range (``_byte_range``) and hands its stats back (``_return_stats``).
In the pod modes no process loads the whole index.
"""

from __future__ import annotations

import dataclasses
import signal
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..config import FilterConfig
from ..constants import (
    AUTO_HOST_MAX_INPUT_BYTES,
    AUTO_HOST_MAX_KEYS,
    TOOL_NAME,
    VERSION,
)
from ..index.store import (
    IndexHeader,
    MinimizerIndex,
    load_header_and_count,
    load_index,
    warn_if_foreign_index,
)
from ..io import native_loader
from ..io.fastx import FastxReader, RecordBatch, input_file_size
from ..io.writers import FastxWriter, format_batch, get_writer, resolve_codec
from ..ops import host_extract
from ..ops.engine import DevicePipeline
from ..parallel.sharded import make_mesh, parse_mesh_spec
from ..server.client import RemoteBackend
from ..utils import trace
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


@dataclass
class Decisions:
    """A batch's decisions, one entry per read unit (a read, or a pair);
    ``kmers`` (the k-mers hit, per unit) only in --debug."""

    keep: np.ndarray  # bool
    hits: np.ndarray  # int64
    totals: np.ndarray  # int64
    kmers: list | None = None

    @classmethod
    def from_list(cls, decisions) -> "Decisions":
        """From a backend's (keep, hits, total, kmers) tuples."""
        n = len(decisions)
        return cls(np.fromiter((d[0] for d in decisions), bool, n),
                   np.fromiter((d[1] for d in decisions), np.int64, n),
                   np.fromiter((d[2] for d in decisions), np.int64, n),
                   [d[3] for d in decisions])


def _units(n_seqs: int, paired: bool):
    """Unit and mate of each sequence of a batch: pairs are adjacent."""
    i = np.arange(n_seqs, dtype=np.int64)
    return (i // 2, i % 2) if paired else (i, np.zeros_like(i))


class HostDecider:
    """Host extraction (the host library's, ops/host_extract) + the
    backend's probe; the --debug engine (it lists each record's
    k-mers)."""

    resolve_depth = 1

    def __init__(self, backend, k: int, w: int):
        self.backend = backend
        self.k, self.w = k, w

    def describe(self) -> str:
        """The ``Engine:`` line's text."""
        return "host batch engine (host library extraction)"

    def decide(self, arena, start, length, paired: bool, prefix_length,
               cfg: FilterConfig) -> Decisions:
        per = host_extract.extract_filter_arena(arena, start, length,
                                                prefix_length, self.k, self.w)
        if not paired:
            return Decisions.from_list(self.backend.decide_unpaired(
                per, self.k, cfg.abs_threshold, cfg.rel_threshold,
                cfg.deplete, cfg.debug))
        ext = [
            (np.concatenate([h1, h2]), np.concatenate([p1, p2]), (e1, e2))
            for (h1, p1, e1), (h2, p2, e2) in zip(per[0::2], per[1::2])
        ]
        return Decisions.from_list(self.backend.decide_paired(
            ext, self.k, cfg.abs_threshold, cfg.rel_threshold, cfg.deplete,
            cfg.debug))

    def launch(self, arena, start, length, paired: bool, prefix_length,
               cfg: FilterConfig):
        """Decide sequences ``arena[start[i]:start[i] + length[i]]``
        (pairs adjacent when ``paired``); returns a resolve() ->
        Decisions closure."""
        result = self.decide(arena, start, length, paired, prefix_length,
                             cfg)
        return lambda: result


class RemoteDecider(HostDecider):
    """HostDecider whose launches run extraction and the POST to the
    server on a small thread pool (DEACON_CLIENT_INFLIGHT workers, default
    3), overlapping them with the write-back of earlier batches; the
    engine loop resolves batches in order (ref: src/remote_filter.rs:
    731-792 is sequential here). The pool's threads share no reader or
    writer handle: each extraction is a stateless host-library call."""

    def __init__(self, backend, k: int, w: int):
        import concurrent.futures
        import os

        super().__init__(backend, k, w)
        workers = max(1, int(os.environ.get("DEACON_CLIENT_INFLIGHT", "3")))
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=workers)
        self.resolve_depth = workers

    def describe(self) -> str:
        return "remote server decisions (host library extraction)"

    def launch(self, arena, start, length, paired: bool, prefix_length,
               cfg: FilterConfig):
        return self._pool.submit(self.decide, arena, start, length, paired,
                                 prefix_length, cfg).result


def _decisions_from_counts(hits, totals, cfg: FilterConfig) -> Decisions:
    """Vectorized decisions from counts."""
    with trace.span("resolve.decide"):
        keep = keep_mask_batch(
            hits, totals, cfg.abs_threshold, cfg.rel_threshold, cfg.deplete
        )
        return Decisions(np.asarray(keep, dtype=bool), hits, totals)


class DeviceDecider:
    """Fused on-device extract+probe+count over a built pipeline
    (ops/engine.DevicePipeline: one card, a mesh or a pod). Every unit is
    decided on the device, including units wider than a tile and rows
    over their minimizer budget: there is no fallback to the host."""

    def __init__(self, pipe: DevicePipeline):
        self.pipe = pipe
        self.resolve_depth = DevicePipeline.RESOLVE_DEPTH

    def describe(self) -> str:
        return self.pipe.describe()

    def launch(self, arena, start, length, paired: bool, prefix_length,
               cfg: FilterConfig):
        unit, mate = _units(length.size, paired)
        resolve = self.pipe.launch_counts(
            arena, start, length, unit, mate,
            length.size // 2 if paired else length.size, prefix_length)
        return lambda: _decisions_from_counts(*resolve(), cfg)


#: the --mesh values of the multi-process modes (parallel/multihost.py)
POD_MESHES = ("pod", "pod-data", "pod-2d")


def filter_mesh(mesh_spec: str, device: str):
    """The mesh of ``--mesh DATAxSHARD``: distinct cards on cuda (raises
    "need N devices, have M" when there are too few), the CPU repeated on
    cpu."""
    n_data, n_shard = parse_mesh_spec(mesh_spec)
    if torch.device(device).type == "cpu":
        return make_mesh(n_data, n_shard, ["cpu"] * (n_data * n_shard))
    return make_mesh(n_data, n_shard)


def _pod_pipeline(cfg: FilterConfig, k: int, w: int) -> DevicePipeline:
    """The pipeline of a multi-process mode, its blocks built from the
    index file, over the world (pod), this rank's group (pod-2d) or a
    rank-local mesh (pod-data with DEACON_POD_ENGINE=sharded or
    DEACON_POD_LOCAL_MESH)."""
    from ..parallel import multihost

    mesh_of = {"pod": multihost.make_pod_mesh,
               "pod-2d": multihost.make_pod2d_group_mesh,
               "pod-data": multihost.make_local_data_mesh}[cfg.mesh]
    return DevicePipeline(str(cfg.minimizers_path), k, w,
                          mesh=mesh_of(cfg.device))


def choose_device(*, client: bool, mesh: str | None, debug: bool,
                  n_keys: int | None, input_size: int | None,
                  sidecar_valid: bool) -> str:
    """Where ``filter --device auto`` runs: "host" or "cuda", by the JAX
    package's rule (deacon_tpu/filter/engine.py:387-398, the sidecar fast
    path of its run() at :694-720), first match wins:

    1. client mode: the server decides; the device is ignored ("cuda");
    2. a ``--mesh``: the mesh runs on the cards ("cuda");
    3. ``--debug``: HostDecider, as on every device ("host");
    4. a valid ``<index>.probe`` sidecar: the host engine from it, the
       keys never decoded ("host");
    5. fewer than AUTO_HOST_MAX_KEYS keys and an input file smaller than
       AUTO_HOST_MAX_INPUT_BYTES (``input_size`` None, stdin, is never
       small): the host engine, its table built at start ("host");
    6. otherwise "cuda", which raises without a card as ``--device cuda``
       does (device.resolve_device).

    Not copied from the JAX package: its fallback to the host decider
    when the device decider fails (deacon_tpu/filter/engine.py:399-404),
    its landing on the JAX CPU backend when there is no TPU, and its
    check for a tunneled backend (default_backend_is_tunneled): a hidden
    fallback and TPU details. The port never falls back from one route
    to another."""
    if client or mesh:
        return "cuda"
    if debug or sidecar_valid:
        return "host"
    if (n_keys is not None and n_keys < AUTO_HOST_MAX_KEYS
            and input_size is not None
            and input_size < AUTO_HOST_MAX_INPUT_BYTES):
        return "host"
    return "cuda"


def make_decider(index, backend, k: int, w: int, cfg: FilterConfig):
    """The device pipeline on cfg.device, over cfg.mesh when it is set;
    the host decider for --debug (its per-record k-mer dump needs host
    extraction; a mesh is still checked, and in the multi-process modes,
    where no host holds the index, it probes the pipeline's blocks:
    DevicePipeline.probe_hashes). In client mode the RemoteDecider:
    host extraction, decisions on the server."""
    if cfg.minimizers_path is None:
        if cfg.mesh:
            print("Warning: --mesh is ignored in client mode (decisions run "
                  "on the server).", file=sys.stderr)
        return RemoteDecider(backend, k, w)
    if cfg.mesh in POD_MESHES:
        pipe = _pod_pipeline(cfg, k, w)
        if cfg.debug:
            stub = MinimizerIndex(IndexHeader.new(k, w),
                                  np.empty(0, dtype=np.uint64))
            return HostDecider(LocalBackend(stub, probe=pipe.probe_hashes),
                               k, w)
        return DeviceDecider(pipe)
    mesh = filter_mesh(cfg.mesh, cfg.device) if cfg.mesh else None
    if cfg.debug:
        return HostDecider(backend, k, w)
    return DeviceDecider(DevicePipeline(index.hashes, k, w,
                                        device=cfg.device, mesh=mesh))


def run(config: FilterConfig, _byte_range=None, _return_stats=False):
    """``filter``. ``_byte_range`` (a range of io/split.py, or a pair of
    them for paired files) reads only that range of the input, and
    ``_return_stats`` returns (stats, k, w) instead of printing the final
    line and summary: filter/pod_data.py's per-rank runs."""
    start_time = time.monotonic()
    if config.mesh and config.device == "host":
        # --mesh wins over the device choice, as in the JAX package: the
        # mesh runs on the cards
        config = dataclasses.replace(config, device="cuda")
    # the host engine and the rule of auto read the header, the key count
    # and the sidecar, once: a valid sidecar carries the finished probe
    # table, and the keys are then never decoded
    header = count = probe = None
    if (config.minimizers_path is not None and not config.mesh
            and config.device in ("host", "auto") and not config.debug):
        header, count = load_header_and_count(config.minimizers_path)
        probe = native_loader.load_probe_sidecar(config.minimizers_path,
                                                 count)
    if config.device == "auto":
        config = dataclasses.replace(config, device=choose_device(
            client=config.minimizers_path is None, mesh=config.mesh,
            debug=config.debug, n_keys=count,
            input_size=input_file_size(config.input_path),
            sidecar_valid=probe is not None))
    if config.mesh == "pod-data" and _byte_range is None:
        from .pod_data import run_pod_data

        return run_pod_data(config)
    if config.mesh == "pod-2d" and _byte_range is None:
        from .pod_data import run_pod_2d

        return run_pod_2d(config)
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

    host = config.device == "host" and not config.debug
    if config.minimizers_path is not None:
        warn_if_foreign_index(config.minimizers_path)
        if config.mesh in POD_MESHES:
            # each process builds its blocks from its rows' keys alone
            header, _ = load_header_and_count(config.minimizers_path)
            index = backend = None
        elif host:
            index = (None if probe is not None
                     else load_index(config.minimizers_path))
            backend = None
        else:
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

    if host and config.minimizers_path is not None:
        stats = run_host_pipeline(config, probe, index, count, k, w, quiet)
        if _return_stats:
            return stats, k, w
        _finish_run(config, stats, start_time, quiet, tool_version,
                    summary_index, k, w)
        return

    decider = make_decider(index, backend, k, w, config)
    if not quiet:
        _eprint(f"Engine: {decider.describe()}")

    stats = FilterStats()
    filtering_start = time.monotonic()
    writer = get_writer(config.output_path, config.compression_level)
    writer2: FastxWriter | None = None
    if config.output2_path is not None and config.input2_path is not None:
        writer2 = get_writer(config.output2_path, config.compression_level)

    spinner = Spinner(not quiet)
    paired = input_type != "single"

    def process(batch: RecordBatch, d: Decisions):
        """Stats, debug lines and output of one resolved batch (pairs
        adjacent in ``batch`` when paired)."""
        lens = batch.seq_lens
        unit_bp = lens[0::2] + lens[1::2] if paired else lens
        per = 2 if paired else 1
        n_units = d.keep.size
        stats.total_seqs += len(batch)
        stats.total_bp += int(lens.sum())
        if config.debug:
            _debug_lines(batch, d, paired)
        kept = np.nonzero(d.keep)[0]
        stats.output_bp += int(unit_bp[kept].sum())
        stats.filtered_seqs += (n_units - kept.size) * per
        stats.filtered_bp += int(unit_bp.sum()) - int(unit_bp[kept].sum())
        first = stats.output_seq_counter + 1
        stats.output_seq_counter += kept.size * per
        numbers = np.arange(first, first + kept.size * per, dtype=np.int64)
        with trace.span("writer"):
            if not paired:
                writer.write(format_batch(batch, kept,
                                          numbers if config.rename else None))
            elif writer2 is not None:
                for w, mate in ((writer, 0), (writer2, 1)):
                    w.write(format_batch(batch, 2 * kept + mate,
                                         numbers[mate::2] if config.rename
                                         else None))
            else:
                idx = np.stack([2 * kept, 2 * kept + 1], axis=1).reshape(-1)
                writer.write(format_batch(batch, idx,
                                          numbers if config.rename else None))
        spinner.update(stats, filtering_start)

    # up to `depth` launched batches stay in flight (their outputs then
    # come back in one fused device-to-host copy), bounded by
    # MAX_PENDING_BYTES of buffered records
    try:
        depth = max(1, int(decider.resolve_depth))
        pending: deque = deque()
        pending_bytes = 0
        batches = _read_batches(config, input_type, _byte_range)
        while True:
            with trace.span("reader"):
                batch = next(batches, None)
            if batch is not None:
                with trace.span("launch"):
                    fut = decider.launch(batch.arena, batch.seq_starts,
                                         batch.seq_lens, paired,
                                         config.prefix_length, config)
                nb = int(batch.seq_lens.sum())
                pending.append((batch, fut, nb))
                pending_bytes += nb
            while pending and (
                batch is None or len(pending) > depth
                or pending_bytes > MAX_PENDING_BYTES
            ):
                done, fut, nb = pending.popleft()
                pending_bytes -= nb
                with trace.span("resolve"):
                    d = fut()
                process(done, d)
            if batch is None:
                break
    finally:
        spinner.finish()

    with trace.span("writer"):
        writer.finish()
        if writer2 is not None:
            writer2.finish()
    if trace.enabled():
        trace.report()
    if _return_stats:
        return stats, k, w
    _finish_run(config, stats, start_time, quiet, tool_version,
                summary_index, k, w)


def run_host_pipeline(config: FilterConfig, probe, index, count: int,
                      k: int, w: int, quiet: bool) -> FilterStats:
    """``filter --device host``: the whole run in the host library's
    pipeline (io/native_loader.native_filter_run). ``probe`` is the table
    mapped from the sidecar, or None, and then it is built from
    ``index``'s keys, the decoded keys are dropped (the table owns a
    copy), and the sidecar is saved (DEACON_PROBE_CACHE policy) on a
    thread that overlaps the run. SIGINT raises the pipeline's cancel
    flag; a thread polls its counters for the spinner. Returns the run's
    stats; raises ValueError with the pipeline's message when it fails,
    and KeyboardInterrupt when it was interrupted."""
    out_codec = resolve_codec(config.output_path, config.compression_level)
    output2 = out2_codec = None
    if config.output2_path is not None and config.input2_path is not None:
        output2 = config.output2_path
        out2_codec = resolve_codec(output2, config.compression_level)
    source = "sidecar cache"
    saver = None
    save_error: list[str] = []
    if probe is None:
        source = "built at startup"
        probe = native_loader.native_probe(index.hashes)
        index.hashes = None
        index_path = config.minimizers_path

        def save():
            try:
                native_loader.maybe_save_probe_sidecar(probe, index_path,
                                                       count)
            except OSError as e:
                save_error.append(str(e))

        saver = threading.Thread(target=save, daemon=True)
        saver.start()
    if not quiet:
        _eprint(f"Engine: native C++ pipeline (probe table: {source})")

    progress = np.zeros(native_loader.PROGRESS_SLOTS, dtype=np.int64)
    start = time.monotonic()
    spinner = Spinner(not quiet)
    stop = threading.Event()
    interrupted = False

    def on_sigint(signum, frame):
        # the run blocks this thread in C, where Python's deferred SIGINT
        # would never be seen: the pipeline polls this flag per batch
        nonlocal interrupted
        interrupted = True
        progress[native_loader.CANCEL] = 1

    try:
        prev_sigint = signal.signal(signal.SIGINT, on_sigint)
    except ValueError:  # not the main thread
        prev_sigint = None

    def poll():
        view = FilterStats()
        while not stop.wait(0.1):
            (view.total_seqs, view.filtered_seqs, view.total_bp,
             view.output_bp) = (int(x) for x in progress[:4])
            spinner.update(view, start)

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    if config.output_path == "-" or output2 == "-":
        sys.stdout.flush()
    try:
        native_loader.native_filter_run(
            config.input_path, config.input2_path, config.output_path,
            output2, out_codec, out2_codec or 0, config.compression_level,
            probe, k, w, config.prefix_length, config.abs_threshold,
            config.rel_threshold, config.deplete, config.rename,
            config.threads, progress)
    except ValueError:
        if interrupted:
            raise KeyboardInterrupt from None
        raise
    finally:
        stop.set()
        poller.join()
        spinner.finish()
        if saver is not None:
            saver.join()
        if prev_sigint is not None:
            signal.signal(signal.SIGINT, prev_sigint)
    if interrupted:
        raise KeyboardInterrupt
    if save_error:
        _eprint(f"Warning: the probe table was not cached: {save_error[0]}")
    stats = FilterStats()
    (stats.total_seqs, stats.filtered_seqs, stats.total_bp, stats.output_bp,
     stats.filtered_bp, stats.output_seq_counter) = (
        int(x) for x in progress[:6])
    return stats


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


def _split_byte_range(br):
    """(range of input 1, range of input 2) of a pod-data range: ``(s,
    e)`` or a BgzfRange for single input, ``((s1, e1), (s2, e2))`` for
    paired files; (None, None) for the whole input."""
    if br is None:
        return None, None
    if isinstance(br[0], tuple):
        return br[0], br[1]
    return br, None


#: finished batches that _read_batches holds queued for the loop, at most;
#: its read-ahead thread reads one more meanwhile
READ_AHEAD_BATCHES = 1
#: name of the read-ahead thread
READ_AHEAD_THREAD = "deacon-read-ahead"
#: the read-ahead's counters (see _ReadAhead)
AHEAD_COUNTERS = ("reader.ahead_ready", "reader.ahead_waits",
                  "reader.ahead_wait_ns", "reader.ahead_full_ns")


def _read_batches(config: FilterConfig, input_type: str, byte_range=None):
    """The input (or its ``byte_range``, see _split_byte_range) as
    RecordBatches of ``config.batch_size`` read units, a pair's two
    records adjacent. Paired files stop at the shorter one; an
    interleaved stream with an odd record count is an error
    (ref: src/remote_filter.rs:1188-1194).

    The first ``next()`` opens the readers on the caller's thread (a
    missing file raises OSError there). From then on a thread of the
    generator's own (_ReadAhead) owns them: it reads, assembles and
    interleaves each batch ahead of the caller, READ_AHEAD_BATCHES
    finished batches at most, and the caller gets the same batches in the
    same order, then a read error at the point in the stream where it
    arose. Closing the generator stops and joins that thread, then closes
    the readers (and with them an input pipe)."""
    size = config.batch_size
    br1, br2 = _split_byte_range(byte_range)
    if input_type == "interleaved":
        readers = [FastxReader.from_path("-")]
    else:
        readers = [FastxReader.from_path(config.input_path, byte_range=br1)]
        if input_type == "paired":
            readers.append(FastxReader.from_path(config.input2_path,
                                                 byte_range=br2))
    ahead = _ReadAhead(_assembled_batches(readers, input_type, size))
    try:
        while (batch := ahead.get()) is not None:
            yield batch
    finally:
        ahead.close()
        for reader in readers:
            reader.close()


def _assembled_batches(readers, input_type: str, size: int):
    """_read_batches's batches, read from its open ``readers``."""
    if input_type == "single":
        while len(batch := readers[0].read_batch(size)):
            yield batch
    elif input_type == "interleaved":
        count = 0
        while len(batch := readers[0].read_batch(2 * size)):
            count += len(batch)
            if len(batch) % 2:
                raise ValueError(
                    "Uneven number of interleaved sequence pairs. "
                    f"Found {count} records.")
            yield batch
    else:
        r1, r2 = readers
        while len(b1 := r1.read_batch(size)):
            b2 = r2.read_batch(len(b1))
            n = len(b2)
            if n:
                with trace.span("reader.assemble"):
                    batch = RecordBatch.interleave(b1.head(n), b2)
                yield batch
            if n < len(b1):
                return


class _ReadAhead:
    """Runs the iterator ``items`` on a thread of its own into a FIFO of
    at most READ_AHEAD_BATCHES items, which ``get`` takes in order; the
    iterator's end and an exception it raises are queued after its items.
    The thread's spans record under ``reader`` (trace.thread_parent).
    With tracing on it counts ``reader.ahead_ready`` (get found a batch
    queued), ``reader.ahead_waits`` and ``reader.ahead_wait_ns`` (get
    waited for one) and ``reader.ahead_full_ns`` (the thread waited for
    room: the caller sets the pace)."""

    _END = object()

    def __init__(self, items):
        self._items = items
        self._queue: deque = deque()
        self._cond = threading.Condition()
        self._stopped = False
        for name in AHEAD_COUNTERS:  # listed, if only as 0
            trace.count(name, 0)
        self._thread = threading.Thread(target=self._produce,
                                        name=READ_AHEAD_THREAD, daemon=True)
        self._thread.start()

    def _produce(self) -> None:
        trace.thread_parent("reader")
        end = self._END
        try:
            for item in self._items:
                if not self._put(item):
                    return
        except Exception as e:  # raised by get, after the items before it
            end = e
        self._put(end)

    def _put(self, item) -> bool:
        """Queue ``item`` once there is room; False once closed."""
        with self._cond:
            if len(self._queue) >= READ_AHEAD_BATCHES and not self._stopped:
                t0 = time.perf_counter_ns() if trace.enabled() else 0
                while (len(self._queue) >= READ_AHEAD_BATCHES
                       and not self._stopped):
                    self._cond.wait()
                if t0:
                    trace.count("reader.ahead_full_ns",
                                time.perf_counter_ns() - t0)
            if self._stopped:
                return False
            self._queue.append(item)
            self._cond.notify()
            return True

    def get(self):
        """The next item; None at the end; raises what the iterator
        raised."""
        with self._cond:
            ready = bool(self._queue)
            t0 = 0 if ready or not trace.enabled() else time.perf_counter_ns()
            while not self._queue:
                self._cond.wait()
            item = self._queue.popleft()
            self._cond.notify()
        if item is self._END:
            return None
        if isinstance(item, Exception):
            raise item
        if ready:
            trace.count("reader.ahead_ready")
        else:
            trace.count("reader.ahead_waits")
            if t0:
                trace.count("reader.ahead_wait_ns",
                            time.perf_counter_ns() - t0)
        return item

    def close(self) -> None:
        """Stop the thread (at once if it waits for room, else after the
        read it is in) and join it."""
        with self._cond:
            self._stopped = True
            self._queue.clear()
            self._cond.notify()
        self._thread.join()


def _debug_lines(batch: RecordBatch, d: Decisions, paired: bool) -> None:
    """--debug: one line per read, or per pair with a hit (the
    reference's paired debug path prints only those; ref:
    src/local_filter.rs:424, :497)."""
    for u in range(d.keep.size):
        hits = int(d.hits[u])
        if paired and hits == 0:
            continue
        ids = [batch.record(i).id.decode("utf-8", "replace")
               for i in ((2 * u, 2 * u + 1) if paired else (u,))]
        kmers = d.kmers[u] if d.kmers is not None else []
        _eprint(
            f"DEBUG: {'/'.join(ids)} hits={hits}/{int(d.totals[u])} "
            f"keep={_rust_bool(bool(d.keep[u]))} kmers=[{','.join(kmers)}]"
        )
