"""Filter traffic: one ``filter`` job a window over a stream of reads, the
pool repeated, against an index held resident on the device.

Set-up makes the index's keys on the device from the seed
(index_keys.py), moves them to the host as the sorted uint64 array of a
``MinimizerIndex``, frees its own device tensors and hands the index to
the program through ``filter.engine.make_decider``, which builds the
radix table as ``filter.engine.run`` does. It makes the pool of reads
(generators/) in memory, as the bytes of its files, and runs one job over
the pool once, which warms every shape the window uses.

The window is one job: the pool is fed through named pipes by threads
that repeat it until the job's reader closes them, so the job reads a
stream as long as a multi-gigabase file with no disk behind it, and its
queue of launched batches fills to the depth that such a job holds. No
batch is read after the window's seconds; the batches in flight are then
resolved and written, and the job finishes. A job is a fresh
``_read_batches`` reader and fresh writers, records formatted by
``format_batch``, the writers finished at its end. ``run_job`` is
``filter.engine.run``'s loop, which joins those objects, copied with the
harness's spans around each call into a layer
(benchmark/tests/test_bench_loop.py holds it to ``run``); the queue is bounded by
the decider's ``resolve_depth`` and the engine's ``MAX_PENDING_BYTES``,
read when the job runs. Outputs go to named pipes drained by threads, so
nothing is written to disk; the head of each output (the first repetition
of the pool and more) is kept in memory for the comparison and the rest
is counted.

A traffic file names its ``generator`` and its ``pool`` (the
generator's parameters), the outputs' extension (``output_ext``, which
picks the codec as the CLI does), and may set the job's mode
(``deplete``, else the configuration's) and a ``mesh`` (the CLI's
``--mesh``).

After the window the program's state is freed and the reference
(reference.py) computes every pool unit's hits and totals from the reads
and the sorted keys. ``correct`` holds every unit of the window's job to
them (unit i of the stream is unit i mod n of the pool), and the records
written for its first repetition of the pool, and the size of each plain
output, to the reference's kept records.
"""

from __future__ import annotations

import fcntl
import gc
import importlib
import os
import shutil
import tempfile
import threading
import time
import zlib
from collections import deque
from contextlib import contextmanager, nullcontext

import numpy as np
import torch

from .. import devtrace
from ..generators.reads import random_bases
from ..index_keys import genome_hashes, make_keys, to_host_u64
from ..reference import I64_MIN, keep_mask, unit_counts
from ..seeds import generator, rng

F_SETPIPE_SZ = 1031
PIPE_BYTES = 1 << 20
FEED_CHUNK = 4 << 20
#: the traced slice: from this share of the window on, for TRACE_SECONDS
TRACE_FROM = 0.25
TRACE_SECONDS = 4.0
SPANS = ("reader", "launch", "resolve", "writer")


class Spans:
    """Seconds inside each span, summed apart inside and outside the
    traced slice; inside it each span is also a ``bench.<name>``
    annotation."""

    def __init__(self):
        self.seconds = dict.fromkeys(SPANS, 0.0)
        self.traced = dict.fromkeys(SPANS, 0.0)
        self.annotate = False

    @contextmanager
    def __call__(self, name: str):
        traced = self.annotate
        ctx = (torch.profiler.record_function(devtrace.SPAN_PREFIX + name)
               if traced else nullcontext())
        t = time.perf_counter()
        with ctx:
            yield
        (self.traced if traced else self.seconds)[name] += (
            time.perf_counter() - t)


def _set_pipe_size(fd: int) -> None:
    try:
        fcntl.fcntl(fd, F_SETPIPE_SZ, PIPE_BYTES)
    except OSError:
        pass


class PipeFeed:
    """A named pipe that a thread fills with a pool file (a
    generators.reads.FileBytes): its head, its body ``repeat`` times over
    (None: until the reader closes the pipe), then its tail."""

    def __init__(self, path: str, file):
        self.path = path
        self.file = file
        os.mkfifo(path)
        self._thread = None
        self._stop = threading.Event()

    def start(self, repeat: int | None) -> None:
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._feed, args=(repeat,),
                                        daemon=True)
        self._thread.start()

    def _feed(self, repeat: int | None) -> None:
        fd = os.open(self.path, os.O_WRONLY)
        try:
            _set_pipe_size(fd)
            self._write(fd, self.file.head)
            done = 0
            while repeat is None or done < repeat:
                if not self._write(fd, self.file.body):
                    return
                done += 1
            self._write(fd, self.file.tail(repeat))
        except BrokenPipeError:
            pass  # the job's reader closed the pipe
        finally:
            os.close(fd)

    def _write(self, fd: int, data: bytes) -> bool:
        view = memoryview(data)
        off = 0
        while off < len(view):
            if self._stop.is_set():
                return False
            off += os.write(fd, view[off:off + FEED_CHUNK])
        return True

    def stop(self) -> None:
        """End the feed, once the job's reader has closed the pipe or
        never opened it: a feed blocked on the pipe is drained here."""
        self._stop.set()
        while self._thread is not None and self._thread.is_alive():
            fd = os.open(self.path, os.O_RDONLY | os.O_NONBLOCK)
            try:
                while os.read(fd, PIPE_BYTES):
                    pass
            except BlockingIOError:
                pass
            finally:
                os.close(fd)
            self._thread.join(0.05)
        self._thread = None


class PipeSink:
    """A named pipe that an output is written to, drained by a thread:
    its first ``keep`` bytes are kept in memory, and every byte counted."""

    def __init__(self, path: str, keep: int):
        self.path = path
        self.keep = keep
        os.mkfifo(path)
        self._thread = None
        self._chunks: list = []
        self._bytes = 0

    def start(self, keep: bool) -> None:
        self._chunks, self._bytes = [], 0
        self._thread = threading.Thread(
            target=self._drain, args=(self.keep if keep else 0,),
            daemon=True)
        self._thread.start()

    def _drain(self, keep: int) -> None:
        fd = os.open(self.path, os.O_RDONLY)
        try:
            _set_pipe_size(fd)
            while chunk := os.read(fd, PIPE_BYTES):
                room = keep - self._bytes
                if room > 0:
                    self._chunks.append(chunk[:room])
                self._bytes += len(chunk)
        finally:
            os.close(fd)

    def join(self) -> dict:
        """Once the writer closed the pipe: the kept ``head`` (a list of
        chunks) and the output's ``bytes``."""
        self._thread.join()
        return {"head": self._chunks, "bytes": self._bytes}

    def abort(self) -> None:
        """Unblock a drain thread whose writer never opened the pipe."""
        if self._thread is not None and self._thread.is_alive():
            try:
                os.close(os.open(self.path, os.O_WRONLY | os.O_NONBLOCK))
            except OSError:
                pass


class Job:
    """What every job shares: the decider, the filter's settings, the
    input's layout, the input feeds and the output pipes."""

    def __init__(self, engine, decider, cfg, paired: bool, feeds, sinks):
        self.engine = engine
        self.decider = decider
        self.cfg = cfg
        self.paired = paired
        self.input_type = "paired" if paired else "single"
        self.feeds = feeds
        self.sinks = sinks


def plumbing(work: str, pool, files: list, in_ext: str,
             out_ext: str) -> tuple:
    """The input feeds of the pool's files (``files``, FileBytes) and the
    output pipes, in ``work``; each output keeps as many bytes as its
    file's plain records take, more than a repetition of the pool writes
    to it."""
    feeds = [PipeFeed(os.path.join(work, f"in_R{i + 1}{in_ext}"), f)
             for i, f in enumerate(files)]
    sinks = [PipeSink(os.path.join(work, f"out_R{i + 1}{out_ext}"),
                      int(fq.data.size))
             for i, fq in enumerate(pool.files)]
    return feeds, sinks


class Tracer:
    """The profiler over a slice of the window, started between two
    iterations of the job's loop once ``start_at`` has passed and stopped
    once it has run ``seconds``. Inside it the host spans are annotated,
    the slice is one ``devtrace.TRACED`` annotation, and the device is
    synchronised at both ends, so the slice holds the device work of the
    batches launched in it (and the collection of earlier ones)."""

    def __init__(self, dev, spans: Spans, start_at: float, seconds: float):
        self.dev, self.spans = dev, spans
        self.start_at, self.seconds = start_at, seconds
        self.prof = self.mark = self.profiler = None
        self.t0 = self.wall_s = 0.0
        self.at = (0, 0)
        self.first_unit = self.units = self.bases = 0

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def tick(self, launched: list) -> None:
        now = time.perf_counter()
        if self.prof is None:
            if self.profiler is None and now >= self.start_at:
                self._sync()
                self.prof = _profiler(self.dev)
                self.prof.__enter__()
                self.mark = torch.profiler.record_function(devtrace.TRACED)
                self.mark.__enter__()
                self.spans.annotate = True
                self.at = tuple(launched)
                self.t0 = time.perf_counter()
        elif now - self.t0 >= self.seconds:
            self.stop(launched)

    def stop(self, launched: list) -> None:
        if self.prof is None:
            return
        self._sync()
        self.mark.__exit__(None, None, None)
        self.spans.annotate = False
        self.wall_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self.first_unit = self.at[0]
        self.units = launched[0] - self.at[0]
        self.bases = launched[1] - self.at[1]
        self.profiler, self.prof = self.prof, None


def run_job(job: Job, spans: Spans, repeat: int | None,
            deadline: float | None = None, keep_output: bool = False,
            tracer: Tracer | None = None) -> dict:
    """One ``filter`` job (filter.engine.run's loop) over the pool fed
    ``repeat`` times (None: until the deadline); with a deadline, no batch
    is read after it. Returns the job's units, bases, seconds, FilterStats,
    per-unit hits, totals and keep, and its outputs (each one's kept head,
    when ``keep_output``, and size)."""
    from deacon_tpu_torch.filter.progress import FilterStats
    from deacon_tpu_torch.io.writers import format_batch, get_writer

    cfg, paired, decider = job.cfg, job.paired, job.decider
    engine = job.engine
    for s in job.sinks:
        s.start(keep_output)
    for f in job.feeds:
        f.start(repeat)
    t0 = time.perf_counter()
    try:
        with spans("writer"):
            writer = get_writer(cfg.output_path, cfg.compression_level)
            writer2 = (get_writer(cfg.output2_path, cfg.compression_level)
                       if paired else None)
    except BaseException:
        for f in job.feeds:
            f.stop()
        for s in job.sinks:
            s.abort()
        raise
    stats = FilterStats()
    got = {"hits": [], "totals": [], "keep": []}

    def process(batch, d):
        lens = batch.seq_lens
        unit_bp = lens[0::2] + lens[1::2] if paired else lens
        per = 2 if paired else 1
        n_units = d.keep.size
        stats.total_seqs += len(batch)
        stats.total_bp += int(lens.sum())
        kept = np.nonzero(d.keep)[0]
        stats.output_bp += int(unit_bp[kept].sum())
        stats.filtered_seqs += (n_units - kept.size) * per
        stats.filtered_bp += int(unit_bp.sum()) - int(unit_bp[kept].sum())
        stats.output_seq_counter += kept.size * per
        got["hits"].append(d.hits)
        got["totals"].append(d.totals)
        got["keep"].append(d.keep)
        with spans("writer"):
            if not paired:
                writer.write(format_batch(batch, kept))
            else:
                for w, mate in ((writer, 0), (writer2, 1)):
                    w.write(format_batch(batch, 2 * kept + mate))

    depth = max(1, int(decider.resolve_depth))
    max_pending = int(engine.MAX_PENDING_BYTES)
    pending: deque = deque()
    pending_bytes = 0
    launched = [0, 0]  # units, bases
    batches = engine._read_batches(cfg, job.input_type)
    try:
        while True:
            if tracer is not None:
                tracer.tick(launched)
            if deadline is not None and time.perf_counter() >= deadline:
                batch = None
            else:
                with spans("reader"):
                    batch = next(batches, None)
            if batch is not None:
                nb = int(batch.seq_lens.sum())
                with spans("launch"):
                    fut = decider.launch(batch.arena, batch.seq_starts,
                                         batch.seq_lens, paired,
                                         cfg.prefix_length, cfg)
                launched[0] += len(batch) // 2 if paired else len(batch)
                launched[1] += nb
                pending.append((batch, fut, nb))
                pending_bytes += nb
            while pending and (batch is None or len(pending) > depth
                               or pending_bytes > max_pending):
                done, fut, nb = pending.popleft()
                pending_bytes -= nb
                with spans("resolve"):
                    d = fut()
                process(done, d)
            if batch is None:
                break
        if tracer is not None:
            tracer.stop(launched)
    finally:
        # the reader closes its pipes first: a feed ends on that
        batches.close()
        for f in job.feeds:
            f.stop()
        with spans("writer"):
            writer.finish()
            if writer2 is not None:
                writer2.finish()
    outputs = [s.join() for s in job.sinks]
    cat = (lambda xs, t: np.concatenate(xs) if xs else np.zeros(0, t))
    return {"units": launched[0], "bases": stats.total_bp, "stats": stats,
            "seconds": time.perf_counter() - t0,
            "hits": cat(got["hits"], np.int64),
            "totals": cat(got["totals"], np.int64),
            "keep": cat(got["keep"], bool), "outputs": outputs}


def _counters(decider) -> dict:
    from deacon_tpu_torch.ops import kernels

    pipe = decider.pipe
    return {"k1_launches": kernels.select_compact.launches,
            "k2_launches": kernels.probe_hits.launches,
            "rerun_batches": pipe.rerun_batches,
            "rerun_units": pipe.rerun_units}


def _profiler(dev):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def _prime_profiler(dev) -> None:
    """One short profiler session before the set-up. Without it, the
    process's first session, started after the set-up, recorded no
    device operation and no host operation at all (torch 2.11 with CUDA
    12.8 on an H100), while every later session recorded them."""
    with _profiler(dev):
        torch.ones(1, device=dev).sum().item()


def _power_limit() -> str | None:
    """The card's name and power limit (nvidia-smi), or None."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def stream_sum(values: np.ndarray, first: int, count: int) -> int:
    """The sum of ``values`` over units ``first .. first + count`` of the
    stream, unit i being ``values[i % values.size]``."""
    n = values.size
    if count <= 0 or n == 0:
        return 0
    idx = np.arange(first, first + count, dtype=np.int64) % n
    return int(values[idx].sum())


def run(config: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device: str, t_start: float, log) -> dict:
    """Set-up, the window, the reference and the comparison of one run.
    Returns the context that the metric readers read."""
    from deacon_tpu_torch.config import FilterConfig
    from deacon_tpu_torch.filter import engine
    from deacon_tpu_torch.filter.backend import LocalBackend
    from deacon_tpu_torch.index.store import IndexHeader, MinimizerIndex

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    k, w = int(config["k"]), int(config["w"])
    # a job's mode and mesh are the traffic's to set; the mode defaults
    # to the deployment's
    deplete = bool(traffic.get("deplete", config["deplete"]))
    ctx: dict = {"device": dev}
    # the interpreter, torch and the program imported, the card reached
    ctx["start_s"] = time.perf_counter() - t_start
    if trace:
        _prime_profiler(dev)

    # the host stand-in genome and the index's keys, on the device
    t = time.perf_counter()
    host_rng = rng(seed, "genome", config["host_genome_salt"])
    genome = random_bases(host_rng, int(config["host_genome_bp"]))
    keys = make_keys(int(config["n_keys"]),
                     genome_hashes(genome, dev, k, w),
                     generator(seed, "keys", dev), dev)
    index = MinimizerIndex(IndexHeader.new(k, w), to_host_u64(keys))
    del keys
    ctx["keys_s"] = time.perf_counter() - t
    if on_card:
        # the harness's own scratch for the keys is no deployment's: the
        # program's peak is read from here on
        torch.cuda.synchronize()
        ctx["keys_peak_bytes"] = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    work = tempfile.mkdtemp(prefix="bench-", dir=os.environ.get("TMPDIR"))
    try:
        # the pool of reads, as the bytes of its files
        t = time.perf_counter()
        pool_params = traffic["pool"]
        gen_mod = importlib.import_module(
            f"{__package__.rsplit('.', 1)[0]}.generators."
            f"{traffic['generator']}")
        pool = gen_mod.make_pool(pool_params, genome,
                                 rng(seed, "pool", traffic["generator"]))
        in_ext, files = gen_mod.pool_bytes(pool, pool_params)
        ctx["pool_s"] = time.perf_counter() - t
        feeds, sinks = plumbing(work, pool, files, in_ext,
                               traffic["output_ext"])
        cfg = FilterConfig(
            minimizers_path="<resident>", input_path=feeds[0].path,
            input2_path=feeds[1].path if pool.paired else None,
            output_path=sinks[0].path,
            output2_path=sinks[1].path if pool.paired else None,
            abs_threshold=int(config["abs_threshold"]),
            rel_threshold=float(config["rel_threshold"]),
            deplete=deplete, device=device, quiet=True,
            mesh=traffic.get("mesh"))

        # the program's index and its warm-up: one job over the pool
        t = time.perf_counter()
        decider = engine.make_decider(index, LocalBackend(index), k, w, cfg)
        if on_card:
            torch.cuda.synchronize()
        ctx["table_build_s"] = time.perf_counter() - t
        job = Job(engine, decider, cfg, pool.paired, feeds, sinks)
        t = time.perf_counter()
        run_job(job, Spans(), repeat=1)
        ctx["warm_s"] = time.perf_counter() - t
        before = _counters(decider)
        spans = Spans()
        gc.collect()

        # the window: one job over the pool repeated
        t_win = time.perf_counter()
        ctx["setup_s"] = t_win - t_start
        tracer = (Tracer(dev, spans, t_win + TRACE_FROM * seconds,
                         TRACE_SECONDS) if trace else None)
        res = run_job(job, spans, None, deadline=t_win + seconds,
                      keep_output=True, tracer=tracer)
        t_end = time.perf_counter()
        ctx["window_s"] = t_end - t_win
        ctx["bases"] = res["bases"]
        ctx["units"] = res["units"]
        ctx["repetitions"] = res["units"] / pool.n_units
        after = _counters(decider)
        ctx["counters"] = {n: after[n] - before[n] for n in after}
        if on_card:
            torch.cuda.synchronize()
            ctx["program_peak_bytes"] = torch.cuda.max_memory_allocated()
        traced_wall = tracer.wall_s if tracer is not None else 0.0
        ctx["span_wall_s"] = ctx["window_s"] - traced_wall
        ctx["spans"] = dict(spans.seconds)
        if on_card:
            ctx["card"] = _power_limit()
        log(f"window: {res['units']} units ({ctx['repetitions']:.2f} "
            f"repetitions of the pool), {res['bases']} bases in "
            f"{ctx['window_s']:.3f} s")
        log("spans of the window (s): " + ", ".join(
            f"{n}={spans.seconds[n] + spans.traced[n]:.3f}" for n in SPANS)
            + f", traced slice={traced_wall:.3f}")

        # the program's state freed, the reference
        del decider, job
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t = time.perf_counter()
        keys_flipped = torch.from_numpy(index.hashes.view(np.int64)).to(dev)
        keys_flipped ^= I64_MIN
        del index
        hits, totals = unit_counts(pool.arena, pool.starts, pool.lens,
                                   pool.unit_of_seq, pool.n_units,
                                   keys_flipped, dev, k, w)
        keep = keep_mask(hits, totals, int(config["abs_threshold"]),
                         float(config["rel_threshold"]), deplete)
        del keys_flipped
        ctx["reference_s"] = time.perf_counter() - t
        ctx["checks"] = compare(pool, res, hits, totals, keep,
                                traffic["output_ext"].endswith(".gz"))
        if tracer is not None and tracer.profiler is not None:
            ctx["traced"] = {
                "units": tracer.units, "bases": tracer.bases,
                "minimizers": stream_sum(totals, tracer.first_unit,
                                         tracer.units)}
            path = os.path.join(work, "trace.json")
            tracer.profiler.export_chrome_trace(path)
            ctx["trace"], cats = devtrace.read_trace_file(path)
            os.remove(path)
            log(f"trace events by category: {cats}")
        return ctx
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _records(data: bytes) -> list:
    """FASTQ bytes split into records of four lines."""
    lines = data.split(b"\n")
    n = (len(lines) - 1) // 4
    return [b"\n".join(lines[4 * i:4 * i + 4]) for i in range(n)]


def inflate_head(data: bytes) -> bytes:
    """The gzip members at the head of ``data``, inflated as far as they
    go (a member cut short gives what it holds)."""
    out = []
    while data:
        d = zlib.decompressobj(wbits=31)
        try:
            out.append(d.decompress(data))
        except zlib.error:
            break
        if not d.eof:
            break
        data = d.unused_data
    return b"".join(out)


def compare(pool, job: dict, hits, totals, keep, gz: bool) -> dict:
    """The numbers that decide ``correct``, each with its limit:
    ``units_wrong``, units of the job whose hits, totals or keep differ
    from the reference's for their pool unit, or that were read and got
    no answer; ``records_wrong``, records of the outputs' first
    repetition of the pool that differ from the reference's kept
    records, are missing or are extra, and one more for each plain output
    whose size is not that of the kept records of every unit read."""
    n, u = pool.n_units, int(job["units"])
    got = (job["hits"], job["totals"], job["keep"])
    if any(g.size != u for g in got):
        wrong = u  # units read and not answered, or answers astray
    else:
        idx = np.arange(u, dtype=np.int64) % n
        bad = np.zeros(u, bool)
        for g, x in zip(got, (hits, totals, keep)):
            bad |= g != x[idx]
        wrong = int(bad.sum())
    records_wrong = 0
    first = min(u, n)
    kept = np.nonzero(keep[:first])[0]
    for fq, out in zip(pool.files, job["outputs"]):
        data = b"".join(out["head"])
        if gz:
            data = inflate_head(data)
        want = fq.records(kept).tobytes()
        # a job that ends inside the first repetition wrote no more
        head = data if u <= n else data[:len(want)]
        if head != want:
            g, x = _records(head), _records(want)
            records_wrong += max(1, abs(len(g) - len(x)) + sum(
                a != b for a, b in zip(g, x)))
        if not gz:
            sizes = np.diff(fq.rec_off) * keep
            full, rest = divmod(u, n)
            expect = full * int(sizes.sum()) + int(sizes[:rest].sum())
            records_wrong += int(out["bytes"] != expect)
    return {"units_wrong": {"value": wrong, "limit": 0},
            "records_wrong": {"value": records_wrong, "limit": 0}}
