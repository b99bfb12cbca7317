"""Server traffic: the deacon-server deployment. One ``deacon server``
holds the index's keys resident on the device, and client processes send
it batches of pre-hashed minimizers in a closed loop.

Set-up makes the keys from the seed (index_keys.py, as filter_stream
does: the harness's own device scratch is freed and the peak reset
before the program holds anything) and the pool of reads
(generators/). The clients' hosts are not part of the run: their
extraction and framing are done once here, by the program's own client
code (``ops/host_extract.extract_filter_arena``, mates joined as the
client joins them, ``server/protocol.encode_binary_request``), into one
file of frames of at most ``request_pairs`` units each. The server is
``server/app.make_server(index=...)`` over the keys in memory, served by
``serve_forever`` on a thread of this process. ``clients`` processes of
``benchmark/server_client.py`` (the standard library only: neither torch
nor the program) replay the frames over loopback, ``inflight`` requests
outstanding each; client i starts at frame floor(n_frames * i / clients)
and cycles over the frames. The clients stand in for other hosts, so
they keep to cores of their own: the last quarter of the cores this
process may use, the server's threads to the rest, from the server's
start to the reference (split_cores; none below 4 cores). On one H100's
host of 8 cores the rate of 18 s windows varied by 8.7% (sd over four)
with every core shared and by 3.7% (sd over eight) with the clients kept
apart.

A warm pass posts every frame once; then the clients start their closed
loop, and the window opens after a ramp of RAMP_SHARE x ``seconds`` at
full load (set-up): the requests that the clients send at one instant
(16 x 3 in the cell) move through the server together at first, and the
rate climbed through a window that opened with them (one H100's host,
the mean of six runs: 39.6 Mbp/s in the window's first fifth, 47.0 in
its fourth).

The window: the clients post until ``seconds`` after it opened, send
nothing after, and the requests in flight come back inside the window,
which ends when the last client has its last answer. ``bases`` counts
the input bases of every unit whose answer came back inside it; every
answer, the ramp's too, is checked, and a failure anywhere counts. With
``trace``, the program's tracing is on (reset as the window starts, its
snapshot kept as ``ctx["program"]``), and a slice of the window is
profiled on every thread (the handler threads are the program's), read
by devtrace and by progtrace (``ctx["program_trace"]``);
``ctx["traced"]["queries"]`` counts the hashes of the frames whose
answers came back inside the slice, from the frames themselves.

After the window the server is freed and the reference (reference.py)
computes every pool unit's hits, totals and keep; reference_server.py
decodes each distinct answer the clients kept, maps its units to the
pool's and decides ``correct``.

The server must be buildable from keys in memory: a program without
``make_server(index=...)`` fails here before any client starts.
"""

from __future__ import annotations

import gc
import importlib
import inspect
import json
import os
import queue
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from .. import devtrace, progtrace, reference_server
from ..generators.reads import random_bases
from ..index_keys import genome_hashes, make_keys, to_host_u64
from ..reference import I64_MIN, keep_mask, unit_counts
from ..seeds import generator, rng
from .filter_stream import _power_limit

CLIENT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "server_client.py")
#: the ramp at full load before the window, as a share of the window
RAMP_SHARE = 0.2
#: the profiled slice: from this share of the window on, for TRACE_SECONDS
TRACE_FROM = 0.25
TRACE_SECONDS = 4.0
#: the share of the cores that the client processes keep to (at least one)
CLIENT_CORE_SHARE = 0.25
#: a request not answered in this many seconds has failed
REQUEST_TIMEOUT_S = 120.0
#: seconds a client may take to answer a command beyond the requests in it
REPLY_GRACE_S = 60.0


def resident_server():
    """The program's ``make_server``, which must take a resident index."""
    from deacon_tpu_torch.server import app

    if "index" not in inspect.signature(app.make_server).parameters:
        raise RuntimeError("the program's server/app.make_server takes no "
                           "resident index (index=): this cell cannot run")
    return app.make_server


def split_cores() -> tuple:
    """(the server's cores, the clients' cores) of the cores this process
    may use: the clients take the last CLIENT_CORE_SHARE of them, at
    least one; (None, None) below 4 cores."""
    allowed = sorted(os.sched_getaffinity(0))
    if len(allowed) < 4:
        return None, None
    n = max(1, int(len(allowed) * CLIENT_CORE_SHARE))
    return set(allowed[:-n]), set(allowed[-n:])


def pin_threads(cpus: set) -> None:
    """Keep every thread of this process on ``cpus``; threads started
    later inherit the mask of the thread that starts them."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except OSError:  # the thread has ended
            pass


class Client:
    """One client process and the lines it answers with."""

    def __init__(self, url: str, frames: str, spans: str, start: int,
                 inflight: int, out: str, cpus: set | None = None):
        self.start = start
        pin = ["--cpus", ",".join(map(str, sorted(cpus)))] if cpus else []
        self.proc = subprocess.Popen(
            [sys.executable, CLIENT, "--url", url, "--frames", frames,
             "--spans", spans, "--start", str(start), "--inflight",
             str(inflight), "--out", out, "--timeout",
             str(REQUEST_TIMEOUT_S), *pin],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            bufsize=1)
        self.lines: queue.Queue = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.put(line)
        self.lines.put(None)

    def send(self, command: str) -> None:
        self.proc.stdin.write(command + "\n")
        self.proc.stdin.flush()

    def reply(self, timeout: float) -> str:
        try:
            line = self.lines.get(timeout=max(timeout, 1.0))
        except queue.Empty:
            raise RuntimeError(f"client {self.start} gave no answer in "
                               f"{timeout:.0f} s") from None
        if line is None or not line.startswith("ok "):
            raise RuntimeError(f"client {self.start} failed: {line!r} "
                               f"(exit {self.proc.poll()})")
        return line[3:].strip()

    def close(self) -> None:
        try:
            self.proc.stdin.close()
        except OSError:
            pass
        try:
            self.proc.wait(10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def write_frames(pool, spans: list, config: dict, deplete: bool, k: int,
                 w: int, path: str) -> tuple:
    """Each request's frame, as the program's client makes it, end to end
    in ``path``; returns ([offset, size, paired] a frame, the input bases
    of each frame, the hashes of each frame)."""
    from deacon_tpu_torch.ops.host_extract import extract_filter_arena
    from deacon_tpu_torch.server.protocol import encode_binary_request

    mates = 2 if pool.paired else 1
    index, bases, hashes = [], [], []
    off = 0
    with open(path, "wb") as fh:
        for a, b in spans:
            s0, s1 = mates * a, mates * b
            lo = int(pool.starts[s0])
            hi = int(pool.starts[s1 - 1] + pool.lens[s1 - 1])
            per = extract_filter_arena(pool.arena[lo:hi],
                                       pool.starts[s0:s1] - lo,
                                       pool.lens[s0:s1], 0, k, w)
            if pool.paired:
                per = [(np.concatenate([h1, h2]), np.concatenate([p1, p2]),
                        (e1, e2))
                       for (h1, p1, e1), (h2, p2, e2) in zip(per[0::2],
                                                             per[1::2])]
            body = encode_binary_request(
                per, int(config["abs_threshold"]),
                float(config["rel_threshold"]), deplete, k, False,
                pool.paired)
            fh.write(body)
            index.append([off, len(body), pool.paired])
            off += len(body)
            bases.append(int(pool.lens[s0:s1].sum()))
            hashes.append(sum(int(h.size) for h, _, _ in per))
    return index, np.array(bases, np.int64), np.array(hashes, np.int64)


def _profiler(dev):
    """A profiler session over every thread of the process, where this
    torch offers that (the server's handler threads are the program's)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        from torch._C._profiler import _ExperimentalConfig

        kw = {"experimental_config":
              _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        kw = {}
    return torch.profiler.profile(activities=activities, **kw)


def _prime_profiler(dev) -> None:
    """One short session before the set-up (as filter_stream's): a
    process's first session recorded nothing on the card."""
    with _profiler(dev):
        torch.ones(1, device=dev).sum().item()


def traced_slice(dev, start_at: float, seconds: float):
    """Profile the process from ``start_at`` for ``seconds``, the device
    synchronised at both ends, the slice one ``devtrace.TRACED``
    annotation; returns (the profiler, the slice's start, its end)."""
    time.sleep(max(0.0, start_at - time.perf_counter()))
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    sync()
    prof = _profiler(dev)
    prof.__enter__()
    try:
        with torch.profiler.record_function(devtrace.TRACED):
            t0 = time.perf_counter()
            time.sleep(seconds)
            sync()
            t1 = time.perf_counter()
    finally:
        prof.__exit__(None, None, None)
    return prof, t0, t1


class GcClock:
    """The interpreter's garbage collections from now on, by generation:
    [count, seconds] (each holds the interpreter lock, so the server's
    handler threads wait through it)."""

    def __init__(self):
        self.stats = {g: [0, 0.0] for g in range(3)}
        self._t0 = 0.0
        gc.callbacks.append(self._tick)

    def _tick(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            s = self.stats[info["generation"]]
            s[0] += 1
            s[1] += time.perf_counter() - self._t0

    def stop(self) -> None:
        if self._tick in gc.callbacks:
            gc.callbacks.remove(self._tick)


def _answers(records: list, out: str) -> dict:
    """Each frame's distinct answers in the window, with their counts:
    {frame: [(body, times), ...]}."""
    got: dict = {}
    for r in records:
        for f, by in r["answers"].items():
            for digest, times in by.items():
                got.setdefault(int(f), {}).setdefault(digest, 0)
                got[int(f)][digest] += times
    answers = {}
    for f, by in got.items():
        answers[f] = []
        for digest, times in by.items():
            with open(os.path.join(out, f"{f}-{digest}.bin"), "rb") as fh:
                answers[f].append((fh.read(), times))
    return answers


def run(config: dict, traffic: dict, seed: int, seconds: float,
        trace_on: bool, device: str, t_start: float, log) -> dict:
    """Set-up, the window, the reference and the comparison of one run.
    Returns the context that the metric readers read."""
    make_server = resident_server()
    from deacon_tpu_torch.index.store import IndexHeader, MinimizerIndex
    from deacon_tpu_torch.utils import trace

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    k, w = int(config["k"]), int(config["w"])
    deplete = bool(traffic.get("deplete", config["deplete"]))
    n_clients, inflight = int(traffic["clients"]), int(traffic["inflight"])
    ctx: dict = {"device": dev}
    ctx["start_s"] = time.perf_counter() - t_start
    was_tracing = trace.enabled()
    if trace_on:
        trace.enable()
        _prime_profiler(dev)
    work = tempfile.mkdtemp(prefix="bench-", dir=os.environ.get("TMPDIR"))
    clients: list = []
    httpd = gc_clock = None
    all_cores = os.sched_getaffinity(0)
    server_cores, client_cores = split_cores()
    try:
        # the host stand-in genome and the index's keys, on the device
        t = time.perf_counter()
        genome = random_bases(rng(seed, "genome", config["host_genome_salt"]),
                              int(config["host_genome_bp"]))
        keys = make_keys(int(config["n_keys"]),
                         genome_hashes(genome, dev, k, w),
                         generator(seed, "keys", dev), dev)
        index = MinimizerIndex(IndexHeader.new(k, w), to_host_u64(keys))
        del keys
        ctx["keys_s"] = time.perf_counter() - t
        if on_card:
            torch.cuda.synchronize()
            ctx["keys_peak_bytes"] = torch.cuda.max_memory_allocated()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

        # the pool of reads and the clients' frames
        t = time.perf_counter()
        gen_mod = importlib.import_module(
            f"{__package__.rsplit('.', 1)[0]}.generators."
            f"{traffic['generator']}")
        pool = gen_mod.make_pool(traffic["pool"], genome,
                                 rng(seed, "pool", traffic["generator"]))
        ctx["pool_s"] = time.perf_counter() - t
        t = time.perf_counter()
        spans = reference_server.frame_spans(pool.n_units,
                                             int(traffic["request_pairs"]))
        frames = os.path.join(work, "frames.bin")
        frame_index, frame_bases, frame_hashes = write_frames(
            pool, spans, config, deplete, k, w, frames)
        spans_path = os.path.join(work, "spans.json")
        with open(spans_path, "w") as fh:
            json.dump(frame_index, fh)
        frame_units = np.array([b - a for a, b in spans], np.int64)
        ctx["frames_s"] = time.perf_counter() - t

        # the server, over the keys in memory, on the server's cores
        t = time.perf_counter()
        if server_cores:
            pin_threads(server_cores)
            log(f"cores: server {sorted(server_cores)}, clients "
                f"{sorted(client_cores)}")
        server = make_server(port=0, host="127.0.0.1", device=device,
                             index=index,
                             version=f"{config['name']}@seed-{seed}")
        threading.Thread(target=server.serve_forever, daemon=True).start()
        httpd = server  # serving: shutdown() returns once it stops
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        if on_card:
            torch.cuda.synchronize()
        ctx["server_s"] = time.perf_counter() - t

        # the clients, and one warm pass over every frame
        t = time.perf_counter()
        nf = len(spans)
        firsts = [nf * i // n_clients for i in range(n_clients + 1)]
        out = os.path.join(work, "answers")
        os.mkdir(out)
        clients = [Client(url, frames, spans_path, firsts[i], inflight, out,
                          client_cores) for i in range(n_clients)]
        for i, c in enumerate(clients):
            c.send(f"warm {firsts[i]} {firsts[i + 1]}")
        for i, c in enumerate(clients):
            wait = REQUEST_TIMEOUT_S * (firsts[i + 1] - firsts[i])
            failed = json.loads(c.reply(wait + REPLY_GRACE_S))["failed"]
            if failed:
                raise RuntimeError(f"the warm pass failed: {failed[:3]}")
        ctx["warm_s"] = time.perf_counter() - t
        gc.collect()

        # the closed loop: a ramp at full load, then the window
        t_win = time.perf_counter() + RAMP_SHARE * seconds
        deadline = t_win + seconds
        for c in clients:
            c.send(f"window {deadline!r}")
        time.sleep(max(0.0, t_win - time.perf_counter()))
        ctx["setup_s"] = time.perf_counter() - t_start
        trace.reset()
        gc_clock = GcClock() if trace_on else None
        prof = None
        slice_at = t_win + TRACE_FROM * seconds
        if trace_on:
            prof, s0, s1 = traced_slice(
                dev, slice_at, min(TRACE_SECONDS, max(0.0, deadline
                                                      - slice_at)))
        records = []
        for c in clients:
            wait = deadline - time.perf_counter() + REQUEST_TIMEOUT_S
            with open(c.reply(wait + REPLY_GRACE_S)) as fh:
                records.append(json.load(fh))
        t_end = max(r["finish"] for r in records)
        ctx["window_s"] = t_end - t_win
        if gc_clock is not None:
            gc_clock.stop()
            log(f"garbage collections in the window (generation: count, "
                f"seconds): {gc_clock.stats}")
        if trace_on:
            ctx["program"] = trace.snapshot()
        if on_card:
            torch.cuda.synchronize()
            ctx["program_peak_bytes"] = torch.cuda.max_memory_allocated()
            ctx["card"] = _power_limit()
        done = [d for r in records for d in r["done"] if d[2] >= t_win]
        failed = [f for r in records for f in r["failed"]]
        answered = np.array([f for f, _, _ in done], np.int64)
        ctx["bases"] = int(frame_bases[answered].sum())
        ctx["units"] = int(frame_units[answered].sum()
                           + sum(frame_units[f] for f, _ in failed))
        traced_wall = (s1 - s0) if prof is not None else 0.0
        ctx["span_wall_s"] = ctx["window_s"] - traced_wall
        latency = [t1 - t0 for _, t0, t1 in done]
        ctx["counters"] = {"requests_answered": len(done),
                           "requests_failed": len(failed),
                           "hashes_answered": int(
                               frame_hashes[answered].sum())}
        log(f"window: {len(done)} requests answered, {len(failed)} failed, "
            f"{ctx['units']} units, {ctx['bases']} bases in "
            f"{ctx['window_s']:.3f} s; {n_clients} clients x {inflight} in "
            f"flight over {nf} frames")
        fifth = seconds / 5
        by_fifth = np.zeros(5)
        for f, _, t1 in done:
            by_fifth[min(4, max(0, int((t1 - t_win) // fifth)))] += (
                frame_bases[f])
        log("Mbp/s answered in each fifth of the window: " + ", ".join(
            f"{b / fifth / 1e6:.2f}" for b in by_fifth))
        if len(latency) >= 2:
            q = statistics.quantiles(latency, n=20)
            log(f"request seconds: median {statistics.median(latency):.4f}, "
                f"p95 {q[18]:.4f}, max {max(latency):.4f}")
        for f in failed[:5]:
            log(f"failed request: frame {f[0]}: {f[1]}")
        for key in ("frames_s", "server_s"):
            log(f"{key}={ctx[key]}")
        if prof is not None:
            inside = [f for f, _, t1 in done if s0 <= t1 < s1]
            ctx["traced"] = {
                "requests": len(inside),
                "units": int(frame_units[inside].sum()),
                "queries": int(frame_hashes[inside].sum())}
            path = os.path.join(work, "trace.json")
            prof.export_chrome_trace(path)
            ctx["trace"], cats = devtrace.read_trace_file(path)
            ctx["program_trace"] = progtrace.read_trace_file(path)
            os.remove(path)
            log(f"trace events by category: {cats}")
            log(f"traced slice: {ctx['traced']}")
            if ctx["program_trace"]:
                for line in progtrace.log_lines(ctx["program_trace"]):
                    log(line)
        if trace_on:
            log("program spans and counters: " + json.dumps(
                {"spans": {n: {str(p): s for p, s in by.items()}
                           for n, by in ctx["program"]["spans"].items()},
                 "counters": ctx["program"]["counters"]}))
        answers = _answers(records, out)

        # the program's state freed, the reference
        httpd.shutdown()
        httpd.server_close()
        httpd = None
        for c in clients:
            c.close()
        clients = []
        if server_cores:
            pin_threads(all_cores)
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
        ctx["checks"] = reference_server.compare(spans, answers, len(failed),
                                                 hits, totals, keep)
        return ctx
    finally:
        if gc_clock is not None:
            gc_clock.stop()
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        for c in clients:
            c.close()
        if server_cores:
            pin_threads(all_cores)
        if trace_on and not was_tracing:
            trace.disable()
        shutil.rmtree(work, ignore_errors=True)
