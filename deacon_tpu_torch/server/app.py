"""HTTP filter server: holds an index's keys on the device and answers
batched decision requests (ref: src/server.rs).

Routes (the reference's surface, src/server.rs:48-58):
  GET  /                        -> human-readable status line
  GET  /index_header            -> IndexHeader JSON
  GET  /index_version           -> "path@sha256(bytes)" (a resident
                                   index: the caller's version string)
  POST /should_output_unpaired  -> FilterResponse (JSON or binary frame)
  POST /should_output_paired    -> FilterResponse (JSON or binary frame)

Requests carry pre-hashed minimizers, so each request is one membership
probe (ops/engine.DeviceHashProbe: the keys resident on ``device``,
"cuda" by default or "cpu"; or, on "host", HostProbe: the host library's
probe table, the JAX server's default) and the host's threshold
decisions (filter/backend.LocalBackend). stdlib ThreadingHTTPServer
(FilterHTTPServer: a thread a connection); body limit 2 GiB (ref:
src/server.rs:58). The keys come from an index file, or from a
MinimizerIndex already in memory (``make_server(index=...)``,
ServerState.from_index: cuda or cpu, no mesh).

With tracing on (utils/trace.py), each POST is span ``server.request``
on its handler thread, split into ``server.read`` (the body),
``server.decode``, ``server.decide`` (LocalBackend's decisions; its
child ``server.probe`` is the probe, whose own children on a
DeviceHashProbe are ``probe.upload``, ``probe.search`` and
``probe.fetch``), ``server.encode`` and ``server.send``; counters
``server.requests``, ``server.units``, ``server.hashes``,
``server.bytes_in``, ``server.bytes_out`` and ``server.errors``
(answers other than 200).

``--mesh DATAxSHARD`` keeps one value range of the keys on each shard's
card (ops/engine.ShardedHashProbe). ``--mesh pod`` spans processes
(parallel/multihost.py): every rank holds one value range on each of
its cards (its pod mesh's data rows); rank 0 serves HTTP and, under a
lock, broadcasts each request's query size and then its hashes to the
other ranks (PodProbe), every rank cuts the query into one part a card
and searches its range on each card, and the bits are reduced back (one
all-reduce a query, as the JAX pod server splits a query over a
process's chips and reduces over ranks); the other ranks run
probe_worker_loop until a size of zero (the server's close) or a failed
collective (rank 0 gone: the process group's timeout).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..filter.backend import LocalBackend
from ..filter.engine import filter_mesh
from ..index.store import (
    MinimizerIndex,
    load_header_and_count,
    load_index,
    load_index_shard,
    warn_if_foreign_index,
)
from ..io import native_loader
from ..ops.engine import DeviceHashProbe, ShardedHashProbe, probe_rows
from ..parallel.multihost import (
    COLLECTIVE_TIMEOUT_S,
    make_pod_mesh,
    maybe_init_distributed,
    world,
)
from ..parallel.sharded import Mesh
from ..utils import trace
from . import protocol

MAX_BODY = 2_147_483_648  # 2 GiB, ref: src/server.rs:58
#: ``/index_version`` of a server over a resident index unless the
#: caller names it
RESIDENT_VERSION = "resident@-"


def _file_sha256(path: str) -> str:
    """Streaming sha256: a full read() would double the peak host memory
    next to a multi-GB index."""
    with open(path, "rb") as f:
        return hashlib.file_digest(f, "sha256").hexdigest()


#: seconds between rank 0's keep-alive messages to idle pod workers (well
#: inside the process group's timeout)
HEARTBEAT_S = COLLECTIVE_TIMEOUT_S / 4


class PodProbe:
    """The probe of a ``--mesh pod`` server. Rank j holds value range j of
    the index's keys (of the pod mesh's n_shard ranges) on each of its
    cards, one copy a data row, decoded once. On rank 0 a call broadcasts
    the query's size, then its hashes, to every rank; every rank cuts the
    query into one part a card, searches its range (ops/engine.probe_rows)
    and sums its bits with all ranks' (the ranges are disjoint).
    Serialised by a lock: broadcasts of two HTTP threads must not
    interleave. While the server is idle, a thread sends a size of -1
    every HEARTBEAT_S, so idle workers do not time out."""

    def __init__(self, index_path: str, mesh):
        self.mesh = mesh
        t = time.perf_counter()
        _, keys, _ = load_index_shard(index_path, mesh.shard, mesh.n_shard)
        self.load_s = time.perf_counter() - t
        self.probes = [DeviceHashProbe(keys, row[0]) for row in mesh.devices]
        self.upload_s = sum(p.upload_s for p in self.probes)
        del keys
        held = ", ".join(f"{p.device} {p.nbytes / 1e9:.3f} GB"
                         for p in self.probes)
        print(f"Pod rank {mesh.shard} holds value range {mesh.shard} of "
              f"{mesh.n_shard} on each card: {held}", file=sys.stderr)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._beat = None

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self.probes)

    def _probe_all(self, q: np.ndarray) -> np.ndarray:
        """Every rank: its range's bits of ``q``, summed over the ranks."""
        mine = probe_rows([[p] for p in self.probes], q.view(np.uint64))
        return self.mesh.sum_over_shards(mine.astype(np.int64)) > 0

    def __call__(self, hashes: np.ndarray) -> np.ndarray:
        q = np.ascontiguousarray(hashes, dtype=np.uint64).view(np.int64)
        if q.size == 0:
            return np.zeros(0, dtype=bool)
        with self._lock:
            self.mesh.broadcast(np.array([q.size], dtype=np.int64))
            return self._probe_all(self.mesh.broadcast(q))

    def start_heartbeat(self) -> None:
        def beat():
            while not self._stop.wait(HEARTBEAT_S):
                with self._lock:
                    self.mesh.broadcast(np.array([-1], dtype=np.int64))

        self._beat = threading.Thread(target=beat, daemon=True)
        self._beat.start()

    def shutdown(self) -> None:
        """Release the worker ranks: a size of zero ends their loops."""
        self._stop.set()
        if self._beat is not None:
            self._beat.join()
        with self._lock:
            self.mesh.broadcast(np.zeros(1, dtype=np.int64))


def probe_worker_loop(probe: PodProbe) -> None:
    """Ranks > 0 of a ``--mesh pod`` server: take part in each of rank
    0's probes. Blocks in the size broadcast (no spinning); returns on a
    size of zero; a failed or timed-out collective (rank 0 gone) raises."""
    while True:
        size = int(probe.mesh.broadcast(np.zeros(1, dtype=np.int64))[0])
        if size == 0:
            return
        if size < 0:  # rank 0's keep-alive
            continue
        probe._probe_all(probe.mesh.broadcast(np.zeros(size, np.int64)))


class HostProbe:
    """The probe of a ``--device host`` server, the JAX server's default:
    the host library's table (io/native_loader.NativeProbe), mapped from
    the ``<index>.probe`` sidecar when one is valid, else built from the
    decoded keys, which are then dropped, and saved as the sidecar under
    the DEACON_PROBE_CACHE policy. A table built here gets huge pages
    when DEACON_PROBE_THP=1, which the ``server`` command sets."""

    upload_s = 0.0

    def __init__(self, index_path: str, count: int):
        t = time.perf_counter()
        self.table = native_loader.load_probe_sidecar(index_path, count)
        self.source = "sidecar cache"
        if self.table is None:
            self.source = "built at startup"
            self.table = native_loader.native_probe(
                load_index(index_path).hashes)
            try:
                native_loader.maybe_save_probe_sidecar(self.table,
                                                       index_path, count)
            except OSError as e:
                print(f"Warning: the probe table was not cached: {e}",
                      file=sys.stderr)
        self.load_s = time.perf_counter() - t
        print(f"Engine: native C++ probe table ({self.source})",
              file=sys.stderr)

    def __call__(self, hashes: np.ndarray) -> np.ndarray:
        return self.table.query(hashes)


def _make_probe(index_path: str, device: str, mesh):
    """The server's probe for ``mesh`` (None, "pod", a DATAxSHARD spec or
    a parallel.sharded.Mesh); the spec and the devices are checked before
    the index is read. A mesh wins over ``device="host"`` and runs on the
    cards, as in the JAX package."""
    if mesh is not None and device == "host":
        device = "cuda"
    if mesh is None and device == "host":
        return lambda: HostProbe(
            index_path, load_header_and_count(index_path)[1])
    if mesh is None:
        return lambda: DeviceHashProbe.from_index_file(index_path, device)
    if mesh == "pod":
        m = make_pod_mesh(device)
        print(f"Index sharded on pod mesh data={m.shape['data']} x "
              f"shard={m.shape['shard']} (collectives over {m.backend})",
              file=sys.stderr)
        return lambda: PodProbe(index_path, m)
    m = mesh if isinstance(mesh, Mesh) else filter_mesh(mesh, device)
    print(f"Index sharded on device mesh data={m.shape['data']} x "
          f"shard={m.shape['shard']}", file=sys.stderr)
    return lambda: ShardedHashProbe(index_path, m)


class ServerState:
    """The index's header, count and version string, and a LocalBackend
    whose probe holds the keys on ``device`` (no host copy stays): the
    whole key set (no mesh), one value range on each shard of a
    DATAxSHARD mesh (a spec or a parallel.sharded.Mesh, whose devices may
    repeat), or this rank's value range (``mesh="pod"``).
    ``timings``: seconds of the start-up's sha256, index load and
    upload.

    ``ServerState(index_path, ...)`` reads an index file;
    ``ServerState.from_index`` takes keys already in memory. Both end in
    one constructor (``_hold``), so from the probe up they run one path."""

    def __init__(self, index_path: str, device: str = "cuda",
                 mesh: str | None = None):
        make_probe = _make_probe(index_path, device, mesh)
        t = time.perf_counter()
        version = f"{index_path}@{_file_sha256(index_path)}"
        sha_s = time.perf_counter() - t
        print(f"Loading index from: {index_path}", file=sys.stderr)
        warn_if_foreign_index(index_path)
        header, count = load_header_and_count(index_path)
        probe = make_probe()
        self._hold(header, count, probe, version, sha_s)
        print("Loaded index!", file=sys.stderr)

    @classmethod
    def from_index(cls, index: MinimizerIndex, device: str = "cuda",
                   version: str = RESIDENT_VERSION) -> "ServerState":
        """A server state over ``index``'s keys, uploaded to ``device``
        ("cuda" or "cpu": a DeviceHashProbe); the state keeps no reference
        to ``index``, so the caller's copy is the only host copy.
        ``/index_version`` answers ``version``. ``--mesh`` and ``--device
        host`` take an index file only (ValueError here)."""
        if device == "host":
            raise ValueError("a resident index is served on cuda or cpu; "
                             "--device host takes an index file")
        self = cls.__new__(cls)
        self._hold(index.header, int(index.hashes.size),
                   DeviceHashProbe(index.hashes, device), version, 0.0)
        return self

    def _hold(self, header, count: int, probe, version: str,
              sha_s: float) -> None:
        self.header, self.count = header, count
        self.probe, self.version = probe, version
        self.timings = {"sha256_s": sha_s, "load_index_s": probe.load_s,
                        "upload_s": probe.upload_s}
        stub = MinimizerIndex(header, np.empty(0, dtype=np.uint64))
        self.backend = LocalBackend(stub, probe=probe)


class FilterHTTPServer(ThreadingHTTPServer):
    """The stdlib threading server with a listen backlog that holds a
    burst of clients. socketserver's default of 5 drops the SYNs of the
    sixth and later of a burst of connections (each request is one
    connection), and those clients wait a second for the retransmission:
    under 12 concurrent requests on the CPU a request's p95 rose from
    0.19 s to 0.7-1.0 s and the rate fell by a third."""

    request_queue_size = 1024


def make_handler(state: ServerState):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # tracing only via env
            import os

            if os.environ.get("DEACON_TPU_LOG"):
                super().log_message(fmt, *args)

        def _send(self, code: int, body: bytes, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/":
                h = state.header
                msg = (
                    f"Index loaded with {state.count} minimizers and "
                    f"header: IndexHeader {{ format_version: {h.format_version}, "
                    f"kmer_length: {h.kmer_length}, window_size: {h.window_size} }}"
                )
                self._send(200, msg.encode(), "text/plain; charset=utf-8")
            elif self.path == "/index_header":
                self._send(200, json.dumps(state.header.to_dict()).encode())
            elif self.path == "/index_version":
                self._send(200, state.version.encode(),
                           "text/plain; charset=utf-8")
            else:
                self._send(404, b"not found", "text/plain")

        def _reply(self, code: int, body: bytes, ctype: str) -> None:
            """A POST's answer (span ``server.send``; counters
            ``server.bytes_out`` and, for any code but 200,
            ``server.errors``)."""
            if code != 200:
                trace.count("server.errors")
            with trace.span("server.send"):
                self._send(code, body, ctype)
            trace.count("server.bytes_out", len(body))

        def do_POST(self):
            with trace.span("server.request"):
                trace.count("server.requests")
                self._post()

        def _post(self):
            if self.path not in ("/should_output_unpaired",
                                 "/should_output_paired"):
                # unread body bytes would desynchronize this keep-alive
                # connection's next request
                self.close_connection = True
                self._reply(404, b"not found", "text/plain")
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                self.close_connection = True
                self._reply(400, b"bad Content-Length", "text/plain")
                return
            if length < 0 or length > MAX_BODY:
                self.close_connection = True
                code, msg = ((413, b"body too large") if length > 0
                             else (400, b"bad Content-Length"))
                self._reply(code, msg, "text/plain")
                return
            with trace.span("server.read"):
                body = self.rfile.read(length)
            trace.count("server.bytes_in", len(body))
            paired = self.path.endswith("_paired")
            binary = protocol.is_binary_request(body)
            try:
                out, ctype = self._answer(body, paired, binary)
            except Exception as e:  # noqa: BLE001 - report to client
                self._reply(400, f"bad request: {e}".encode(), "text/plain")
                return
            self._reply(200, out, ctype)

        def _answer(self, body: bytes, paired: bool, binary: bool):
            """The response body and content type of a request body."""
            with trace.span("server.decode"):
                if binary:
                    (batch, abs_t, rel_t, deplete, k, debug,
                     req_paired) = protocol.decode_binary_request(body)
                    if req_paired != paired:
                        raise ValueError("paired flag/route mismatch")
                else:
                    batch, abs_t, rel_t, deplete, k, debug = (
                        protocol.decode_request(body, paired)
                    )
            decide = (state.backend.decide_paired if paired
                      else state.backend.decide_unpaired)
            # the probe inside is span server.probe (LocalBackend)
            with trace.span("server.decide"):
                decisions = decide(batch, k, abs_t, rel_t, deplete, debug)
            trace.count("server.units", len(decisions))
            with trace.span("server.encode"):
                if binary:
                    return (protocol.encode_binary_response(decisions),
                            protocol.BINARY_CTYPE)
                return protocol.encode_response(decisions), "application/json"

    return Handler


def make_server(index_path: str | None = None, port: int = 0,
                host: str = "0.0.0.0", device: str = "cuda",
                mesh: str | None = None, *,
                index: MinimizerIndex | None = None,
                version: str = RESIDENT_VERSION):
    """A FilterHTTPServer serving the index file ``index_path``, or
    the keys of ``index`` held in memory (ServerState.from_index, on
    "cuda" or "cpu", no mesh; ``version`` is its ``/index_version``);
    ``httpd.state`` is its ServerState. The caller runs serve_forever."""
    if (index_path is None) == (index is None):
        raise ValueError("make_server takes one of an index path and "
                         "index=")
    if index is None:
        state = ServerState(index_path, device=device, mesh=mesh)
    elif mesh is not None:
        raise ValueError("--mesh takes an index file, not a resident index")
    else:
        state = ServerState.from_index(index, device=device, version=version)
    httpd = FilterHTTPServer((host, port), make_handler(state))
    httpd.state = state
    return httpd


def run_server(index_path: str, port: int, host: str = "0.0.0.0",
               device: str = "cuda", mesh: str | None = None) -> None:
    print("Loading server!", file=sys.stderr)
    if mesh == "pod" and maybe_init_distributed() and world()[1] != 0:
        # a worker rank: hold this rank's range and mirror rank 0's probes
        state = ServerState(index_path, device=device, mesh=mesh)
        print(f"Pod worker rank {world()[1]}: mirroring rank 0 probes",
              file=sys.stderr)
        probe_worker_loop(state.probe)
        return
    httpd = make_server(index_path, port, host=host, device=device,
                        mesh=mesh)
    pod = httpd.state.probe if isinstance(httpd.state.probe, PodProbe) \
        else None
    if pod is not None:
        pod.start_heartbeat()
    print(f"Serving on {host}:{port}", file=sys.stderr)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        if pod is not None:
            pod.shutdown()
