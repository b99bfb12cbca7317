"""HTTP filter server: holds an index's keys on the device and answers
batched decision requests (ref: src/server.rs).

Routes (the reference's surface, src/server.rs:48-58):
  GET  /                        -> human-readable status line
  GET  /index_header            -> IndexHeader JSON
  GET  /index_version           -> "path@sha256(bytes)"
  POST /should_output_unpaired  -> FilterResponse (JSON or binary frame)
  POST /should_output_paired    -> FilterResponse (JSON or binary frame)

Requests carry pre-hashed minimizers, so each request is one membership
probe (ops/engine.DeviceHashProbe: the keys resident on ``device``,
"cuda" by default or "cpu"; or, on "host", HostProbe: the host library's
probe table, the JAX server's default) and the host's threshold
decisions (filter/backend.LocalBackend). stdlib ThreadingHTTPServer; body limit
2 GiB (ref: src/server.rs:58).

``--mesh DATAxSHARD`` keeps one value range of the keys on each shard's
card (ops/engine.ShardedHashProbe). ``--mesh pod`` spans processes
(parallel/multihost.py): every rank holds one value range on its card;
rank 0 serves HTTP and, under a lock, broadcasts each request's query
size and then its hashes to the other ranks (PodProbe), every rank
searches its range, and the bits are reduced back; the other ranks run
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
from ..ops.engine import DeviceHashProbe, ShardedHashProbe
from ..parallel.multihost import (
    COLLECTIVE_TIMEOUT_S,
    make_pod_mesh,
    maybe_init_distributed,
    world,
)
from ..parallel.sharded import Mesh
from . import protocol

MAX_BODY = 2_147_483_648  # 2 GiB, ref: src/server.rs:58


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
    the index's keys (of the pod mesh's n_shard ranges) on its card. On
    rank 0 a call broadcasts the query's size, then its hashes, to every
    rank, searches its own range, and sums the bits of all ranks (the
    ranges are disjoint). Serialised by a lock: broadcasts of two HTTP
    threads must not interleave. While the server is idle, a thread sends
    a size of -1 every HEARTBEAT_S, so idle workers do not time out."""

    def __init__(self, index_path: str, mesh):
        self.mesh = mesh
        t = time.perf_counter()
        _, keys, _ = load_index_shard(index_path, mesh.shard, mesh.n_shard)
        self.load_s = time.perf_counter() - t
        self.local = DeviceHashProbe(keys, mesh.devices[0][0])
        self.upload_s = self.local.upload_s
        del keys
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._beat = None

    @property
    def nbytes(self) -> int:
        return self.local.nbytes

    def _probe_all(self, q: np.ndarray) -> np.ndarray:
        """Every rank: its range's bits of ``q``, summed over the ranks."""
        mine = self.local(q.view(np.uint64)).astype(np.int64)
        return self.mesh.sum_over_shards(mine) > 0

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
    upload."""

    def __init__(self, index_path: str, device: str = "cuda",
                 mesh: str | None = None):
        make_probe = _make_probe(index_path, device, mesh)
        t = time.perf_counter()
        self.version = f"{index_path}@{_file_sha256(index_path)}"
        sha_s = time.perf_counter() - t
        print(f"Loading index from: {index_path}", file=sys.stderr)
        warn_if_foreign_index(index_path)
        self.header, self.count = load_header_and_count(index_path)
        self.probe = make_probe()
        self.timings = {"sha256_s": sha_s, "load_index_s": self.probe.load_s,
                        "upload_s": self.probe.upload_s}
        stub = MinimizerIndex(self.header, np.empty(0, dtype=np.uint64))
        self.backend = LocalBackend(stub, probe=self.probe)
        print("Loaded index!", file=sys.stderr)


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

        def do_POST(self):
            if self.path not in ("/should_output_unpaired",
                                 "/should_output_paired"):
                # unread body bytes would desynchronize this keep-alive
                # connection's next request
                self.close_connection = True
                self._send(404, b"not found", "text/plain")
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                self.close_connection = True
                self._send(400, b"bad Content-Length", "text/plain")
                return
            if length < 0 or length > MAX_BODY:
                self.close_connection = True
                code, msg = ((413, b"body too large") if length > 0
                             else (400, b"bad Content-Length"))
                self._send(code, msg, "text/plain")
                return
            body = self.rfile.read(length)
            paired = self.path.endswith("_paired")
            binary = protocol.is_binary_request(body)
            try:
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
                decisions = decide(batch, k, abs_t, rel_t, deplete, debug)
                if binary:
                    self._send(200, protocol.encode_binary_response(decisions),
                               protocol.BINARY_CTYPE)
                else:
                    self._send(200, protocol.encode_response(decisions))
            except Exception as e:  # noqa: BLE001 - report to client
                self._send(400, f"bad request: {e}".encode(), "text/plain")

    return Handler


def make_server(index_path: str, port: int, host: str = "0.0.0.0",
                device: str = "cuda", mesh: str | None = None):
    """A ThreadingHTTPServer serving the index; ``httpd.state`` is its
    ServerState. The caller runs serve_forever."""
    state = ServerState(index_path, device=device, mesh=mesh)
    httpd = ThreadingHTTPServer((host, port), make_handler(state))
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
