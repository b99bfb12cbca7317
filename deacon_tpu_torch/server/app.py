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
"cuda" by default or "cpu") and the host's threshold decisions
(filter/backend.LocalBackend). stdlib ThreadingHTTPServer; body limit
2 GiB (ref: src/server.rs:58). ``--mesh`` is not ported.
"""

from __future__ import annotations

import hashlib
import json
import sys
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..filter.backend import LocalBackend
from ..index.store import (
    MinimizerIndex,
    load_header_and_count,
    warn_if_foreign_index,
)
from ..ops.engine import DeviceHashProbe
from . import protocol

MAX_BODY = 2_147_483_648  # 2 GiB, ref: src/server.rs:58


def _file_sha256(path: str) -> str:
    """Streaming sha256: a full read() would double the peak host memory
    next to a multi-GB index."""
    with open(path, "rb") as f:
        return hashlib.file_digest(f, "sha256").hexdigest()


class ServerState:
    """The index's header, count and version string, and a LocalBackend
    whose probe holds the keys on ``device`` (no host copy stays).
    ``timings``: seconds of the start-up's sha256, index load and
    upload."""

    def __init__(self, index_path: str, device: str = "cuda",
                 mesh: str | None = None):
        if mesh is not None:
            raise ValueError("--mesh on the server is not ported yet")
        t = time.perf_counter()
        self.version = f"{index_path}@{_file_sha256(index_path)}"
        sha_s = time.perf_counter() - t
        print(f"Loading index from: {index_path}", file=sys.stderr)
        warn_if_foreign_index(index_path)
        self.header, self.count = load_header_and_count(index_path)
        self.probe = DeviceHashProbe.from_index_file(index_path, device)
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
    httpd = make_server(index_path, port, host=host, device=device,
                        mesh=mesh)
    print(f"Serving on {host}:{port}", file=sys.stderr)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
