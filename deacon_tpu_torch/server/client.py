"""Remote filtering client backend (ref: src/remote_filter.rs:306-428, C8).

The client computes minimizer hashes locally (exactly like local filtering)
and POSTs batches of pre-hashed minimizers to a deacon server for the
membership + threshold decision. Implements the same decide_* contract as
filter.backend.LocalBackend so the streaming engine is backend-agnostic.
It speaks to the port's server, the JAX package's and the reference's.
"""

from __future__ import annotations

import urllib.error
import urllib.request

from ..index.store import IndexHeader
from . import protocol


class ServerError(RuntimeError):
    pass


class RemoteBackend:
    def __init__(self, server_address: str, timeout: float = 600.0):
        import os

        self.address = server_address.rstrip("/")
        self.timeout = timeout
        self.header = self._fetch_header()
        # binary wire negotiation: None = untried (first decide attempts
        # the packed frame and falls back to JSON permanently if the
        # server rejects it — a reference server only ever sees one
        # failed POST). DEACON_WIRE=json disables the attempt.
        self._binary: bool | None = (
            False if os.environ.get("DEACON_WIRE", "") == "json" else None
        )

    # ------------------------------------------------------------------
    def _get(self, path: str) -> bytes:
        try:
            with urllib.request.urlopen(
                self.address + path, timeout=self.timeout
            ) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:  # reached the server: its error
            raise ServerError(f"Server returned an error: {e.code}") from e
        except urllib.error.URLError as e:
            raise ServerError(
                f"Failed to contact server at {self.address}: {e}"
            ) from e

    def _post(self, path: str, body: bytes,
              ctype: str = "application/json") -> bytes:
        req = urllib.request.Request(
            self.address + path,
            data=body,
            headers={"Content-Type": ctype},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            raise ServerError(f"Server returned an error: {e.code}") from e
        except urllib.error.URLError as e:
            raise ServerError(
                f"Failed to contact server at {self.address}: {e}"
            ) from e

    def _fetch_header(self) -> IndexHeader:
        """GET /index_header (ref: src/server_common.rs:63-81)."""
        import json

        obj = json.loads(self._get("/index_header"))
        header = IndexHeader(
            obj["format_version"], obj["kmer_length"], obj["window_size"]
        )
        header.validate()
        return header

    def summary_index(self) -> str:
        """addr:path@sha256 via GET /index_version
        (ref: src/filter_common.rs:46-81)."""
        return self.address + ":" + self._get("/index_version").decode()

    # ------------------------------------------------------------------
    def _decide(self, path, paired, batch, kmer_length, abs_threshold,
                rel_threshold, deplete, debug):
        # packed binary frame when the server supports it (debug requests
        # carry k-mer strings and always ride JSON); first use probes the
        # server, a rejection permanently selects JSON (reference-server
        # compatible — it only ever sees one failed POST)
        if self._binary is not False and not debug:
            body = protocol.encode_binary_request(
                batch, abs_threshold, rel_threshold, deplete, kmer_length,
                debug, paired,
            )
            try:
                resp = self._post(path, body, ctype=protocol.BINARY_CTYPE)
                out = protocol.decode_binary_response(resp)
                self._binary = True
                return out
            except (ServerError, ValueError):
                if self._binary:  # negotiated earlier: a real error
                    raise
                self._binary = False
        enc = (
            protocol.encode_paired_request if paired
            else protocol.encode_unpaired_request
        )
        body = enc(
            batch, abs_threshold, rel_threshold, deplete, kmer_length, debug
        )
        return protocol.decode_response(self._post(path, body))

    def decide_unpaired(self, batch, kmer_length, abs_threshold, rel_threshold,
                        deplete, debug):
        if not batch:
            return []
        return self._decide(
            "/should_output_unpaired", False, batch, kmer_length,
            abs_threshold, rel_threshold, deplete, debug,
        )

    def decide_paired(self, batch, kmer_length, abs_threshold, rel_threshold,
                      deplete, debug):
        if not batch:
            return []
        return self._decide(
            "/should_output_paired", True, batch, kmer_length,
            abs_threshold, rel_threshold, deplete, debug,
        )
