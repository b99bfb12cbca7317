"""One client of the server cell: replays request frames made in set-up to
a deacon server over loopback, as ``deacon client`` posts its batches,
with ``--inflight`` requests outstanding (a closed loop: the next request
goes when one comes back, no think time).

    python3 benchmark/server_client.py --url http://127.0.0.1:<port> \
        --frames <file> --spans <json> --start <frame> --inflight 3 \
        --out <dir> [--timeout <s>] [--cpus 6,7]

``--frames`` holds the frames end to end, ``--spans`` their
[offset, size, paired] in order. Each request is one POST on its own
connection with the binary wire's content type, as the program's
``RemoteBackend._post`` sends it. Commands, one line each on stdin:

- ``warm <first> <end>``: post frames first .. end - 1 once each; answer
  ``ok <json>`` with the failures;
- ``window <deadline>``: post frames ``start``, ``start + 1``, ... (over
  the frames cyclically) until the deadline (a ``time.perf_counter``
  value: CLOCK_MONOTONIC, shared by the processes of one host), send
  nothing after it, wait for the requests in flight, write its record
  to ``<out>/client-<start>-<pid>.json`` and answer ``ok <that path>``.
  Each distinct response body is written once, to
  ``<out>/<frame>-<sha1>.bin``.

``--cpus`` keeps the process (and so every thread it starts) on those
cores. EOF on stdin ends the process. Standard library only: the program and
torch are never imported and the card is never touched.
"""

from __future__ import annotations

import argparse
import hashlib
import http.client
import json
import mmap
import os
import sys
import threading
import time
import urllib.error
import urllib.request

BINARY_CTYPE = "application/x-deacon-binary"
ROUTES = {False: "/should_output_unpaired", True: "/should_output_paired"}


class Replay:
    def __init__(self, args):
        self.url = args.url.rstrip("/")
        with open(args.spans) as f:
            self.spans = json.load(f)
        self._file = open(args.frames, "rb")
        self.frames = mmap.mmap(self._file.fileno(), 0,
                                access=mmap.ACCESS_READ)
        self.start = args.start
        self.inflight = args.inflight
        self.out = args.out
        self.timeout = args.timeout
        # no proxy: the server is on this host
        self.opener = urllib.request.build_opener(
            urllib.request.ProxyHandler({}))
        self.lock = threading.Lock()

    def post(self, f: int) -> bytes:
        """Frame f's answer; raises on an HTTP error or a timeout."""
        off, size, paired = self.spans[f]
        req = urllib.request.Request(
            self.url + ROUTES[bool(paired)], data=self.frames[off:off + size],
            headers={"Content-Type": BINARY_CTYPE}, method="POST")
        with self.opener.open(req, timeout=self.timeout) as resp:
            return resp.read()

    def run(self, next_frame, record) -> None:
        """``inflight`` threads, each posting ``next_frame()`` until it
        gives None and passing each outcome to ``record``."""
        def worker():
            while True:
                with self.lock:
                    f = next_frame()
                if f is None:
                    return
                t0 = time.perf_counter()
                try:
                    body, err = self.post(f), None
                except (urllib.error.URLError, http.client.HTTPException,
                        OSError, ValueError) as e:
                    body, err = None, f"{type(e).__name__}: {e}"
                t1 = time.perf_counter()
                with self.lock:
                    record(f, t0, t1, body, err)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.inflight)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def warm(self, first: int, end: int) -> dict:
        todo = list(range(first, end))
        failed = []

        def record(f, t0, t1, body, err):
            if err is not None:
                failed.append([f, err])

        self.run(lambda: todo.pop(0) if todo else None, record)
        return {"failed": failed}

    def window(self, deadline: float) -> str:
        n = len(self.spans)
        sent = [0]
        done, failed = [], []
        answers: dict = {}  # frame -> {sha1: count}

        def next_frame():
            if time.perf_counter() >= deadline:
                return None
            f = (self.start + sent[0]) % n
            sent[0] += 1
            return f

        def record(f, t0, t1, body, err):
            if err is not None:
                failed.append([f, err])
                return
            digest = hashlib.sha1(body).hexdigest()
            by = answers.setdefault(str(f), {})
            if digest not in by:
                path = os.path.join(self.out, f"{f}-{digest}.bin")
                if not os.path.exists(path):
                    tmp = f"{path}.{os.getpid()}"
                    with open(tmp, "wb") as fh:
                        fh.write(body)
                    os.replace(tmp, path)
                by[digest] = 0
            by[digest] += 1
            done.append([f, t0, t1])

        self.run(next_frame, record)
        finish = time.perf_counter()
        result = {"start": self.start, "sent": sent[0], "done": done,
                  "failed": failed, "answers": answers, "finish": finish}
        path = os.path.join(self.out, f"client-{self.start}-{os.getpid()}"
                            ".json")
        with open(path, "w") as fh:
            json.dump(result, fh)
        return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--url", required=True)
    ap.add_argument("--frames", required=True)
    ap.add_argument("--spans", required=True)
    ap.add_argument("--start", type=int, required=True)
    ap.add_argument("--inflight", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--cpus", default="")
    args = ap.parse_args(argv)
    if args.cpus:
        os.sched_setaffinity(0, {int(c) for c in args.cpus.split(",")})
    replay = Replay(args)
    for line in sys.stdin:
        cmd, *rest = line.split()
        if cmd == "warm":
            out = replay.warm(int(rest[0]), int(rest[1]))
            print("ok " + json.dumps(out), flush=True)
        elif cmd == "window":
            print("ok " + replay.window(float(rest[0])), flush=True)
        else:
            print(f"error unknown command {cmd!r}", flush=True)
            return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
