"""The port's server over a resident index, under concurrent clients, on
the CPU.

``make_server(index=...)`` (ServerState.from_index) must answer exactly as
the server of the same keys read from a file, on both wires and both
routes; eight clients posting at once must get every unit equal to the
benchmark's plain reference (benchmark/reference.py); with tracing on,
every span and counter of the request path records, and with it off
nothing does; a wrong probe bit must be caught by the comparison the
benchmark's server cell makes (benchmark/reference_server.py); a burst
of connections must all be taken by the listen backlog.
"""

import concurrent.futures
import os
import socket
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import reference, reference_server  # noqa: E402
from deacon_tpu_torch.index.store import (  # noqa: E402
    IndexHeader,
    MinimizerIndex,
    load_index,
    write_index,
)
from deacon_tpu_torch.ops.engine import DeviceHashProbe  # noqa: E402
from deacon_tpu_torch.ops.host_extract import (  # noqa: E402
    extract_filter_batch,
)
from deacon_tpu_torch.ops.minimizers_np import (  # noqa: E402
    compute_minimizer_hashes,
)
from deacon_tpu_torch.server import protocol  # noqa: E402
from deacon_tpu_torch.server.app import (  # noqa: E402
    FilterHTTPServer,
    make_server,
)
from deacon_tpu_torch.utils import trace  # noqa: E402

K, W = 31, 15
ABS, REL = 2, 0.01
_B = np.frombuffer(b"ACGT", np.uint8)
_COMP = bytes.maketrans(b"ACGT", b"TGCA")

#: the request path's spans and counters (server/app.py's doc)
SPANS = ("server.request", "server.read", "server.decode", "server.decide",
         "server.probe", "probe.upload", "probe.search", "probe.fetch",
         "server.encode", "server.send")
COUNTERS = ("server.requests", "server.units", "server.hashes",
            "server.bytes_in", "server.bytes_out", "server.errors")


def _rs(rng, n):
    return rng.choice(_B, size=n).tobytes()


def _serve(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


def _post(addr, path, body, ctype):
    req = urllib.request.Request(addr + path, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A genome whose minimizers plus 3,000 random keys are the index;
    60 single reads and 60 pairs, half from the genome; both servers."""
    tmp = tmp_path_factory.mktemp("server_load")
    rng = np.random.default_rng(2424)
    genome = _rs(rng, 20_000)
    keys = np.unique(np.concatenate([
        compute_minimizer_hashes(genome, K, W),
        rng.integers(0, 2**64, 3_000, dtype=np.uint64)]))
    idx = tmp / "ref.idx"
    write_index(keys, IndexHeader.new(K, W), idx)

    def read(n):
        if rng.random() < 0.5:
            s = int(rng.integers(0, len(genome) - n))
            r = genome[s:s + n]
            return r.translate(_COMP)[::-1] if rng.random() < 0.5 else r
        return _rs(rng, n)

    singles = [read(int(rng.integers(40, 400))) for _ in range(60)]
    pairs = [(read(150), read(150)) for _ in range(60)]
    index = MinimizerIndex(IndexHeader.new(K, W), keys.copy())
    resident = make_server(index=index, host="127.0.0.1", device="cpu",
                           version="panhuman1-test@seed-1")
    from_file = make_server(str(idx), 0, host="127.0.0.1", device="cpu")
    out = {"idx": idx, "keys": keys, "singles": singles, "pairs": pairs,
           "resident": _serve(resident), "file": _serve(from_file),
           "state": resident.state}
    yield out
    for httpd in (resident, from_file):
        httpd.shutdown()
        httpd.server_close()


def _batch(data, paired, lo=0, hi=None):
    """The client's batch of reads (pairs) lo..hi, as RemoteDecider makes
    it: host extraction, mates joined."""
    if not paired:
        return extract_filter_batch(data["singles"][lo:hi], 0, K, W)
    seqs = [s for p in data["pairs"][lo:hi] for s in p]
    per = extract_filter_batch(seqs, 0, K, W)
    return [(np.concatenate([h1, h2]), np.concatenate([p1, p2]), (e1, e2))
            for (h1, p1, e1), (h2, p2, e2) in zip(per[0::2], per[1::2])]


def _body(data, paired, binary, lo=0, hi=None):
    batch = _batch(data, paired, lo, hi)
    if binary:
        return (protocol.encode_binary_request(batch, ABS, REL, True, K,
                                               False, paired),
                protocol.BINARY_CTYPE)
    enc = (protocol.encode_paired_request if paired
           else protocol.encode_unpaired_request)
    return enc(batch, ABS, REL, True, K, False), "application/json"


def _route(paired):
    return "/should_output_paired" if paired else "/should_output_unpaired"


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "json"])
@pytest.mark.parametrize("paired", [False, True], ids=["unpaired", "paired"])
def test_resident_index_answers_as_the_file_server(data, paired, binary):
    body, ctype = _body(data, paired, binary)
    got = _post(data["resident"], _route(paired), body, ctype)
    want = _post(data["file"], _route(paired), body, ctype)
    assert got[0] == want[0] == 200
    assert got[1] == want[1]
    decode = (protocol.decode_binary_response if binary
              else protocol.decode_response)
    assert len(decode(got[1])) == (len(data["pairs"]) if paired
                                   else len(data["singles"]))


def test_resident_index_header_and_version(data):
    for path in ("/", "/index_header"):
        assert _get(data["resident"] + path) == _get(data["file"] + path)
    assert _get(data["resident"] + "/index_version") == (
        b"panhuman1-test@seed-1")
    assert _get(data["file"] + "/index_version").startswith(
        str(data["idx"]).encode() + b"@")
    st = data["state"]
    assert st.count == data["keys"].size
    # the state holds no host copy: its backend's index is a stub and the
    # probe's keys are its own copy
    assert st.backend.index.hashes.size == 0 and st.backend._probe is st.probe
    assert isinstance(st.probe, DeviceHashProbe)
    assert [n for n, v in vars(st.probe).items()
            if isinstance(v, np.ndarray)] == []
    assert set(st.timings) == {"sha256_s", "load_index_s", "upload_s"}


@pytest.mark.parametrize("kwargs", [
    {}, {"index_path": "x.idx", "index": "both"}, {"index": "mesh",
                                                   "mesh": "1x2"},
    {"index": "host", "device": "host"}],
    ids=["neither", "both", "mesh", "host"])
def test_resident_index_refuses_what_it_cannot_serve(data, kwargs):
    kw = dict(kwargs)
    if "index" in kw:
        kw["index"] = load_index(data["idx"])
    with pytest.raises(ValueError):
        make_server(host="127.0.0.1", **{"device": "cpu", **kw})


def _reference(data, paired):
    """(hits, totals, keep) of every unit by benchmark/reference.py."""
    seqs = ([s for p in data["pairs"] for s in p] if paired
            else data["singles"])
    lens = np.array([len(s) for s in seqs], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    arena = np.frombuffer(b"".join(seqs), np.uint8)
    n = len(seqs) // (2 if paired else 1)
    unit_of_seq = np.repeat(np.arange(n, dtype=np.int64),
                            2 if paired else 1)
    keys = torch.from_numpy(np.sort(data["keys"]).view(np.int64)) ^ (
        reference.I64_MIN)
    hits, totals = reference.unit_counts(arena, starts, lens, unit_of_seq, n,
                                         keys, torch.device("cpu"), K, W)
    return hits, totals, reference.keep_mask(hits, totals, ABS, REL, True)


def _load(data, per_frame=12, clients=8, rounds=4):
    """``clients`` threads, each posting every frame of both routes
    ``rounds`` times from its own starting frame (binary wire); returns
    {paired: (spans, {frame: [(body, times)]}, failed)}."""
    out = {}
    jobs = []
    for paired in (False, True):
        n = len(data["pairs"] if paired else data["singles"])
        spans = reference_server.frame_spans(n, per_frame)
        bodies = [_body(data, paired, True, a, b)[0] for a, b in spans]
        out[paired] = (spans, {}, [0])
        jobs += [(paired, f, body) for f, body in enumerate(bodies)]
    lock = threading.Lock()

    def client(i):
        for r in range(rounds):
            for j in range(len(jobs)):
                paired, f, body = jobs[(i + j) % len(jobs)]
                code, resp = _post(data["resident"], _route(paired), body,
                                   protocol.BINARY_CTYPE)
                with lock:
                    _, answers, failed = out[paired]
                    if code != 200:
                        failed[0] += 1
                        continue
                    got = answers.setdefault(f, {})
                    got[resp] = got.get(resp, 0) + 1

    with concurrent.futures.ThreadPoolExecutor(clients) as pool:
        list(pool.map(client, range(clients)))
    return {p: (s, {f: list(by.items()) for f, by in a.items()}, n[0])
            for p, (s, a, n) in out.items()}


def test_concurrent_clients_match_the_reference(data):
    loads = _load(data)
    for paired, (spans, answers, failed) in loads.items():
        assert sum(t for by in answers.values() for _, t in by) == (
            8 * 4 * len(spans))
        checks = reference_server.compare(spans, answers, failed,
                                          *_reference(data, paired))
        assert checks == {"units_wrong": {"value": 0, "limit": 0},
                          "requests_failed": {"value": 0, "limit": 0}}
        # keep, hits and totals are not all alike: the check has teeth
        hits = _reference(data, paired)[0]
        assert hits.min() == 0 and hits.max() >= ABS


def test_requests_are_decided_side_by_side(data, monkeypatch):
    """Eight clients at once: each request is decided on its own handler
    thread, so decisions that wait outside the interpreter lock overlap
    (the server serialises no request behind another), and every answer
    still comes back."""
    from deacon_tpu_torch.filter.backend import LocalBackend

    decide = LocalBackend.decide_paired
    inside, most = [0], [0]
    lock = threading.Lock()

    def counting(self, *args):
        with lock:
            inside[0] += 1
            most[0] = max(most[0], inside[0])
        try:
            time.sleep(0.02)
            return decide(self, *args)
        finally:
            with lock:
                inside[0] -= 1

    monkeypatch.setattr(LocalBackend, "decide_paired", counting)
    spans, answers, failed = _load(data, clients=8, rounds=1)[True]
    assert failed == 0
    assert sum(t for by in answers.values() for _, t in by) == 8 * len(spans)
    assert most[0] > 1


def test_decisions_leave_nothing_for_the_collector(data):
    """A request's non-debug decisions are tuples of immutables, which the
    garbage collector stops tracking: a busy server's full collections
    do not scan them (an empty list a unit stayed tracked)."""
    import gc

    out = data["state"].backend.decide_paired(_batch(data, True), K, ABS,
                                              REL, True, False)
    gc.collect()
    assert out and not any(gc.is_tracked(d) for d in out)
    assert all(d[3] == () for d in out)
    assert protocol.encode_response(out[:1]).endswith(b", []]]}")


def test_a_wrong_probe_bit_is_caught(data, monkeypatch):
    collect = DeviceHashProbe.collect

    def flipped(bits):
        out = collect(bits).copy()
        out[out.size // 2] ^= True
        return out

    monkeypatch.setattr(DeviceHashProbe, "collect", staticmethod(flipped))
    spans, answers, failed = _load(data, clients=2, rounds=1)[True]
    checks = reference_server.compare(spans, answers, failed,
                                      *_reference(data, True))
    assert checks["units_wrong"]["value"] > 0
    assert checks["requests_failed"]["value"] == 0


@pytest.fixture
def tracing():
    was = trace.enabled()
    trace.reset()
    trace.enable()
    try:
        yield
    finally:
        if not was:
            trace.disable()
        trace.reset()


def test_request_path_traced(data, tracing):
    body, ctype = _body(data, True, True)
    assert _post(data["resident"], _route(True), body, ctype)[0] == 200
    assert _post(data["resident"], _route(False), b"{broken",
                 "application/json")[0] == 400
    snap = trace.snapshot()
    for name in SPANS:
        assert sum(s["calls"] for s in snap["spans"][name].values()) > 0, \
            name
    for name in COUNTERS:
        assert snap["counters"][name] > 0, name
    assert set(snap["spans"]["server.request"]) == {None}
    assert set(snap["spans"]["server.probe"]) == {"server.decide"}
    assert set(snap["spans"]["probe.search"]) == {"server.probe"}
    assert snap["counters"]["server.requests"] == 2
    assert snap["counters"]["server.errors"] == 1
    assert snap["counters"]["server.units"] == len(data["pairs"])
    assert snap["counters"]["server.bytes_in"] == len(body) + len(b"{broken")


def test_request_path_untraced_records_nothing(data):
    was = trace.enabled()
    trace.disable()
    trace.reset()
    try:
        body, ctype = _body(data, False, True)
        assert _post(data["resident"], _route(False), body, ctype)[0] == 200
        assert trace.snapshot() == {"spans": {}, "counters": {}}
    finally:
        if was:
            trace.enable()


def test_trace_registries_of_many_threads_lose_nothing(tracing):
    """More recording threads than cores, switching as often as the
    interpreter allows: every span and count of every thread is in the
    snapshot, ended threads included, and a reset empties them all."""
    threads, rounds = 32, 300
    start = threading.Barrier(threads)

    def work():
        start.wait(timeout=30)
        for _ in range(rounds):
            with trace.span("load.outer"):
                with trace.span("load.inner"):
                    trace.count("load.n", 2)

    was = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(was)
    snap = trace.snapshot()
    assert snap["spans"]["load.outer"][None]["calls"] == threads * rounds
    assert snap["spans"]["load.inner"]["load.outer"]["calls"] == (
        threads * rounds)
    assert snap["counters"]["load.n"] == 2 * threads * rounds
    assert trace.snapshot() == snap  # folding ended threads keeps them
    trace.reset()
    assert trace.snapshot() == {"spans": {}, "counters": {}}


def test_a_requests_spans_share_one_bucket(tracing):
    """The outermost span on a thread decides whether a span's seconds
    are profiled: a child opened inside a session under a parent opened
    before it counts as unprofiled, and the reverse as profiled."""
    cpu = [torch.profiler.ProfilerActivity.CPU]
    with trace.span("root.before"):
        with torch.profiler.profile(activities=cpu):
            with trace.span("child.inside"):
                pass
    with torch.profiler.profile(activities=cpu):
        outer = trace.span("root.inside")
        outer.__enter__()
    with trace.span("child.after"):
        pass
    outer.__exit__(None, None, None)
    snap = trace.snapshot()["spans"]
    assert snap["child.inside"]["root.before"]["traced_seconds"] == 0
    assert snap["child.inside"]["root.before"]["seconds"] > 0
    assert snap["child.after"]["root.inside"]["seconds"] == 0
    assert snap["child.after"]["root.inside"]["traced_seconds"] > 0


def test_handler_threads_are_annotated_in_an_all_threads_session(
        data, tracing, tmp_path):
    """A session that records every thread (as the benchmark's server
    cell starts it) holds the handler threads' spans as ``deacon.*``
    annotations, on the handler's thread."""
    import json

    from torch._C._profiler import _ExperimentalConfig

    try:
        cfg = _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        pytest.skip("this torch's profiler records one thread only")
    body, ctype = _body(data, True, True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=cfg) as prof:
        assert _post(data["resident"], _route(True), body, ctype)[0] == 200
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    with open(tmp_path / "t.json") as f:
        events = json.load(f)["traceEvents"]
    tids = {e["name"]: e.get("tid") for e in events
            if str(e.get("name", "")).startswith(trace.PREFIX)}
    assert {trace.PREFIX + n for n in SPANS} <= set(tids)
    assert tids["deacon.probe.search"] == tids["deacon.server.request"]
    assert tids["deacon.server.request"] != threading.get_native_id()


def test_listen_backlog_holds_a_burst():
    """A burst of 64 connections to a server that has not accepted any
    yet all complete: the kernel queues them (socketserver's default
    backlog of 5 drops the SYNs of the rest, which retry after a
    second)."""
    from http.server import BaseHTTPRequestHandler

    httpd = FilterHTTPServer(("127.0.0.1", 0), BaseHTTPRequestHandler)
    socks = []
    try:
        t = time.perf_counter()
        for _ in range(64):
            s = socket.create_connection(httpd.server_address, timeout=5)
            socks.append(s)
        assert time.perf_counter() - t < 0.9
    finally:
        for s in socks:
            s.close()
        httpd.server_close()
