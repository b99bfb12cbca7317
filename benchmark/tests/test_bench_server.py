"""The server cell at a tiny size on the port's ``cpu`` route: the
driver end to end (``correct``, its metrics, its traced run's program
spans), the readers on a hand-made context, the response decoder against
the program's encoder, ``correct`` false under a flipped answer and a
failed request, and a fast failure when the program's server cannot hold
a resident index."""

import inspect
import json
import os
import time

import numpy as np
import pytest

from benchmark import harness, reference_server
from benchmark.drivers import server_clients
from benchmark.tests.test_bench_harness import TINY_UNITS, shrink

CELL = "panhuman1srv.clients16-pe150"
SERVER_METRICS = ("server_wire_share", "server_probe_share",
                  "server_decide_share", "server_inflight_mean")
H100 = "NVIDIA H100 80GB HBM3, 700.00 W"


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """2,000 pairs in four requests of 500, four clients."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    shrink(str(tmp_path), units={**TINY_UNITS, "clients16-pe150": 2000})
    path = tmp_path / "benchmark" / "traffic" / "clients16-pe150.json"
    t = json.loads(path.read_text())
    t.update(request_pairs=500, clients=4)
    path.write_text(json.dumps(t))
    return str(tmp_path)


def run(root, seed=2**31 + 21, seconds=1.5, trace=False):
    return harness.run_cell(root, CELL, seed, seconds, trace, "cpu", 0.0,
                            lambda m: None)


def test_cell_correct_on_cpu(tiny):
    r = run(tiny)
    assert r["correct"] is True and r["failed"] == 0
    assert r["checks"] == {"units_wrong": {"value": 0, "limit": 0},
                           "requests_failed": {"value": 0, "limit": 0}}
    assert r["attempted"] >= 2000 and r["attempted"] % 500 == 0
    assert set(r["metrics"]) == {"filter_mbp_s", "setup_s"}  # no card GB
    assert r["device"]["platform"] == "cpu"
    assert not [n for n in os.listdir(tiny) if n.startswith("bench-")]


def test_traced_run_reads_the_program_spans(tiny):
    r = run(tiny, seconds=5.0, trace=True)
    assert r["correct"] is True
    m = r["metrics"]
    assert set(SERVER_METRICS) <= set(m)
    parts = sum(m[n]["value"] for n in SERVER_METRICS[:3])
    assert 0.9 < parts <= 1.0 + 1e-9
    assert 0.1 <= m["server_inflight_mean"]["value"] <= 12.0
    # no device trace and no card on the CPU
    for name in ("server_probe_roofline", "device_idle_share"):
        assert name not in m


def test_readers_on_a_known_context():
    def s(seconds, self_seconds=None, traced=0.0):
        return {"calls": 10, "seconds": seconds,
                "self_seconds": seconds if self_seconds is None
                else self_seconds, "traced_seconds": traced}

    spans = {"server.request": {None: s(40.0, traced=10.0)},
             "server.read": {"server.request": s(2.0)},
             "server.decode": {"server.request": s(6.0)},
             "server.decide": {"server.request": s(20.0, 16.0)},
             "server.probe": {"server.decide": s(4.0)},
             "server.encode": {"server.request": s(3.0)},
             "server.send": {"server.request": s(1.0)}}
    ctx = {"program": {"spans": spans, "counters": {}}, "window_s": 10.0,
           "card": H100, "traced": {"queries": 3_000_000},
           "program_trace": {"device_s": {"probe.search": 0.002}}}
    val = {n: harness.reader(n).read(ctx) for n in SERVER_METRICS
           + ("server_probe_roofline",)}
    assert val["server_wire_share"] == pytest.approx(12.0 / 40.0)
    assert val["server_probe_share"] == pytest.approx(4.0 / 40.0)
    assert val["server_decide_share"] == pytest.approx(16.0 / 40.0)
    # (40 s of requests + 10 profiled) over 10 s
    assert val["server_inflight_mean"] == pytest.approx(5.0)
    # 41 B a query at 3.35 TB/s over 2 ms of device time
    assert val["server_probe_roofline"] == pytest.approx(
        100 * 41 * 3e6 / 3.35e12 / 0.002)
    # nothing to read: no value, no error
    for name in SERVER_METRICS + ("server_probe_roofline",):
        assert harness.reader(name).read({"device": None}) is None


def test_decoder_reads_the_programs_frames():
    from deacon_tpu_torch.server import protocol

    decisions = [(True, 0, 31), (False, 7, 40), (True, 1, 0)]
    body = protocol.encode_binary_response(
        [(k, h, t, []) for k, h, t in decisions])
    keep, hits, totals = reference_server.decode_response(body)
    assert keep.tolist() == [True, False, True]
    assert hits.tolist() == [0, 7, 1] and totals.tolist() == [31, 40, 0]
    for bad in (body[:-1], body + b"\0", b"DXB1" + body[4:], b"",
                b"DXR1\x05\0\0\0"):
        with pytest.raises(ValueError):
            reference_server.decode_response(bad)


def test_compare_counts_units_and_failures():
    spans = reference_server.frame_spans(5, 2)
    assert spans == [(0, 2), (2, 4), (4, 5)]
    keep = np.array([True, False, True, True, False])
    hits = np.array([0, 5, 1, 0, 9])
    totals = np.array([30, 31, 32, 33, 34])

    def frame(a, b, flip=None):
        from deacon_tpu_torch.server import protocol

        d = [(bool(keep[i]), int(hits[i]), int(totals[i]), [])
             for i in range(a, b)]
        if flip is not None:
            k, h, t, x = d[flip]
            d[flip] = (not k, h, t, x)
        return protocol.encode_binary_response(d)

    ok = {0: [(frame(0, 2), 3)], 1: [(frame(2, 4), 1)], 2: [(frame(4, 5), 2)]}
    assert reference_server.compare(spans, ok, 0, hits, totals, keep) == {
        "units_wrong": {"value": 0, "limit": 0},
        "requests_failed": {"value": 0, "limit": 0}}
    bad = dict(ok)
    bad[1] = [(frame(2, 4), 1), (frame(2, 4, flip=0), 2)]
    bad[2] = [(b"DXR1", 1)]
    c = reference_server.compare(spans, bad, 4, hits, totals, keep)
    assert c["units_wrong"]["value"] == 2
    assert c["requests_failed"]["value"] == 5
    wrong_size = {0: [(frame(0, 1), 1)]}
    assert reference_server.compare(spans, wrong_size, 0, hits, totals,
                                    keep)["units_wrong"]["value"] == 2


def test_flipped_answer_is_refused(tiny, monkeypatch):
    from deacon_tpu_torch.server import protocol

    encode = protocol.encode_binary_response

    def flipping(decisions):
        d = list(decisions)
        k, h, t, x = d[len(d) // 2]
        d[len(d) // 2] = (not k, h, t, x)
        return encode(d)

    monkeypatch.setattr(protocol, "encode_binary_response", flipping)
    r = run(tiny)
    assert r["correct"] is False
    assert r["checks"]["units_wrong"]["value"] > 0
    assert r["checks"]["requests_failed"]["value"] == 0


def test_failed_request_is_refused(tiny, monkeypatch):
    """One request of the window fails (the warm pass's four pass)."""
    from deacon_tpu_torch.filter.backend import LocalBackend

    decide = LocalBackend.decide_paired
    calls = [0]

    def failing(self, *args):
        calls[0] += 1
        if calls[0] == 7:
            raise ValueError("planted")
        return decide(self, *args)

    monkeypatch.setattr(LocalBackend, "decide_paired", failing)
    r = run(tiny)
    assert r["correct"] is False
    assert r["checks"]["requests_failed"]["value"] == 1
    assert r["checks"]["units_wrong"]["value"] == 0


@pytest.mark.parametrize("n, server, clients", [
    (8, set(range(6)), {6, 7}), (16, set(range(12)), set(range(12, 16))),
    (4, {0, 1, 2}, {3}), (3, None, None)])
def test_split_cores(monkeypatch, n, server, clients):
    monkeypatch.setattr(server_clients.os, "sched_getaffinity",
                        lambda pid: set(range(n)))
    assert server_clients.split_cores() == (server, clients)


def test_clients_keep_to_their_own_cores(tiny, monkeypatch):
    """The client processes run on the clients' cores, the server's
    threads on the rest, and the run gives the caller its cores back."""
    before = os.sched_getaffinity(0)
    if len(before) < 2:
        pytest.skip("needs two cores to split")
    cores = sorted(before)
    split = (set(cores[:-1]), set(cores[-1:]))
    monkeypatch.setattr(server_clients, "split_cores", lambda: split)
    seen = {"clients": [], "server": []}
    make = server_clients.resident_server()

    def make_server(**kw):
        seen["server"].append(os.sched_getaffinity(0))
        return make(**kw)

    class Client(server_clients.Client):
        def reply(self, timeout):
            line = super().reply(timeout)
            seen["clients"].append(os.sched_getaffinity(self.proc.pid))
            return line

    monkeypatch.setattr(server_clients, "resident_server", lambda: make_server)
    monkeypatch.setattr(server_clients, "Client", Client)
    assert run(tiny)["correct"] is True
    assert seen["server"] == [split[0]]
    assert seen["clients"] and all(c == split[1] for c in seen["clients"])
    assert os.sched_getaffinity(0) == before


def test_no_resident_server_fails_fast(tiny, monkeypatch):
    """A program whose make_server takes no index= (the server cell's
    parent) fails at once, before the keys and before any client."""
    from deacon_tpu_torch.server import app

    def old_make_server(index_path, port, host="0.0.0.0", device="cuda",
                        mesh=None):
        raise AssertionError("not to be called")

    assert "index" not in inspect.signature(old_make_server).parameters
    monkeypatch.setattr(app, "make_server", old_make_server)

    def no_clients(*a, **k):
        raise AssertionError("a client was started")

    monkeypatch.setattr(server_clients, "Client", no_clients)
    monkeypatch.setattr(server_clients, "make_keys", no_clients)
    t = time.perf_counter()
    with pytest.raises(RuntimeError, match="resident index"):
        run(tiny)
    assert time.perf_counter() - t < 5.0


@pytest.mark.parametrize("rel,banned", [
    ("reference_server.py", {"deacon_tpu_torch", "torch"}),
    ("server_client.py", {"deacon_tpu_torch", "torch", "numpy"})])
def test_check_and_clients_import_nothing_of_the_program(rel, banned):
    """The plain check imports nothing of the program; the clients,
    standing for other hosts, import neither it nor torch."""
    from benchmark.tests.test_bench_imports import top_level_imports

    assert not top_level_imports(rel) & banned
