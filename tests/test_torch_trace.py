"""The port's tracing (deacon_tpu_torch/utils/trace.py): off, a span is
one shared no-op and ``filter`` records nothing; on, self time is a span's
time less its children's, spans inside a torch.profiler session are
``deacon.*`` annotations whose seconds go to their own bucket, and
``filter --device cpu`` writes the same bytes as with tracing off while
every stage of its device path, and the host library's reader and writer
counters, record."""

import gzip
import json
import time

import numpy as np
import pytest
import torch

from deacon_tpu_torch.cli import main as torch_main
from deacon_tpu_torch.index.store import IndexHeader, write_index
from deacon_tpu_torch.ops.minimizers_np import compute_minimizer_hashes
from deacon_tpu_torch.utils import trace

_B = np.frombuffer(b"ACGT", np.uint8)
_COMP = bytes.maketrans(b"ACGT", b"TGCA")

#: every span of the device path, by the layer it splits
DEVICE_PATH_SPANS = (
    "reader", "launch", "resolve", "writer",
    "reader.parse", "reader.assemble",
    "launch.counts", "launch.pack", "launch.upload", "launch.enqueue",
    "step.select", "step.hash", "step.sort", "step.probe", "step.totals",
    "resolve.fetch", "resolve.rerun", "resolve.decide",
    "writer.format", "writer.write", "writer.finish")


@pytest.fixture
def tracing():
    """Tracing on, an empty registry, and tracing off again after."""
    was = trace.enabled()
    trace.reset()
    trace.enable()
    try:
        yield
    finally:
        if not was:
            trace.disable()
        trace.reset()


@pytest.fixture
def untraced():
    was = trace.enabled()
    trace.disable()
    trace.reset()
    try:
        yield
    finally:
        if was:
            trace.enable()


def _rs(rng, n):
    return rng.choice(_B, size=n).tobytes()


def _fq(recs) -> bytes:
    return b"".join(b"@%s\n%s\n+\n%s\n" % (n, s, b"I" * len(s))
                    for n, s in recs)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """An index, and pairs drawn from its genome or random, with three
    low-complexity mates that select more minimizers than their rows'
    budget on the small tiles below (their units rerun)."""
    tmp = tmp_path_factory.mktemp("torch_trace")
    rng = np.random.default_rng(2207)
    genome = _rs(rng, 20_000)
    idx = tmp / "ref.idx"
    write_index(compute_minimizer_hashes(genome, 31, 15),
                IndexHeader.new(31, 15), idx)

    def read(n):
        if rng.random() < 0.5:
            s = int(rng.integers(0, len(genome) - n))
            r = genome[s:s + n]
            return r.translate(_COMP)[::-1] if rng.random() < 0.5 else r
        return _rs(rng, n)

    r1 = [(b"p%d/1" % i, read(int(rng.integers(40, 400)))) for i in range(90)]
    r2 = [(b"p%d/2" % i, read(int(rng.integers(40, 400)))) for i in range(90)]
    r1[3] = (b"p3/1", genome[2000:2300] + b"A" * 600)
    r2[11] = (b"p11/2", b"AC" * 450 + genome[4000:4080])
    r1[17] = (b"p17/1", b"T" * 1000)
    files = {"r1.fq": _fq(r1), "r2.fq": _fq(r2),
             "r1.fq.gz": gzip.compress(_fq(r1), compresslevel=6)}
    for name, body in files.items():
        (tmp / name).write_bytes(body)
    return tmp


#: (inputs, outputs) of each filter case
CASES = {"paired_plain": (["r1.fq", "r2.fq"], ["o1.fq", "o2.fq"]),
         "single_gz": (["r1.fq.gz"], ["o.fq.gz"])}


def _filter(data, out_dir, case, monkeypatch):
    # tiles small enough that the low-complexity mates overflow their rows
    monkeypatch.setenv("DEACON_TPU_TILES", "256:16,1024:8")
    ins, outs = CASES[case]
    args = ["filter", str(data / "ref.idx"), *(str(data / i) for i in ins),
            "-o", str(out_dir / outs[0]), "--device", "cpu",
            "--quiet"]
    if len(outs) > 1:
        args += ["-O", str(out_dir / outs[1])]
    assert torch_main(args) in (None, 0)
    return [(out_dir / o).read_bytes() for o in outs]


def test_off_span_is_the_shared_noop_and_filter_records_nothing(
        data, tmp_path, monkeypatch, untraced):
    assert trace.span("launch") is trace.OFF
    assert trace.span("reader.parse") is trace.span("writer")
    with trace.span("x"):
        trace.count("c", 3)
    _filter(data, tmp_path, "paired_plain", monkeypatch)
    assert trace.snapshot() == {"spans": {}, "counters": {}}


def test_self_time_is_duration_less_children(tracing):
    with trace.span("outer"):
        time.sleep(0.01)
        with trace.span("inner"):
            time.sleep(0.02)
        with trace.span("inner"):
            time.sleep(0.01)
    trace.count("n", 2)
    trace.count("n", 5)
    snap = trace.snapshot()
    outer = snap["spans"]["outer"][None]
    inner = snap["spans"]["inner"]["outer"]
    assert outer["calls"] == 1 and inner["calls"] == 2
    assert inner["seconds"] >= 0.03 and outer["seconds"] >= 0.04
    assert outer["self_seconds"] == pytest.approx(
        outer["seconds"] - inner["seconds"], abs=1e-9)
    assert inner["self_seconds"] == inner["seconds"]
    assert outer["traced_seconds"] == inner["traced_seconds"] == 0
    assert snap["counters"] == {"n": 7}


def test_spans_in_a_profiler_session_are_annotations(tracing, tmp_path):
    with trace.span("before"):
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("layer"):
            with trace.span("layer.stage"):
                torch.ones(64).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"deacon.layer", "deacon.layer.stage"} <= names
    assert "deacon.before" not in names
    spans = trace.snapshot()["spans"]
    for name, parent in (("layer", None), ("layer.stage", "layer")):
        s = spans[name][parent]
        assert s["calls"] == 1 and s["traced_seconds"] > 0
        assert s["seconds"] == s["self_seconds"] == 0
    assert spans["before"][None]["traced_seconds"] == 0


def _calls(snap, name):
    return sum(s["calls"] for s in snap["spans"].get(name, {}).values())


@pytest.mark.parametrize("case", sorted(CASES))
def test_filter_traced_writes_the_same_bytes_and_records_every_stage(
        data, tmp_path, monkeypatch, case):
    (tmp_path / "off").mkdir()
    (tmp_path / "on").mkdir()
    was = trace.enabled()
    trace.disable()
    try:
        want = _filter(data, tmp_path / "off", case, monkeypatch)
        trace.reset()
        trace.enable()
        got = _filter(data, tmp_path / "on", case, monkeypatch)
        snap = trace.snapshot()
    finally:
        trace.reset()
        if not was:
            trace.disable()
    assert got == want
    assert all(len(b) for b in got)
    missing = [n for n in DEVICE_PATH_SPANS if _calls(snap, n) == 0]
    assert not missing
    spans = snap["spans"]
    # the stages sit under their layers
    assert set(spans["launch.pack"]) == {"launch.counts", "resolve.rerun"}
    assert set(spans["launch.counts"]) == {"launch"}
    assert set(spans["step.sort"]) == {"launch.enqueue"}
    assert set(spans["reader.parse"]) == {"reader"}
    c = snap["counters"]
    assert c["launch.device_batches"] >= 2
    assert 0 < c["launch.row_bases"] <= c["launch.tile_bases"]
    assert c["launch.rows"] > 0 and c["upload.bytes"] > 0
    assert c["fetch.copies"] >= 3 and c["fetch.bytes"] > 0
    assert c["output.bytes_in"] == sum(
        len(gzip.decompress(b)) if case == "single_gz" else len(b)
        for b in got)
    assert c["output.bytes_out"] == sum(len(b) for b in got)
    if case == "single_gz":
        assert c["decode.busy_ns"] > 0 and c["encode.ns"] > 0
        assert c["decode.bytes"] == len(gzip.decompress(
            (data / "r1.fq.gz").read_bytes()))
    else:
        assert c["decode.busy_ns"] == c["decode.full_wait_ns"] == 0
        assert c["decode.bytes"] == c["reader.empty_wait_ns"] == 0


def test_filter_prints_the_registry_at_its_end(data, tmp_path, monkeypatch,
                                               capsys, tracing):
    _filter(data, tmp_path, "paired_plain", monkeypatch)
    err = capsys.readouterr().err
    assert err.startswith("deacon trace:")
    assert "  launch.pack (under launch.counts): " in err
    assert "  counter launch.tile_bases = " in err


def test_host_engine_profile_follows_deacon_trace(data, tmp_path, capfd,
                                                  monkeypatch):
    monkeypatch.delenv("DEACON_NATIVE_PROFILE", raising=False)
    monkeypatch.setenv("DEACON_TRACE", "1")
    assert torch_main(["filter", str(data / "ref.idx"),
                       str(data / "r1.fq"), "-o", str(tmp_path / "o.fq"),
                       "--device", "host", "--quiet"]) in (None, 0)
    assert "DEACON_NATIVE_PROFILE (ms;" in capfd.readouterr().err
