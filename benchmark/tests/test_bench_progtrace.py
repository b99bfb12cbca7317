"""progtrace on a hand-made Chrome trace (device seconds and idle seconds
booked to the innermost program span, the rest unattributed or
unlinked), the readers of the program's spans and counters on a
hand-made context, and progrun's wrappers around the harness at a tiny
size on the port's ``cpu`` route."""

import pytest

from benchmark import harness, progrun, progtrace
from benchmark.tests.test_bench_harness import run, tiny  # noqa: F401


def X(name, ts, dur, tid=1, cat="user_annotation", corr=None):
    e = {"ph": "X", "name": name, "ts": ts, "dur": dur, "tid": tid,
         "cat": cat}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# in microseconds: the slice is [0, 100] on the loop's thread 1
EVENTS = [
    X("bench.traced", 0, 100),
    X("bench.launch", 10, 30),  # the harness's, not the program's
    X("deacon.launch.counts", 10, 30),
    X("deacon.launch.pack", 12, 6),
    X("deacon.launch.enqueue", 20, 15),
    X("deacon.step.sort", 22, 4),
    X("deacon.reader.parse", 50, 20),
    X("deacon.resolve.fetch", 80, 15),
    X("deacon.writer.write", 0, 100, tid=2),  # another thread
    X("cudaLaunchKernel", 23, 1, cat="cuda_runtime", corr=1),
    X("cudaLaunchKernel", 30, 1, cat="cuda_runtime", corr=2),
    X("cudaMemcpyAsync", 5, 0.5, cat="cuda_runtime", corr=3),
    X("sort_kernel", 25, 20, tid=7, cat="kernel", corr=1),
    X("probe_kernel", 45, 10, tid=7, cat="kernel", corr=2),
    X("Memcpy HtoD", 5, 3, tid=7, cat="gpu_memcpy", corr=3),
    X("lost_kernel", 96, 14, tid=7, cat="kernel", corr=4),  # cut at 100
    {"ph": "i", "name": "marker", "ts": 1},
]


def test_innermost_pieces():
    spans = [(0, 10, "a"), (2, 5, "b"), (3, 4, "c"), (6, 10, "d"),
             (20, 30, "e")]
    assert progtrace.innermost(spans) == [
        (0, 2, "a"), (2, 3, "b"), (3, 4, "c"), (4, 5, "b"), (5, 6, "a"),
        (6, 10, "d"), (20, 30, "e")]


def test_device_and_idle_seconds_by_innermost_span():
    pt = progtrace.read_trace(EVENTS)
    us = 1e-6
    assert pt["device_s"] == pytest.approx({
        "step.sort": 20 * us, "launch.enqueue": 10 * us,
        "unattributed": 3 * us, "unlinked": 4 * us})
    # idle: [0, 5], [8, 25], [55, 96]
    assert pt["idle_total_s"] == pytest.approx(63 * us)
    assert pt["idle_s"] == pytest.approx({
        "unattributed": (5 + 2 + 10 + 1) * us, "launch.counts": 4 * us,
        "launch.pack": 6 * us, "launch.enqueue": 2 * us,
        "step.sort": 3 * us, "reader.parse": 15 * us,
        "resolve.fetch": 15 * us})
    assert sum(pt["idle_s"].values()) == pytest.approx(pt["idle_total_s"])
    assert any("step.sort=" in line for line in progtrace.log_lines(pt))


def test_no_slice_or_no_device_reads_nothing():
    assert progtrace.read_trace(EVENTS[1:]) is None
    assert progtrace.read_trace([e for e in EVENTS
                                 if e.get("cat") != "kernel"
                                 and e.get("cat") != "gpu_memcpy"]) is None


def stats(seconds, self_seconds=None, traced=0.0, calls=1):
    return {"calls": calls, "seconds": seconds,
            "self_seconds": seconds if self_seconds is None
            else self_seconds, "traced_seconds": traced}


CTX = {
    "span_wall_s": 10.0, "window_s": 20.0,
    "trace": {"slice_s": 4.0, "busy_s": 0.5, "kernels": {}, "gaps": []},
    "program_trace": {"device_s": {"step.sort": 0.2, "unlinked": 0.1},
                      "idle_s": {}, "idle_total_s": 3.5},
    "program": {
        "spans": {
            "launch.counts": {None: stats(5.0, 1.0, traced=2.0)},
            "launch.pack": {"launch.counts": stats(2.0),
                            "resolve.rerun": stats(0.7)},
            "launch.upload": {"launch.counts": stats(1.0)},
            "launch.enqueue": {"launch.counts": stats(0.5),
                               "resolve.rerun": stats(0.1)},
            "reader.parse": {None: stats(3.0)},
            "reader.assemble": {None: stats(0.25), "reader": stats(0.25)},
            "writer.format": {None: stats(1.5)},
            "resolve.fetch": {None: stats(0.2)},
        },
        "counters": {"decode.busy_ns": 4_000_000_000,
                     "encode.ns": 10_000_000_000,
                     "launch.row_bases": 300, "launch.tile_bases": 400}},
}
WANT = {"plan_share": 0.1, "pack_share": 0.2, "upload_share": 0.1,
        "enqueue_share": 0.05, "parse_share": 0.3, "assemble_share": 0.05,
        "format_share": 0.15, "fetch_share": 0.02, "rerun_share": 0.0,
        "decode_busy_share": 0.2, "encode_share": 0.5, "tile_fill": 0.75,
        "sort_device_share": 0.4}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_context(name):
    m = harness.reader(name)
    assert m.read(CTX) == pytest.approx(WANT[name])
    # a run without the program's registry or its trace: nothing to read
    bare = {k: v for k, v in CTX.items()
            if k not in ("program", "program_trace")}
    assert m.read(bare) is None
    assert m.read({}) is None


def test_every_reader_is_listed_once():
    names = [m for m, _ in progrun.PROGRAM_METRICS]
    assert sorted(names) == sorted(WANT)


@pytest.mark.parametrize("cell", ["panhuman1.pe150", "panmouse1a.pe150-gz"])
def test_progrun_reads_the_window_on_cpu(tiny, monkeypatch,  # noqa: F811
                                         cell):
    from deacon_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "_on", trace.enabled())
    lines = []
    kept = progrun.wrap(lines.append, monkeypatch.setattr)
    try:
        r = run(tiny, cell, seconds=2.0, trace=True)
    finally:
        trace.reset()
    assert r["correct"] is True
    m = {n: v["value"] for n, v in r["metrics"].items()}
    # no device trace on the CPU: sort_device_share is left out
    assert set(WANT) - set(m) == {"sort_device_share"} | (
        set() if cell.endswith("-gz") else {"decode_busy_share",
                                            "encode_share"})
    assert 0 < m["tile_fill"] <= 1
    launch = sum(m[n] for n in ("plan_share", "pack_share", "upload_share",
                                "enqueue_share"))
    assert 0.5 * m["launch_share"] < launch <= m["launch_share"]
    reader = m["parse_share"] + m["assemble_share"]
    assert 0.5 * m["reader_wait_share"] < reader <= m["reader_wait_share"]
    if cell.endswith("-gz"):
        assert m["decode_busy_share"] > 0 and m["encode_share"] > 0
    ctx = kept["ctx"]
    assert ctx["program"]["counters"]["launch.device_batches"] > 0
    assert any(line.startswith("program spans and counters: ")
               for line in lines)
