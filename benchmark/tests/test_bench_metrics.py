"""The metric readers on hand-counted cases: the roofline functions, the
trace's busy union and named gaps, and the span shares."""

import numpy as np
import pytest

from benchmark import devtrace, harness, peaks
from benchmark.drivers.filter_stream import stream_sum

H100 = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAKS = {"hbm_bytes_per_s": 3.35e12, "int32_ops_per_s": 33.5e12}


def test_k1_bound_by_operations():
    k1 = harness.reader("k1_roofline")
    # 1e9 bases: 4e10 ops / 33.5e12 = 1.19403 ms; bytes 0.375e9 + 12 * 1e8
    # = 1.575e9 B / 3.35e12 = 0.470 ms: operations bound it
    assert k1.bound_s(10**9, 10**8, PEAKS) == pytest.approx(4e10 / 33.5e12)
    # a minimizer-heavy case where bytes bound it
    assert k1.bound_s(100, 10**9, PEAKS) == pytest.approx(
        (37.5 + 12e9) / 3.35e12)


def test_k2_bound_by_bytes():
    k2 = harness.reader("k2_roofline")
    # 1e6 queries of 8 B + one 32 B sector each, 1e5 units of 4 B hits
    assert k2.bound_s(10**6, 10**5, PEAKS) == pytest.approx(
        (40e6 + 4e5) / 3.35e12)


def ctx_with_trace(kernels):
    return {"card": H100,
            "trace": {"slice_s": 1.0, "busy_s": 0.25, "kernels": kernels,
                      "gaps": []},
            "traced": {"units": 6, "bases": 900, "minimizers": 130}}


def test_roofline_readers():
    ctx = ctx_with_trace({"void select_compact_kernel<31>(...)": 1e-6,
                          "radix_probe_kernel": 2e-6, "cub::Sort": 5.0})
    k1 = harness.reader("k1_roofline").read(ctx)
    ops = 40 * 900 / (132 * 64 * 1.98e9)  # 16.7e12 lane instructions/s
    nbytes = (0.375 * 900 + 12 * (100 + 30)) / 3.35e12
    assert k1 == pytest.approx(100 * max(ops, nbytes) / 1e-6)
    k2 = harness.reader("k2_roofline").read(ctx)
    assert k2 == pytest.approx(100 * (40 * 130 + 4 * 6) / 3.35e12 / 2e-6)
    assert harness.reader("device_idle_share").read(ctx) == 0.75


def test_h100_int32_peak_counts_lane_instructions():
    """132 multiprocessors x 64 INT32 lanes x 1.98 GHz: an IMAD is one
    operation, as K1's 40 operations a base count it."""
    h100 = peaks.PEAKS["NVIDIA H100 80GB HBM3"]
    assert h100["int32_ops_per_s"] == pytest.approx(16.727e12, rel=1e-4)
    assert h100["hbm_bytes_per_s"] == 3.35e12


@pytest.mark.parametrize("first,count,want", [
    (0, 4, 100), (0, 6, 130), (2, 4, 100), (3, 9, 40 + 100 + 100),
    (5, 0, 0)])
def test_stream_sum_wraps_the_pool(first, count, want):
    """Unit i of the window's stream is unit i mod n of the pool."""
    assert stream_sum(np.array([10, 20, 30, 40]), first, count) == want


def test_roofline_silent_without_its_kernel_or_peak():
    ctx = ctx_with_trace({"cub::Sort": 5.0})
    assert harness.reader("k1_roofline").read(ctx) is None
    assert harness.reader("k2_roofline").read(ctx) is None
    ctx = ctx_with_trace({"select_compact_kernel": 1.0})
    ctx["card"] = "Some Other Card, 300.00 W"
    assert harness.reader("k1_roofline").read(ctx) is None
    assert harness.reader("k1_roofline").read({"card": H100}) is None


def ev(name, ts, dur, cat="cpu_op"):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def test_read_trace():
    events = [
        ev("bench.traced", 100, 100, "user_annotation"),
        ev("bench.reader", 100, 30, "user_annotation"),
        ev("bench.writer", 150, 50, "user_annotation"),
        ev("k_a", 90, 20, "kernel"),       # 100-110 inside the slice
        ev("k_b", 105, 10, "kernel"),      # overlaps k_a: union 100-115
        ev("Memcpy HtoD", 140, 5, "gpu_memcpy"),
        ev("k_a", 190, 30, "kernel"),      # 190-200 inside
        ev("k_c", 300, 10, "kernel"),      # outside the slice
        ev("aten::add", 120, 5),
    ]
    t = devtrace.read_trace(events)
    assert t["slice_s"] == pytest.approx(100e-6)
    assert t["busy_s"] == pytest.approx(30e-6)   # 15 + 5 + 10
    assert t["kernels"] == pytest.approx({"k_a": 20e-6, "k_b": 10e-6,
                                          "Memcpy HtoD": 5e-6})
    # idle: 115-140 (reader 115-130, then nothing), 145-190 (writer)
    assert t["gaps"][0] == ("writer", pytest.approx(45e-6))
    assert t["gaps"][1] == ("reader", pytest.approx(25e-6))
    b = devtrace.breakdown(t)
    assert b["device_ops"][0] == ["k_a", pytest.approx(20e-6)]
    assert len(b["idle_gaps"]) == 2


def test_read_trace_without_device_work():
    assert devtrace.read_trace([ev("bench.traced", 0, 10, "user_annotation")]
                               ) is None


def test_span_shares():
    ctx = {"span_wall_s": 4.0, "spans": {"reader": 1.0, "launch": 2.0,
                                          "resolve": 0.5, "writer": 0.25},
           "window_s": 5.0, "bases": 10**9, "units": 100,
           "counters": {"rerun_units": 5}}
    got = {n: harness.reader(n).read(ctx) for n in (
        "reader_wait_share", "launch_share", "resolve_wait_share",
        "writer_share", "filter_mbp_s", "rerun_unit_share")}
    assert got == {"reader_wait_share": 0.25, "launch_share": 0.5,
                   "resolve_wait_share": 0.125, "writer_share": 0.0625,
                   "filter_mbp_s": 200.0, "rerun_unit_share": 0.05}
    assert harness.reader("reader_wait_share").read({"span_wall_s": 0}) is None
