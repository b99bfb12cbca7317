"""Reading a torch.profiler trace of the window's traced slice: the device's busy
intervals, time by device operation, and the idle gaps named by the
harness's span that the host was in.

The profiler's Chrome trace (``export_chrome_trace``) puts host
annotations (``record_function``) and device operations on one clock, in
microseconds. Device operations are the events of category ``kernel``,
``gpu_memcpy`` and ``gpu_memset``; the harness's spans are host
annotations named ``bench.<span>``, and the traced slice is one
``bench.traced`` annotation.
"""

from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TRACED = "bench.traced"
SPAN_PREFIX = "bench."
NAME_CHARS = 120
#: idle gaps named, longest first
GAPS = 10


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _clip(intervals, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def read_trace(events: list) -> dict | None:
    """From the Chrome trace's ``traceEvents``: ``slice_s`` (the traced
    slice's start to its end), ``busy_s`` (the union of device
    intervals within it), ``kernels`` (device seconds by operation name),
    ``gaps`` (the GAPS longest idle intervals, longest first, as (the
    span that overlaps most of it, seconds)).
    None when the trace holds no traced slice or no device operation."""
    slices, spans, device = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        name = str(e.get("name", ""))
        if e.get("cat") in DEVICE_CATS:
            device.append((a, b, name))
        elif name == TRACED:
            slices.append((a, b))
        elif name.startswith(SPAN_PREFIX):
            spans.append((a, b, name[len(SPAN_PREFIX):]))
    if not slices or not device:
        return None
    lo = min(a for a, _ in slices)
    hi = max(b for _, b in slices)
    inside = [(a, b, n) for a, b, n in device if b > lo and a < hi]
    kernels: dict = {}
    for a, b, n in inside:
        kernels[n] = kernels.get(n, 0.0) + (min(b, hi) - max(a, lo)) / 1e6
    busy = _union(_clip([(a, b) for a, b, _ in inside], lo, hi))
    busy_us = sum(b - a for a, b in busy)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    idle = sorted(((a, b) for a, b in zip(edges[0::2], edges[1::2])
                   if b > a), key=lambda g: g[0] - g[1])[:GAPS]
    gaps = []
    for a, b in idle:
        best, name = 0.0, "other"
        for sa, sb, sn in spans:
            ov = min(b, sb) - max(a, sa)
            if ov > best:
                best, name = ov, sn
        gaps.append((name, (b - a) / 1e6))
    return {"slice_s": (hi - lo) / 1e6, "busy_s": busy_us / 1e6,
            "kernels": kernels, "gaps": gaps}


def read_trace_file(path: str):
    """(read_trace of the file, the count of its events by category)."""
    with open(path, "rb") as f:
        events = json.load(f).get("traceEvents", [])
    cats: dict = {}
    for e in events:
        key = f"{e.get('cat')}/{e.get('ph')}"
        cats[key] = cats.get(key, 0) + 1
    return read_trace(events), cats


def breakdown(trace: dict, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took
    most time and the longest idle gaps, each named."""
    ops = sorted(trace["kernels"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in trace["gaps"][:top]]}


def kernel_seconds(trace: dict, kernel: str) -> float:
    """Device seconds of every operation whose name holds ``kernel``."""
    return sum(s for n, s in trace["kernels"].items() if kernel in n)
