"""The program's own spans (deacon_tpu_torch/utils/trace.py) in the run:
its registry read over the window, and its ``deacon.<span>`` annotations
in the torch.profiler trace of the window's traced slice.

From the Chrome trace (read_trace):

- ``device_s``: device seconds by program span. Each device operation
  (kernel, memcpy, memset), clipped to the slice, is tied by
  ``args.correlation`` to the runtime or driver call that launched it, and
  booked to the innermost ``deacon.`` span open on that call's thread when
  it was made; ``unattributed`` when none was, ``unlinked`` when no call
  has its correlation.
- ``idle_s``: the slice's device-idle seconds by program span. Every
  interval of the slice in which the device ran nothing is split by the
  innermost ``deacon.`` span open over it on the thread of
  ``bench.traced`` (the job's loop); time under no program span is
  ``unattributed``.

From the registry (``ctx["program"]``, trace.snapshot() of the window):
span_share and counter_share, the readers' shares.
"""

from __future__ import annotations

import bisect
import json

from .devtrace import DEVICE_CATS, TRACED, _clip, _union

PREFIX = "deacon."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
UNATTRIBUTED = "unattributed"
UNLINKED = "unlinked"


def innermost(spans) -> list:
    """The (start, end, name) spans of one thread, nested as one thread
    opens them -> sorted, disjoint (start, end, name) pieces: the
    innermost span open at each time covered by any."""
    pieces, stack = [], []  # stack: (end, name), innermost last
    t = float("-inf")

    def close_until(x):
        nonlocal t
        while stack and stack[-1][0] <= x:
            end, name = stack.pop()
            if end > t:
                pieces.append((t, end, name))
                t = end

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        close_until(a)
        if stack and a > t:
            pieces.append((t, a, stack[-1][1]))
        stack.append((b, name))
        t = max(t, a)
    close_until(float("inf"))
    return pieces


def _at(pieces, starts, x):
    """The name of the piece holding time x, or None."""
    i = bisect.bisect_right(starts, x) - 1
    if i >= 0 and pieces[i][0] <= x < pieces[i][1]:
        return pieces[i][2]
    return None


def _add(d: dict, key, value: float) -> None:
    d[key] = d.get(key, 0.0) + value


def read_trace(events: list) -> dict | None:
    """``device_s`` and ``idle_s`` (see the module's doc), in seconds,
    and ``idle_total_s``, from the Chrome trace's ``traceEvents``. None
    when the trace holds no traced slice or no device operation."""
    slices, device, spans = [], [], {}
    launches: dict = {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        name, cat = str(e.get("name", "")), e.get("cat")
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            device.append((a, b, corr))
        elif cat in LAUNCH_CATS:
            launches[corr] = (a, e.get("tid"))
        elif name == TRACED:
            slices.append((a, b, e.get("tid")))
        elif name.startswith(PREFIX):
            spans.setdefault(e.get("tid"), []).append(
                (a, b, name[len(PREFIX):]))
    if not slices or not device:
        return None
    lo = min(a for a, _, _ in slices)
    hi = max(b for _, b, _ in slices)
    pieces = {tid: innermost(s) for tid, s in spans.items()}
    starts = {tid: [p[0] for p in ps] for tid, ps in pieces.items()}

    device_s: dict = {}
    for a, b, corr in device:
        us = min(b, hi) - max(a, lo)
        if us <= 0:
            continue
        launch = launches.get(corr)
        if launch is None:
            owner = UNLINKED
        else:
            ts, tid = launch
            owner = (_at(pieces[tid], starts[tid], ts) if tid in pieces
                     else None) or UNATTRIBUTED
        _add(device_s, owner, us / 1e6)

    busy = _union(_clip([(a, b) for a, b, _ in device], lo, hi))
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    loop = pieces.get(slices[0][2], [])
    idle_s: dict = {}
    total = 0.0
    j = 0
    for a, b in idle:
        total += (b - a) / 1e6
        covered = 0.0
        while j < len(loop) and loop[j][1] <= a:
            j += 1
        k = j
        while k < len(loop) and loop[k][0] < b:
            ov = min(b, loop[k][1]) - max(a, loop[k][0])
            if ov > 0:
                _add(idle_s, loop[k][2], ov / 1e6)
                covered += ov
            k += 1
        if b - a > covered:
            _add(idle_s, UNATTRIBUTED, (b - a - covered) / 1e6)
    return {"device_s": device_s, "idle_s": idle_s, "idle_total_s": total}


def read_trace_file(path: str) -> dict | None:
    with open(path, "rb") as f:
        return read_trace(json.load(f).get("traceEvents", []))


def log_lines(program_trace: dict) -> list:
    """The program trace as lines for the log, largest first."""
    out = []
    for key, what in (("device_s", "device seconds by program span"),
                      ("idle_s", "device-idle seconds by program span")):
        items = sorted(program_trace[key].items(), key=lambda kv: -kv[1])
        out.append(f"{what}: " + ", ".join(f"{n}={s:.6f}" for n, s in items))
    out.append(f"device-idle seconds in all: "
               f"{program_trace['idle_total_s']:.6f}")
    return out


def span_seconds(ctx: dict, name: str, under: str | None = None,
                 key: str = "seconds") -> float | None:
    """``key`` of span ``name`` in the window's registry, summed over its
    parents, or under parent ``under`` alone; 0 for a span that never
    ran, None without a registry."""
    prog = ctx.get("program")
    if prog is None:
        return None
    by_parent = prog["spans"].get(name, {})
    return sum(s[key] for p, s in by_parent.items()
               if under is None or p == under)


def span_share(ctx: dict, name: str, under: str | None = None,
               key: str = "seconds") -> float | None:
    """span_seconds over the window's wall time outside its traced slice
    (``span_wall_s``, the base of the harness's span shares)."""
    wall = ctx.get("span_wall_s", 0)
    seconds = span_seconds(ctx, name, under, key)
    if seconds is None or wall <= 0:
        return None
    return seconds / wall


def counter_share(ctx: dict, name: str) -> float | None:
    """Counter ``name`` (nanoseconds) over the window's seconds."""
    prog, window = ctx.get("program"), ctx.get("window_s", 0)
    if prog is None or name not in prog["counters"] or window <= 0:
        return None
    return prog["counters"][name] / 1e9 / window
