"""The program's own spans and counters, off unless ``DEACON_TRACE=1``
(read once, at import) or ``enable()``.

``with span("launch.pack"):`` times one stage of a layer. Each span name
keeps, per parent span (the span open around it on the same thread, or
None): its calls, its seconds on ``time.perf_counter_ns`` (CLOCK_MONOTONIC
on Linux, the clock of the host library's counters), and its self seconds,
its seconds less those of the spans opened inside it. While a
torch.profiler session records, a span is also the annotation
``deacon.<name>`` in the profiler's trace, on the clock of the device's
kernels and copies, and its seconds go to ``traced_seconds`` in place of
``seconds`` and ``self_seconds``: a profiled stretch pays the profiler's
costs. ``count(name, n)`` adds to an integer counter.

Off, ``span()`` returns one shared no-op context manager and ``count()``
returns at once: no clock is read and torch is not called.

``filter`` prints ``report()`` on stderr at its end when tracing is on;
``snapshot()`` hands the registry to a caller as plain dicts, and
``reset()`` empties it."""

from __future__ import annotations

import os
import sys
import threading
import time

#: the profiler annotation of span ``name`` is PREFIX + name
PREFIX = "deacon."

_on = os.environ.get("DEACON_TRACE", "") == "1"
_lock = threading.Lock()
#: (name, parent) -> [calls, ns, self ns, traced ns]
_spans: dict = {}
_counters: dict = {}
_local = threading.local()


def enabled() -> bool:
    return _on


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


def _profiling() -> bool:
    """A torch.profiler session records (torch unimported: none can)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


class _Span:
    __slots__ = ("name", "parent", "child_ns", "mark", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.child_ns = 0
        self.mark = None
        if _profiling():
            import torch

            self.mark = torch.profiler.record_function(PREFIX + self.name)
            self.mark.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self.t0
        if self.mark is not None:
            self.mark.__exit__(*exc)
        _local.stack.pop()
        parent = self.parent
        if parent is not None:
            parent.child_ns += ns
        key = (self.name, None if parent is None else parent.name)
        with _lock:
            s = _spans.get(key)
            if s is None:
                s = _spans[key] = [0, 0, 0, 0]
            s[0] += 1
            if self.mark is None:
                s[1] += ns
                s[2] += ns - self.child_ns
            else:
                s[3] += ns
        return False


def span(name: str):
    """A context manager timing stage ``name`` (see the module's doc)."""
    return _Span(name) if _on else OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (kept only while tracing is on)."""
    if _on:
        with _lock:
            _counters[name] = _counters.get(name, 0) + int(n)


def reset() -> None:
    with _lock:
        _spans.clear()
        _counters.clear()


def snapshot() -> dict:
    """``{"spans": {name: {parent: {"calls", "seconds", "self_seconds",
    "traced_seconds"}}}, "counters": {name: value}}``; a span opened
    under no span has the parent None."""
    with _lock:
        spans: dict = {}
        for (name, parent), (calls, ns, self_ns, traced_ns) in _spans.items():
            spans.setdefault(name, {})[parent] = {
                "calls": calls, "seconds": ns / 1e9,
                "self_seconds": self_ns / 1e9,
                "traced_seconds": traced_ns / 1e9}
        return {"spans": spans, "counters": dict(_counters)}


def report() -> None:
    """The registry as one block on stderr: each span under each parent
    with its calls, seconds and self seconds (profiled seconds apart),
    then each counter."""
    snap = snapshot()
    lines = ["deacon trace: span (under parent): calls, seconds, self "
             "seconds[, profiled seconds]"]
    for name in sorted(snap["spans"]):
        for parent, s in sorted(snap["spans"][name].items(),
                                key=lambda kv: kv[0] or ""):
            line = (f"  {name} (under {parent or '-'}): {s['calls']}, "
                    f"{s['seconds']:.6f}, {s['self_seconds']:.6f}")
            if s["traced_seconds"]:
                line += f", {s['traced_seconds']:.6f}"
            lines.append(line)
    lines += [f"  counter {n} = {v}" for n, v in sorted(
        snap["counters"].items())]
    print("\n".join(lines), file=sys.stderr, flush=True)
