"""The program's own spans and counters, off unless ``DEACON_TRACE=1``
(read once, at import) or ``enable()``.

``with span("launch.pack"):`` times one stage of a layer. Each span name
keeps, per parent span (the span open around it on the same thread, else
the name a worker thread gave with ``thread_parent``, or None): its
calls, its seconds on ``time.perf_counter_ns`` (CLOCK_MONOTONIC on Linux,
the clock of the host library's counters), and its self seconds, its
seconds less those of the spans opened inside it. While a
torch.profiler session records, a span is also the annotation
``deacon.<name>`` in the profiler's trace, on the clock of the device's
kernels and copies. A span whose outermost span on its thread opened
while a session recorded puts its seconds in ``traced_seconds`` in place
of ``seconds`` and ``self_seconds`` (a profiled stretch pays the
profiler's costs), and so does every span inside it: the spans of one
request or one batch land in one bucket. ``count(name, n)`` adds to an
integer counter.

Off, ``span()`` returns one shared no-op context manager and ``count()``
returns at once: no clock is read and torch is not called.

Each thread records into a registry of its own, with no lock on the way:
a lock shared by every span and count made the many handler threads of a
busy server queue on it, each wait of one thread for the lock a wait for
the interpreter lock too. ``snapshot()`` sums the threads' registries; the
registry of a thread that has ended is folded into one for ended threads.

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
_local = threading.local()


class _Registry:
    """One thread's spans, (name, parent) -> [calls, ns, self ns, traced
    ns], and counters; written by that thread alone."""

    __slots__ = ("thread", "spans", "counters")

    def __init__(self, thread):
        self.thread = thread
        self.spans: dict = {}
        self.counters: dict = {}

    def add(self, other: "_Registry") -> None:
        for key, s in list(other.spans.items()):
            mine = self.spans.setdefault(key, [0, 0, 0, 0])
            for i, v in enumerate(list(s)):
                mine[i] += v
        for name, v in list(other.counters.items()):
            self.counters[name] = self.counters.get(name, 0) + v


#: guards _live and _ended (never taken while a span or count records)
_lock = threading.Lock()
#: the registries of threads that may still record
_live: list = []
#: what threads that have ended recorded
_ended = _Registry(None)


def _fold_ended() -> None:
    """Under _lock: move the registries of ended threads into _ended."""
    alive = []
    for reg in _live:
        if reg.thread.is_alive():
            alive.append(reg)
        else:
            _ended.add(reg)
    _live[:] = alive


def _registry() -> _Registry:
    """This thread's registry, made and listed on its first record."""
    reg = getattr(_local, "reg", None)
    if reg is None:
        reg = _local.reg = _Registry(threading.current_thread())
        with _lock:
            _fold_ended()
            _live.append(reg)
    return reg


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
    """A torch.profiler session records (torch unimported: none can).
    The session's own state is the thread's that started it; the
    process-wide flag (``torch.autograd.profiler._is_profiler_enabled``)
    also covers a session that records every thread, such as the HTTP
    server's handler threads."""
    torch = sys.modules.get("torch")
    return torch is not None and (
        torch.autograd._profiler_enabled()
        or getattr(torch.autograd.profiler, "_is_profiler_enabled", False))


class _Span:
    __slots__ = ("name", "parent", "child_ns", "mark", "traced", "t0")

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
        profiling = _profiling()
        if profiling:
            import torch

            self.mark = torch.profiler.record_function(PREFIX + self.name)
            self.mark.__enter__()
        self.traced = (profiling if self.parent is None
                       else self.parent.traced)
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
        key = (self.name, getattr(_local, "parent", None) if parent is None
               else parent.name)
        spans = _registry().spans
        s = spans.get(key)
        if s is None:
            s = spans[key] = [0, 0, 0, 0]
        s[0] += 1
        if self.traced:
            s[3] += ns
        else:
            s[1] += ns
            s[2] += ns - self.child_ns
        return False


def thread_parent(name: str | None) -> None:
    """Record the spans that this thread opens under no span of its own
    under the parent ``name``: a worker thread's stages under the layer
    it works for (the filter's read-ahead thread's under ``reader``)."""
    _local.parent = name


def span(name: str):
    """A context manager timing stage ``name`` (see the module's doc)."""
    return _Span(name) if _on else OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (kept only while tracing is on)."""
    if _on:
        counters = _registry().counters
        counters[name] = counters.get(name, 0) + int(n)


def reset() -> None:
    """Empty every thread's registry (a record made by another thread at
    the same moment may be kept or lost)."""
    with _lock:
        _fold_ended()
        for reg in (_ended, *_live):
            reg.spans.clear()
            reg.counters.clear()


def snapshot() -> dict:
    """``{"spans": {name: {parent: {"calls", "seconds", "self_seconds",
    "traced_seconds"}}}, "counters": {name: value}}``; a span opened
    under no span has the parent None."""
    total = _Registry(None)
    with _lock:
        _fold_ended()
        for reg in (_ended, *_live):
            total.add(reg)
    spans: dict = {}
    for (name, parent), (calls, ns, self_ns, traced_ns) in total.spans.items():
        spans.setdefault(name, {})[parent] = {
            "calls": calls, "seconds": ns / 1e9,
            "self_seconds": self_ns / 1e9,
            "traced_seconds": traced_ns / 1e9}
    return {"spans": spans, "counters": total.counters}


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
