"""One run of one cell, as benchmark/run.py makes it, with the program's
own tracing on (deacon_tpu_torch/utils/trace.py), and the per-layer
metrics that read it.

    python3 benchmark/progrun.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

The registry is enabled before the set-up, emptied as the window's job
starts and read when it returns (``ctx["program"]``), and the traced
slice's Chrome trace is read by progtrace as well
(``ctx["program_trace"]``, logged on stderr). With ``--trace 1`` the
result line's ``metrics`` add PROGRAM_METRICS; with ``--trace 0`` its
end-to-end metrics are those of a run with tracing on, to set against
run.py's for what tracing costs. filter_stream and the harness run as
they are: their functions are wrapped here, never edited.
"""

import time

T_START = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import devtrace, harness, progtrace  # noqa: E402
from benchmark import run as bench_run  # noqa: E402
from benchmark.drivers import filter_stream  # noqa: E402

#: the metrics that read the program's registry or its spans in the
#: trace (benchmark/metrics/<name>.py, each a share), and the cells they
#: read something in (None: every cell)
GZ = ("panmouse1a.pe150-gz",)
PROGRAM_METRICS = (
    ("plan_share", None), ("pack_share", None), ("upload_share", None),
    ("enqueue_share", None), ("parse_share", None),
    ("assemble_share", None), ("decode_busy_share", GZ),
    ("format_share", None), ("encode_share", GZ), ("fetch_share", None),
    ("rerun_share", None), ("tile_fill", None), ("sort_device_share", None))


def wrap(log, patch=setattr) -> dict:
    """Wrap filter_stream's window job and run, devtrace's trace reader
    and the harness's run of a cell, each set by ``patch(module, name,
    wrapper)``; returns the dict the window's context is kept in."""
    from deacon_tpu_torch.utils import trace

    trace.enable()
    kept: dict = {}
    run_job = filter_stream.run_job
    read_trace_file = devtrace.read_trace_file
    stream_run = filter_stream.run
    run_cell = harness.run_cell

    def window_job(job, spans, repeat, deadline=None, **kw):
        if deadline is None:  # the warm-up
            return run_job(job, spans, repeat, deadline=deadline, **kw)
        trace.reset()
        res = run_job(job, spans, repeat, deadline=deadline, **kw)
        kept["program"] = trace.snapshot()
        return res

    def read_both(path):
        kept["program_trace"] = progtrace.read_trace_file(path)
        return read_trace_file(path)

    def run(*args):
        ctx = stream_run(*args)
        ctx.update(kept)
        kept["ctx"] = ctx
        return ctx

    def cell(root, name, seed, seconds, trace_on, *args):
        result = run_cell(root, name, seed, seconds, trace_on, *args)
        ctx = kept["ctx"]
        if ctx.get("program_trace"):
            for line in progtrace.log_lines(ctx["program_trace"]):
                log(line)
        log("program spans and counters: " + json.dumps(
            {"spans": {n: {str(p): s for p, s in by.items()}
                       for n, by in ctx["program"]["spans"].items()},
             "counters": ctx["program"]["counters"]}))
        if trace_on:
            metrics = result["metrics"]
            for m, cells in PROGRAM_METRICS:
                if cells is None or name in cells:
                    value = harness.reader(m).read(ctx)
                    if value is not None:
                        metrics[m] = {"value": value, "unit": "share"}
        return result

    patch(filter_stream, "run_job", window_job)
    patch(devtrace, "read_trace_file", read_both)
    patch(filter_stream, "run", run)
    patch(harness, "run_cell", cell)
    return kept


def main(argv=None) -> int:
    bench_run.T_START = T_START
    wrap(bench_run.log)
    return bench_run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
