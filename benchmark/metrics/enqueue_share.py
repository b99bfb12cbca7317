"""Share of the window's wall time outside its traced slice spent
enqueueing each device batch's step (ops/engine.engine_step's torch
operations and kernel launches): the program's span ``launch.enqueue``
under ``launch.counts`` (a rerun's batches are booked to rerun_share)."""

from benchmark.progtrace import span_share


def read(ctx):
    return span_share(ctx, "launch.enqueue", under="launch.counts")
