"""Share of the window's wall time outside its traced slice spent
uploading each device batch (ops/engine.upload: a pinned buffer, the host
copy into it, the host-to-device copy): the program's span
``launch.upload`` under ``launch.counts`` (a rerun's batches are booked to
rerun_share)."""

from benchmark.progtrace import span_share


def read(ctx):
    return span_share(ctx, "launch.upload", under="launch.counts")
