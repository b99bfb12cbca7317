"""Share of the window's wall time outside its traced slice spent in the
planning of each launch: the self time of the program's span
``launch.counts`` (DevicePipeline.launch_counts less its packing, upload
and enqueue: effective lengths, chunk spans, the tile and batch cuts)."""

from benchmark.progtrace import span_share


def read(ctx):
    return span_share(ctx, "launch.counts", key="self_seconds")
