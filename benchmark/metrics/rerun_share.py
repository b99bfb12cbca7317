"""Share of the window's wall time outside its traced slice spent
rerunning the units of rows over their minimizer budget
(ops/engine.DevicePipeline._rerun_over_budget, with its packing, upload,
enqueue and copies back): the program's span ``resolve.rerun``."""

from benchmark.progtrace import span_share


def read(ctx):
    return span_share(ctx, "resolve.rerun")
