"""Share of the window's wall time outside its traced slice spent waiting
for the device and copying the pending batches' outputs back in one copy
(ops/engine.FetchGroup.materialize): the program's span
``resolve.fetch``."""

from benchmark.progtrace import span_share


def read(ctx):
    return span_share(ctx, "resolve.fetch")
