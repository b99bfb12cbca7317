"""Share of the window's wall time outside its traced slice spent
formatting the kept records (io/writers.format_batch, the host library's
dx_gather): the program's span ``writer.format``."""

from benchmark.progtrace import span_share


def read(ctx):
    return span_share(ctx, "writer.format")
