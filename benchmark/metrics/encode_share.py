"""Share of the window's seconds that the writers spent in their
encoders (the host library's ``encode.ns``: deflate, zstd or xz on the
job's loop thread, their output's fwrite apart)."""

from benchmark.progtrace import counter_share


def read(ctx):
    return counter_share(ctx, "encode.ns")
