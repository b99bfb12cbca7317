"""Share of the window's seconds that the readers' decode-ahead threads
spent reading and decoding their serial streams (the host library's
``decode.busy_ns``, summed over the job's input files: one thread
inflating each gzip member ahead of its parser, two for a pair of files;
0 for plain input)."""

from benchmark.progtrace import counter_share


def read(ctx):
    return counter_share(ctx, "decode.busy_ns")
