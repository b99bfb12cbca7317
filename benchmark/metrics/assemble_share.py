"""Share of the window's wall time outside its traced slice spent copying
parsed records into owned batches (NativeFastxReader.read_batch) and
interleaving mates (filter/engine._read_batches): the program's span
``reader.assemble``."""

from benchmark.progtrace import span_share


def read(ctx):
    return span_share(ctx, "reader.assemble")
