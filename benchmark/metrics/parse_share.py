"""Share of the window's wall time outside its traced slice spent parsing
records into the reader's buffers
(io/native_loader.NativeFastxReader.read_batch_raw: dx_next_batch_view,
with the input's read and, for serial codecs, the wait on the decode-ahead
thread): the program's span ``reader.parse``."""

from benchmark.progtrace import span_share


def read(ctx):
    return span_share(ctx, "reader.parse")
