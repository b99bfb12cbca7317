"""Share of the server's request seconds spent in LocalBackend's
decisions without the probe: the self time of the program's span
``server.decide`` (the batch's concatenation, the distinct hits and the
thresholds) over ``server.request``, summed over the handler threads
outside the traced slice."""

from benchmark.progtrace import span_seconds


def read(ctx):
    request = span_seconds(ctx, "server.request")
    if not request:
        return None
    return span_seconds(ctx, "server.decide", key="self_seconds") / request
