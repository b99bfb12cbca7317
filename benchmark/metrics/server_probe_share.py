"""Share of the server's request seconds spent in the membership probe:
the program's span ``server.probe`` (LocalBackend.probe: the upload, the
search and the wait for the bits) over ``server.request``, summed over
the handler threads outside the traced slice."""

from benchmark.progtrace import span_seconds


def read(ctx):
    request = span_seconds(ctx, "server.request")
    if not request:
        return None
    return span_seconds(ctx, "server.probe") / request
