"""Share of the server's request seconds spent on the wire: the
program's spans ``server.read`` (the body), ``server.decode``,
``server.encode`` and ``server.send`` over ``server.request``, summed
over the handler threads outside the traced slice."""

from benchmark.progtrace import span_seconds

PARTS = ("server.read", "server.decode", "server.encode", "server.send")


def read(ctx):
    request = span_seconds(ctx, "server.request")
    if not request:
        return None
    return sum(span_seconds(ctx, p) for p in PARTS) / request
