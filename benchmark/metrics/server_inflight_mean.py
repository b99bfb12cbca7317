"""The mean number of requests in service: the seconds of the program's
span ``server.request`` (all of ``do_POST``), profiled or not, summed
over the handler threads, over the window's seconds. Near 1 when the
handler threads take turns on the interpreter lock with nothing else to
wait for; higher as far as their reads, sends, probes and waits for the
lock overlap."""

from benchmark.progtrace import span_seconds


def read(ctx):
    window = ctx.get("window_s", 0)
    request = span_seconds(ctx, "server.request")
    if not request or window <= 0:
        return None
    return (request + span_seconds(ctx, "server.request",
                                   key="traced_seconds")) / window
