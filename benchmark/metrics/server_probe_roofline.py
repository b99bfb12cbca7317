"""The server probe's share of its roofline, %: the least time the card
needs to answer the traced slice's queries against the index over the
device seconds of the operations launched inside the program's span
``probe.search`` (progtrace).

The work is counted from the frames the driver made, never from the
program: the hashes of every request whose answer came back inside the
slice, each queried once, at 8 B a query read, one 32 B sector of the
index read for it and 1 B of its answer written. Bytes over the memory
peak (peaks.py), whatever implements the search."""

from benchmark.peaks import peak

SPAN = "probe.search"
BYTES_PER_QUERY = 8 + 32 + 1


def bound_s(queries: int, peaks: dict) -> float:
    return BYTES_PER_QUERY * queries / peaks["hbm_bytes_per_s"]


def read(ctx):
    pt, peaks, traced = ctx.get("program_trace"), peak(ctx), ctx.get("traced")
    if not pt or not peaks or not traced:
        return None
    spent = pt["device_s"].get(SPAN, 0.0)
    if spent <= 0:
        return None
    return 100.0 * bound_s(traced["queries"], peaks) / spent
