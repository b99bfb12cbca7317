"""K2's share of its roofline, %: the least time the card needs to probe
the traced slice's minimizers against the index over the device time of
the kernel that does it.

The work is counted from the inputs, never from the program's table: each
unit's minimizers (the reference's totals), for the units launched in the
slice, are queried once, at
8 B a query read and one 32 B sector of the index read for it, and 4 B
of hits are written a unit. Bytes over the memory peak (peaks.py)."""

from benchmark.devtrace import kernel_seconds
from benchmark.peaks import peak

KERNEL = "radix_probe_kernel"
BYTES_PER_QUERY = 8 + 32
BYTES_PER_UNIT = 4


def bound_s(queries: int, units: int, peaks: dict) -> float:
    return ((BYTES_PER_QUERY * queries + BYTES_PER_UNIT * units)
            / peaks["hbm_bytes_per_s"])


def read(ctx):
    t, peaks = ctx.get("trace"), peak(ctx)
    if not t or not peaks:
        return None
    spent = kernel_seconds(t, KERNEL)
    if spent <= 0:
        return None
    traced = ctx["traced"]
    return 100.0 * bound_s(traced["minimizers"], traced["units"],
                           peaks) / spent
