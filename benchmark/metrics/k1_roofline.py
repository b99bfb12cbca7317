"""K1's share of its roofline, %: the least time the card needs for the
traced slice's minimizer extraction over the device time of the kernel
that does it.

The work is counted from the inputs, never from the program's tiles:
every input base is read once at 3/8 B (2 bits of code, 1 of validity)
and costs 40 int32 operations, each one instruction on one lane (an IMAD
counts one, as the peak does: peaks.py); every minimizer written out is
12 B (its 8 B value and 4 B position), the minimizers counted as the
units' minimizer positions in the reference (its totals) for the units
launched in the slice. The bound is the larger of operations over the
int32 peak and bytes over the memory peak."""

from benchmark.devtrace import kernel_seconds
from benchmark.peaks import peak

KERNEL = "select_compact_kernel"
OPS_PER_BASE = 40
BYTES_PER_BASE = 3 / 8
BYTES_PER_MINIMIZER = 12


def bound_s(bases: int, minimizers: int, peaks: dict) -> float:
    ops = OPS_PER_BASE * bases / peaks["int32_ops_per_s"]
    nbytes = (BYTES_PER_BASE * bases + BYTES_PER_MINIMIZER * minimizers)
    return max(ops, nbytes / peaks["hbm_bytes_per_s"])


def read(ctx):
    t, peaks = ctx.get("trace"), peak(ctx)
    if not t or not peaks:
        return None
    spent = kernel_seconds(t, KERNEL)
    if spent <= 0:
        return None
    traced = ctx["traced"]
    return 100.0 * bound_s(traced["bases"], traced["minimizers"],
                           peaks) / spent
