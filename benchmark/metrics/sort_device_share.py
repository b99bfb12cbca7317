"""Share of the traced slice's device-busy seconds spent in the operations
launched inside the program's span ``step.sort`` (the two stable sorts of
the probe stream, ops/radix_probe.prep_sorted), from the profiler trace
(progtrace)."""


def read(ctx):
    pt, t = ctx.get("program_trace"), ctx.get("trace")
    if not pt or not t or t["busy_s"] <= 0:
        return None
    return pt["device_s"].get("step.sort", 0.0) / t["busy_s"]
