"""Share of the window's read units that the device pipeline ran a second
time because a row selected more minimizers than its budget (the
program's counter ``DevicePipeline.rerun_units``)."""


def read(ctx):
    units = ctx.get("units", 0)
    if units <= 0 or "counters" not in ctx:
        return None
    return ctx["counters"]["rerun_units"] / units
