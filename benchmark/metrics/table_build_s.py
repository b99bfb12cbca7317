"""Seconds of filter.engine.make_decider on the host's sorted keys: the
upload and the radix table's build."""


def read(ctx):
    return ctx.get("table_build_s")
