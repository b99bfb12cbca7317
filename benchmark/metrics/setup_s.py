"""Seconds from the process's start to the window's."""


def read(ctx):
    return ctx.get("setup_s")
