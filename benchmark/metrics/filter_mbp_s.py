"""Input bases of every read unit decided and written in the window, over
the window's seconds, in Mbp/s: the whole job, the batches in flight at
the window's end resolved and written inside it, one rate."""


def read(ctx):
    if ctx.get("window_s", 0) <= 0:
        return None
    return ctx["bases"] / ctx["window_s"] / 1e6
