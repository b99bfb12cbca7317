"""Share of the window's wall time outside its traced slice spent inside
the reader (io/fastx, io/native): each next() of
_read_batches."""

SPAN = "reader"


def read(ctx):
    wall = ctx.get("span_wall_s", 0)
    if wall <= 0:
        return None
    return ctx["spans"][SPAN] / wall
