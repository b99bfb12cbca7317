"""Share of the window's wall time outside its traced slice spent inside
the writer (io/writers.format_batch,
NativeWriter): format_batch and write, and opening and finishing the
writers."""

SPAN = "writer"


def read(ctx):
    wall = ctx.get("span_wall_s", 0)
    if wall <= 0:
        return None
    return ctx["spans"][SPAN] / wall
