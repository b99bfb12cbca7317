"""Share of the window's wall time outside its traced slice spent inside
device step collection (ops/engine's
FetchGroup, the sync and the device-to-host copy, reruns over budget):
each call of a batch's resolve callable."""

SPAN = "resolve"


def read(ctx):
    wall = ctx.get("span_wall_s", 0)
    if wall <= 0:
        return None
    return ctx["spans"][SPAN] / wall
