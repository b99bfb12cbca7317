"""Share of the window's wall time outside its traced slice spent inside
host planning and dispatch (ops/pack,
ops/engine.DevicePipeline.launch_counts): each decider.launch."""

SPAN = "launch"


def read(ctx):
    wall = ctx.get("span_wall_s", 0)
    if wall <= 0:
        return None
    return ctx["spans"][SPAN] / wall
