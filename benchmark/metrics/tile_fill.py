"""The bases of the rows packed into the window's device batches over
the bases their tiles hold (rows x L), which K1 reads and pays for: the
program's counters ``launch.row_bases`` and ``launch.tile_bases``."""


def read(ctx):
    prog = ctx.get("program")
    if prog is None:
        return None
    c = prog["counters"]
    if c.get("launch.tile_bases", 0) <= 0:
        return None
    return c["launch.row_bases"] / c["launch.tile_bases"]
