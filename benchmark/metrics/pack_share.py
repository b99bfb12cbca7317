"""Share of the window's wall time outside its traced slice spent packing
each device batch's rows into tiles (ops/pack.pack_block, the host
library's dx_pack_tile): the program's span ``launch.pack`` under
``launch.counts`` (a rerun's batches are booked to rerun_share)."""

from benchmark.progtrace import span_share


def read(ctx):
    return span_share(ctx, "launch.pack", under="launch.counts")
