"""1 - (the union of the card's kernel, copy and memset intervals over the
window's traced slice) / the slice's length, from torch.profiler."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t["slice_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["slice_s"]
