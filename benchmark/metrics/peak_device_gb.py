"""The program's peak device memory, GB: torch.cuda.max_memory_allocated()
over the table's build, the warm-up and the window (reset once the
harness has freed its own key tensors)."""


def read(ctx):
    peak = ctx.get("program_peak_bytes")
    return None if peak is None else peak / 1e9
