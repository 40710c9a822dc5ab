"""peak_mem_gib: torch.cuda.max_memory_allocated() over the window, after
reset_peak_memory_stats() at its start."""


def read(ctx):
    if ctx["peak_bytes"] is None:
        return None
    return dict(value=ctx["peak_bytes"] / 2**30, unit="GiB")
