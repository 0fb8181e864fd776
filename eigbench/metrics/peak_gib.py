"""peak_gib: ``torch.cuda.max_memory_allocated()`` over the window, after
``reset_peak_memory_stats()`` at its start, with the resident session
included, in GiB.  A card's reading only: None on the CPU."""


def read(ctx):
    if ctx["device"]["platform"] != "gpu":
        return None
    return ctx["peak_bytes"] / 2**30
