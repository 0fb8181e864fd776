"""host_copy_mb: the mean over the measured window's solves of the
program's counter ``timings["host_copy_bytes"]`` (the bytes each call
copied from the card to the host: the ``v0`` digest's copy, the Ritz
stage's and the health probe's), in MiB.  A card's reading only: None on
the CPU and where the program has no such counter."""


def read(ctx):
    if ctx["device"]["platform"] != "gpu":
        return None
    bs = [t["host_copy_bytes"] for t in ctx["window"]["timings"] if "host_copy_bytes" in t]
    return sum(bs) / len(bs) / 2**20 if bs else None
