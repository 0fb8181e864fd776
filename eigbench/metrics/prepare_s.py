"""prepare_s: the host's clock around ``repro_torch.prepare(A, ...)``
(``api/session.py`` ``prepare`` -> ``kernels/engine.py`` ``make_engine``
and the device layout), in seconds."""


def read(ctx):
    return ctx["prepare_s"]
