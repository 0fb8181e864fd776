"""setup_s: seconds from the process's start to the end of warm-up
(import, the matrix made on the card and copied to the host, ``prepare``,
the warm-up solves), on the host's clock."""


def read(ctx):
    return ctx["setup_s"]
