"""Host reads per ALM trial: the loop test, each cached closest-point
projection, the CG loop tests and the Anderson Gram matrix (solver
``stats``, traced solves)."""


def read(ctx):
    c = ctx.counters
    if not c.get("trials"):
        return None
    return c["host_reads"] / c["trials"]
