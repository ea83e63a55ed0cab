"""CG iterations per ALM trial of the global step (solver ``stats``,
traced solves)."""


def read(ctx):
    c = ctx.counters
    if not c.get("trials"):
        return None
    return c["cg_iters"] / c["trials"]
