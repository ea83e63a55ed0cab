"""Share of ALM trials whose closest-point cache refreshed, in % (solver
``stats``: cp_refreshes over trials, traced solves)."""


def read(ctx):
    c = ctx.counters
    if not c.get("trials"):
        return None
    return 100.0 * c["cp_refreshes"] / c["trials"]
