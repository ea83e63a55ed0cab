"""Trials per accepted ALM iteration: the accept/reject loop's waste
(solver ``stats``: trials over accepted iterations, traced solves)."""


def read(ctx):
    c = ctx.counters
    if not c.get("accepted"):
        return None
    return c["trials"] / c["accepted"]
