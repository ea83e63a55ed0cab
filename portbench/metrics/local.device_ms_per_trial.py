"""Device ms per ALM trial launched in the local step (``local`` spans: the
hard projections, the closest-point cache's test, refresh and B1 sweeps),
from the profiled pass."""


def read(ctx):
    s = getattr(ctx, "spans", None)
    a = None if s is None else s.profiled
    if a is None or not a.count("local"):
        return None
    return 1e3 * a.total("local") / a.count("local")
