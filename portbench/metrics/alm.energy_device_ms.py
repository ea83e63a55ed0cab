"""Device ms per solve of the work launched inside the two soft-energy
evaluations (``solve.energy`` spans: the uncached closest-point query and
its read), from the profiled pass."""


def read(ctx):
    s = getattr(ctx, "spans", None)
    a = None if s is None else s.profiled
    if a is None or not a.count("solve"):
        return None
    return 1e3 * a.total("solve.energy") / a.count("solve")
