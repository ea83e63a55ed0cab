"""Device ms per ALM trial launched in the global step (``global`` spans:
the x-update's right-hand side, the ELL matvec, the two-level
preconditioner, B2/B3), from the profiled pass."""


def read(ctx):
    s = getattr(ctx, "spans", None)
    a = None if s is None else s.profiled
    if a is None or not a.count("global"):
        return None
    return 1e3 * a.total("global") / a.count("global")
