"""Share of the wall time of the traced frames in which no operation ran on
the device, in %: 1 - (union of the device events' intervals in the traced
frames) / (the wall time of as many frames run untraced just before them; the
profiler slows the host, which sets the pace here)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0 or t.untraced_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.untraced_s)
