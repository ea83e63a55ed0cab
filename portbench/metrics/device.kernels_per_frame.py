"""Kernels the device ran per traced frame (the trace's device events,
copies and fills left out): the launches the local step's graph replays
and the rest of the step cost."""


def read(ctx):
    t, c = ctx.trace, ctx.counters
    if t is None or not c.get("frames"):
        return None
    n = sum(k for name, (k, _) in t.kernels.items()
            if not name.startswith(("Memcpy", "Memset")))
    return n / c["frames"] if n else None
