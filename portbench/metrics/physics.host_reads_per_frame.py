"""Host reads per simulated frame (``PhysicsSolver.stats["host_reads"]``
over the traced frames): one per Anderson Gram matrix, the CG loop tests,
a reject test where it is read."""


def read(ctx):
    c = ctx.counters
    if not c.get("frames"):
        return None
    return c["host_reads"] / c["frames"]
