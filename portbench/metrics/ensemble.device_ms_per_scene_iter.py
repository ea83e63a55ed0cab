"""Busy device ms per scene-iteration of the traced ensemble frames: the
union of the device events' intervals over ``scene_iters`` (scenes times
the ADMM iterations the tiled step ran). What the tiled step amortises
over its scenes, and what a faster local step would move."""


def read(ctx):
    t, c = ctx.trace, ctx.counters
    if t is None or t.busy_s <= 0 or not c.get("scene_iters"):
        return None
    return 1e3 * t.busy_s / c["scene_iters"]
