"""Share of the profiled pass's device time launched in the combined
residual (``step.comb`` spans: its x-solve, its z-update and the norm), in
%."""


def read(ctx):
    s = getattr(ctx, "spans", None)
    a = None if s is None else s.profiled
    if a is None or not a.count("step") or a.device_total_s <= 0:
        return None
    return 100.0 * a.total("step.comb") / a.device_total_s
