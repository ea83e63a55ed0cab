"""Share of the profiled pass's device idle time that falls in a solve's
work outside its accept/reject loop, in %: the idle gaps whose middle lies
in a ``solve`` span but in no ``alm.loop`` span, over every idle gap of the
pass's window (the host's clock around the profiled solves)."""


def read(ctx):
    s = getattr(ctx, "spans", None)
    a = None if s is None else s.profiled
    if a is None or not a.count("solve") or a.idle_total_s <= 0:
        return None
    outside = a.total("solve", "idle_s") - a.total("alm.loop", "idle_s")
    return 100.0 * outside / a.idle_total_s
