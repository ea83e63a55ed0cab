"""Host ms a solve spends outside its accept/reject loop (the program's
``solve`` span less its ``alm.loop`` spans, recorded without the
profiler): the delta-form anchors, the two soft energies' uncached
closest-point queries and their reads, the history read and the answer's
copy; averaged over the solves."""

from portbench import spans


def read(ctx):
    s = getattr(ctx, "spans", None)
    if s is None:
        return None
    work = spans.outside(s.host, "solve", "alm.loop")
    return 1e-6 * sum(work) / len(work) if work else None
