"""Host ms per ALM trial in the accept/reject loop while not waiting on a
read: the ``alm.loop`` spans less their ``sync`` spans, over the trials
(one ``local`` span each), recorded without the profiler."""

from portbench import spans


def read(ctx):
    s = getattr(ctx, "spans", None)
    if s is None:
        return None
    trials = spans.count(s.host, "local")
    if not trials:
        return None
    return 1e-6 * sum(spans.outside(s.host, "alm.loop", "sync")) / trials
