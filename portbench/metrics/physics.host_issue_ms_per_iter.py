"""Host ms per ADMM iteration in a physics step while not waiting on a
read: the ``step`` spans less their ``sync`` spans, over the iterations
(one ``step.global`` span each), recorded without the profiler."""

from portbench import spans


def read(ctx):
    s = getattr(ctx, "spans", None)
    if s is None:
        return None
    iters = spans.count(s.host, "step.global")
    if not iters:
        return None
    return 1e-6 * sum(spans.outside(s.host, "step", "sync")) / iters
