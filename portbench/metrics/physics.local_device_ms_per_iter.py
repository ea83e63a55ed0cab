"""Device ms per ADMM iteration launched in the physics local step
(``step.local`` spans: the gradient's and the prox's CUDA-graph replays;
the combined residual's z-update is not among them), over the iterations
(one ``step.global`` span each), from the profiled pass."""


def read(ctx):
    s = getattr(ctx, "spans", None)
    a = None if s is None else s.profiled
    if a is None or not a.count("step.global"):
        return None
    return 1e3 * a.total("step.local") / a.count("step.global")
