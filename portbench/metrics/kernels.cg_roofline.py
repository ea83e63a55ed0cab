"""B2 and B3's share of their roofline, in %: the least time their bytes
need at the H100's peak bandwidth (from the CG vectors' rows and columns,
portbench.roofline), over their device time in the trace (kernel events
``cg1_fused`` and ``cg2_fused``)."""

from portbench import roofline


def read(ctx):
    t = ctx.trace
    if t is None or "cg_rows" not in ctx.problem:
        return None
    n1, s1 = t.matching("cg1_fused")
    n2, s2 = t.matching("cg2_fused")
    if n1 + n2 == 0 or s1 + s2 <= 0:
        return None
    n, c, w = (ctx.problem[k] for k in ("cg_rows", "cg_cols", "word"))
    least = (n1 * roofline.bound_s(*roofline.cg_update1(n, c, w), w)
             + n2 * roofline.bound_s(*roofline.cg_update2(n, c, w), w))
    return 100.0 * least / (s1 + s2)
