"""Seconds of the set-up spent in the program's builds and captures: the
outermost ``setup.build`` spans (the solver's assembly, ELL and two-level
build, the closest-point groups, the physics system and its dense
inverse) and ``setup.capture`` spans (CUDA graph captures)."""

from portbench import spans


def read(ctx):
    s = getattr(ctx, "spans", None)
    if s is None:
        return None
    setup = s.setup
    idx = [i for i, sp in enumerate(setup)
           if sp[0].startswith("setup.") and not _under_setup(setup, i)]
    if not idx:
        return None
    return 1e-9 * sum(setup[i][2] - setup[i][1] for i in idx)


def _under_setup(setup, i):
    p = setup[i][3]
    while p is not None:
        if setup[p][0].startswith("setup."):
            return True
        p = setup[p][3]
    return False
