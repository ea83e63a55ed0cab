"""Faults planted in the program underneath a run, to show that the
comparison that decides ``correct`` catches them (the tests at a small
size on the CPU; ``calibrate.py`` at the cells' own size on the card).

  * ``unchanged``: every ALM trial returns its state unchanged (the loop
    still counts it as an accepted iteration);
  * ``altered``: the answer altered where it is produced: one vertex of
    the solution, drawn by the caller, moved by one target edge along z;
  * ``step_unchanged``: the physics step returns the positions and
    velocities it was given;
  * ``step_altered``: the physics step's new positions with one vertex
    moved by `shift` metres along x.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def planted(kind, vertex=0, shift=1.0):
    from aa_admm_tpu_torch.solver import geometry as g
    from aa_admm_tpu_torch.solver import physics as ph

    if kind.startswith("step_"):
        orig_step = ph.step_xzu

        def step(system, x, v, pin_pos, counts=None):
            x_new, v_new, trace = orig_step(system, x, v, pin_pos, counts)
            if kind == "step_unchanged":
                return x, v, trace
            x_new = x_new.clone()
            x_new[vertex, 0] += shift
            return x_new, v_new, trace

        ph.step_xzu = step
        try:
            yield
        finally:
            ph.step_xzu = orig_step
    elif kind == "unchanged":
        orig = g._alm_trial

        def trial(system, st, it_h):
            return dict(st, it=st["it"] + 1, trial=st["trial"] + 1)

        g._alm_trial = trial
        try:
            yield
        finally:
            g._alm_trial = orig
    elif kind == "altered":
        orig = g.ALMGeometrySolver.get_solution

        def get_solution(self):
            x = orig(self).copy()
            x[vertex, 2] += shift
            return x

        g.ALMGeometrySolver.get_solution = get_solution
        try:
            yield
        finally:
            g.ALMGeometrySolver.get_solution = orig
    else:
        raise ValueError(kind)
