"""The beams app's driver: the scene built by the app (``apps/beams.py``
``build_scene``), each unit one frame of the app's ``stretch(dt)`` followed
by ``PhysicsSolver.step()``, exactly as the app runs it.

The check runs frames of the plain reference (reference/physics.py) and
compares the positions after each: the largest distance of a vertex from
the reference's, in metres (the beams are 1 m tall). The warm-up's frames
run from the scene as built, so the start is checked by itself; a sample
of the window's frames, drawn from the seed, each run from the positions
and velocities the program had after the frame before (a frame of the
reference costs about as much as the program's, so it follows the
program from its own state rather than replay the whole window).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.reference.physics import BeamsReference


class Driver:
    def __init__(self, cfg, mix, check, seed, device):
        self.cfg, self.mix, self.chk = cfg, mix, check
        self.seed, self.device = seed, torch.device(device)
        self.latencies, self.states = [], []
        self.counters = dict(frames=0, host_reads=0)
        self.problem = {}

    def setup(self):
        from aa_admm_tpu_torch.apps.beams import build_scene
        from aa_admm_tpu_torch.core.config import AccelType, Settings

        c = self.cfg
        s = Settings()
        s.timestep_s, s.gravity = c["dt"], c["gravity"]
        s.admm_iters, s.anderson_m = c["admm_iters"], c["anderson_m"]
        s.acceleration_type = AccelType.ANDERSON
        s.dtype = np.dtype(c["dtype"])
        self.solver, self.stretch = build_scene(s, device=self.device,
                                                cubes=tuple(c["cubes"]))
        self.warm = []
        for _ in range(int(self.mix["warmup_frames"])):
            self._frame()
            self.warm.append(self._state())

    def _state(self):
        """The program's positions and velocities, read to the host."""
        return (np.array(self.solver.x, np.float64),
                np.array(self.solver.v, np.float64))

    def _frame(self):
        self.stretch(self.cfg["dt"])
        self.solver.step()

    def unit(self):
        reads = self.solver.stats["host_reads"]
        t0 = time.perf_counter()
        self._frame()
        self.latencies.append(time.perf_counter() - t0)
        self.states.append(self._state())
        self.counters["frames"] += 1
        self.counters["host_reads"] += self.solver.stats["host_reads"] - reads

    def end_to_end(self, wall_s):
        return dict(frame_ms=1e3 * wall_s / max(len(self.latencies), 1))

    def release(self):
        self.solver = self.stretch = None

    def check(self):
        """[(name, reading, limit)] over the warm-up's frames and a sample
        of the window's, and the number of sampled frames that failed."""
        ref = BeamsReference(self.cfg, self.device)
        lim = self.chk["limits"]["x_gap_m"]
        gaps = [gap_m(x, ref.frame()) for x, _ in self.warm]
        n = len(self.states)
        k = min(int(self.chk["sample"]), n)
        picks = sorted(np.random.default_rng(
            [int(self.seed) % 2**64, 2]).choice(n, size=k, replace=False))
        failed = 0
        for j in picks:
            x, v = (self.warm + self.states)[len(self.warm) + j - 1]
            ref.start(x, v, len(self.warm) + j)
            gap = gap_m(self.states[j][0], ref.frame())
            failed += int(gap > lim)
            gaps.append(gap)
        return [("x_gap_m", max(gaps), lim)], failed


def gap_m(xp, xr):
    """The largest distance (m) of a vertex of xp from its place in xr."""
    if not np.isfinite(xp).all():
        return float("inf")
    return float(np.linalg.norm(xp - xr, axis=1).max())
