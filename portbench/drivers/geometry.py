"""The wire-mesh app's driver: one solver set up once on the configuration's
design, each request one ``ALMGeometrySolver.solve_ADMM`` from an initial
mesh that the mix draws from the seed.

Request kinds (the mix's ``kind``):
  * ``noise``: the design with fresh Gaussian noise on every vertex's z
    (sigma ``noise_sigma`` times the coarse grid's unit edge);
  * ``handle``: the design with a handle patch lifted along z: the
    vertices within ``radius_edges`` target edges (in x, y) of a vertex
    drawn as its centre rise by h (1 - (r/R)^2)^2, h drawn from
    ``lift_edges`` target edges, up or down.

The check replays a sample of the window's requests through the plain
reference (reference/wiremesh.py) and compares the answers (``readings``):
the worst edge-length error and the worst distance to the surface that
the program's answer leaves beyond the reference's, as a share of the
request's own initial worst error, and where the cell holds it, the
largest coordinate gap between the two answers.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import scenes
from portbench.reference import wiremesh as ref
from portbench.reference.closest_point import triangle_groups


def _rng(seed, *key):
    return np.random.default_rng([int(seed) % 2**64, *key])


class Driver:
    def __init__(self, cfg, mix, check, seed, device):
        self.cfg, self.mix, self.chk = cfg, mix, check
        self.seed, self.device = seed, torch.device(device)
        self.latencies, self.solutions = [], []
        self._surface = None
        self.counters = dict(trials=0, accepted=0, cg_iters=0, host_reads=0,
                             cp_refreshes=0)

    # -- set-up --

    def setup(self):
        from aa_admm_tpu_torch.ops.constraints import (AngleBatch,
                                                       EdgeLengthBatch,
                                                       RefSurfaceBatch)
        from aa_admm_tpu_torch.solver.geometry import ALMGeometrySolver

        c = self.cfg
        v, f, target, rv, rf = scenes.wire_design(c)
        self.base, self.target = v, target
        self.ref_tris = rv[rf]
        self.corners, self.edges = scenes.quad_corners(f), scenes.quad_edges(f)
        dt = np.dtype(c["dtype"])
        n = len(v)
        s = ALMGeometrySolver(device=self.device)
        s.dtype = dt
        s.add_soft_constraint(RefSurfaceBatch.create(
            list(range(n)), c["closeness_weight"], rv, rf, dtype=dt))
        s.add_hard_constraint(AngleBatch.create(
            self.corners, 1.0, c["min_angle"], c["max_angle"], dtype=dt))
        s.add_hard_constraint(EdgeLengthBatch.create(
            self.edges, 1.0, target, dtype=dt))
        s.setup_ADMM(n, c["penalty"])
        self.solver = s
        self.eps = c["rel_residual_eps_ratio"] * scenes.mean_edge_length(v, f)
        # warm every shape the window uses: a solve through the cache's
        # refresh and fast path, the CG and the accelerator
        self._solve(self.request(None), self.mix["warmup_iterations"])
        self.problem = dict(cg_rows=n, cg_cols=3, word=dt.itemsize)

    def request(self, i):
        """The initial mesh of request i (None: the warm-up's)."""
        m = self.mix
        rng = _rng(self.seed, 1) if i is None else _rng(self.seed, 0, i)
        x = self.base.copy()
        if m["kind"] == "noise":
            x[:, 2] += m["noise_sigma"] * rng.normal(size=len(x))
        elif m["kind"] == "handle":
            centre = x[rng.integers(len(x))]
            R = m["radius_edges"] * self.target
            lo, hi = m["lift_edges"]
            h = rng.uniform(lo, hi) * self.target * rng.choice((-1.0, 1.0))
            r2 = ((x[:, :2] - centre[:2]) ** 2).sum(1) / (R * R)
            x[:, 2] += np.where(r2 < 1.0, h * (1.0 - r2) ** 2, 0.0)
        else:
            raise ValueError(f"unknown request kind {m['kind']!r}")
        return x

    def _solve(self, x, iters):
        c = self.cfg
        self.solver.solve_ADMM(x, self.eps, iters, c["anderson_m"],
                               cg_max_iters=c["cg_max_iters"])
        return self.solver.get_solution()

    # -- the window --

    def unit(self):
        """One request: the solve of the next initial mesh, to its answer on
        the host."""
        i = len(self.latencies)
        t0 = time.perf_counter()
        x = self._solve(self.request(i), self.mix["iterations"])
        self.latencies.append(time.perf_counter() - t0)
        self.solutions.append(x)
        st = self.solver.stats
        self.counters["accepted"] += len(self.solver.function_values)
        for k in ("trials", "cg_iters", "host_reads", "cp_refreshes"):
            self.counters[k] += int(st[k])

    def end_to_end(self, wall_s):
        lat = sorted(self.latencies)
        # the 90th percentile by nearest rank over every request
        return dict(alm_iter_ms=1e3 * wall_s / max(self.counters["accepted"], 1),
                    resolve_p90_ms=1e3 * lat[math.ceil(0.9 * len(lat)) - 1])

    def release(self):
        self.solver = None

    # -- correct --

    def check(self):
        """[(name, reading, limit)] over a sample of the window's requests
        drawn from the seed, and the number of sampled requests that
        failed."""
        n = len(self.solutions)
        k = min(int(self.chk["sample"]), n)
        picks = sorted(_rng(self.seed, 2).choice(n, size=k, replace=False))
        solver = ref.WireMeshReference(
            len(self.base), self.corners, self.edges, self.target,
            self.cfg["min_angle"], self.cfg["max_angle"], self.ref_tris,
            self.cfg["penalty"], self.cfg["closeness_weight"], self.device)
        worst, failed = {}, 0
        for i in picks:
            x0 = self.request(int(i))
            xr = solver.solve(x0, self.mix["iterations"],
                              self.cfg["anderson_m"])
            r = self.readings(x0, self.solutions[i], xr)
            bad = any(r[k] > lim for k, lim in self.chk["limits"].items())
            failed += int(bad)
            for key, val in r.items():
                worst[key] = max(worst.get(key, -math.inf), val)
        return [(k, worst[k], lim) for k, lim in self.chk["limits"].items()], \
            failed

    def readings(self, x0, xp, xr):
        """The numbers a request's check may compare: what the program's
        answer xp leaves of the initial mesh x0's worst edge error and worst
        surface distance beyond the reference's answer xr, as shares of
        x0's; and the largest coordinate gap between xp and xr in target
        edges. A cell's check file names the numbers it holds."""
        if not np.isfinite(xp).all():
            return dict(edge_max_gap=math.inf, dist_max_gap=math.inf,
                        x_gap_edges=math.inf)
        e = [ref.edge_errors(x, self.edges, self.target).max()
             for x in (x0, xp, xr)]
        if self._surface is None:
            tris = torch.as_tensor(self.ref_tris, device=self.device)
            self._surface = (tris, triangle_groups(tris))
        d = [ref.surface_distances(x, self._surface[0], self.target,
                                   self._surface[1]).max()
             for x in (x0, xp, xr)]
        return dict(edge_max_gap=(e[1] - e[2]) / e[0],
                    dist_max_gap=(d[1] - d[2]) / d[0],
                    x_gap_edges=float(np.abs(xp - xr).max()) / self.target)
