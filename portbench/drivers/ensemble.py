"""The beams pin-speed sweep's driver: the sweep built by the app
(``apps/beams.py`` ``build_sweep``), each unit one ``frame()`` of it:
every scene's pins moved by its own speed times dt, then one tiled step
of all the scenes (``parallel/ensemble.py``).

After each unit the scenes' positions and velocities, the frame's reject
rows and its Anderson resets reach the host in one copy, outside the
unit's latency. The check runs frames of the plain reference
(reference/ensemble.py) on the CPU, one scene at a time at that scene's
speed, and compares the positions and the velocities after each: the
largest distance of a vertex from the reference's, in metres, and of its
velocity from the reference's, in m/s. Every scene's first warm-up frame
runs from the scene as built (a scene given another scene's speed is
caught there); every other frame compared, the rest of the warm-up and a
sample of (frame, scene) pairs of the window drawn from the seed, runs
from the positions and velocities the program had after the frame before
(so a wrong velocity is caught by its own gap, not by the next frame's
positions, which continue from it).
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import time

import numpy as np
import torch

from portbench.drivers.physics import gap_m
from portbench.reference.ensemble import SweepSceneReference


class Driver:
    def __init__(self, cfg, mix, check, seed, device):
        self.cfg, self.mix, self.chk = cfg, mix, check
        self.seed, self.device = seed, torch.device(device)
        self.latencies, self.states = [], []
        self.counters = dict(frames=0, host_reads=0, scene_iters=0,
                             rejects=0)
        self.problem = {}

    def setup(self):
        from aa_admm_tpu_torch.apps.beams import build_sweep

        c = self.cfg
        speeds = c["pin_speeds_m_s"]
        if len(speeds) != int(c["scenes"]):
            raise ValueError(f"{c['scenes']} scenes, {len(speeds)} speeds")
        _, self.sweep = build_sweep(settings(c), speeds, device=self.device,
                                    cubes=tuple(c["cubes"]))
        S, n = self.sweep.xs.shape[:2]
        self.problem = dict(scenes=S, vertices=S * n,
                            elements=S * self.sweep.elements)
        self.scene_rejects = np.zeros(S, np.int64)
        self.scene_resets = np.zeros(S, np.int64)
        self.warm = []
        for _ in range(int(self.mix["warmup_frames"])):
            self.sweep.frame()
            self.warm.append(self._state())

    def _state(self):
        """(xs, vs (S, n, 3), rejects per scene, Anderson resets per
        scene), read to the host in one copy."""
        sw = self.sweep
        S, n = sw.xs.shape[:2]
        tr = sw.trace
        flat = torch.cat([sw.xs.reshape(-1).double(),
                          sw.vs.reshape(-1).double(),
                          tr.reject.reshape(-1).double(),
                          tr.reset_count.reshape(-1).double()]).cpu().numpy()
        k, r = S * n * 3, tr.reject.numel()
        return (flat[:k].reshape(S, n, 3), flat[k:2 * k].reshape(S, n, 3),
                flat[2 * k:2 * k + r].reshape(S, -1).sum(1).astype(np.int64),
                flat[2 * k + r:].astype(np.int64))

    def unit(self):
        counts = self.sweep.counts
        reads = counts["host_reads"]
        t0 = time.perf_counter()
        tr = self.sweep.frame()
        self.latencies.append(time.perf_counter() - t0)
        st = self._state()
        self.states.append(st)
        self.scene_rejects += st[2]
        self.scene_resets += st[3]
        self.counters["frames"] += 1
        self.counters["host_reads"] += counts["host_reads"] - reads
        self.counters["scene_iters"] += tr.reject.numel()  # S x iterations
        self.counters["rejects"] += int(st[2].sum())

    def end_to_end(self, wall_s):
        return dict(frame_ms=1e3 * wall_s / max(len(self.latencies), 1))

    def release(self):
        print(f"portbench: over the window, rejects per scene "
              f"{self.scene_rejects.tolist()}, Anderson resets per scene "
              f"{self.scene_resets.tolist()}", file=sys.stderr)
        self.sweep = None

    def check(self):
        """[(name, reading, limit)] over every scene's warm-up frames and a
        sample of the window's (frame, scene) pairs, and the number of
        sampled pairs that failed. Each frame compared is a job of its own
        (from the scene as built, or from the program's state after the
        frame before), run on the CPU in a worker process of its own: a
        frame of the reference is thousands of small Newton steps, each
        read on the host, and costs more than the program's frame of all
        the scenes (on the H100's host 5-6 s on the card, ~17 s on one
        core; processes sharing the card queue behind each other, while
        the cores run them side by side)."""
        t0 = time.perf_counter()
        speeds = self.cfg["pin_speeds_m_s"]
        lims = self.chk["limits"]
        runs = self.warm + self.states
        S, n = len(speeds), len(self.states)
        k = min(int(self.chk["sample"]), n * S)
        picks = sorted(np.random.default_rng(
            [int(self.seed) % 2**64, 3]).choice(n * S, size=k,
                                                replace=False))
        frames = [(j, s) for j in range(len(self.warm)) for s in range(S)]
        frames += [(len(self.warm) + j, s)
                   for j, s in (divmod(int(p), S) for p in picks)]
        jobs = [(self.cfg, speeds[s],
                 None if j == 0 else (runs[j - 1][0][s], runs[j - 1][1][s],
                                      j), (runs[j][0][s], runs[j][1][s]))
                for j, s in frames]
        # one process a job, up to two a core: the last wave of a pool of
        # one a core would run alone
        procs = min(len(jobs), 2 * len(os.sched_getaffinity(0)))
        with multiprocessing.get_context("spawn").Pool(procs) as pool:
            gaps = pool.map(_reference_gap, jobs, chunksize=1)
        names = ("x_gap_m", "v_gap_m_s")
        failed = sum(any(g > lims[name] for g, name in zip(gv, names))
                     for gv in gaps[S * len(self.warm):])
        print(f"portbench: check of {len(gaps)} scene frames took "
              f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
        return [(name, max(gv[i] for gv in gaps), lims[name])
                for i, name in enumerate(names)], failed


def _reference_gap(job):
    """One job of the check, in a worker process: the reference's frame of
    one scene on the CPU, from the scene as built (start None) or from
    (x, v, frames), and its gaps to the program's positions (m) and
    velocities (m/s)."""
    cfg, speed, start, (x_prog, v_prog) = job
    torch.set_num_threads(1)
    ref = SweepSceneReference(cfg, speed, "cpu")
    if start is not None:
        ref.start(*start)
    x_gap = gap_m(x_prog, ref.frame())
    return x_gap, gap_m(v_prog, ref.v.double().numpy())


def settings(cfg):
    """The app's Settings for the configuration: beams.cpp's flags."""
    from aa_admm_tpu_torch.core.config import AccelType, Settings

    s = Settings()
    s.timestep_s, s.gravity = cfg["dt"], cfg["gravity"]
    s.admm_iters, s.anderson_m = cfg["admm_iters"], cfg["anderson_m"]
    s.acceleration_type = AccelType.ANDERSON
    s.dtype = np.dtype(cfg["dtype"])
    return s
