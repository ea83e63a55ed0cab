"""beams — the reference's headline physics scene (counterpart of
aa_admm_tpu/apps/beams.py:1-135; admm_anderson_xzu/samples/Asia2019/
beams.cpp:94-167, headless).

Usage: python -m aa_admm_tpu_torch.apps.beams [-it N -a 1 -am M ...]
           [--log-x-star] [--cpu]

Three 12x3x3 tet-block beams (Linear / NeoHookean / StVK, soft rubber),
end-pinned, with the pins stretched +/- x by 1 m/s each frame
(stretch_beams, beams.cpp:66-92). Runs the xzu solver on the CUDA card
unless device="cpu" (or --cpu), and writes result/residual-{m|no}.txt like
the reference's testAndersonADMM harness; --log-x-star first writes
result/solverlog-{m|no}.txt (``log_x_star``). ``cubes`` scales each beam's
block counts (the published scene is (12, 3, 3)). ``build_sweep`` runs the
scene as a parameter sweep: S copies, each pulled at its own pin speed,
stepped together as one tiled ensemble (parallel/ensemble.py).
"""

from __future__ import annotations

import copy
import os
import sys

import numpy as np
import torch

from ..core.config import AccelType, Lame, Settings
from ..core.factory import make_tet_blocks
from ..core.solverlog import SolverLog
from ..parallel.ensemble import ensemble_run_frames, tile_system
from ..solver.physics import PhysicsSolver, StepTrace, UpdateOrder, _counts


def build_scene(settings: Settings, order=UpdateOrder.XZU, device=None,
                cubes=(12, 3, 3)):
    kinds = ["linear", "neohookean", "stvk"]
    offsets_y = [1.75, 0.0, -1.75]
    soft_rubber = Lame.from_young_poisson(10000000, 0.399)

    solver = PhysicsSolver(order=order, device=device)
    pin_ids, pin_labels, pin_points = [], [], []
    for kind, oy in zip(kinds, offsets_y):
        mesh = make_tet_blocks(*cubes)
        lo, hi = mesh.bounds()
        center = 0.5 * (lo + hi)
        scale = 1.0 / (hi - lo)[1]          # each beam 1 m tall
        mesh.verts = (mesh.verts - center) * scale + np.array([0.0, oy, 0.0])
        offset = solver.add_tetmesh(mesh.verts, mesh.tets, soft_rubber,
                                    kind=kind)
        # find_pins (beams.cpp:37-60): extreme-x vertices of each beam.
        min_x = mesh.verts[:, 0].min() + 1e-2
        max_x = mesh.verts[:, 0].max() - 1e-2
        for j, v in enumerate(mesh.verts):
            if v[0] < min_x or v[0] > max_x:
                pin_ids.append(j + offset)
                pin_labels.append(int(v[0] > max_x))
                pin_points.append(v.copy())

    def stretch(dt):
        """stretch_beams (beams.cpp:66-92): move pins +/- 1 m/s in x from
        the solver's current pin positions (so it composes with
        run(n, pin_vel), which advances solver.pins too)."""
        move = np.array([1.0, 0.0, 0.0]) * dt
        pts = [solver.pins.get(pid, p0) + (move if lab else -move)
               for pid, lab, p0 in zip(pin_ids, pin_labels, pin_points)]
        solver.set_pins(pin_ids, pts)

    stretch(settings.timestep_s)  # initial pin placement (beams.cpp:160)
    solver.initialize(settings)
    # Constant pin velocity field for run(n, pin_vel=stretch.pin_velocity)
    # == n x [stretch(dt); step()].
    vel = np.zeros((solver.n_verts, 3))
    for pid, lab in zip(pin_ids, pin_labels):
        vel[pid, 0] = 1.0 if lab else -1.0
    stretch.pin_velocity = vel
    return solver, stretch


class Sweep:
    """S copies of one beams scene, each pulled by its own pin speed,
    stepped together as one tiled system (parallel/ensemble.py). Scene s
    is the published scene with `speeds[s]` m/s where beams.cpp pulls at
    1 m/s: its pins start one such stretch from rest (beams.cpp:160) and
    move by dt * speeds[s] before each frame's step.

    ``xs``, ``vs`` ((S, n, 3) device tensors) are the scenes' positions
    and velocities, ``trace`` the last frame's StepTrace (every field led
    by S), ``counts`` the host reads and CG iterations of every frame,
    ``elements`` the element count of one scene."""

    def __init__(self, solver: PhysicsSolver, speeds, pins, sides):
        system = solver.system
        x0 = solver._x_dev
        S, n = len(speeds), system.n_verts
        vel = np.zeros((S, n, 3))
        vel[:, pins, 0] = np.outer(np.asarray(speeds, np.float64), sides)
        rest = np.zeros((n, 3))
        rest[pins] = solver._all_verts()[pins]
        self.system = system
        self.elements = sum(b.w.shape[0] for b in system.batches)
        self.pin_vel = torch.from_numpy(vel).to(x0.device, x0.dtype)
        self.pps = (torch.from_numpy(rest).to(x0.device, x0.dtype)
                    + system.dt * self.pin_vel)
        self.xs = x0.expand(S, n, 3).clone()
        self.vs = torch.zeros_like(self.xs)
        self.trace = None
        self.counts = _counts()
        tile_system(system, S)      # built now, with the scene

    def frame(self) -> StepTrace:
        """Every scene one frame: its pins moved by dt times its speed,
        then one tiled step. Returns the frame's StepTrace."""
        self.xs, self.vs, self.pps, tr = ensemble_run_frames(
            self.system, self.xs, self.vs, self.pps, 1, self.pin_vel,
            self.counts)
        self.trace = StepTrace(*(a[:, 0] for a in tr))
        if self.xs.is_cuda:
            torch.cuda.synchronize(self.xs.device)
        return self.trace


def build_sweep(settings: Settings, speeds, device=None, cubes=(12, 3, 3)):
    """The beams scene swept over its pin speed: one scene per entry of
    `speeds` (m/s; the published scene pulls at 1). Returns (solver, Sweep):
    the solver of one scene as ``build_scene`` builds it (never stepped
    here), and the Sweep whose ``frame()`` advances every scene."""
    solver, stretch = build_scene(settings, device=device, cubes=cubes)
    side = stretch.pin_velocity[:, 0]          # +-1 on the pins, else 0
    pins = np.nonzero(side)[0]
    return solver, Sweep(solver, speeds, pins, side[pins])


def log_x_star(settings: Settings, result_dir: str = "result",
               star_iters: int = 2000, device=None):
    """Convergence against the ground truth (SolverLog.hpp:28-71): run the
    first beams timestep to convergence (star_iters iterations without
    acceleration, the minimizer of that step's ADMM objective), then the
    same step with `settings` through step_instrumented feeding a
    SolverLog, and write result/solverlog-{m|no}.txt with one
    ``runtime_ms  normalized_error`` row per iteration (error = ||x* - x||
    / ||x* - x0||). Returns the SolverLog."""
    star_settings = copy.deepcopy(settings)
    star_settings.admm_iters = star_iters
    star_settings.acceleration_type = AccelType.NOACC
    ref_solver, ref_stretch = build_scene(star_settings, device=device)
    ref_stretch(star_settings.timestep_s)
    ref_solver.step()
    log = SolverLog()
    log.x_star = np.asarray(ref_solver.x, np.float64).ravel()

    solver, stretch = build_scene(settings, device=device)
    stretch(settings.timestep_s)
    solver.step_instrumented(log=log)

    os.makedirs(result_dir, exist_ok=True)
    tag = (str(settings.anderson_m)
           if settings.acceleration_type == AccelType.ANDERSON else "no")
    with open(os.path.join(result_dir, f"solverlog-{tag}.txt"), "w") as f:
        for t, e in zip(log.runtimes, log.errors):
            f.write(f"{t}\t{e:.16g}\n")
    return log


def main(argv=None, n_frames: int = 10, result_dir: str = "result",
         device=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    if "--cpu" in argv:
        argv.remove("--cpu")
        device = "cpu"
    want_log = "--log-x-star" in argv
    if want_log:
        argv.remove("--log-x-star")
    settings = Settings()
    settings.admm_iters = 100
    if settings.parse_args(argv):
        return 0
    if want_log:
        log_x_star(settings, result_dir, device=device)
    solver, stretch = build_scene(settings, device=device)
    for _ in range(n_frames):
        stretch(settings.timestep_s)
        solver.step()
    solver.save(result_dir)
    return solver


if __name__ == "__main__":
    main()
