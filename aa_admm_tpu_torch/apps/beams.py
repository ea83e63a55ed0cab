"""beams — the reference's headline physics scene (counterpart of
aa_admm_tpu/apps/beams.py:1-135; admm_anderson_xzu/samples/Asia2019/
beams.cpp:94-167, headless).

Usage: python -m aa_admm_tpu_torch.apps.beams [-it N -a 1 -am M ...] [--cpu]

Three 12x3x3 tet-block beams (Linear / NeoHookean / StVK, soft rubber),
end-pinned, with the pins stretched +/- x by 1 m/s each frame
(stretch_beams, beams.cpp:66-92). Runs the xzu solver on the CUDA card
unless device="cpu" (or --cpu), and writes result/residual-{m|no}.txt like
the reference's testAndersonADMM harness. ``cubes`` scales each beam's
block counts (the published scene is (12, 3, 3)).
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.config import Lame, Settings
from ..core.factory import make_tet_blocks
from ..solver.physics import PhysicsSolver, UpdateOrder


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


def main(argv=None, n_frames: int = 10, result_dir: str = "result",
         device=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    if "--cpu" in argv:
        argv.remove("--cpu")
        device = "cpu"
    settings = Settings()
    settings.admm_iters = 100
    if settings.parse_args(argv):
        return 0
    solver, stretch = build_scene(settings, device=device)
    for _ in range(n_frames):
        stretch(settings.timestep_s)
        solver.step()
    solver.save(result_dir)
    return solver


if __name__ == "__main__":
    main()
