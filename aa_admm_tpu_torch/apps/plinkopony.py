"""plinkopony — horse759 dropped through a 2-layer grid of cylinder pegs
onto a tilted slide floor, zxu order (counterpart of
aa_admm_tpu/apps/plinkopony.py; admm_anderson_hard_zxu/samples/Asia2019/
plinkopony.cpp:28-110, headless).

Usage: python -m aa_admm_tpu_torch.apps.plinkopony [-a 1 -am 5 ...]
       [--mesh BASENAME] [--cpu]

As plinkohit: BASENAME.ele/.node, by default the reference's horse759; runs
on the CUDA card unless --cpu; writes result/residual-{m|no}.txt.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.config import Lame, Settings
from ..core.meshio import load_elenode
from ..solver.physics import PhysicsSolver, UpdateOrder
from ._data import find_data
from .plinkohit import parse_argv


def build_scene(settings: Settings, mesh_path: str | None = None,
                device=None):
    mesh = load_elenode(mesh_path or find_data("horse759"))
    # float32 transform as the reference's XForm<float> (plinkopony.cpp:39-42)
    v32 = mesh.verts.astype(np.float32)
    mesh.verts = (np.float32(13.0) * v32
                  + np.array([0.25, 5.0, 0.0], np.float32)).astype(np.float64)

    solver = PhysicsSolver(order=UpdateOrder.ZXU, device=device)
    solver.add_tetmesh(mesh.verts, mesh.tets, Lame.rubber(), kind="linear")
    # 3x5 + 2x4 cylinder pegs (plinkopony.cpp:56-80)
    for j in range(3):
        for i in range(5):
            solver.add_obstacle("cylinder",
                                center=[i * 1.5 - 3.0, j * 3.0 - 3.0, 0.0],
                                rad=0.4)
    for j in range(2):
        for i in range(4):
            solver.add_obstacle("cylinder",
                                center=[i * 1.5 - 2.25, j * 3.0 - 1.5, 0.0],
                                rad=0.4)
    # Tilted slide floor at y=-6.5 with normal (0.5, sqrt(3)/2, 0)
    solver.add_obstacle("slide_floor", center=[0.0, -6.5, 0.0],
                        normal=[0.5, np.sqrt(3.0) / 2.0, 0.0])
    solver.set_collisions(list(range(len(mesh.verts))))
    solver.initialize(settings)
    return solver


def main(argv=None, n_frames: int = 10, result_dir: str = "result",
         mesh_path: str | None = None, device=None):
    argv, mesh, cli_device = parse_argv(
        argv if argv is not None else sys.argv[1:])
    settings = Settings()
    settings.admm_iters = 13
    if settings.parse_args(argv):
        return 0
    solver = build_scene(settings, mesh_path or mesh, cli_device or device)
    for _ in range(n_frames):
        solver.step()
    solver.save(result_dir)
    return solver


if __name__ == "__main__":
    main()
