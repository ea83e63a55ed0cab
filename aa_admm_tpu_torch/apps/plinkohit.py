"""plinkohit — horse759 tet mesh dropped onto a plane-and-half-sphere
obstacle with per-vertex hard collision terms, zxu order (counterpart of
aa_admm_tpu/apps/plinkohit.py; admm_anderson_hard_zxu/samples/Asia2019/
plinkohit.cpp:39-123, headless).

Usage: python -m aa_admm_tpu_torch.apps.plinkohit [-a 1 -am 5 ...]
       [--mesh BASENAME] [--cpu]

BASENAME names a TetGen pair (BASENAME.ele, BASENAME.node); by default the
reference's horse759 (apps/_data.py). Runs on the CUDA card unless --cpu,
and writes result/residual-{m|no}.txt with the zxu reject column.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.config import Lame, Settings
from ..core.meshio import load_elenode
from ..solver.physics import PhysicsSolver, UpdateOrder
from ._data import find_data


def build_scene(settings: Settings, mesh_path: str | None = None,
                device=None):
    mesh = load_elenode(mesh_path or find_data("horse759"))
    # xform: scale 13, translate (0.25, 2.5, 0) (plinkohit.cpp:47-50), in
    # float32 as the reference's XForm<float> rounds it.
    v32 = mesh.verts.astype(np.float32)
    mesh.verts = (np.float32(13.0) * v32
                  + np.array([0.25, 2.5, 0.0], np.float32)).astype(np.float64)

    solver = PhysicsSolver(order=UpdateOrder.ZXU, device=device)
    solver.add_tetmesh(mesh.verts, mesh.tets, Lame.rubber(), kind="linear")
    # Plane+half-sphere at y=-3, r=1 (plinkohit.cpp:87-92)
    solver.add_obstacle("plane_half_sphere", center=[0.0, -3.0, 0.0], rad=1.0)
    # Hard collision terms on every vertex (set_collision, plinkohit.cpp:103-123)
    solver.set_collisions(list(range(len(mesh.verts))))
    solver.initialize(settings)
    return solver


def parse_argv(argv):
    """(settings args, mesh path or None, device or None) of a command line
    with the port's --mesh BASENAME and --cpu."""
    argv = list(argv)
    mesh = device = None
    if "--cpu" in argv:
        argv.remove("--cpu")
        device = "cpu"
    if "--mesh" in argv:
        i = argv.index("--mesh")
        mesh = argv[i + 1]
        del argv[i:i + 2]
    return argv, mesh, device


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
