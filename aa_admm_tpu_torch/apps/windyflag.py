"""windyflag — cloth under wind with strain limiting, zxu order
(counterpart of aa_admm_tpu/apps/windyflag.py; admm_anderson_hard_zxu/
samples/Asia2019/windyflag.cpp:63-183, headless).

Usage: python -m aa_admm_tpu_torch.apps.windyflag [-it N -a 1 -am 5 ...]
       [--mesh CLOTH.obj] [--cpu]

The cloth.obj triangle mesh (by default the reference's, apps/_data.py),
Lame(50, 0.1) with strain limits [0.95, 1.05], two corner pins on the min-x
edge, Wejchert-Haumann wind (10,0,2)*2.5, admm_iters=100, penalty=1.0. Runs
on the CUDA card unless --cpu; writes result/residual-{m|no}.txt.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.config import Lame, Settings
from ..core.meshio import load_obj
from ..solver.physics import PhysicsSolver, UpdateOrder
from ._data import find_data
from .plinkohit import parse_argv


def get_pins(verts):
    """windyflag.cpp:27-60: among min-x vertices, the min-y and max-y ones."""
    min_x = verts[:, 0].min() + 1e-3
    up_idx = down_idx = -1
    curr_max_y, curr_min_y = -99999.0, 99999.0
    for i, v in enumerate(verts):
        if v[0] > min_x:
            continue
        if v[1] < curr_min_y:
            up_idx, curr_min_y = i, v[1]
        elif v[1] > curr_max_y:
            down_idx, curr_max_y = i, v[1]
    if up_idx < 0 or down_idx < 0:
        raise RuntimeError("Failed to find pin locations")
    return [up_idx, down_idx]


def build_scene(settings: Settings, mesh_path: str | None = None,
                device=None, wind_mode: str = "jacobi"):
    """wind_mode: 'jacobi' (one scatter, the default) or 'sequential' (the
    reference's wind loop on one thread) — see WindForce."""
    mesh = load_obj(mesh_path or find_data("cloth.obj"))
    lame = Lame.from_young_poisson(50, 0.1, limit_min=0.95, limit_max=1.05)

    solver = PhysicsSolver(order=UpdateOrder.ZXU, device=device)
    solver.add_trimesh(mesh.verts, mesh.faces, lame)
    solver.set_pins(get_pins(mesh.verts))
    solver.set_wind(mesh.faces, np.array([10.0, 0.0, 2.0]) * 2.5,
                    mode=wind_mode)
    solver.initialize(settings)
    return solver


def main(argv=None, n_frames: int = 10, result_dir: str = "result",
         mesh_path: str | None = None, device=None):
    argv, mesh, cli_device = parse_argv(
        argv if argv is not None else sys.argv[1:])
    settings = Settings()
    settings.admm_iters = 100
    settings.penalty = 1.0
    if settings.parse_args(argv):
        return 0
    solver = build_scene(settings, mesh_path or mesh, cli_device or device)
    for _ in range(n_frames):
        solver.step()
    solver.save(result_dir)
    return solver


if __name__ == "__main__":
    main()
