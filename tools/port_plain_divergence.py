"""The plain geometry solver (solver/geometry_plain.py) of the JAX package
and of the PyTorch port on chip_smoke's planarity scene, f64 on the CPU:
residuals at iterations 1, 10, 20 and the last, and how far apart the two
packages end.

    python tools/port_plain_divergence.py [ITERATIONS]   # default 60

Scene: the noisy 48 x 48-face quad grid (2,401 vertices) against the clean
height field triangulated to 9,800 triangles; PlaneBatch hard, a
RefSurfaceBatch of weight 1 soft, penalty 100, Anderson m = 5. The JAX side
compiles the whole loop; expect several minutes.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from aa_admm_tpu.ops import constraints as jc  # noqa: E402
from aa_admm_tpu.solver.geometry_plain import GeometrySolver as JG  # noqa: E402
from aa_admm_tpu_torch.ops import constraints as tc  # noqa: E402
from aa_admm_tpu_torch.solver.geometry_plain import GeometrySolver as TG  # noqa: E402


def main(iters):
    mesh, ref_v, ref_f = chip_smoke.planarity_scene()
    n = mesh.n_verts()
    out = {}
    for name, make, mod in (("JAX", JG, jc),
                            ("port", lambda: TG(device="cpu"), tc)):
        s = make()
        s.add_hard_constraint(mod.PlaneBatch.create(mesh.faces, weight=1.0))
        s.add_soft_constraint(mod.RefSurfaceBatch.create(
            list(range(n)), 1.0, ref_v, ref_f))
        s.setup_ADMM(n, penalty_param=100.0)
        s.solve_ADMM(mesh.verts, 1e-10, iters, 5)
        out[name] = np.asarray(s.function_values)
        print(f"{name}: residual at iterations 1, 10, 20, {iters}: "
              f"{out[name][[0, 9, 19, -1]].tolist()}", flush=True)
    rel = np.max(np.abs(out["JAX"] - out["port"]) / out["JAX"])
    print(f"max relative difference over {iters} iterations: {rel:.3e}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 60)
