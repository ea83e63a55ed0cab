"""Time rows of two instrumented physics steps in a row, in the JAX package
and in the PyTorch port, on the CPU.

    python tools/port_instrumented_rows.py

Scene: make_tet_blocks(3, 2, 2), xzu, 6 ADMM iterations, two pins. The JAX
package's PhysicsSolver.step_instrumented writes row i of every step as
t0 + runtime.step_time[i], from the start of a list that accumulates over
steps, so its second step repeats the first step's rows (shifted by the
first step's end when step_times was empty before). The port takes each
step's rows from the entries that step appended.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from aa_admm_tpu.core.config import Lame as JLame  # noqa: E402
from aa_admm_tpu.core.config import Settings as JSettings  # noqa: E402
from aa_admm_tpu.core.factory import make_tet_blocks as jblocks  # noqa: E402
from aa_admm_tpu.solver.physics import PhysicsSolver as JSolver  # noqa: E402
from aa_admm_tpu_torch.core.config import Lame, Settings  # noqa: E402
from aa_admm_tpu_torch.core.factory import make_tet_blocks  # noqa: E402
from aa_admm_tpu_torch.solver.physics import PhysicsSolver  # noqa: E402


def rows(solver):
    solver.step_instrumented()
    n = len(solver.step_times)
    solver.step_instrumented()
    return solver.step_times[:n], solver.step_times[n:]


def main():
    for name, blocks, S, L, mk in (
            ("JAX", jblocks, JSettings, JLame, lambda: JSolver(order="xzu")),
            ("port", make_tet_blocks, Settings, Lame,
             lambda: PhysicsSolver(order="xzu", device="cpu"))):
        mesh = blocks(3, 2, 2)
        s = S()
        s.admm_iters, s.verbose = 6, 0
        solver = mk()
        solver.add_tetmesh(mesh.verts, mesh.tets, L.from_young_poisson(1e6, 0.3))
        solver.set_pins([0, 1])
        solver.initialize(s)
        first, second = rows(solver)
        print(f"{name}: step 1 rows {np.round(first, 2).tolist()}")
        print(f"{name}: step 2 rows {np.round(second, 2).tolist()}")
        again = np.allclose(np.asarray(second) - first[-1], first)
        print(f"{name}: runtime.step_time holds "
              f"{len(set(solver.runtime.step_time))} distinct values; step 2 "
              f"repeats step 1's rows shifted by its end: {again}")


if __name__ == "__main__":
    main()
