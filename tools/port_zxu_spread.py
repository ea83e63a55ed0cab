"""How far roundoff moves a zxu step with self-contacts, on the two-block
scene of tests/test_selfcollision.py (a 1 x 1 x 1-cube block falling onto
a pinned 2 x 1 x 2 slab, 10 non-accelerated iterations a step, float64).

    python3 tools/port_zxu_spread.py          # on a CUDA device
    python3 tools/port_zxu_spread.py --cpu    # the CPU half only

Per step, from one trajectory's state: the contacts at the step's start,
and the largest difference of x after the step between
  * the CPU run and a CPU run from the state nudged by one unit in the
    last place (the scene's own spread);
  * on a CUDA device, the solver as it runs there (prox replayed from CUDA
    graphs) and the same solver with ``physics._graphed`` replaced in this
    process by a direct call (eager), and eager against the CPU.
The hard contact snap is discontinuous, so a step with contacts turns such
differences into far larger ones; tests/test_torch_physics_solver.py
therefore holds the graphs against eager calls one replay at a time.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make(device):
    from aa_admm_tpu_torch.core.config import Lame, Settings
    from aa_admm_tpu_torch.core.factory import make_tet_blocks
    from aa_admm_tpu_torch.solver.physics import PhysicsSolver
    bottom, top = make_tet_blocks(2, 1, 2), make_tet_blocks(1, 1, 1)
    s = Settings()
    s.admm_iters = 10
    s.verbose = 0
    sv = PhysicsSolver(order="zxu", device=device)
    o0 = sv.add_tetmesh(bottom.verts, bottom.tets, Lame.rubber(),
                        self_collision=True)
    sv.add_tetmesh(top.verts + [0.5, 1.05, 0.5], top.tets, Lame.rubber(),
                   self_collision=True)
    sv.set_pins(list(range(o0, o0 + len(bottom.verts))))
    sv.initialize(s)
    return sv


def main(argv):
    import torch
    from aa_admm_tpu_torch.solver import physics
    torch.set_num_threads(1)
    card = "--cpu" not in argv and torch.cuda.is_available()
    names = ["cpu", "nudged"] + (["graphs", "eager"] if card else [])
    solvers = {n: make("cuda" if n in ("graphs", "eager") else "cpu")
               for n in names}
    graphed = physics._graphed
    rng = np.random.default_rng(0)
    lead = solvers["graphs" if card else "cpu"]
    for k in range(8):
        x, v = lead.x.copy(), lead.v.copy()
        for n, sv in solvers.items():
            sv.x = x * (1 + 1e-16 * rng.choice([-1, 1], size=x.shape)) \
                if n == "nudged" else x.copy()
            sv.v = v.copy()
            if n == "eager":
                physics._graphed = lambda system, key, fn, t: fn(t)
            sv.step()
            physics._graphed = graphed
        b = solvers["cpu"].system.batches[solvers["cpu"]._selfcol_index]
        xs = {n: sv.x for n, sv in solvers.items()}
        line = (f"step {k}: {int(b.active.sum())} contacts; max |dx| nudged "
                f"CPU {np.abs(xs['nudged'] - xs['cpu']).max():.2e}")
        if card:
            line += (f", graphs vs eager "
                     f"{np.abs(xs['graphs'] - xs['eager']).max():.2e}, eager "
                     f"vs CPU {np.abs(xs['eager'] - xs['cpu']).max():.2e}")
        print(line)
    if card:
        import subprocess
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())


if __name__ == "__main__":
    main(sys.argv[1:])
