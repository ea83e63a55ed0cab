"""How reproducible one beams timestep is, in the JAX package and in the
PyTorch port, at float64 on the CPU.

    python tools/port_beams_spread.py [ITERS]

Runs the first beams timestep (ITERS ADMM iterations, default 100), without
acceleration and with Anderson m = 5, in five variants: the JAX package;
the JAX package with x changed by one part in 1e15; the JAX package with its
singular-value Newton polished as the port polishes it (the package itself
is not changed: tests/test_torch_svd_prox.py's ``jax_newton_polished``
wraps ``prox._sigma_newton`` in this process);
the port; the port with x changed by one part in 1e15. Each is compared with
the plain JAX run and with the polished one: the largest relative
difference of the primal residuals, the largest difference over the first
residual, the reject iterations, and the final positions. A minute or two.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def main(argv):
    iters = int(argv[0]) if argv else 100
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import torch

    from aa_admm_tpu.apps import beams as jbeams
    from aa_admm_tpu.core import config as jconfig
    from aa_admm_tpu.ops import prox as jpx
    from aa_admm_tpu_torch.apps import beams as tbeams
    from aa_admm_tpu_torch.core import config as tconfig
    from test_torch_svd_prox import jax_newton_polished

    torch.set_num_threads(1)
    orig = jpx._sigma_newton
    polished = jax_newton_polished()

    def run(which, accel, pert=False, polish=False):
        C = jconfig if which == "jax" else tconfig
        s = C.Settings()
        s.admm_iters = iters
        s.verbose = 0
        if accel:
            s.acceleration_type = C.AccelType.ANDERSON
            s.anderson_m = 5
        jpx._sigma_newton = polished if polish else orig
        jax.clear_caches()
        if which == "jax":
            solver, stretch = jbeams.build_scene(s)
        else:
            solver, stretch = tbeams.build_scene(s, device="cpu")
        stretch(s.timestep_s)
        if pert:
            solver.x = np.asarray(solver.x) * (1 + 1e-15)
        tr = solver.step()
        jpx._sigma_newton = orig
        return [np.asarray(a.numpy() if hasattr(a, "numpy") else a)
                for a in (tr.prim, tr.comb, tr.reject)] + [np.asarray(solver.x)]

    for accel in (False, True):
        runs = {"jax": run("jax", accel),
                "jax, x*(1+1e-15)": run("jax", accel, pert=True),
                "jax, Newton polished": run("jax", accel, polish=True),
                "port": run("torch", accel),
                "port, x*(1+1e-15)": run("torch", accel, pert=True)}
        for base in ("jax", "jax, Newton polished"):
            ref = runs[base]
            for name, out in runs.items():
                if name == base:
                    continue
                a, b = ref[0], out[0]
                v = ~np.isnan(a) & ~np.isnan(b)
                d = np.abs(a - b)[v]
                print(f"{'AA m=5' if accel else 'no AA '} {name:22s} vs "
                      f"{base:20s}: prim max rel {np.max(d / np.abs(a[v])):.2e}"
                      f", max diff / prim[0] {d.max() / a[0]:.2e}, recorded "
                      f"{int((~np.isnan(a)).sum())}/{int((~np.isnan(b)).sum())}"
                      f", rejects {np.nonzero(ref[2])[0][:6].tolist()} / "
                      f"{np.nonzero(out[2])[0][:6].tolist()}, max |dx| "
                      f"{np.abs(ref[3] - out[3]).max():.2e}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
