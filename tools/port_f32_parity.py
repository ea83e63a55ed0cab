"""float32 parity of the PyTorch port against the JAX package on the CPU.

    python tools/port_f32_parity.py jax|torch [N_FACES] [N_REF] [ITERS]

Runs the wire-mesh app's ``optimize_mesh`` at float32 in one package on the
synthetic scene of chip_smoke.py (a noisy N_FACES^2 quad grid on a bumpy
height field, subdivided; the field triangulated on an N_REF^2 grid; default
80 and 102: 25,921 vertices on the CG path against 20,402 triangles, so the
subgroup cache runs) and prints every fourth function value, the reject
count and the edge-error report. Run it once per package and compare: f32
trajectories are judged by quality, not bitwise. CPU only; a run takes
minutes.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv):
    which = argv[0]
    nf, nr, iters = [int(a) for a in argv[1:]] + [80, 102, 20][len(argv) - 1:]
    import chip_smoke as cs
    sub, el, ref_v, ref_f = cs.full_scene(n_faces=nf, n_ref=nr)
    t = time.time()
    if which == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from aa_admm_tpu.apps.wire_mesh_opt import (check_wiremesh_error,
                                                    optimize_mesh)
        from aa_admm_tpu.core.polymesh import PolyMesh
        s = optimize_mesh(PolyMesh(verts=sub.verts, faces=sub.faces), ref_v,
                          ref_f, max_iter=iters, anderson_m=5, edge_length=el,
                          dtype=np.float32, result_dir="result/f32_parity_jax")
    else:
        from aa_admm_tpu_torch.apps.wire_mesh_opt import (
            check_wiremesh_error, optimize_mesh)
        s = optimize_mesh(sub, ref_v, ref_f, max_iter=iters, anderson_m=5,
                          edge_length=el, dtype=np.float32,
                          result_dir="result/f32_parity_torch", device="cpu")
        print(s.stats)
    out = s.get_solution()
    print(f"{which}: {sub.n_verts()} vertices, {time.time() - t:.1f} s, "
          f"fv {s.function_values[::4]}, rejects {sum(s.anderson_reset)}")
    e, _, _ = check_wiremesh_error(sub, out, el, np.pi / 4, 3 * np.pi / 4)
    print(f"{which}: edge err mean {e.mean():.7f} max {e.max():.7f}")


if __name__ == "__main__":
    main(sys.argv[1:])
