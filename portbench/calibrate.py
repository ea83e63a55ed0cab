"""The readings that a cell's limits (``checks/<workload>.json``) are set
from, at the cell's own size, on the card:

    python3 portbench/calibrate.py --workload NAME [--seeds 12]
        [--controls 3] [--first-seed N] [--out FILE]

One solver is set up as a run sets it up. For each seed the program
answers that seed's first request and the plain reference answers it too;
the numbers compared (drivers/geometry.py ``readings``) are printed per
seed beside the solve's counts and times. On the first ``--controls``
seeds the controls (the reference put in the program's place: all in
bfloat16; with its hard projections in bfloat16 and its state in float32;
all in float16; and in float32 with TF32 matmuls, for comparison) and the
two planted faults of faults.py are read the same way. One JSON line per
reading goes to ``--out``.

For the beams (a physics driver) the program runs ``--frames`` frames after
its warm-up, and the reference runs each frame as the check does: the
first from the scene, every later one from the program's state after the
frame before. The control is the reference in float32 run the same way,
the faults ``step_unchanged`` and ``step_altered``. The scene draws
nothing from the seed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2**31 + 101)
    ap.add_argument("--out", default=None)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from portbench import run
    run.cache_env(ROOT)
    bench = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    w, c = run.cell(bench, args.workload)
    cfg = run.load_json(os.path.join(ROOT, c["file"]))
    mix = run.load_json(os.path.join(ROOT, "portbench", "mixes",
                                     w["traffic"] + ".json"))
    chk = run.load_json(os.path.join(ROOT, "portbench", "checks",
                                     args.workload + ".json"))
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    try:
        if cfg["driver"] == "physics":
            physics(args, cfg, mix, chk, emit)
        else:
            geometry(args, cfg, mix, chk, emit)
    finally:
        if out:
            out.close()
    return 0


def physics(args, cfg, mix, chk, emit):
    import torch

    from portbench import faults
    from portbench.drivers.physics import Driver, gap_m
    from portbench.reference.physics import BeamsReference

    def frames(fault=None):
        drv = Driver(cfg, mix, chk, args.first_seed, args.device)
        t = time.perf_counter()
        with faults.planted(fault, vertex=7, shift=0.01) if fault else \
                contextlib.nullcontext():
            drv.setup()
            for _ in range(args.frames):
                drv.unit()
        return drv.warm + drv.states, time.perf_counter() - t

    def gaps(states, dtype):
        """Each frame's gap as the check takes it: the first from the scene,
        every later one from the program's state after the frame before."""
        ref = BeamsReference(cfg, args.device, dtype=dtype)
        t = time.perf_counter()
        out = [gap_m(states[0][0], ref.frame())]
        for j in range(1, len(states)):
            ref.start(*states[j - 1], j)
            out.append(gap_m(states[j][0], ref.frame()))
        return out, (time.perf_counter() - t) / len(states)

    for j in range(args.seeds):
        states, t_prog = frames()
        g, t_ref = gaps(states, torch.float64)
        emit(dict(kind="program", run=j, program_s=t_prog,
                  reference_s_per_frame=t_ref, x_gap_m=g))
        if j >= args.controls:
            continue
        # the control: the reference in float32 in the program's place
        ctl = BeamsReference(cfg, args.device, dtype=torch.float32)
        xs = [(ctl.frame(), None)]
        ref = BeamsReference(cfg, args.device)
        g = [gap_m(xs[0][0], ref.frame())]
        for k in range(1, len(states)):
            ctl.start(*states[k - 1], k)
            ref.start(*states[k - 1], k)
            g.append(gap_m(ctl.frame(), ref.frame()))
        emit(dict(kind="control_f32", run=j, x_gap_m=g))
        for kind in ("step_unchanged", "step_altered"):
            fs, _ = frames(kind)
            emit(dict(kind="fault_" + kind, run=j,
                      x_gap_m=gaps(fs, torch.float64)[0]))


def geometry(args, cfg, mix, chk, emit):
    import numpy as np
    import torch

    from portbench import faults
    from portbench.drivers.geometry import Driver
    from portbench.reference import wiremesh as ref

    drv = Driver(cfg, mix, chk, args.first_seed, args.device)
    t0 = time.perf_counter()
    drv.setup()
    print(f"setup {time.perf_counter() - t0:.2f} s, {len(drv.base)} vertices",
          flush=True)

    def reference(dtype, local=None):
        return ref.WireMeshReference(
            len(drv.base), drv.corners, drv.edges, drv.target,
            cfg["min_angle"], cfg["max_angle"], drv.ref_tris, cfg["penalty"],
            cfg["closeness_weight"], args.device, dtype=dtype,
            local_dtype=local)

    exact = reference(torch.float64)
    f32, bf16 = torch.float32, torch.bfloat16
    controls = dict(control_bf16=(bf16, None, False),
                    control_bf16_local=(f32, bf16, False),
                    control_fp16=(torch.float16, None, False),
                    control_tf32=(f32, None, True))
    ctl_solvers = {}
    iters, m = mix["iterations"], cfg["anderson_m"]

    for j in range(args.seeds):
        seed = args.first_seed + 7919 * j
        drv.seed = seed
        x0 = drv.request(0)
        t = time.perf_counter()
        xp = drv._solve(x0, iters)
        t_prog = time.perf_counter() - t
        st = dict(drv.solver.stats)
        t = time.perf_counter()
        xr = exact.solve(x0, iters, m)
        t_ref = time.perf_counter() - t
        r = drv.readings(x0, xp, xr)
        e = [ref.edge_errors(x, drv.edges, drv.target) for x in (x0, xp, xr)]
        a = [ref.angle_excess(x, drv.corners, cfg["min_angle"],
                              cfg["max_angle"]) for x in (x0, xp, xr)]
        emit(dict(kind="program", seed=seed, **r, program_s=t_prog,
                  reference_s=t_ref, trials=st["trials"],
                  cg_iters=st["cg_iters"], cp_refreshes=st["cp_refreshes"],
                  accepted=len(drv.solver.function_values),
                  edge_max=[float(x.max()) for x in e],
                  edge_rms=[float(np.sqrt((x ** 2).mean())) for x in e],
                  corners_outside=[int((x > 0).sum()) for x in a]))
        if j >= args.controls:
            continue
        for name, (dtype, local, tf32) in controls.items():
            if name not in ctl_solvers:
                ctl_solvers[name] = reference(dtype, local)
            torch.backends.cuda.matmul.allow_tf32 = tf32
            try:
                t = time.perf_counter()
                xc = ctl_solvers[name].solve(x0, iters, m)
                emit(dict(kind=name, seed=seed, **drv.readings(x0, xc, xr),
                          seconds=time.perf_counter() - t))
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
        vertex = int(np.random.default_rng(seed).integers(len(x0)))
        for kind in ("unchanged", "altered"):
            with faults.planted(kind, vertex=vertex, shift=drv.target):
                xf = drv._solve(x0, iters)
            emit(dict(kind="fault_" + kind, seed=seed,
                      **drv.readings(x0, xf, xr)))


if __name__ == "__main__":
    sys.exit(main())
