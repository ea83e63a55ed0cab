"""What the port's fixed-order scatter costs against the index_add_ it
replaced, end to end, on one NVIDIA GPU: run it once from this checkout and
once with ``--tree DIR`` pointing at an unpacked checkout of the parent
commit, in turns (parent, change, change, parent), in one call on one card.

    python3 tools/port_scatter_cost.py [--tree DIR] [--out FILE]

Per run, imports ``aa_admm_tpu_torch`` from DIR (default: this checkout) and
measures on the card:
  * beams-published, float64, ``-a 1 -am 5``: three steps from the scene's
    start (the first captures the CUDA graphs), ms of the second and third;
    whether two such runs from one state give the same bits;
  * windyflag-synthetic (64 x 64 cloth), float64, ``-a 1 -am 5``: the
    same, then three steps under torch.profiler: device ms and kernels per
    step;
  * planarity-synthetic-costa2k, float32, 100 iterations (chip_smoke phase
    7's run): ms per accepted iteration, trials, cp-cache refreshes, host
    reads; then the same run under torch.profiler: device ms and kernels
    per trial, and the costliest kernels;
  * wiremesh-synthetic-231k, float32, 20 iterations (chip_smoke phase 5's
    scene) on the ELL operator: ms per trial, CG iterations and cp-cache
    refreshes per trial, setup seconds.
Prints one line per measurement and, last, one JSON object of them all
(also written to FILE when given).
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def steps(make, n=3):
    s = make()
    for _ in range(n):
        s.step()
    s.flush_traces()
    return s


def physics(out, name, make):
    a, b = steps(make), steps(make)
    out[name] = dict(step_ms=[float(v) for v in a.step_ms],
                     repeat_ms=[float(v) for v in b.step_ms],
                     bit_equal=bool(np.array_equal(a.x, b.x)
                                    and a.step_prim == b.step_prim))
    print(f"{name}: ms per step {a.step_ms} and {b.step_ms} (the first "
          f"captures the graphs); two runs bit-equal: "
          f"{out[name]['bit_equal']}", flush=True)


def device_profile(fn, top=5):
    """fn() under torch.profiler: its device kernels' total ms and count,
    the `top` costliest (name, ms, count), and fn's result."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:                   # device work, not runtime calls
            rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    return dict(device_ms=sum(r[1] for r in rows),
                kernels=sum(r[2] for r in rows), top=rows[:top],
                result=result)


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree) if args.tree else ROOT
    sys.path.insert(0, ROOT)          # chip_smoke's scene builders
    sys.path.insert(0, tree)          # the package under test comes first
    import torch
    if not torch.cuda.is_available():
        print("port_scatter_cost: needs a CUDA device", file=sys.stderr)
        return 1
    import aa_admm_tpu_torch
    import chip_smoke as cs
    from aa_admm_tpu_torch.ops import cuda_kernels as ck
    pkg = os.path.dirname(aa_admm_tpu_torch.__file__)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"{card}; package from {pkg}", flush=True)
    ck.build_all()
    out = dict(card=card, tree=tree)

    from aa_admm_tpu_torch.apps import windyflag as wf
    tmp = tempfile.mkdtemp(prefix="scatter_cost_")
    cloth, _, _ = cs.cloth_file(tmp, 64)
    physics(out, "beams-published", lambda: cs.beams_solver("cuda", True))
    make_wf = lambda: wf.build_scene(cs.zxu_settings(True, 100),
                                     mesh_path=cloth, device="cuda")
    physics(out, "windyflag-synthetic", make_wf)
    prof = device_profile(lambda: steps(make_wf))
    prof.pop("result")
    out["windyflag-synthetic"]["profiled"] = dict(
        prof, device_ms_per_step=prof["device_ms"] / 3,
        kernels_per_step=prof["kernels"] / 3)
    print(f"windyflag-synthetic, three steps again under torch.profiler: "
          f"{prof['device_ms'] / 3:.3f} device ms and "
          f"{prof['kernels'] / 3:.1f} kernels per step", flush=True)

    solver, _, secs = cs.run_planarity(ck, "cuda", np.float32, 100)
    st, n_it = solver.stats, len(solver.function_values)
    out["planarity-synthetic-costa2k"] = dict(
        ms_per_iteration=st["solve_s"] / n_it * 1e3, trials=st["trials"],
        cp_refreshes=st["cp_refreshes"], iterations=n_it,
        host_reads=st["host_reads"])
    print(f"planarity f32, 100 iterations: "
          f"{st['solve_s'] / n_it * 1e3:.3f} ms per iteration, "
          f"{st['trials']} trials, {st['cp_refreshes']} cp-cache refreshes, "
          f"{st['host_reads']} host reads", flush=True)
    prof = device_profile(lambda: cs.run_planarity(ck, "cuda", np.float32,
                                                   100)[0])
    trials = prof.pop("result").stats["trials"]
    out["planarity-synthetic-costa2k"]["profiled"] = dict(
        prof, device_ms_per_trial=prof["device_ms"] / trials,
        kernels_per_trial=prof["kernels"] / trials, trials=trials)
    print(f"planarity f32, 100 iterations again under torch.profiler: "
          f"{prof['device_ms'] / trials:.3f} device ms and "
          f"{prof['kernels'] / trials:.1f} kernels per trial over {trials} "
          f"trials; costliest: " + "; ".join(
              f"{k[:60]} {ms:.1f} ms x{n}" for k, ms, n in prof["top"]),
          flush=True)

    from aa_admm_tpu_torch.apps import wire_mesh_opt as wm
    sub, el, ref_v, ref_f = cs.full_scene()
    t0 = time.perf_counter()
    solver = wm.optimize_mesh(sub, ref_v, ref_f, max_iter=20, anderson_m=5,
                              edge_length=el, min_angle_radian=np.pi * 0.25,
                              max_angle_radian=np.pi * 0.75,
                              dtype=np.float32, result_dir=tmp, device="cuda")
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    st = solver.stats
    out["wiremesh-synthetic-231k"] = dict(
        ms_per_trial=st["solve_s"] / st["trials"] * 1e3,
        trials=st["trials"], cg_iters=st["cg_iters"],
        cp_refreshes=st["cp_refreshes"], setup_s=solver.setup_s,
        total_s=total, operator="ell")
    print(f"wire mesh f32, 20 iterations (ELL): "
          f"{st['solve_s'] / st['trials'] * 1e3:.3f} ms per trial, "
          f"{st['trials']} trials, {st['cg_iters']} CG iterations, "
          f"{st['cp_refreshes']} cp-cache refreshes; setup "
          f"{solver.setup_s:.2f} s", flush=True)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
