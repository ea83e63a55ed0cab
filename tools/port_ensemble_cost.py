"""What the port's scene ensembles cost on one NVIDIA GPU, for this checkout
and, with ``--tree DIR``, for another (an unpacked checkout, e.g. the
parent commit's), in turns (other, this, this, other), each run in its own
process, in one call on one card.

    python3 tools/port_ensemble_cost.py [--tree DIR] [--frames N]

Each run imports ``aa_admm_tpu_torch`` and ``chip_smoke`` (for its scene
helpers) from its tree and steps plinkohit-synthetic (chip_smoke phase 9's
936-vertex block, float32, ``-a 1 -am 5``, 13 iterations per frame) as
ensembles of 1, 8, 32 and 128 scenes: one warm frame (the CUDA graphs'
capture), then N frames timed one by one (synchronized). Prints one line
per run and size (median ms per frame, its quartiles, iterations/s) and,
last, one JSON object of every run.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (1, 8, 32, 128)


def one(tree, n_frames):
    """One run in this process, with `tree`'s package: {S: frame ms}."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import chip_smoke as cs
    from aa_admm_tpu_torch.apps import plinkohit
    from aa_admm_tpu_torch.parallel.ensemble import ensemble_step
    assert os.path.dirname(os.path.abspath(cs.__file__)) == \
        os.path.abspath(tree)
    with tempfile.TemporaryDirectory() as tmp:
        hit = cs.block_file(tmp, "hit", (12, 7, 8), 0.15, 0.25, -1.0,
                            (0.25, 2.5, 0.0))
        s = cs.zxu_settings(True, 13)
        s.dtype = np.dtype(np.float32)
        solver = plinkohit.build_scene(s, mesh_path=hit, device="cuda")
    step = ensemble_step(solver.system.order)
    out = {}
    for S in SIZES:
        xs, vs, pps = cs.replicas(solver, S)
        xs, vs, _ = step(solver.system, xs, vs, pps)
        ms = []
        for _ in range(n_frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xs, vs, _ = step(solver.system, xs, vs, pps)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out[S] = ms
    return out


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--one")
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one(args.one, args.frames)))
        return 0
    import numpy as np
    trees = [ROOT] if not args.tree else [args.tree, ROOT, ROOT, args.tree]
    runs = []
    for tree in trees:
        side = "this" if tree == ROOT else "other"
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", tree, "--frames", str(args.frames)],
                           capture_output=True, text=True, check=True)
        ms = json.loads(p.stdout.strip().splitlines()[-1])
        runs.append({"tree": side, "frame_ms": ms})
        for S, v in ms.items():
            lo, med, hi = np.percentile(v, [25, 50, 75])
            print(f"{side} S={S}: median {med:.3f} ms per frame "
                  f"(quartiles {lo:.3f}, {hi:.3f}), "
                  f"{int(S) * 13 * 1e3 / med:.1f} iterations/s", flush=True)
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
