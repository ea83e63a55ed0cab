"""testAndersonADMM — the reference's convergence-sweep harness (counterpart
of aa_admm_tpu/apps/test_anderson_admm.py; admm_anderson_{xzu,hard_zxu}/
testAndersonADMM + testParam.txt): run beams with ``-a 0`` and ``-am 1..6``,
collecting result/residual-*.txt per run. These files are how the paper's
convergence plots were produced.

Usage: python -m aa_admm_tpu_torch.apps.test_anderson_admm [n_frames]
           [result_dir] [--cpu]
"""

from __future__ import annotations

import os
import sys

DEFAULT_PARAMS = ["-a 0", "-am 1", "-am 2", "-am 3", "-am 4", "-am 5",
                  "-am 6"]


def main(argv=None, params=None, n_frames: int = 10,
         result_dir: str = "result"):
    argv = list(argv if argv is not None else sys.argv[1:])
    cpu = "--cpu" in argv
    if cpu:
        argv.remove("--cpu")
    if argv:
        n_frames = int(argv[0])
    if len(argv) > 1:
        result_dir = argv[1]
    os.makedirs(result_dir, exist_ok=True)
    from .beams import main as beams_main
    for line in (params or DEFAULT_PARAMS):
        print(f"=== beams {line} ===")
        beams_main(line.split() + ["-v", "0"] + (["--cpu"] if cpu else []),
                   n_frames=n_frames, result_dir=result_dir)
    print("residual files:", sorted(os.listdir(result_dir)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
