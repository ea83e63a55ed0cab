"""The readings that the beams-ensemble-8 cell's limits (portbench/checks/
beams-ensemble-8.json, ``x_gap_m`` and ``v_gap_m_s``) are set from, at the
cell's own size, on the card, and the sweep's spans:

    python3 tools/port_sweep_calibrate.py [--frames 4] [--seed N]
        [--out FILE]

* sound: the cell's driver sets the sweep up as a run does (one warm-up
  frame) and runs ``--frames`` frames; every (frame, scene) is run again
  by the plain reference at float64, the warm-up frame from the scene as
  built, every later frame from the program's state after the frame
  before (as the check does for its sample): the positions' and the
  velocities' gaps, and each scene's rejects and Anderson resets;
* control: the program built at float32 through the same ``build_sweep``
  (the configuration's ``dtype`` float32), two frames after its warm-up,
  and the driver's own check of it;
* fault: the program built with scenes 3 and 4's speeds (1.0 and 1.25
  m/s, the nearest pair) swapped; the check's own reading of it, and each
  scene's warm-up frame against the reference;
* spans: two frames recorded (``core/timers.py``): one ``ensemble.step``
  root a frame, its ``sync`` spans against the frame's host reads, and the
  set-up's ``setup.build`` spans.

One JSON line per reading goes to standard output and to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CELL = "beams-ensemble-8"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--seed", type=int, default=2**31 + 301)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from aa_admm_tpu_torch.apps import beams
    from aa_admm_tpu_torch.core import timers
    from portbench import run
    from portbench.drivers.ensemble import Driver, settings
    from portbench.drivers.physics import gap_m
    from portbench.reference.ensemble import SweepSceneReference

    run.cache_env(ROOT)
    bench = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    w, c = run.cell(bench, CELL)
    cfg = run.load_json(os.path.join(ROOT, c["file"]))
    mix = run.load_json(os.path.join(ROOT, "portbench", "mixes",
                                     w["traffic"] + ".json"))
    chk = run.load_json(os.path.join(ROOT, "portbench", "checks",
                                     CELL + ".json"))
    speeds = cfg["pin_speeds_m_s"]
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    # sound
    t = time.perf_counter()
    drv = Driver(cfg, mix, chk, args.seed, args.device)
    drv.setup()
    for _ in range(args.frames):
        drv.unit()
    prog_s = time.perf_counter() - t
    runs = drv.warm + drv.states
    t = time.perf_counter()
    x_gaps, v_gaps = [], []
    for s, v in enumerate(speeds):
        ref = SweepSceneReference(cfg, v, args.device)
        xr, vr = [], []
        for j in range(len(runs)):
            if j:
                ref.start(runs[j - 1][0][s], runs[j - 1][1][s], j)
            xr.append(gap_m(runs[j][0][s], ref.frame()))
            vr.append(gap_m(runs[j][1][s], ref.v.double().cpu().numpy()))
        x_gaps.append(xr)
        v_gaps.append(vr)
    n_ref = len(speeds) * len(runs)
    emit(dict(kind="sound", frames=len(runs), program_s=prog_s,
              reference_s_per_frame=(time.perf_counter() - t) / n_ref,
              x_gap_m=x_gaps, v_gap_m_s=v_gaps,
              rejects_per_scene=[[int(r[2][s]) for r in runs]
                                 for s in range(len(speeds))],
              resets_per_scene=[[int(r[3][s]) for r in runs]
                                for s in range(len(speeds))],
              frame_ms=[1e3 * x for x in drv.latencies],
              counters=dict(drv.counters)))
    drv.release()

    # control: the program at float32, held by the driver's own check
    ctl = Driver(dict(cfg, dtype="float32"), mix, chk, args.seed,
                 args.device)
    ctl.setup()
    for _ in range(2):
        ctl.unit()
    ctl.release()
    t = time.perf_counter()
    checks, failed = ctl.check()
    emit(dict(kind="control_f32", checks=checks, failed=failed,
              check_s=time.perf_counter() - t))

    # fault: scenes 3 and 4 swapped in the program
    build = beams.build_sweep

    def swapped(st, sp, **kw):
        sp = list(sp)
        sp[3], sp[4] = sp[4], sp[3]
        return build(st, sp, **kw)

    beams.build_sweep = swapped
    try:
        bad = Driver(cfg, mix, chk, args.seed, args.device)
        bad.setup()
    finally:
        beams.build_sweep = build
    bad.release()
    t = time.perf_counter()
    checks, failed = bad.check()
    emit(dict(kind="fault_swapped_3_4", checks=checks, failed=failed,
              check_s=time.perf_counter() - t,
              per_scene=[gap_m(bad.warm[0][0][s],
                               SweepSceneReference(cfg, v, args.device)
                               .frame()) for s, v in enumerate(speeds)]))

    # spans
    with timers.recording() as rec:
        _, sw = beams.build_sweep(settings(cfg), speeds,
                                  device=args.device,
                                  cubes=tuple(cfg["cubes"]))
    builds = [sp for sp in rec.spans if sp[0] == "setup.build"]
    with timers.recording() as rec:
        reads = []
        for _ in range(2):
            r0 = sw.counts["host_reads"]
            sw.frame()
            reads.append(sw.counts["host_reads"] - r0)
    spans = rec.spans
    roots = [i for i, sp in enumerate(spans) if sp[3] is None]
    emit(dict(kind="spans",
              setup_build_s=[1e-9 * (e - s) for _, s, e, _, _ in builds],
              roots=[spans[i][0] for i in roots],
              sync_per_root=[sum(1 for sp in spans if sp[0] == "sync"
                                 and sp[4] == spans[i][4]) for i in roots],
              host_reads=reads))
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
