"""The beams pin-speed sweep (aa_admm_tpu_torch/apps/beams.py
``build_sweep``) on the CPU at f64 and a small size (3 x 1 x 1 cubes a
beam, 10 iterations a frame), and its benchmark cell
(portbench/drivers/ensemble.py):

* each scene of the sweep against the plain per-scene reference
  (portbench/reference/ensemble.py) at its own speed, over 3 frames; in
  one sweep (40 iterations a frame) the fastest scene rejects and the
  others never, so the per-scene reject branch is held to the reference
  too;
* the published-speed scene against ``build_scene``'s ``stretch`` and
  ``PhysicsSolver.step``;
* the spans: one ``ensemble.step`` root a frame, its ``sync`` spans equal
  to the frame's host reads, and the tiled system's build in
  ``setup.build``;
* the cell's tiny run is correct, and not correct with two scenes'
  speeds swapped in the program, with two scenes' velocities swapped
  after each frame (the positions then follow the reference) or with the
  program built at float32; its readers on synthetic contexts.
"""

import os
import sys

import numpy as np
import pytest
import torch

from aa_admm_tpu_torch.apps import beams
from aa_admm_tpu_torch.core import timers
from aa_admm_tpu_torch.core.config import AccelType, Settings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import run, trace  # noqa: E402
from portbench.drivers.physics import gap_m  # noqa: E402
from portbench.reference.ensemble import SweepSceneReference  # noqa: E402

CUBES, ITERS, M = (3, 1, 1), 10, 5
# (speeds, iterations a frame, the scenes that reject in 3 frames): in the
# second sweep the 10 m/s scene rejects once (in its third frame), the
# others never. (At 30 m/s and more this small scene's tets invert, and the
# port and the reference part whether tiled or not.)
SWEEPS = {"gentle": ([0.5, 1.0, 2.0], ITERS, ()),
          "rejecting": ([0.5, 2.0, 5.0, 10.0], 40, (3,))}
# Program and reference are two float64 implementations of one algorithm
# that take the same branches: their positions differ by rounding, 5e-15
# to 1e-13 m here (the beams are 1 m tall), far inside 1e-10.
GAP = 1e-10
CELL = "beams-ensemble-8"
BENCH = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def settings(iters=ITERS):
    s = Settings()
    s.admm_iters, s.anderson_m, s.verbose = iters, M, 0
    s.acceleration_type = AccelType.ANDERSON
    s.dtype = np.dtype("float64")
    return s


def ref_cfg(iters=ITERS):
    return dict(cubes=list(CUBES), dt=Settings().timestep_s,
                gravity=Settings().gravity, admm_iters=iters, anderson_m=M)


@pytest.mark.parametrize("sweep", sorted(SWEEPS))
def test_each_scene_follows_its_reference(sweep):
    speeds, iters, rejecting = SWEEPS[sweep]
    _, sw = beams.build_sweep(settings(iters), speeds, device="cpu",
                              cubes=CUBES)
    refs = [SweepSceneReference(ref_cfg(iters), v, "cpu") for v in speeds]
    rejects = 0
    for _ in range(3):
        tr = sw.frame()
        rejects = rejects + tr.reject.sum(1)
        for s, r in enumerate(refs):
            assert gap_m(sw.xs[s].numpy(), r.frame()) < GAP
    assert [int(n) > 0 for n in rejects] == [s in rejecting
                                             for s in range(len(speeds))]


def test_published_speed_is_the_single_scene():
    """Scene 1 (1 m/s) of the sweep is the app's own scene: the tiled
    step solves its columns beside the others' with the same inverse and
    the same per-scene AA, so positions agree to rounding of the block
    solve's sums (bit for bit on this CPU) and traces alike."""
    _, sw = beams.build_sweep(settings(), [0.5, 1.0, 2.0], device="cpu",
                              cubes=CUBES)
    solver, stretch = beams.build_scene(settings(), device="cpu",
                                        cubes=CUBES)
    for _ in range(3):
        tr = sw.frame()
        stretch(solver.settings.timestep_s)
        one = solver.step()
        assert gap_m(sw.xs[1].numpy(), solver.x) < 1e-12
        assert torch.allclose(tr.prim[1], one.prim, rtol=1e-10, atol=0)
        assert torch.equal(tr.reject[1], one.reject)
        assert int(tr.reset_count[1]) == int(one.reset_count)


def test_speeds_part_the_scenes():
    """Each scene follows its own speed: after k frames its pins sit
    speed * (k + 1) * dt from rest along x, and the scenes' positions
    differ (their reject rows part in the rejecting sweep above)."""
    speeds = SWEEPS["gentle"][0]
    _, sw = beams.build_sweep(settings(), speeds, device="cpu", cubes=CUBES)
    ref = SweepSceneReference(ref_cfg(), 1.0, "cpu")
    k = 2
    for _ in range(k):
        sw.frame()
    rest = ref.rest_pins.numpy()
    for s, v in enumerate(speeds):
        moved = sw.xs[s].numpy()[ref.pins] - rest
        assert np.allclose(moved[:, 0], ref.side * v * (k + 1) * ref.dt,
                           rtol=0, atol=1e-12)
        assert not moved[:, 1:].any()
    for a in range(len(speeds)):
        for b in range(a):
            assert gap_m(sw.xs[a].numpy(), sw.xs[b].numpy()) > 1e-3


def test_spans_of_the_sweep():
    with timers.recording() as rec:
        _, sw = beams.build_sweep(settings(), [0.5, 1.0], device="cpu",
                                  cubes=CUBES)
    setup = rec.spans
    builds = [s for s in setup if s[0] == "setup.build"]
    # the scene's system (initialize) and its tile, both roots of the set-up
    assert len(builds) == 2 and all(s[3] is None for s in builds)
    with timers.recording() as rec:
        reads = []
        for _ in range(3):
            r0 = sw.counts["host_reads"]
            sw.frame()
            reads.append(sw.counts["host_reads"] - r0)
    spans = rec.spans
    roots = [i for i, s in enumerate(spans) if s[3] is None]
    assert [spans[i][0] for i in roots] == ["ensemble.step"] * 3
    for k, i in enumerate(roots):
        mine = [s for s in spans if s[4] == spans[i][4]]
        assert sum(s[0] == "sync" for s in mine) == reads[k] == ITERS
        assert sum(s[0] == "step.global" for s in mine) == ITERS
        assert not any(s[0].startswith("setup.") for s in mine)


def tiny():
    w, c = run.cell(BENCH, CELL)
    cfg = run.load_json(os.path.join(ROOT, c["file"]))
    mix = run.load_json(os.path.join(ROOT, "portbench", "mixes",
                                     w["traffic"] + ".json"))
    chk = run.load_json(os.path.join(ROOT, "portbench", "checks",
                                     CELL + ".json"))
    cfg.update(cubes=list(CUBES), admm_iters=ITERS, scenes=3,
               pin_speeds_m_s=[0.5, 1.0, 2.0])
    return dict(config=cfg, mix=mix, check=chk)


@pytest.mark.parametrize("traced", [0, 1])
def test_tiny_cell_is_correct(traced):
    res, checks = run.run_cell(BENCH, CELL, 2**31 + 11, 0.5, traced, "cpu",
                               overrides=tiny())
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert [c[0] for c in checks] == ["x_gap_m", "v_gap_m_s"]
    # a velocity is the frame's move over dt (1/30 s): its gap is the
    # positions' times 30, inside GAP * 30
    assert checks[0][1] < GAP and checks[1][1] < 30 * GAP
    if traced:
        # the CPU trace has no device events: only the counter reads
        assert res["metrics"]["physics.host_reads_per_frame"]["value"] \
            == ITERS
    else:
        assert set(res["metrics"]) == {"frame_ms", "setup_s"}


def test_swapped_speeds_are_not_correct(monkeypatch):
    """Two scenes' speeds swapped in the program: the warm-up frame of
    each is checked from the scene as built at its configured speed."""
    build = beams.build_sweep

    def swapped(settings, speeds, **kw):
        speeds = list(speeds)
        speeds[0], speeds[2] = speeds[2], speeds[0]
        return build(settings, speeds, **kw)

    monkeypatch.setattr(beams, "build_sweep", swapped)
    res, checks = run.run_cell(BENCH, CELL, 2**31 + 11, 0.5, 0, "cpu",
                               overrides=tiny())
    assert not res["correct"] and checks[0][1] > 1e-3


def test_swapped_velocities_are_not_correct(monkeypatch):
    """Two scenes' velocities swapped after every frame: each sampled
    frame's reference starts from the program's own (x, v), so the
    positions follow it; the velocities' gap alone finds the fault."""
    frame = beams.Sweep.frame

    def swapping(self):
        tr = frame(self)
        self.vs = self.vs[[1, 0, 2]]
        return tr

    monkeypatch.setattr(beams.Sweep, "frame", swapping)
    res, checks = run.run_cell(BENCH, CELL, 2**31 + 11, 0.5, 0, "cpu",
                               overrides=tiny())
    lims = tiny()["check"]["limits"]
    assert not res["correct"]
    assert checks[0][1] < GAP and checks[1][1] > lims["v_gap_m_s"]


def test_f32_control_is_not_correct():
    """The program built at float32 through the same ``build_sweep``, held
    by the driver's own check, fails both limits."""
    o = tiny()
    o["config"]["dtype"] = "float32"
    res, checks = run.run_cell(BENCH, CELL, 2**31 + 11, 0.5, 0, "cpu",
                               overrides=o)
    assert not res["correct"]
    assert all(v > lim for _, v, lim in checks)


def _ctx(counters, summary):
    return run.Context(counters, summary, {})


def test_readers_on_synthetic_contexts():
    events = [("kernel_a", True, 0.0, 0.2), ("kernel_b", True, 0.1, 0.3),
              ("Memcpy DtoH", True, 0.5, 0.6), ("Memset", True, 0.6, 0.65),
              ("cudaLaunchKernel", False, 0.0, 0.01)]
    s = trace.summarize(events, window_s=1.5, untraced_s=1.3)
    c = dict(frames=2, host_reads=200, scene_iters=1600, rejects=3)
    rd = {m: run.reader(ROOT, m) for m in (
        "ensemble.device_ms_per_scene_iter", "device.kernels_per_frame",
        "physics.host_reads_per_frame", "device.idle.frame")}
    busy = 0.3 + 0.15                       # [0, 0.3] and [0.5, 0.65]
    assert rd["ensemble.device_ms_per_scene_iter"](_ctx(c, s)) == \
        pytest.approx(1e3 * busy / 1600)
    assert rd["device.kernels_per_frame"](_ctx(c, s)) == 1.0
    assert rd["physics.host_reads_per_frame"](_ctx(c, s)) == 100.0
    assert rd["device.idle.frame"](_ctx(c, s)) == \
        pytest.approx(100.0 * (1 - busy / 1.3))
    # silent without a trace, device events or frames
    empty = trace.summarize([], window_s=1.0, untraced_s=1.0)
    for name, f in rd.items():
        assert f(_ctx({}, None)) is None, name
        if name != "physics.host_reads_per_frame":
            assert f(_ctx(c, empty)) is None, name
