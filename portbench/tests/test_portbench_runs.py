"""Whole runs of each cell at a tiny size on the CPU (the look for a chip
skipped): the plain references agree with the program, the controls and
the planted faults come out not correct, and a run on the card (marked
``cuda``) prints its result line."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import faults, run  # noqa: E402
from portbench.drivers import geometry, physics  # noqa: E402
from portbench.reference import wiremesh  # noqa: E402
from portbench.reference.physics import BeamsReference  # noqa: E402

BENCH = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
WIRE = ("wiremesh-maletorso-cold", "wiremesh-maletorso-warm")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(workload):
    """The cell's config, mix and check at a size a test run holds."""
    w, c = run.cell(BENCH, workload)
    cfg = run.load_json(os.path.join(ROOT, c["file"]))
    mix = run.load_json(os.path.join(ROOT, "portbench", "mixes",
                                     w["traffic"] + ".json"))
    chk = run.load_json(os.path.join(ROOT, "portbench", "checks",
                                     workload + ".json"))
    if cfg["driver"] == "geometry":
        cfg["design"]["grid_faces"] = 6
        cfg["reference_surface"]["n"] = 12
        mix["iterations"] = min(mix["iterations"], 8)
        mix["trace_units"] = 2
        if mix["kind"] == "noise":
            # a 6-face grid moves too little in 8 iterations for a solve
            # that moves nothing to show in the coordinates: more noise
            mix["noise_sigma"] = 0.3
    else:
        cfg["cubes"] = [3, 2, 2]
        cfg["admm_iters"] = 8
    return dict(config=cfg, mix=mix, check=chk)


def cell_run(workload, seed=2**31 + 5, trace=0, fault=None, **kw):
    o = tiny(workload)
    if fault is None:
        return run.run_cell(BENCH, workload, seed, 0.5, trace, "cpu",
                            overrides=o)
    with faults.planted(fault, **kw):
        return run.run_cell(BENCH, workload, seed, 0.5, trace, "cpu",
                            overrides=o)


@pytest.mark.parametrize("workload", WIRE + ("beams-published",))
@pytest.mark.parametrize("trace", [0, 1])
def test_run_is_correct(workload, trace):
    res, checks = cell_run(workload, trace=trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert checks and all(v <= lim for _, v, lim in checks)
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in run.metrics_for(BENCH, workload, kind)}
    assert set(res["metrics"]) <= names
    if not trace:
        assert set(res["metrics"]) == names
        assert all(m["value"] > 0 for m in res["metrics"].values())


@pytest.mark.parametrize("workload", WIRE)
@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_wire_fault_is_not_correct(workload, fault):
    res, _ = cell_run(workload, fault=fault, vertex=40, shift=0.5)
    assert not res["correct"] and res["failed"] >= 1


@pytest.mark.parametrize("fault", ["step_unchanged", "step_altered"])
def test_beams_fault_is_not_correct(fault):
    res, _ = cell_run("beams-published", fault=fault, vertex=7, shift=0.01)
    assert not res["correct"] and res["failed"] >= 1


@pytest.mark.parametrize("workload", WIRE)
def test_wire_control_is_not_correct(workload):
    """The reference in bfloat16 in the program's place fails a limit."""
    o = tiny(workload)
    d = geometry.Driver(o["config"], o["mix"], o["check"], 11, "cpu")
    d.setup()
    solve = lambda dtype: wiremesh.WireMeshReference(  # noqa: E731
        len(d.base), d.corners, d.edges, d.target, o["config"]["min_angle"],
        o["config"]["max_angle"], d.ref_tris, o["config"]["penalty"],
        o["config"]["closeness_weight"], "cpu", dtype=dtype).solve(
            x0, o["mix"]["iterations"], o["config"]["anderson_m"])
    x0 = d.request(0)
    r = d.readings(x0, solve(torch.bfloat16), solve(torch.float64))
    assert any(r[k] > lim for k, lim in o["check"]["limits"].items())


def test_beams_control_is_not_correct():
    """The reference in float32 in the program's place fails the limit."""
    o = tiny("beams-published")
    lim = o["check"]["limits"]["x_gap_m"]
    r64 = BeamsReference(o["config"], "cpu", torch.float64)
    r32 = BeamsReference(o["config"], "cpu", torch.float32)
    gaps = [physics.gap_m(r32.frame(), r64.frame()) for _ in range(2)]
    assert max(gaps) > lim


def test_wire_reference_follows_the_program_at_f64():
    """At float64 on the dense path the program and the reference take the
    same trials: the answers agree to rounding."""
    o = tiny("wiremesh-maletorso-cold")
    o["config"]["dtype"] = "float64"
    d = geometry.Driver(o["config"], o["mix"], o["check"], 3, "cpu")
    d.setup()
    x0 = d.request(0)
    xp = d._solve(x0, 20)
    xr = wiremesh.WireMeshReference(
        len(d.base), d.corners, d.edges, d.target, o["config"]["min_angle"],
        o["config"]["max_angle"], d.ref_tris, o["config"]["penalty"],
        o["config"]["closeness_weight"], "cpu").solve(x0, 20, 5)
    assert np.abs(xp - xr).max() < 1e-9 * d.target


def test_beams_reference_follows_the_program():
    o = tiny("beams-published")
    d = physics.Driver(o["config"], o["mix"], o["check"], 3, "cpu")
    d.setup()
    d.unit()
    d.unit()
    ref = BeamsReference(o["config"], "cpu")
    for xp, _ in d.warm + d.states:
        assert physics.gap_m(xp, ref.frame()) < 1e-12


@pytest.mark.parametrize("k", [1, 2, 8])
def test_closest_points_match_a_sweep(k):
    from portbench.reference.closest_point import (_sweep, closest_points,
                                                   triangle_groups)
    g = torch.Generator().manual_seed(0)
    tris = torch.rand((300, 3, 3), generator=g, dtype=torch.float64)
    p = 2 * torch.rand((500, 3), generator=g, dtype=torch.float64) - 0.5
    groups = triangle_groups(tris, size=16)
    a, b = closest_points(p, tris, groups, k=k, block=128), _sweep(p, tris)
    assert torch.allclose((a - p).norm(dim=-1), (b - p).norm(dim=-1),
                          rtol=0, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WIRE + ("beams-published",))
def test_cell_on_the_card(workload):
    """A short run of each cell on the card prints its result line."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", workload, "--seed", "12345", "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, timeout=900,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
