"""The port's xzu physics solver on its own, at f64 on the CPU, on the small
scene of tests/test_physics.py and on beams: CG against the dense inverse,
``run`` against repeated ``step`` with moving pins, the residual file, pins
and gravity, the parts that ``initialize`` refuses until they are ported,
and the entry points' device rule (tests/test_torch_physics.py holds the
port against the JAX package and the C++ golden)."""

import numpy as np
import pytest
import torch

from aa_admm_tpu_torch.apps import beams as tbeams
from aa_admm_tpu_torch.core.config import AccelType, Lame, Settings
from aa_admm_tpu_torch.core.factory import make_tet_blocks
from aa_admm_tpu_torch.solver import physics as tphys


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Single-threaded torch: the slice's element batches are small, and
    OpenMP workers spinning between thousands of tiny ops starve the other
    test processes (a beams step took 15x longer with three running)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _settings(accel, iters):
    s = Settings()
    s.admm_iters = iters
    s.verbose = 0
    if accel:
        s.acceleration_type = AccelType.ANDERSON
        s.anderson_m = 4
    return s


def _small_beam_solver(kind="linear", accel=False, iters=25,
                       linear_solver="auto"):
    """tests/test_physics.py's small scene in the port."""
    mesh = make_tet_blocks(4, 2, 2)
    lo, hi = mesh.bounds()
    mesh.verts = (mesh.verts - 0.5 * (lo + hi)) / (hi - lo)[1]
    s = _settings(accel, iters)
    s.linear_solver = linear_solver
    solver = tphys.PhysicsSolver(device="cpu")
    solver.add_tetmesh(mesh.verts, mesh.tets,
                       Lame.from_young_poisson(1e6, 0.35), kind=kind)
    pins = [i for i, v in enumerate(mesh.verts)
            if v[0] < mesh.verts[:, 0].min() + 1e-3]
    solver.set_pins(pins)
    solver.initialize(s)
    return solver, pins


@pytest.mark.parametrize("accel", [False, True], ids=["noacc", "aa4"])
def test_cg_matches_dense(accel):
    d, _ = _small_beam_solver(kind="neohookean", accel=accel,
                              linear_solver="dense")
    c, _ = _small_beam_solver(kind="neohookean", accel=accel,
                              linear_solver="cg")
    assert d.system.solver is not None and c.system.solver is None
    td, tc = d.step(), c.step()
    np.testing.assert_allclose(d.x, c.x, rtol=1e-8, atol=1e-10)
    # tests/test_physics.py's bounds; accelerated, the late residuals (below
    # 1e-9 of the first) carry the CG solves' 1e-12 tolerance
    pd, pc = td.prim.numpy(), tc.prim.numpy()
    np.testing.assert_allclose(pd, pc, rtol=1e-6,
                               atol=1e-9 * pd[0] if accel else 1e-10)
    # the CG path reads its loop tests (and, accelerated, the reject test)
    assert c.stats["cg_iters"] > 0
    assert c.stats["host_reads"] > d.stats["host_reads"]


def test_run_matches_stepwise_with_moving_pins():
    s = _settings(True, 8)
    a, stretch_a = tbeams.build_scene(s, device="cpu")
    b, stretch_b = tbeams.build_scene(s, device="cpu")
    for _ in range(3):
        stretch_a(s.timestep_s)
        a.step()
    b.run(3, pin_vel=stretch_b.pin_velocity)
    a.flush_traces()
    b.flush_traces()
    np.testing.assert_allclose(b.x, a.x, rtol=0, atol=1e-12)
    np.testing.assert_allclose(b.v, a.v, rtol=0, atol=1e-9)
    np.testing.assert_allclose(b.pin_pos, a.pin_pos, rtol=0, atol=1e-12)
    np.testing.assert_allclose(b.step_prim, a.step_prim, rtol=1e-12)
    np.testing.assert_allclose(b.step_comb, a.step_comb, rtol=1e-12)
    assert b.step_reject == a.step_reject
    stretch_a(s.timestep_s)
    a.step()
    stretch_b(s.timestep_s)
    b.step()
    np.testing.assert_allclose(b.x, a.x, rtol=0, atol=1e-12)
    # the pins moved by +/- 1 m/s * dt per frame (plus the initial placement)
    pins = list(b.pins)
    moved = np.abs(b.x[pins, 0] - np.concatenate(b.verts)[pins, 0])
    np.testing.assert_allclose(moved, 5 * s.timestep_s, rtol=1e-9)


def test_residual_file_format(tmp_path):
    solver, _ = _small_beam_solver(iters=10)
    solver.step()
    solver.save(str(tmp_path))
    rows = [line.split("\t") for line in
            (tmp_path / "residual-no.txt").read_text().strip().split("\n")]
    assert len(rows) == 10 and len(rows[0]) == 3
    times = [float(r[0]) for r in rows]
    assert all(t1 >= t0 for t0, t1 in zip(times, times[1:]))
    prim = [float(r[1]) for r in rows]
    assert prim[-1] < prim[0]


def test_pins_hold_and_bodies_fall():
    solver, pins = _small_beam_solver(kind="stvk", iters=20)
    x0 = solver.x.copy()
    for _ in range(3):
        solver.step()
    np.testing.assert_allclose(solver.x[pins], x0[pins], atol=1e-12)
    free = np.setdiff1d(np.arange(len(x0)), pins)
    assert solver.x[free, 1].mean() < x0[free, 1].mean()
    assert np.isfinite(solver.x).all() and np.isfinite(solver.v).all()


def test_initialize_refuses_unported_parts():
    mesh = make_tet_blocks(2, 1, 1)
    s = _settings(False, 2)

    def fresh(order="xzu"):
        sv = tphys.PhysicsSolver(order=order, device="cpu")
        sv.add_tetmesh(mesh.verts, mesh.tets, Lame.rubber())
        return sv

    with pytest.raises(NotImplementedError):
        fresh("zxu").initialize(s)
    sv = fresh()
    sv.add_obstacle("floor", y=-2.0)
    with pytest.raises(ValueError):
        sv.initialize(s)
    sv = fresh()
    sv.set_wind(np.zeros((1, 3), np.int64), np.ones(3))
    with pytest.raises(NotImplementedError):
        sv.initialize(s)
    sv = fresh()
    s.trace_chunk = 4
    with pytest.raises(NotImplementedError):
        sv.initialize(s)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only rule")
def test_entry_points_need_cuda():
    s = _settings(False, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tphys.PhysicsSolver()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbeams.build_scene(s)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbeams.main(["-it", "2"], n_frames=1)


@pytest.mark.cuda
@pytest.mark.parametrize("accel", [False, True], ids=["noacc", "aa4"])
@pytest.mark.parametrize("linear_solver", ["dense", "cg"])
def test_cuda_graphs_match_eager_on_card(accel, linear_solver):
    """On the card the prox, gradient and CG operator replay CUDA graphs;
    the step, first call (capture) and second (replay), must match the
    eager step on the CPU (the x-step's scatter sums in a varying order on
    the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    mesh = make_tet_blocks(4, 2, 2)
    s = _settings(accel, 20)
    s.linear_solver = linear_solver
    out = {}
    for dev in ("cpu", "cuda"):
        solver = tphys.PhysicsSolver(device=dev)
        for kind, dy in (("linear", 0.0), ("neohookean", 2.0), ("stvk", 4.0)):
            solver.add_tetmesh(mesh.verts + [0.0, dy, 0.0], mesh.tets,
                               Lame.from_young_poisson(1e6, 0.35), kind=kind)
        x = np.concatenate(solver.verts)
        solver.set_pins(np.nonzero(x[:, 0] < 1e-3)[0])
        solver.initialize(s)
        args = (solver._x_dev, solver._v_dev, solver._pin_pos_dev())
        for call in range(2 if dev == "cuda" else 1):
            xn, _, tr = tphys.step_xzu(solver.system, *args)
            out[dev, call] = (xn.cpu().numpy(), tr.prim.cpu().numpy())
    assert len(solver.system.__dict__["_graphs"]) > 0
    for key in (("cuda", 0), ("cuda", 1)):
        np.testing.assert_allclose(out[key][0], out["cpu", 0][0],
                                   rtol=1e-8, atol=1e-9)
        np.testing.assert_allclose(out[key][1], out["cpu", 0][1],
                                   rtol=1e-8, atol=1e-9 * out[key][1][0])
