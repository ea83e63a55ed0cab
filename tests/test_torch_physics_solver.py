"""The port's physics solver on its own, at f64 on the CPU, on the small
scene of tests/test_physics.py and on beams: CG against the dense inverse,
``run`` against repeated ``step`` with moving pins, the residual file, pins
and gravity, what ``initialize`` accepts and refuses in each order, and the
entry points' device rule (tests/test_torch_physics.py and
tests/test_torch_zxu.py hold the port against the JAX package and the C++
golden)."""

import numpy as np
import pytest
import torch

from aa_admm_tpu_torch.apps import beams as tbeams
from aa_admm_tpu_torch.apps import plinkohit as thit
from aa_admm_tpu_torch.apps import plinkopony as tpony
from aa_admm_tpu_torch.apps import windyflag as tflag
from aa_admm_tpu_torch.core.config import AccelType, Lame, Settings
from aa_admm_tpu_torch.core.factory import make_plane_grid, make_tet_blocks
from aa_admm_tpu_torch.core.meshio import save_elenode, save_obj
from aa_admm_tpu_torch.ops import cuda_kernels as ck
from aa_admm_tpu_torch.ops.elements import TetBatch
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
    """zxu and wind initialize (and step); obstacles, collision terms and
    dynamic colliders with xzu raise ValueError, as in the JAX package;
    trace_chunk > 0 initializes and steps (chunked residual tracing)."""
    mesh = make_tet_blocks(2, 1, 1)
    s = _settings(False, 2)

    def fresh(order="xzu"):
        sv = tphys.PhysicsSolver(order=order, device="cpu")
        sv.add_tetmesh(mesh.verts, mesh.tets, Lame.rubber())
        return sv

    sv = fresh("zxu")
    sv.add_obstacle("floor", y=-2.0)
    sv.set_collisions(range(len(mesh.verts)))
    sv.set_wind(mesh.tets[:, :3], np.ones(3))
    assert sv.initialize(s)
    assert sv.system.order == "zxu" and sv.system.wind is not None
    sv.step()
    assert np.isfinite(sv.x).all()
    sv = fresh()
    sv.set_wind(mesh.tets[:, :3], np.ones(3), mode="sequential")
    assert sv.initialize(s)
    with pytest.raises(ValueError, match="wind mode"):
        sv.set_wind(mesh.tets[:, :3], np.ones(3), mode="gusty")
    for refuse in (lambda sv: sv.add_obstacle("floor", y=-2.0),
                   lambda sv: sv.add_obstacle("mesh", verts=mesh.verts,
                                              tets=mesh.tets),
                   lambda sv: sv.set_collisions([0, 1]),
                   lambda sv: sv.add_dynamic_collider(mesh.verts, mesh.tets)):
        sv = fresh()
        refuse(sv)
        with pytest.raises(ValueError):
            sv.initialize(s)
    sv = fresh()
    s.trace_chunk = 4
    assert sv.initialize(s)
    sv.step()
    sv.flush_traces()
    assert len(sv.step_prim) == s.admm_iters and np.isfinite(sv.x).all()


def _mesh_files(tmp_path):
    """A tet block as .ele/.node and a cloth as .obj."""
    block = str(tmp_path / "block")
    save_elenode(block, make_tet_blocks(2, 1, 1))
    cloth = str(tmp_path / "cloth.obj")
    grid = make_plane_grid(4, 4)
    save_obj(cloth, grid.verts, grid.faces)
    return block, cloth


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only rule")
def test_entry_points_need_cuda(tmp_path):
    s = _settings(False, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tphys.PhysicsSolver()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbeams.build_scene(s)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbeams.main(["-it", "2"], n_frames=1)
    block, cloth = _mesh_files(tmp_path)
    for app, path in ((thit, block), (tpony, block), (tflag, cloth)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            app.build_scene(s, mesh_path=path)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            app.main(["-it", "2", "--mesh", path], n_frames=1,
                     result_dir=str(tmp_path / "r"))
        assert app.build_scene(s, mesh_path=path,
                               device="cpu").device.type == "cpu"


@pytest.mark.cuda
@pytest.mark.parametrize("accel", [False, True], ids=["noacc", "aa4"])
@pytest.mark.parametrize("linear_solver", ["dense", "cg"])
def test_cuda_graphs_match_eager_on_card(accel, linear_solver):
    """On the card the tet batches' prox and gradient are one kernel launch
    a call (ops/cuda_kernels.py tet_prox, tet_grad) and the CG operator
    replays a CUDA graph; the step, first call (capture) and second
    (replay), must match the eager step on the CPU (the x-step's scatter
    sums in a varying order on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    mesh = make_tet_blocks(4, 2, 2)
    iters = 20
    s = _settings(accel, iters)
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
        ck.reset_launch_counts()
        for call in range(2 if dev == "cuda" else 1):
            xn, _, tr = tphys.step_xzu(solver.system, *args)
            out[dev, call] = (xn.cpu().numpy(), tr.prim.cpu().numpy())
    # no tet batch replays a graph: on the CG path the operator does
    assert all(isinstance(b, TetBatch) for b in solver.system.batches)
    assert set(solver.system.__dict__.get("_graphs", {})) == (
        {"A"} if linear_solver == "cg" else set())
    # the tet batches' launches over the two steps: each batch's prox in
    # the set-up and in each iteration's z-update (and, accelerated, in its
    # combined residual); its gradient in each accelerated iteration
    per_iter = 2 if accel else 1
    assert ck.launch_counts()["tet_prox"] == 2 * 3 * (per_iter * iters + 1)
    assert ck.launch_counts()["tet_grad"] == (2 * 3 * iters if accel else 0)
    for key in (("cuda", 0), ("cuda", 1)):
        np.testing.assert_allclose(out[key][0], out["cpu", 0][0],
                                   rtol=1e-8, atol=1e-9)
        np.testing.assert_allclose(out[key][1], out["cpu", 0][1],
                                   rtol=1e-8, atol=1e-9 * out[key][1][0])


@pytest.mark.cuda
def test_graphed_zxu_step_after_contact_refresh_on_card(monkeypatch):
    """On the card the self-collision prox replays a CUDA graph that reads
    the contacts copied into its batch each step. Over steps whose contact
    set changes (empty, then the landing block's, then empty again), every
    graph replay must give exactly what the eager call gives on the same
    input and contacts, and the contacts detected on the card must equal
    the CPU's from the same state.

    Whole steps are not compared with the CPU's: the hard snap turns
    roundoff into up to 3.8e-7 of x in a contact step (a one-ulp nudge of
    the state does that on the CPU alone), and a graph sums in its own
    order (steps without contacts agree to 4e-15, measured on an H100)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    bottom, top = make_tet_blocks(2, 1, 2), make_tet_blocks(1, 1, 1)
    s = _settings(False, 10)
    solvers = {}
    for dev in ("cpu", "cuda"):
        sv = tphys.PhysicsSolver(order="zxu", device=dev)
        o0 = sv.add_tetmesh(bottom.verts, bottom.tets, Lame.rubber(),
                            self_collision=True)
        sv.add_tetmesh(top.verts + [0.5, 1.05, 0.5], top.tets, Lame.rubber(),
                       self_collision=True)
        sv.set_pins(list(range(o0, o0 + len(bottom.verts))))
        sv.initialize(s)
        solvers[dev] = sv
    gpu, cpu = solvers["cuda"], solvers["cpu"]

    replays = []
    graphed = tphys._graphed

    def checked(system, key, fn, x):
        y = graphed(system, key, fn, x)
        replays.append((key, torch.equal(y, fn(x))))
        return y

    monkeypatch.setattr(tphys, "_graphed", checked)
    tet_calls = {"prox": 0, "grad": 0}
    for op in tet_calls:
        def counted(self, x, _op=op, _fn=getattr(TetBatch, op)):
            tet_calls[_op] += x.is_cuda and x.shape[-1] > 0
            return _fn(self, x)
        monkeypatch.setattr(TetBatch, op, counted)
    ck.reset_launch_counts()
    counts = []
    for _ in range(6):
        cpu.x = gpu.x                        # the same state on both
        cpu._refresh_self_contacts()
        gpu.step()
        bg = gpu.system.batches[gpu._selfcol_index]
        bc = cpu.system.batches[cpu._selfcol_index]
        np.testing.assert_array_equal(bg.active.cpu().numpy(),
                                      bc.active.numpy())
        for name in ("target", "normal"):
            np.testing.assert_allclose(getattr(bg, name).cpu().numpy(),
                                       getattr(bc, name).numpy(),
                                       rtol=1e-12, atol=1e-12)
        counts.append(int(bc.active.sum()))
        assert np.isfinite(gpu.x).all()
    assert counts[0] == 0 and max(counts) > 0 and counts[-1] == 0, counts
    assert replays and all(ok for _, ok in replays), \
        sorted({k for k, ok in replays if not ok})
    # a graph for each batch but the tet batches, which launch one kernel
    # a call on the card
    others = [b for b in gpu.system.batches if not isinstance(b, TetBatch)]
    assert 0 < len(others) < len(gpu.system.batches)
    assert len(gpu.system.__dict__["_graphs"]) == len(others)
    assert tet_calls["prox"] > 0
    assert ck.launch_counts()["tet_prox"] == tet_calls["prox"]
    assert ck.launch_counts()["tet_grad"] == tet_calls["grad"]
