"""The port's host reads (core/timers.py ``host_read``) on the CPU: every
read the solvers make is one ``sync`` span, so under ``recording()`` the
spans equal the counts that ``stats`` and ``counts`` report, on every
path; those counts (and the work counts beside them) keep the values they
had before the reads were made in one place; and the count is kept per
thread.

The paths: the wire-mesh solve (subgroup cache, CG), a flat-cache solve
on the dense path, the plain geometry solver, an accelerated xzu step on
the dense and the CG path, ``run``, zxu on the CG path with a reject, the
instrumented xzu step with a ``SolverLog`` and the instrumented zxu step,
a chunked step, ``save_admm_state``, a two-scene ``Sweep`` frame and a zxu
step with self-collision."""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from aa_admm_tpu_torch.apps.beams import build_sweep
from aa_admm_tpu_torch.core import timers
from aa_admm_tpu_torch.core.config import AccelType, Lame, Settings
from aa_admm_tpu_torch.core.factory import make_tet_blocks
from aa_admm_tpu_torch.core.solverlog import SolverLog
from aa_admm_tpu_torch.ops.constraints import (AngleBatch, ClosenessBatch,
                                               EdgeLengthBatch, PlaneBatch,
                                               RefSurfaceBatch)
from aa_admm_tpu_torch.solver import physics as tphys
from aa_admm_tpu_torch.solver.geometry import ALMGeometrySolver
from aa_admm_tpu_torch.solver.geometry_plain import GeometrySolver


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- geometry ----

def _height_field(m, lo, hi, amp, fx, fy):
    """An m x m grid of heights amp sin(fx X) cos(fy Y) over [lo, hi]^2,
    triangulated to 2 (m - 1)^2 triangles."""
    u = np.linspace(lo, hi, m)
    X, Y = np.meshgrid(u, u, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel(),
                      (amp * np.sin(fx * X) * np.cos(fy * Y)).ravel()], 1)
    i, j = np.meshgrid(np.arange(m - 1), np.arange(m - 1), indexing="ij")
    a = (i * m + j).ravel()
    faces = np.concatenate([np.stack([a, a + m, a + 1], 1),
                            np.stack([a + m, a + m + 1, a + 1], 1)])
    return verts, faces


def _wire_mesh(reference, dense_threshold):
    """tests/test_torch_spans.py's 7 x 7-face noisy wire mesh (angle and
    edge-length constraints) held to `reference`: (solver, verts)."""
    n = 7
    xs, ys = np.meshgrid(np.arange(n + 1.0), np.arange(n + 1.0),
                         indexing="ij")
    rng = np.random.default_rng(4)
    verts = np.stack([xs.ravel(), ys.ravel(),
                      0.3 * rng.normal(size=xs.size)], 1)
    vid = lambda i, j: i * (n + 1) + j  # noqa: E731
    F = np.array([[vid(i, j), vid(i + 1, j), vid(i + 1, j + 1),
                   vid(i, j + 1)] for i in range(n) for j in range(n)])
    corners = np.concatenate([np.stack([F[:, i], F[:, (i + 1) % 4],
                                        F[:, (i + 3) % 4]], 1)
                              for i in range(4)])
    edges = np.unique(np.sort(np.concatenate(
        [F[:, [i, (i + 1) % 4]] for i in range(4)]), 1), axis=0)
    s = ALMGeometrySolver(dense_threshold=dense_threshold, device="cpu")
    s.add_soft_constraint(RefSurfaceBatch.create(list(range(len(verts))),
                                                 1.0, *reference))
    s.add_hard_constraint(AngleBatch.create(corners, 1.0, np.pi / 4,
                                            3 * np.pi / 4))
    s.add_hard_constraint(EdgeLengthBatch.create(edges, 1.0, 0.8))
    s.setup_ADMM(len(verts), 1000.0)
    return s, verts


_ALM_KEYS = ("host_reads", "cg_iters", "trials", "cp_refreshes",
             "energy_refreshes")


def _alm(solver, verts, **kw):
    def run():
        solver.solve_ADMM(verts, 1e-8, 12, 5, **kw)
        return {k: solver.stats[k] for k in _ALM_KEYS}
    return run


def wire_group_cg():
    """20,402 triangles: the subgroup cache; the CG path."""
    ref = _height_field(102, -15.0, 21.0, 0.3, 0.13, 0.09)
    return _alm(*_wire_mesh(ref, 0), cg_max_iters=15)


def flat_dense():
    """4,418 triangles: the flat cache (its candT layout); the dense
    inverse."""
    ref = _height_field(48, -1.0, 8.0, 0.2, 1.0, 1.0)
    return _alm(*_wire_mesh(ref, 12000))


def plain():
    """The plain solver on a noisy 4 x 4 quad grid (planarity hard,
    closeness soft), accelerated: the reset test and the Gram read."""
    rng = np.random.default_rng(0)
    xs, ys = np.meshgrid(np.arange(5.0), np.arange(5.0), indexing="ij")
    verts = np.stack([xs.ravel(), ys.ravel(),
                      0.2 * rng.normal(size=xs.size)], 1)
    faces = [[i * 5 + j, (i + 1) * 5 + j, (i + 1) * 5 + j + 1, i * 5 + j + 1]
             for i in range(4) for j in range(4)]
    s = GeometrySolver(device="cpu")
    s.add_hard_constraint(PlaneBatch.create(faces, weight=1.0))
    s.add_soft_constraint(ClosenessBatch.create(list(range(len(verts))),
                                                weight=1.0, targets=verts))
    s.setup_ADMM(len(verts), penalty_param=100.0)

    def run():
        s.solve_ADMM(verts, 1e-10, 30, 5)
        return {k: s.stats[k] for k in ("host_reads", "iters", "resets")}
    return run


# ---- physics ----

def _settings(iters, m=4, linear_solver="auto", **kw):
    s = Settings()
    s.admm_iters, s.verbose = iters, 0
    s.acceleration_type, s.anderson_m = AccelType.ANDERSON, m
    s.linear_solver = linear_solver
    for k, v in kw.items():
        setattr(s, k, v)
    return s


def _beam(settings, order="xzu"):
    """tests/test_torch_spans.py's 4 x 2 x 2 NeoHookean beam, -x end
    pinned."""
    mesh = make_tet_blocks(4, 2, 2)
    lo, hi = mesh.bounds()
    verts = (mesh.verts - 0.5 * (lo + hi)) / (hi - lo)[1]
    solver = tphys.PhysicsSolver(order=order, device="cpu")
    solver.add_tetmesh(verts, mesh.tets, Lame.from_young_poisson(1e6, 0.35),
                       kind="neohookean")
    solver.set_pins(np.nonzero(verts[:, 0] < verts[:, 0].min() + 1e-3)[0])
    solver.initialize(settings)
    return solver


def _stats(solver, call):
    def run():
        call(solver)
        return dict(solver.stats)
    return run


def beams_dense():
    return _stats(_beam(_settings(6)), lambda s: s.step())


def beams_cg():
    return _stats(_beam(_settings(6, linear_solver="cg")), lambda s: s.step())


def beams_run():
    return _stats(_beam(_settings(4, linear_solver="cg")), lambda s: s.run(2))


def _obstacles(settings):
    """tests/test_torch_zxu.py's block driven into five obstacles."""
    mesh = make_tet_blocks(2, 2, 2)
    solver = tphys.PhysicsSolver(order="zxu", device="cpu")
    solver.add_tetmesh(mesh.verts + [-0.93, -3.17, -1.07], mesh.tets,
                       Lame.rubber())
    solver.add_obstacle("floor", y=-2.0)
    solver.add_obstacle("slide_floor", center=[0.0, -3.0, 0.0],
                        normal=[0.5, np.sqrt(3.0) / 2.0, 0.0])
    solver.add_obstacle("sphere", center=[0.0, -2.0, 0.0], rad=0.5)
    solver.add_obstacle("plane_half_sphere", center=[0.0, -3.0, 0.0],
                        rad=1.0)
    solver.add_obstacle("cylinder", center=[0.0, -2.5, 0.0], rad=0.4)
    solver.set_collisions(list(range(len(mesh.verts))))
    solver.initialize(settings)
    return solver


def zxu_cg_reject():
    def call(s):
        tr = s.step()
        assert int(tr.reject.sum()) > 0
    return _stats(_obstacles(_settings(12, 5, "cg", cg_max_iters=40)), call)


def instrumented_xzu_log():
    def call(s):
        log = SolverLog()
        log.x_star = np.zeros(3 * s.n_verts)
        s.step_instrumented(log=log)
    return _stats(_beam(_settings(6, linear_solver="cg")), call)


def instrumented_zxu():
    return _stats(_obstacles(_settings(8, 5, "cg", cg_max_iters=40)),
                  lambda s: s.step_instrumented())


def chunked():
    return _stats(_beam(_settings(6, linear_solver="cg", trace_chunk=4)),
                  lambda s: s.step())


def save_admm_state(tmp_path):
    return _stats(_beam(_settings(6, linear_solver="cg")),
                  lambda s: s.save_admm_state(
                      str(tmp_path / "zu.txt"), str(tmp_path / "x.txt"),
                      at_iteration=3, aa_file=str(tmp_path / "aa.npz")))


def sweep():
    _, sw = build_sweep(_settings(5, 5), [0.5, 1.5], device="cpu",
                        cubes=(2, 1, 1))

    def run():
        sw.frame()
        return dict(sw.counts)
    return run


def zxu_selfcol():
    """tests/test_torch_zxu.py's block falling onto a pinned slab, both
    self-colliding, three steps (contacts in the last)."""
    bottom, top = make_tet_blocks(2, 1, 2), make_tet_blocks(1, 1, 1)
    solver = tphys.PhysicsSolver(order="zxu", device="cpu")
    o0 = solver.add_tetmesh(bottom.verts, bottom.tets, Lame.rubber(),
                            self_collision=True)
    solver.add_tetmesh(top.verts + [0.5, 1.05, 0.5], top.tets, Lame.rubber(),
                       self_collision=True)
    solver.set_pins(list(range(o0, o0 + len(bottom.verts))))
    solver.initialize(_settings(6, 5))

    def call(s):
        for _ in range(3):
            s.step()
    return _stats(solver, call)


PATHS = dict(wire_group_cg=wire_group_cg, flat_dense=flat_dense, plain=plain,
             beams_dense=beams_dense, beams_cg=beams_cg, beams_run=beams_run,
             zxu_cg_reject=zxu_cg_reject,
             instrumented_xzu_log=instrumented_xzu_log,
             instrumented_zxu=instrumented_zxu, chunked=chunked,
             save_admm_state=save_admm_state, sweep=sweep,
             zxu_selfcol=zxu_selfcol)


def _build(name, tmp_path):
    make = PATHS[name]
    return make(tmp_path) if name == "save_admm_state" else make()


# Each path's counts, read on the tree before host_read, with the same
# seeds and sizes.
COUNTS = dict(
    wire_group_cg=dict(host_reads=219, cg_iters=180, trials=12,
                       cp_refreshes=5, energy_refreshes=1),
    flat_dense=dict(host_reads=39, cg_iters=0, trials=12, cp_refreshes=3,
                    energy_refreshes=2),
    plain=dict(host_reads=60, iters=30, resets=12),
    beams_dense=dict(host_reads=6, cg_iters=0),
    beams_cg=dict(host_reads=279, cg_iters=254),
    beams_run=dict(host_reads=398, cg_iters=364),
    zxu_cg_reject=dict(host_reads=205, cg_iters=168),
    instrumented_xzu_log=dict(host_reads=311, cg_iters=274),
    instrumented_zxu=dict(host_reads=150, cg_iters=116),
    chunked=dict(host_reads=279, cg_iters=254),
    save_admm_state=dict(host_reads=279, cg_iters=254),
    sweep=dict(host_reads=5, cg_iters=0),
    zxu_selfcol=dict(host_reads=39, cg_iters=0))


@pytest.mark.parametrize("path", list(PATHS))
def test_sync_spans_equal_host_reads(path, tmp_path):
    run = _build(path, tmp_path)
    with timers.recording() as rec:
        counts = run()
    syncs = sum(1 for s in rec.spans if s[0] == "sync")
    assert counts["host_reads"] > 0
    assert syncs == counts["host_reads"]


@pytest.mark.parametrize("path", list(PATHS))
def test_counts_unchanged(path, tmp_path):
    assert _build(path, tmp_path)() == COUNTS[path]


def test_host_reads_are_per_thread():
    """More threads than cores, switching often: thread i reads 3 + i
    times and sees exactly that many (a count shared between threads, or
    a lost update, would show)."""
    t = torch.zeros(())
    n = (os.cpu_count() or 1) + 2
    seen, start = [None] * n, threading.Barrier(n)

    def reads(i):
        r0 = timers.host_reads()
        start.wait()
        for _ in range(3 + i):
            timers.host_read(t)
        seen[i] = timers.host_reads() - r0

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=reads, args=(i,))
                   for i in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert seen == [3 + i for i in range(n)]
