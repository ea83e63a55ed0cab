"""The port's program spans (core/timers.py ``span``/``recording``) on the
CPU: recording off keeps nothing and reads no clock; a wire-mesh solve and
a beams step give the same answers bit for bit with recording off and on;
the ``sync`` spans of a solve and of a step are the host reads its
``stats`` count; spans nest as the solvers open them; and the spans land
on torch.profiler's clock."""

import itertools
import time
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aa_admm_tpu_torch.core import timers
from aa_admm_tpu_torch.core.config import AccelType, Lame, Settings
from aa_admm_tpu_torch.core.factory import make_tet_blocks
from aa_admm_tpu_torch.ops.constraints import (AngleBatch, EdgeLengthBatch,
                                               RefSurfaceBatch)
from aa_admm_tpu_torch.solver import physics as tphys
from aa_admm_tpu_torch.solver.geometry import ALMGeometrySolver


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _by_name(spans, name):
    return [i for i, s in enumerate(spans) if s[0] == name]


def _ancestors(spans, i):
    out, p = [], spans[i][3]
    while p is not None:
        out.append(spans[p][0])
        p = spans[p][3]
    return out


def _check_tree(spans):
    """Every span is closed inside its parent and carries its root's
    request; roots number 0, 1, ... in order."""
    roots = 0
    for i, (_, s, e, parent, req) in enumerate(spans):
        assert e is not None and e >= s
        if parent is None:
            assert req == roots
            roots += 1
        else:
            ps, pe = spans[parent][1:3]
            assert parent < i and ps <= s and e <= pe
            assert req == spans[parent][4]


# ---- the recorder ----

def test_recording_off_keeps_nothing_and_reads_no_clock(monkeypatch):
    assert timers._active is None
    assert timers.span("solve") is timers.span("sync")

    def no_clock():
        raise AssertionError("a span read the clock with recording off")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    loop = itertools.repeat(None, 10_000)
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        for _ in loop:
            with timers.span("sync"):
                pass
        after = tracemalloc.get_traced_memory()[0]
    finally:
        tracemalloc.stop()
    assert after == before


def test_recordings_do_not_nest():
    with timers.recording() as rec:
        with timers.span("a"):
            with timers.span("b"):
                pass
        with timers.span("c"):
            pass
        with pytest.raises(RuntimeError):
            with timers.recording():
                pass
    assert timers._active is None
    assert [(n, p, r) for n, _, _, p, r in rec.spans] == [
        ("a", None, 0), ("b", 0, 0), ("c", None, 1)]
    _check_tree(rec.spans)


def test_spans_on_the_profiler_clock():
    """A span around a torch op holds the op's kineto event once moved onto
    the profiler's clock (50 us allowed for the two clocks' pairing)."""
    a = torch.randn(256, 256, dtype=torch.float64)
    with timers.recording() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with timers.span("mm"):
                torch.mm(a, a)
    (_, s, e, _, _), = rec.profiler_spans()
    ev = [x for x in prof.profiler.kineto_results.events()
          if x.name() == "aten::mm"]
    assert len(ev) == 1
    slack = 50_000
    assert ev[0].start_ns() >= s - slack
    assert ev[0].start_ns() + ev[0].duration_ns() <= e + slack


# ---- the wire mesh: a CG solve through the closest-point cache ----

def _wire_solver():
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
    m = 48     # 4,418 reference triangles: the closest-point cache is on
    u = np.linspace(-1.0, n + 1.0, m)
    X, Y = np.meshgrid(u, u, indexing="ij")
    rv = np.stack([X.ravel(), Y.ravel(),
                   (0.2 * np.sin(X) * np.cos(Y)).ravel()], 1)
    i, j = np.meshgrid(np.arange(m - 1), np.arange(m - 1), indexing="ij")
    a = (i * m + j).ravel()
    rf = np.concatenate([np.stack([a, a + m, a + 1], 1),
                         np.stack([a + m, a + m + 1, a + 1], 1)])
    s = ALMGeometrySolver(dense_threshold=0, device="cpu")
    s.add_soft_constraint(RefSurfaceBatch.create(list(range(len(verts))),
                                                 1.0, rv, rf))
    s.add_hard_constraint(AngleBatch.create(corners, 1.0, np.pi / 4,
                                            3 * np.pi / 4))
    s.add_hard_constraint(EdgeLengthBatch.create(edges, 1.0, 0.8))
    return s, verts


def test_wire_mesh_solve_spans():
    off, x0 = _wire_solver()
    off.setup_ADMM(len(x0), 1000.0)
    off.solve_ADMM(x0, 1e-8, 12, 5, cg_max_iters=15)
    with timers.recording() as rec:
        on, _ = _wire_solver()
        on.setup_ADMM(len(x0), 1000.0)
        on.solve_ADMM(x0, 1e-8, 12, 5, cg_max_iters=15)
    np.testing.assert_array_equal(on.get_solution(), off.get_solution())
    assert on.function_values == off.function_values
    assert on.stats["cg_iters"] > 0

    spans = rec.spans
    _check_tree(spans)
    roots = [s[0] for s in spans if s[3] is None]
    assert roots == ["setup.build", "solve"]
    solve, = _by_name(spans, "solve")
    loops = _by_name(spans, "alm.loop")
    assert len(loops) == 1 and spans[loops[0]][3] == solve
    assert [spans[i][3] for i in _by_name(spans, "solve.energy")] == [
        solve, solve]
    for name in ("local", "global"):
        idx = _by_name(spans, name)
        assert len(idx) == on.stats["trials"]
        assert all(spans[i][3] == loops[0] for i in idx)
    syncs = _by_name(spans, "sync")
    parents = [spans[spans[i][3]][0] for i in syncs]
    # the loop test, the cache test (local), the CG tests (global) and the
    # Gram read (the loop itself)
    assert set(parents) == {"alm.loop", "local", "global"}
    assert parents.count("local") == on.stats["trials"]
    # the loop's sync spans are the reads stats count, no more, no fewer
    assert len(syncs) == on.stats["host_reads"]


# ---- beams: one accelerated step, dense and CG ----

def _beam_solver(linear_solver):
    mesh = make_tet_blocks(4, 2, 2)
    lo, hi = mesh.bounds()
    mesh.verts = (mesh.verts - 0.5 * (lo + hi)) / (hi - lo)[1]
    s = Settings()
    s.admm_iters, s.verbose = 6, 0
    s.acceleration_type, s.anderson_m = AccelType.ANDERSON, 4
    s.linear_solver = linear_solver
    solver = tphys.PhysicsSolver(device="cpu")
    solver.add_tetmesh(mesh.verts, mesh.tets,
                       Lame.from_young_poisson(1e6, 0.35), kind="neohookean")
    solver.set_pins([i for i, v in enumerate(mesh.verts)
                     if v[0] < mesh.verts[:, 0].min() + 1e-3])
    solver.initialize(s)
    return solver


@pytest.mark.parametrize("linear_solver", ["dense", "cg"])
def test_beams_step_spans(linear_solver):
    off = _beam_solver(linear_solver)
    off.step()
    with timers.recording() as rec:
        on = _beam_solver(linear_solver)
        on.step()
    np.testing.assert_array_equal(on.x, off.x)
    np.testing.assert_array_equal(on.v, off.v)

    spans = rec.spans
    _check_tree(spans)
    assert [s[0] for s in spans if s[3] is None] == ["setup.build", "step"]
    step, = _by_name(spans, "step")
    iters = on.settings.admm_iters
    assert len(_by_name(spans, "step.global")) == iters
    assert len(_by_name(spans, "step.local")) == 2 * iters
    assert len(_by_name(spans, "step.comb")) == iters
    for name in ("step.local", "step.global", "step.comb"):
        assert all(spans[i][3] == step for i in _by_name(spans, name))
    # the combined residual's solve and z-update open no phase of their own
    for i, s in enumerate(spans):
        if s[0] != "sync":
            assert "step.comb" not in _ancestors(spans, i)
    syncs = _by_name(spans, "sync")
    assert all(spans[i][4] == spans[step][4] for i in syncs)
    assert len(syncs) == on.stats["host_reads"]
    if linear_solver == "cg":
        assert on.stats["cg_iters"] > 0
    else:
        assert len(syncs) == iters
