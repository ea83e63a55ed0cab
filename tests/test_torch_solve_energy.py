"""The solve's two soft energies through the loop's closest-point cache
(``ALMGeometrySolver.solve_ADMM``, ``soft_energy_delta`` in
aa_admm_tpu_torch/solver/geometry.py) on the CPU.

A 7 x 7-face noisy wire mesh on the CG path, held to a reference surface of
three sizes: tests/test_torch_geometry.py's height field (20,402 triangles,
the subgroup cache), a 48 x 48 grid (4,418 triangles, the flat cache) and a
40 x 40 grid (3,042 triangles: no cache, the uncached sweep), at f64 and
f32. The initial mesh is exact in f32, so both precisions project the same
points as the uncached ``soft_energy`` does.

* The printed ``Init energy`` and ``final energy`` equal the uncached
  ``soft_energy`` of the initial mesh and of the solution (rtol 1e-12 at
  f64, 1e-5 at f32); on the flat cache also the brute-force
  ``closest_point_on_mesh``'s.
* On a cached reference the energies refresh once or twice
  (``stats["energy_refreshes"]``); every refresh the solve makes is one the
  stats count (``cp_refreshes`` + ``energy_refreshes``); the loop's first
  trial takes the fast path on the cache the initial energy built.
* The seeded loop's answer is the unseeded loop's (``solve_alm``, whose
  first trial refreshes), bit for bit; with no cache nothing refreshes.
* On the card (``cuda``): the same at MaleTorso's size (the benchmark's
  120 x 120-face design against its 144-grid field), the energies' device
  time under 40 ms a solve.
"""

import json
import os
import re
import time

import numpy as np
import pytest
import torch

from aa_admm_tpu_torch.ops import closest_point as cp
from aa_admm_tpu_torch.ops.constraints import (AngleBatch, EdgeLengthBatch,
                                               RefSurfaceBatch)
from aa_admm_tpu_torch.solver import geometry as tg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _height_field(n=102, lo=-15.0, hi=21.0):
    """tests/test_torch_geometry.py's reference: 20,402 triangles (above
    the subgroup-cache threshold of 20,000)."""
    u = np.linspace(lo, hi, n)
    X, Y = np.meshgrid(u, u, indexing="ij")
    Z = 0.3 * np.sin(0.13 * X) * np.cos(0.09 * Y)
    verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], 1)
    i, j = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    a = (i * n + j).ravel()
    b = a + n
    faces = np.concatenate([np.stack([a, b, a + 1], 1),
                            np.stack([b, b + 1, a + 1], 1)])
    return verts, faces


def _wavy_grid(m, lo=-1.0, hi=8.0):
    """z = 0.2 sin x cos y on an m x m vertex grid: 2 (m-1)^2 triangles."""
    u = np.linspace(lo, hi, m)
    X, Y = np.meshgrid(u, u, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel(),
                      (0.2 * np.sin(X) * np.cos(Y)).ravel()], 1)
    i, j = np.meshgrid(np.arange(m - 1), np.arange(m - 1), indexing="ij")
    a = (i * m + j).ravel()
    faces = np.concatenate([np.stack([a, a + m, a + 1], 1),
                            np.stack([a + m, a + m + 1, a + 1], 1)])
    return verts, faces


REFS = {"group": _height_field, "flat": lambda: _wavy_grid(48),
        "uncached": lambda: _wavy_grid(40)}


def _solver(ref, dtype):
    """The wire mesh (f32-exact noisy 8 x 8 vertices; Angle and EdgeLength
    hard, the reference surface soft) set up on the CG path."""
    n = 7
    xs, ys = np.meshgrid(np.arange(n + 1.0), np.arange(n + 1.0),
                         indexing="ij")
    rng = np.random.default_rng(4)
    verts = np.stack([xs.ravel(), ys.ravel(),
                      0.3 * rng.normal(size=xs.size)], 1)
    verts = verts.astype(np.float32).astype(np.float64)
    vid = lambda i, j: i * (n + 1) + j  # noqa: E731
    F = np.array([[vid(i, j), vid(i + 1, j), vid(i + 1, j + 1),
                   vid(i, j + 1)] for i in range(n) for j in range(n)])
    corners = np.concatenate([np.stack([F[:, i], F[:, (i + 1) % 4],
                                        F[:, (i + 3) % 4]], 1)
                              for i in range(4)])
    edges = np.unique(np.sort(np.concatenate(
        [F[:, [i, (i + 1) % 4]] for i in range(4)]), 1), axis=0)
    rv, rf = REFS[ref]()
    s = tg.ALMGeometrySolver(dense_threshold=0, device="cpu")
    s.dtype = np.dtype(dtype)
    s.add_soft_constraint(RefSurfaceBatch.create(
        list(range(len(verts))), 1.0, rv, rf, dtype=dtype))
    s.add_hard_constraint(AngleBatch.create(corners, 1.0, np.pi / 4,
                                            3 * np.pi / 4, dtype=dtype))
    s.add_hard_constraint(EdgeLengthBatch.create(edges, 1.0, 0.8,
                                                 dtype=dtype))
    s.setup_ADMM(len(verts), 1000.0)
    return s, verts, (rv, rf)


_FLOAT = r"([-+]?(?:\d+\.?\d*(?:e[-+]?\d+)?|inf|nan))"


def _printed_energies(out):
    """The (initial, final) energies a solve printed."""
    (e0,) = re.findall(r"Init energy = " + _FLOAT, out)
    (ef,) = re.findall(r"final energy = " + _FLOAT, out)
    return float(e0), float(ef)


def _brute_energy(x, idx, w, rv, rf):
    """0.5 w^2 ||x - proj(x)||^2 summed, the projection the brute-force
    sweep over every triangle, at f64."""
    p = torch.from_numpy(x[idx])
    tris = torch.from_numpy(rv[rf])
    q = cp.closest_point_on_mesh(p, tris)
    return float(0.5 * (torch.from_numpy(w) ** 2
                        * ((p - q) ** 2).sum(1)).sum())


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("ref", ["group", "flat", "uncached"])
def test_solve_energies_through_the_cache(ref, dtype, capsys, monkeypatch):
    refreshes, tests = [], []
    for name in ("_cp_refresh", "_cp_refresh_group"):
        real = getattr(cp, name)

        def counted(*a, _real=real, **k):
            refreshes.append(1)
            return _real(*a, **k)
        monkeypatch.setattr(cp, name, counted)
    real_test = cp._needs_refresh

    def recorded(*a, **k):
        tests.append(real_test(*a, **k))
        return tests[-1]
    monkeypatch.setattr(cp, "_needs_refresh", recorded)

    s, x0, (rv, rf) = _solver(ref, dtype)
    capsys.readouterr()
    s.solve_ADMM(x0, 1e-8, 12, 5, cg_max_iters=15)
    e0, ef = _printed_energies(capsys.readouterr().out)
    st, sol = s.stats, s.get_solution()
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    rtol = 1e-12 if dtype == np.float64 else 1e-5

    def uncached(x):
        return float(tg.soft_energy(s.system, torch.from_numpy(x).to(tdt)))
    np.testing.assert_allclose(e0, uncached(x0), rtol=rtol)
    np.testing.assert_allclose(ef, uncached(sol), rtol=rtol)
    if ref == "flat":
        b = s.system.soft[0]
        idx, w = b.idx.numpy(), b.w.double().numpy()
        xf = s._tensor(sol).double().numpy()
        np.testing.assert_allclose(e0, _brute_energy(x0, idx, w, rv, rf),
                                   rtol=rtol)
        np.testing.assert_allclose(ef, _brute_energy(xf, idx, w, rv, rf),
                                   rtol=rtol)

    assert len(refreshes) == st["cp_refreshes"] + st["energy_refreshes"]
    if ref == "uncached":
        assert st["energy_refreshes"] == st["cp_refreshes"] == 0
        assert tests == []
    else:
        assert st["energy_refreshes"] in (1, 2)
        assert st["cp_refreshes"] >= 1
        # the initial energy refreshes the fresh cache; the first trial
        # projects the same points on the fast path
        assert tests[:2] == [True, False]
        # a cache test per trial and per energy
        assert len(tests) == st["trials"] + 2

    # the loop's answer is the unseeded loop's, bit for bit
    want = tg.solve_alm(s.system, s._tensor(x0))
    assert torch.equal(s._tensor(sol), want.x)
    np.testing.assert_array_equal(
        np.asarray(s.function_values),
        want.function_values[:len(s.function_values)].numpy())


# ---- on the card: MaleTorso's size ----

@pytest.mark.cuda
def test_energies_at_maletorso_size_on_card(capsys):
    """The benchmark's wire-mesh configuration (58,081 vertices against
    40,898 reference triangles, f32, CG capped at 15): five iterations from
    a handle edit of the design, after a warm-up solve. Both energies equal
    the uncached soft_energy within 1e-5 relative, and the ``solve.energy``
    spans hold under 40 device ms a solve (torch.profiler, events assigned
    to spans by their launches, as portbench/spans.py does)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from aa_admm_tpu_torch.core import timers
    from portbench import scenes
    from portbench import spans as pspans

    with open(os.path.join(ROOT, "portbench", "configs",
                           "wiremesh-maletorso.json")) as fh:
        cfg = json.load(fh)
    v, f, target, rv, rf = scenes.wire_design(cfg)
    dt = np.dtype(cfg["dtype"])
    s = tg.ALMGeometrySolver(device="cuda")
    s.dtype = dt
    s.add_soft_constraint(RefSurfaceBatch.create(
        list(range(len(v))), cfg["closeness_weight"], rv, rf, dtype=dt))
    s.add_hard_constraint(AngleBatch.create(
        scenes.quad_corners(f), 1.0, cfg["min_angle"], cfg["max_angle"],
        dtype=dt))
    s.add_hard_constraint(EdgeLengthBatch.create(
        scenes.quad_edges(f), 1.0, target, dtype=dt))
    s.setup_ADMM(len(v), cfg["penalty"])
    assert s.system.soft[0].grp_tris is not None
    eps = cfg["rel_residual_eps_ratio"] * scenes.mean_edge_length(v, f)

    def edit(seed):
        rng = np.random.default_rng(seed)
        x = v.copy()
        centre = x[rng.integers(len(x))]
        r2 = ((x[:, :2] - centre[:2]) ** 2).sum(1) / (8.0 * target) ** 2
        x[:, 2] += np.where(r2 < 1.0, 2.0 * target * (1.0 - r2) ** 2, 0.0)
        return x.astype(np.float32).astype(np.float64)

    def solve(x):
        s.solve_ADMM(x, eps, 5, cfg["anderson_m"],
                     cg_max_iters=cfg["cg_max_iters"])

    solve(edit(0))                                   # builds the kernels
    x = edit(1)
    capsys.readouterr()
    with timers.recording() as rec:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            lo = time.perf_counter_ns()
            solve(x)
            torch.cuda.synchronize()
            hi = time.perf_counter_ns()
    e0, ef = _printed_energies(capsys.readouterr().out)
    assert s.stats["energy_refreshes"] in (1, 2)
    sp = pspans.in_seconds(rec.profiler_spans())
    shift = rec.anchor_ns[1] - rec.anchor_ns[0]
    a = pspans.assign(pspans.from_profiler(prof), sp, (lo + shift) * 1e-9,
                      (hi + shift) * 1e-9)
    assert a.count("solve") == 1
    energy_ms = 1e3 * a.total("solve.energy")
    assert 0 < energy_ms < 40.0, energy_ms

    def uncached(y):
        return float(tg.soft_energy(
            s.system, torch.from_numpy(y).to(device="cuda",
                                             dtype=torch.float32)))
    np.testing.assert_allclose(e0, uncached(x), rtol=1e-5)
    np.testing.assert_allclose(ef, uncached(s.get_solution()), rtol=1e-5)
