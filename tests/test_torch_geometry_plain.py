"""The port's plain geometry solver (solver/geometry_plain.py) against the
JAX package's at f64 on the CPU: tests/test_geometry_plain.py's noisy quad
grid (planarity hard, closeness soft) with and without Anderson
acceleration, and the same grid with a soft RefSurfaceBatch over a
5,000-triangle reference, so that its projection takes the 2-stage
closest-point path (kernel B1's twin on CPU tensors). Function values within
1e-10 relative and 1e-10 of the first (with Anderson the late values carry
the AA solves' roundoff: 1.6e-12 absolute on 0.45), equal resets,
solutions within 1e-9 (2.1e-10 measured on the 2-stage case); regularization
rows raise NotImplementedError in both packages; the entry point defaults
to CUDA."""

import numpy as np
import pytest
import torch

from aa_admm_tpu.ops import constraints as jc
from aa_admm_tpu.solver.geometry_plain import GeometrySolver as JGeometrySolver
from aa_admm_tpu_torch.ops import constraints as tc
from aa_admm_tpu_torch.solver import geometry_plain as tplain


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _noisy_quad_grid(nx=4, ny=4, noise=0.2, seed=0):
    """tests/test_geometry_plain.py:11's grid."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.arange(nx + 1, dtype=float),
                         np.arange(ny + 1, dtype=float), indexing="ij")
    verts = np.stack([xs.ravel(), ys.ravel(),
                      noise * rng.normal(size=xs.size)], axis=1)
    faces = [[i * (ny + 1) + j, (i + 1) * (ny + 1) + j,
              (i + 1) * (ny + 1) + j + 1, i * (ny + 1) + j + 1]
             for i in range(nx) for j in range(ny)]
    return verts, faces


def _reference(n=51, lo=-1.0, hi=5.0):
    """A gently curved height field triangulated to 2 (n - 1)^2 triangles
    (5,000 at n = 51)."""
    u = np.linspace(lo, hi, n)
    X, Y = np.meshgrid(u, u, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel(),
                      (0.05 * np.sin(X) * np.cos(Y)).ravel()], 1)
    i, j = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    a = (i * n + j).ravel()
    faces = np.concatenate([np.stack([a, a + n, a + 1], 1),
                            np.stack([a + n, a + n + 1, a + 1], 1)])
    return verts, faces


def _solve(mod, solver, verts, faces, iters, m, ref=None):
    solver.add_hard_constraint(mod.PlaneBatch.create(faces, weight=1.0))
    solver.add_soft_constraint(mod.ClosenessBatch.create(
        list(range(len(verts))), weight=1.0, targets=verts))
    if ref is not None:
        solver.add_soft_constraint(mod.RefSurfaceBatch.create(
            list(range(len(verts))), 10.0, ref[0], ref[1]))
    solver.setup_ADMM(len(verts), penalty_param=100.0)
    trace = solver.solve_ADMM(verts, 1e-10, iters, m)
    return (np.asarray(solver.function_values), solver.get_solution(),
            int(trace.resets))


def _compare(iters, m, ref=None, grid=()):
    verts, faces = _noisy_quad_grid(*grid)
    fj, xj, rj = _solve(jc, JGeometrySolver(), verts, faces, iters, m, ref)
    t = tplain.GeometrySolver(device="cpu")
    ft, xt, rt = _solve(tc, t, verts, faces, iters, m, ref)
    assert len(ft) == len(fj) == iters
    np.testing.assert_allclose(ft, fj, rtol=1e-10, atol=1e-10 * fj[0])
    np.testing.assert_allclose(xt, xj, rtol=1e-8, atol=1e-9)
    assert rt == rj
    return t, ft, rt


def test_plain_planarity_matches_jax():
    t, fv, resets = _compare(100, 5)
    assert fv[-1] < fv[0]
    # one read of the reset test and one of the AA Gram matrix per iteration
    assert t.stats["host_reads"] == 200 and t.stats["resets"] == resets


def test_plain_noacc_matches_jax():
    t, fv, resets = _compare(80, 0, grid=(3, 3, 0.1, 2))
    assert resets == 0 and t.stats["host_reads"] == 0
    assert fv[-1] < fv[0] * 0.05
    assert all(b <= a * 1.001 for a, b in zip(fv, fv[1:]))


def test_plain_ref_surface_2stage_matches_jax(monkeypatch):
    ref = _reference()
    assert len(ref[1]) == 5000 > tc._CP_2STAGE_THRESHOLD
    calls = []
    orig = tc.closest_point_on_mesh_2stage

    def counted(p, tri_verts, *a, **kw):
        calls.append(int(p.shape[0]))
        return orig(p, tri_verts, *a, **kw)
    monkeypatch.setattr(tc, "closest_point_on_mesh_2stage", counted)
    t, fv, _ = _compare(30, 5, ref=ref)
    # the init sweep, one projection per iteration and one per reset
    assert len(calls) >= 31 and set(calls) == {25}
    assert np.isfinite(fv).all() and fv[-1] < fv[0]


@pytest.mark.parametrize("side", ["jax", "port"])
def test_plain_refuses_regularization_rows(side):
    verts, faces = _noisy_quad_grid()
    s = JGeometrySolver() if side == "jax" else tplain.GeometrySolver(
        device="cpu")
    mod = jc if side == "jax" else tc
    s.add_hard_constraint(mod.PlaneBatch.create(faces, weight=1.0))
    s.reg_rows.append((np.asarray([0]), np.asarray([1.0]), np.zeros(3)))
    with pytest.raises(NotImplementedError, match="regularization"):
        s.setup_ADMM(len(verts), penalty_param=100.0)


def test_plain_solver_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tplain.GeometrySolver()
    assert tplain.GeometrySolver(device="cpu").device.type == "cpu"


@pytest.mark.cuda
def test_plain_f64_gpu_matches_cpu_on_card():
    """The 2-stage case at f64 on the card (kernel B1 in its projections)
    against the CPU (B1's twin): function values within 1e-8 relative, equal
    resets, and B1 launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from aa_admm_tpu_torch.ops import cuda_kernels as ck
    verts, faces = _noisy_quad_grid()
    out = {}
    for dev in ("cpu", "cuda"):
        ck.reset_launch_counts()
        s = tplain.GeometrySolver(device=dev)
        out[dev] = _solve(tc, s, verts, faces, 30, 5, ref=_reference())
        out[dev] += (ck.launch_counts()["ericson_idx"],)
    (fc, xc, rc, lc), (fg, xg, rg, lg) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(fg, fc, rtol=1e-8, atol=1e-12 * fc[0])
    np.testing.assert_allclose(xg, xc, rtol=1e-8, atol=1e-8)
    assert rg == rc and lc == 0 and lg >= 31
