"""The planarity slice of the PyTorch port against the JAX package at f64 on
the CPU: ``PlaneBatch`` (transform, its host copy, scatter, project, and the
dense, sparse and diagonal assembly that take it) carried across with
``convert.batch_from_numpy``, the error reports, and the planarity app's
``optimize_mesh`` on a noisy quad grid against a reference of 5,000
triangles, so that the flat closest-point cache with cached (9, K, Q)
candidates and the 2-stage refresh run.

Tolerances: batch operations 1e-12; function values rtol 1e-8 and solutions
1e-9 absolute (FV_RTOL and X_ATOL of tests/test_torch_geometry.py); reject
sequences equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_admm_tpu.apps import planarity_opt as jpo
from aa_admm_tpu.core import polymesh as jpoly
from aa_admm_tpu.ops import constraints as jc
from aa_admm_tpu.solver import geometry as jg
from aa_admm_tpu_torch import convert
from aa_admm_tpu_torch.apps import planarity_opt as tpo
from aa_admm_tpu_torch.core import meshio as tmeshio
from aa_admm_tpu_torch.ops import constraints as tc
from aa_admm_tpu_torch.ops import cuda_kernels as ck
from aa_admm_tpu_torch.solver import geometry as tg

TOL = dict(rtol=1e-12, atol=1e-12)
FV_RTOL = 1e-8
X_ATOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Single-threaded torch: small batches, and OpenMP workers spinning
    between tiny ops starve the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field(x, y):
    return 0.4 * np.sin(0.5 * x) * np.cos(0.4 * y)


def _grid(nx, ny, noise, seed=0):
    """tests/test_geometry.py's noisy quad grid, on a gentle height field."""
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.arange(nx + 1, dtype=float),
                         np.arange(ny + 1, dtype=float), indexing="ij")
    verts = np.stack([xs.ravel(), ys.ravel(),
                      (_field(xs, ys) + noise * rng.normal(size=xs.shape)).ravel()],
                     axis=1)
    vid = lambda i, j: i * (ny + 1) + j
    faces = [[vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)]
             for i in range(nx) for j in range(ny)]
    return verts, faces


def _reference(n=51, lo=-1.0, hi=7.0):
    """The clean field triangulated to 2 (n-1)^2 = 5,000 triangles: above
    the 2-stage threshold (4,096), below the subgroup cache's (20,000)."""
    u = np.linspace(lo, hi, n)
    X, Y = np.meshgrid(u, u, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel(), _field(X, Y).ravel()], 1)
    i, j = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    a = (i * n + j).ravel()
    b = a + n
    faces = np.concatenate([np.stack([a, b, a + 1], 1),
                            np.stack([b, b + 1, a + 1], 1)])
    return verts, faces


def _fields(b):
    out = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
    out = {k: (v if isinstance(v, (int, float)) or v is None
               else np.asarray(v)) for k, v in out.items()}
    out["_host"] = getattr(b, "_host", None)
    return out


def _mixed_faces(n_verts=30, seed=1):
    """Faces of valence 3, 4 and 5, so that padding and masks are used."""
    rng = np.random.default_rng(seed)
    return [list(rng.choice(n_verts, k, replace=False))
            for k in rng.integers(3, 6, 24)]


def test_plane_batch_matches_jax():
    faces = _mixed_faces()
    jb = jc.PlaneBatch.create(faces, 2.0)
    tb = tc.PlaneBatch.create(faces, 2.0)
    cb = convert.batch_from_numpy("PlaneBatch", _fields(jb))
    rng = np.random.default_rng(2)
    x = rng.normal(size=(30, 3))
    pj = np.array(jb.transform(jnp.asarray(x)))
    t = rng.normal(size=pj.shape)
    for b in (tb, cb):
        np.testing.assert_array_equal(b.idx.numpy(), np.asarray(jb.idx))
        np.testing.assert_array_equal(b.mask.numpy(), np.asarray(jb.mask))
        assert b.block_shape == jb.block_shape
        pt = b.transform(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(pt, pj, **TOL)
        np.testing.assert_allclose(b.transform_host(x), jb.transform_host(x),
                                   **TOL)
        np.testing.assert_allclose(
            b.scatter(torch.from_numpy(t), 30).numpy(),
            np.asarray(jb.scatter(jnp.asarray(t), 30)), **TOL)
        np.testing.assert_allclose(
            b.project(torch.from_numpy(pj)).numpy(),
            np.asarray(jb.project(jnp.asarray(pj))), **TOL)
    # the projection is onto planes: projecting again changes nothing, and
    # padded slots stay zero
    pr = tb.project(torch.from_numpy(pj))
    np.testing.assert_allclose(tb.project(pr).numpy(), pr.numpy(), atol=1e-12)
    assert not pr.numpy()[~tb.mask.numpy()].any()
    # <T x, t> == <x, T^T t>: scatter is the transform's adjoint
    lhs = float((tb.transform(torch.from_numpy(x)) * torch.from_numpy(t)).sum())
    rhs = float((torch.from_numpy(x) * tb.scatter(torch.from_numpy(t), 30)).sum())
    assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))


def test_plane_batch_assembly_matches_jax():
    faces = _mixed_faces()
    edges = np.array([[0, 1], [2, 5], [7, 3]])
    jh = [jc.PlaneBatch.create(faces, 1.0), jc.EdgeLengthBatch.create(edges, 1.0, 1.0)]
    th = [tc.PlaneBatch.create(faces, 1.0), tc.EdgeLengthBatch.create(edges, 1.0, 1.0)]
    js = [jc.ClosenessBatch.create(np.arange(30), 0.5, np.zeros((30, 3)))]
    ts = [tc.ClosenessBatch.create(np.arange(30), 0.5, np.zeros((30, 3)))]
    A_j = jc.assemble_geometry_node_matrix(30, jh, js, 1e5)
    A_t = tc.assemble_geometry_node_matrix(30, th, ts, 1e5)
    np.testing.assert_allclose(A_t, A_j, rtol=1e-13, atol=1e-8)
    S_t = tc.assemble_geometry_node_matrix_sparse(30, th, ts, 1e5).toarray()
    np.testing.assert_allclose(S_t, A_j, rtol=1e-13, atol=1e-8)
    np.testing.assert_allclose(tg._geometry_node_diag(30, th, ts, 1e5, None),
                               jg._geometry_node_diag(30, jh, js, 1e5, None),
                               rtol=1e-14)


@pytest.fixture(scope="module")
def solves():
    verts, faces = _grid(6, 6, 0.1)
    ref_v, ref_f = _reference()
    js = jpo.optimize_mesh(jpoly.PolyMesh(verts=verts, faces=faces), ref_v,
                           ref_f, 20, 5)
    ck.reset_launch_counts()
    ts = tpo.optimize_mesh(tpo.PolyMesh(verts=verts, faces=faces), ref_v,
                           ref_f, 20, 5, device="cpu")
    return verts, faces, ref_v, ref_f, js, ts


def test_optimize_mesh_matches_jax(solves):
    verts, faces, ref_v, ref_f, js, ts = solves
    fj, ft = np.asarray(js.function_values), np.asarray(ts.function_values)
    assert len(ft) == len(fj) > 0
    np.testing.assert_allclose(ft, fj, rtol=FV_RTOL)
    assert ts.anderson_reset == js.anderson_reset
    np.testing.assert_allclose(ts.get_solution(), js.get_solution(), rtol=0,
                               atol=X_ATOL)
    # the dense x-step, and the flat cache with cached candidates, which
    # both refreshed (2-stage sweep) and took its fast path
    assert ts.system.solver is not None
    soft = ts.soft[0]
    assert isinstance(soft, tc.RefSurfaceBatch) and soft.grp_tris is None
    cache = soft.cp_cache_init(torch.float64)
    assert cache is not None and cache.candT is not None
    st = ts.stats
    assert 1 <= st["cp_refreshes"] < st["trials"]
    assert ck.launch_counts() == {"ericson": 0, "ericson_idx": 0,
                                  "cg_update1": 0, "cg_update2": 0,
                                  "cg_dot": 0, "cg_update1_given": 0,
                                  "cg_update2_given": 0}


def test_planarity_error_falls_and_matches_jax(solves, capsys):
    verts, faces, ref_v, ref_f, js, ts = solves
    mesh = tpo.PolyMesh(verts=verts, faces=faces)
    pl_b, dg_b = tpo.check_planarity_error(mesh)
    pl_a, dg_a = tpo.check_planarity_error(mesh, ts.get_solution())
    jpl_a, jdg_a = jpo.check_planarity_error(
        jpoly.PolyMesh(verts=verts, faces=faces), js.get_solution())
    np.testing.assert_allclose(pl_a, jpl_a, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(dg_a, jdg_a, rtol=1e-6, atol=1e-12)
    assert pl_a.max() < 0.5 * pl_b.max() and dg_a.max() < dg_b.max()
    d_t = tpo.check_ref_surface_distance(ts.get_solution(), mesh, ref_v, ref_f,
                                         device="cpu")
    d_j = jpo.check_ref_surface_distance(
        js.get_solution(), jpoly.PolyMesh(verts=verts, faces=faces), ref_v,
        ref_f)
    np.testing.assert_allclose(d_t, d_j, rtol=0, atol=1e-8)  # x to 1e-9


def test_main_cli_on_cpu(tmp_path, monkeypatch):
    verts, faces = _grid(3, 3, 0.1, seed=4)
    ref_v, ref_f = _reference(n=8)
    tmeshio.save_obj(str(tmp_path / "in.obj"), verts, faces)
    tmeshio.save_obj(str(tmp_path / "ref.obj"), ref_v, ref_f)
    (tmp_path / "opts.txt").write_text("Iterations 5\nAndersonM 3\n")
    monkeypatch.chdir(tmp_path)
    rc = tpo.main(["in.obj", "ref.obj", "opts.txt", "out.obj", "--cpu"])
    assert rc == 0
    out_v, out_f = tmeshio.load_obj_poly(str(tmp_path / "out.obj"))
    assert out_v.shape == verts.shape and np.isfinite(out_v).all()
    assert [list(f) for f in out_f] == faces
    assert (tmp_path / "result" / "residual-3.txt").exists()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only rule")
def test_entry_points_need_cuda():
    verts, faces = _grid(2, 2, 0.1)
    ref_v, ref_f = _reference(n=5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpo.optimize_mesh(tpo.PolyMesh(verts=verts, faces=faces), ref_v,
                          ref_f, 2, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpo.main(["a.obj", "b.obj", "c.txt", "d.obj"])
