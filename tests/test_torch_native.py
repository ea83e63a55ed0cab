"""The port's native host library (aa_admm_tpu_torch/native, built by g++
into aa_admm_tpu_torch/build/) against the JAX package's loader of the same
C++ source and against the port's NumPy parsers and brute-force
closest-point sweep, and the fast path that core/meshio.py takes. The
native tests skip without g++."""

import os
import shutil

import numpy as np
import pytest
import torch

from aa_admm_tpu import native as jnative
from aa_admm_tpu_torch import native as tnative
from aa_admm_tpu_torch.core import factory as tfactory
from aa_admm_tpu_torch.core import meshio as tmeshio


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native library is compiled at first use")
    assert tnative.available()
    return tnative


def test_library_is_built_into_the_port_build_dir(lib):
    path = lib.lib_path()
    assert path.exists()
    assert path.parent == tnative.BUILD_DIR
    assert path.parent.name == "build"
    assert path.parent.parent.name == "aa_admm_tpu_torch"


def test_aabb_matches_port_bruteforce_and_jax(lib):
    """Squared distances against the port's f64 brute-force sweep at 1e-12
    (points may differ where two triangles are equidistant); points and
    distances equal to the JAX package's loader of the same library."""
    rng = np.random.default_rng(0)
    ref_v = rng.normal(size=(60, 3))
    ref_f = rng.integers(0, 60, size=(100, 3)).astype(np.int32)
    q = rng.normal(size=(40, 3)) * 2.0
    pts, sqd = lib.AabbTree(ref_v, ref_f).closest_points(q)
    from aa_admm_tpu_torch.ops.closest_point import closest_point_on_mesh
    ref = closest_point_on_mesh(torch.from_numpy(q),
                                torch.from_numpy(ref_v[ref_f])).numpy()
    np.testing.assert_allclose(sqd, np.sum((q - ref) ** 2, axis=1),
                               rtol=1e-10, atol=1e-12)
    if jnative.available():
        jp, jd = jnative.AabbTree(ref_v, ref_f).closest_points(q)
        np.testing.assert_array_equal(pts, jp)
        np.testing.assert_array_equal(sqd, jd)
    np.testing.assert_array_equal(
        lib.host_closest_points(ref_v, ref_f, q), pts)


def test_host_closest_points_fallback(monkeypatch):
    """Without the library the port's brute-force sweep answers."""
    rng = np.random.default_rng(1)
    ref_v = rng.normal(size=(20, 3))
    ref_f = rng.integers(0, 20, size=(30, 3))
    q = rng.normal(size=(10, 3))
    monkeypatch.setattr(tnative, "available", lambda: False)
    pts = tnative.host_closest_points(ref_v, ref_f, q)
    from aa_admm_tpu_torch.ops.closest_point import closest_point_on_mesh
    ref = closest_point_on_mesh(torch.from_numpy(q),
                                torch.from_numpy(ref_v[ref_f])).numpy()
    np.testing.assert_array_equal(pts, ref)


def test_obj_parse_matches_numpy_and_jax(lib, tmp_path):
    p = tmp_path / "m.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0.25\n"
                 "f 1/1/1 2/2/2 3/3/3 4/4/4\nf 1 3 4\n")
    verts, tris = lib.load_obj_native(str(p))
    assert verts.shape == (4, 3) and tris.shape == (3, 3)   # quad fan-split
    _, polys = tmeshio._parse_obj(str(p))
    py_tris = [[f[0], f[k], f[k + 1]] for f in polys
               for k in range(1, len(f) - 1)]
    np.testing.assert_array_equal(tris, py_tris)
    np.testing.assert_array_equal(verts, tmeshio.load_obj_poly(str(p))[0])
    jv, jt = jnative.load_obj_native(str(p))
    np.testing.assert_array_equal(verts, jv)
    np.testing.assert_array_equal(tris, jt)
    # meshio takes the native path
    for m in (tmeshio.load_obj(str(p)), tmeshio.load_obj_numpy(str(p))):
        np.testing.assert_array_equal(m.verts, verts)
        np.testing.assert_array_equal(m.faces, tris)
    assert lib.load_obj_native(str(tmp_path / "missing.obj")) is None


def test_elenode_parse_matches_numpy(lib, tmp_path, monkeypatch):
    mesh = tfactory.make_tet_blocks(2, 1, 1)
    base = str(tmp_path / "m")
    tmeshio.save_elenode(base, mesh)
    verts, tets = lib.load_elenode_native(base)
    fast = tmeshio.load_elenode(base)
    slow = tmeshio.load_elenode_numpy(base)
    monkeypatch.setattr(tnative, "load_elenode_native", lambda b: None)
    fallback = tmeshio.load_elenode(base)
    for m in (fast, slow, fallback):
        np.testing.assert_array_equal(m.verts, verts)
        np.testing.assert_array_equal(m.tets, tets)
    np.testing.assert_array_equal(tets, mesh.tets)
    np.testing.assert_allclose(verts, mesh.verts, rtol=1e-15)


def test_meshio_falls_back_without_the_library(tmp_path, monkeypatch):
    grid = tfactory.make_plane_grid(3, 3)
    path = str(tmp_path / "g.obj")
    tmeshio.save_obj(path, grid.verts, grid.faces)
    monkeypatch.setattr(tnative, "load_obj_native", lambda p: None)
    m = tmeshio.load_obj(path)
    np.testing.assert_array_equal(m.faces, grid.faces)
    np.testing.assert_allclose(m.verts, grid.verts, rtol=1e-15)
    assert os.path.exists(path)


def test_aabb_rejects_bad_shapes_and_indices(lib):
    v = np.eye(3)
    with pytest.raises(ValueError, match="shape"):
        lib.AabbTree(v[:, :2], np.array([[0, 1, 2]]))
    with pytest.raises(ValueError, match="does not exist"):
        lib.AabbTree(v, np.array([[0, 1, 3]]))
    with pytest.raises(ValueError, match="shape"):
        lib.AabbTree(v, np.array([[0, 1, 2]])).closest_points(np.zeros(3))
