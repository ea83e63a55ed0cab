"""Constraint batches of the PyTorch port (aa_admm_tpu_torch.ops.constraints)
against the JAX package at f64 on the CPU: transform, scatter and project of
the Angle, EdgeLength, Closeness and RefSurface batches, the dense and
sparse global-matrix assembly, and the port's own copies of the host-side
core (mesh IO, subdivision, option files, error reports).

Tolerance 1e-12: the same arithmetic in f64; scatter sums in another order
(index_add_ against segment_sum)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_admm_tpu.apps import wire_mesh_opt as jwm
from aa_admm_tpu.core import meshio as jmeshio
from aa_admm_tpu.core import polymesh as jpoly
from aa_admm_tpu.core.config import Parameters as JParameters
from aa_admm_tpu.ops import constraints as jc
from aa_admm_tpu_torch.apps import wire_mesh_opt as twm
from aa_admm_tpu_torch.core import meshio as tmeshio
from aa_admm_tpu_torch.core import polymesh as tpoly
from aa_admm_tpu_torch.core.config import Parameters as TParameters
from aa_admm_tpu_torch.ops import constraints as tc

TOL = dict(rtol=1e-12, atol=1e-12)
N = 40


def _batches(pkg, rng_seed=11):
    rng = np.random.default_rng(rng_seed)
    tri = rng.integers(0, N, (25, 3))
    edges = rng.integers(0, N, (30, 2))
    idx = rng.choice(N, 12, replace=False)
    targets = rng.normal(size=(12, 3))
    ref_v = rng.normal(size=(30, 3))
    ref_f = rng.integers(0, 30, (20, 3))
    return [
        pkg.AngleBatch.create(tri, 2.0, 0.3, 2.8),
        pkg.EdgeLengthBatch.create(edges, 1.5, 0.9),
        pkg.ClosenessBatch.create(idx, 2.5, targets),
        pkg.RefSurfaceBatch.create(idx, 3.0, ref_v, ref_f),
    ]


@pytest.mark.parametrize("which", range(4))
def test_batch_transform_scatter_project(which):
    bj = _batches(jc)[which]
    bt = _batches(tc)[which]
    rng = np.random.default_rng(which)
    x = rng.normal(size=(N, 3))
    tj = np.asarray(bj.transform(jnp.asarray(x)))
    tt = bt.transform(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tt, tj, **TOL)
    np.testing.assert_allclose(bt.transform_host(x), bj.transform_host(x),
                               **TOL)
    assert tuple(bt.block_shape) == tuple(bj.block_shape)
    t = rng.normal(size=bj.block_shape)
    np.testing.assert_allclose(bt.scatter(torch.from_numpy(t), N).numpy(),
                               np.asarray(bj.scatter(jnp.asarray(t), N)),
                               **TOL)
    # project the transformed block, and a random one (angles inside and
    # outside the clamp range, arbitrary edge vectors, off-surface points)
    for p in (tj, 3.0 * t):
        np.testing.assert_allclose(bt.project(torch.tensor(p)).numpy(),
                                   np.asarray(bj.project(jnp.asarray(p))),
                                   **TOL)


def test_cast_floats_moves_dtype_keeps_mirrors():
    b = _batches(tc)[0]
    b32 = tc.cast_floats(b, np.float32, "cpu")
    assert b32.w.dtype == torch.float32 and b32.idx.dtype == torch.int64
    assert tc.hostarr(b32, "w").dtype == np.float64


def test_global_matrix_assembly_matches_jax():
    hard_j, soft_j = _batches(jc)[:2], _batches(jc)[2:]
    hard_t, soft_t = _batches(tc)[:2], _batches(tc)[2:]
    rng = np.random.default_rng(3)
    reg = (rng.integers(0, N, size=(5, 3)), rng.normal(size=(5, 3)),
           np.ones((5, 3), bool))
    dj = jc.assemble_geometry_node_matrix(N, hard_j, soft_j, 37.0, reg_rows=reg)
    dt = tc.assemble_geometry_node_matrix(N, hard_t, soft_t, 37.0, reg_rows=reg)
    np.testing.assert_allclose(dt, dj, **TOL)
    sj = jc.assemble_geometry_node_matrix_sparse(N, hard_j, soft_j, 37.0,
                                                 reg_rows=reg)
    st = tc.assemble_geometry_node_matrix_sparse(N, hard_t, soft_t, 37.0,
                                                 reg_rows=reg)
    np.testing.assert_allclose(st.toarray(), sj.toarray(), **TOL)
    vmap = rng.integers(0, 10, N)
    np.testing.assert_allclose(
        tc.assemble_geometry_node_matrix(10, hard_t, soft_t, 5.0,
                                         vertex_map=vmap),
        jc.assemble_geometry_node_matrix(10, hard_j, soft_j, 5.0,
                                         vertex_map=vmap), **TOL)


def _grid_mesh(mod, nx=5, ny=4, noise=0.2, seed=0):
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.arange(nx + 1, dtype=float),
                         np.arange(ny + 1, dtype=float), indexing="ij")
    verts = np.stack([xs.ravel(), ys.ravel(),
                      noise * rng.normal(size=xs.size)], axis=1)
    vid = lambda i, j: i * (ny + 1) + j
    faces = [[vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)]
             for i in range(nx) for j in range(ny)]
    return mod.PolyMesh(verts=verts, faces=faces)


def test_host_core_copies_match_jax(tmp_path):
    """Subdivision + smoothing, OBJ round trips, option files and the
    wire-mesh error report: the port's copies give the JAX package's
    results."""
    sj = jpoly.subdivide_and_smooth(_grid_mesh(jpoly))
    st = tpoly.subdivide_and_smooth(_grid_mesh(tpoly))
    np.testing.assert_allclose(st.verts, sj.verts, rtol=1e-9, atol=1e-9)
    assert st.faces == sj.faces
    poly = tmp_path / "m.obj"
    tmeshio.save_obj(str(poly), st.verts, st.faces)
    vj, fj = jmeshio.load_obj_poly(str(poly))
    vt, ft = tmeshio.load_obj_poly(str(poly))
    np.testing.assert_array_equal(vt, vj)
    assert ft == fj
    tj, tt = jmeshio.load_obj(str(poly)), tmeshio.load_obj(str(poly))
    np.testing.assert_array_equal(tt.faces, tj.faces)
    opts = tmp_path / "opts.txt"
    opts.write_text("# comment\nIterations 7\nAndersonM 3\n")
    assert TParameters.load(str(opts)).output() == \
        JParameters.load(str(opts)).output()
    el = st.average_edge_length() * 0.5
    out = st.verts + np.random.default_rng(1).normal(size=st.verts.shape) * 0.05
    for a, b in zip(twm.check_wiremesh_error(st, out, el, np.pi / 4,
                                             3 * np.pi / 4),
                    jwm.check_wiremesh_error(sj, out, el, np.pi / 4,
                                             3 * np.pi / 4)):
        np.testing.assert_allclose(a, b, **TOL)
    ref_v = np.array([[-1.0, -1, 0], [6, -1, 0], [6, 6, 0], [-1, 6, 0]])
    ref_f = np.array([[0, 1, 2], [0, 2, 3]])
    np.testing.assert_allclose(
        twm.check_ref_surface_distance(out, st, ref_v, ref_f, device="cpu"),
        jwm.check_ref_surface_distance(out, sj, ref_v, ref_f), **TOL)
