"""The port's analytic and mesh colliders against the JAX package at f64 on
the CPU: every signed-distance kind and ``prox_collision`` to 1e-12 (points
on the plane-and-half-sphere seam and on a cylinder's axis included),
``barycoords_tet``, ``point_in_tets`` and ``TetMeshSdf`` on the scenes of
tests/test_collider.py, the dense and spatial-hash dynamic colliders on
random queries (hit, face and overflow bit for bit, points, barycentrics and
normals to 1e-12) and the hash itself (every tet's bucket, bit for bit,
where the int32 cell products overflow)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_admm_tpu.core.factory import make_tet_blocks
from aa_admm_tpu.ops import collider as jcol
from aa_admm_tpu.ops import prox as jprox
from aa_admm_tpu.ops import sdf as jsdf
from aa_admm_tpu_torch.ops import collider as tcol
from aa_admm_tpu_torch.ops import prox as tprox
from aa_admm_tpu_torch.ops import sdf as tsdf

TOL = 1e-12
SQ3 = np.sqrt(3.0) / 2.0
OBSTACLES = {
    "floor": [("floor", dict(y=-2.0)), ("floor", dict(y=-2.5))],
    "slide_floor": [("slide_floor", dict(center=[0.0, -3.0, 0.0],
                                         normal=[0.5, SQ3, 0.0]))],
    "sphere": [("sphere", dict(center=[0.0, -2.0, 0.0], rad=0.5)),
               ("sphere", dict(center=[1.0, -1.0, 0.5], rad=0.7))],
    "plane_half_sphere": [("plane_half_sphere",
                           dict(center=[0.0, -3.0, 0.0], rad=1.0))],
    "cylinder": [("cylinder", dict(center=[i * 1.5 - 3.0, -2.5, 0.0],
                                   rad=0.4)) for i in range(3)],
}


def _scenes(items, dtype=np.float64):
    jb, tb = jsdf.SdfSceneBuilder(), tsdf.SdfSceneBuilder()
    for kind, kw in items:
        getattr(jb, f"add_{kind}")(**kw)
        getattr(tb, f"add_{kind}")(**kw)
    return jb.build(dtype), tb.build(dtype)


def _queries(n=400, seed=0):
    """Random points around the obstacles, plus points on the
    plane-and-half-sphere seam (horizontal distance exactly its radius,
    above, on and below its plane), on its plane, and on cylinder axes."""
    g = np.random.default_rng(seed)
    pts = [g.normal(size=(n, 3)) * 1.5 + [0.0, -2.5, 0.0]]
    for y in (-3.5, -3.0, -2.0):
        pts.append([[1.0, y, 0.0], [-1.0, y, 0.0], [0.0, y, 1.0],
                    [0.6, y, 0.8]])
    pts.append([[0.3, -3.0, 0.2], [3.0, -3.0, -1.0]])
    pts.append([[i * 1.5 - 3.0, -2.5, z] for i in range(3)
                for z in (-1.0, 0.0, 2.0)])
    return np.concatenate([np.asarray(p, np.float64) for p in pts])


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("kind", list(OBSTACLES) + ["all"])
def test_signed_distance_matches_jax(kind):
    items = sum(OBSTACLES.values(), []) if kind == "all" else OBSTACLES[kind]
    js, ts = _scenes(items)
    assert ts.n_objects == js.n_objects == len(items)
    x = _queries()
    dj, pj = js.signed_distance(jnp.asarray(x))
    dt, pt = ts.signed_distance(torch.from_numpy(x))
    _close(dt, dj)
    _close(pt, pj)
    # batched (..., 3) queries keep their leading shape
    dt2, pt2 = ts.signed_distance(torch.from_numpy(x[:12].reshape(3, 4, 3)))
    assert dt2.shape == (3, 4) and pt2.shape == (3, 4, 3)
    _close(dt2.reshape(-1), dt[:12])


def test_float32_scene_has_no_float64():
    _, ts = _scenes(sum(OBSTACLES.values(), []), np.float32)
    for f in ("floor_y", "slide_center", "slide_normal", "sphere_center",
              "sphere_rad", "phs_center", "phs_rad", "cyl_center", "cyl_rad"):
        assert getattr(ts, f).dtype == torch.float32, f
    d, p = ts.signed_distance(torch.from_numpy(_queries().astype(np.float32)))
    assert d.dtype == p.dtype == torch.float32
    empty = tsdf.SdfSceneBuilder().build(np.float32)
    assert empty.n_objects == 0 and empty.cyl_center.shape == (0, 3)


def _box_obstacle():
    box = make_tet_blocks(1, 1, 1)
    box.verts = box.verts * np.array([3.0, 1.0, 3.0]) + [-1.0, -1.5, -1.0]
    return box


def test_prox_collision_matches_jax():
    js, ts = _scenes(sum(OBSTACLES.values(), []))
    box = _box_obstacle()
    jm = jcol.TetMeshSdf.create(box.verts, box.tets)
    tm = tcol.TetMeshSdf.create(box.verts, box.tets)
    x = _queries(seed=1)
    active = np.random.default_rng(2).random(len(x)) < 0.8
    for meshes in ((), (0,)):
        out_j = jprox.prox_collision(jnp.asarray(x), js, jnp.asarray(active),
                                     tuple(jm for _ in meshes))
        out_t = tprox.prox_collision(torch.from_numpy(x), ts,
                                     torch.from_numpy(active),
                                     tuple(tm for _ in meshes))
        _close(out_t, out_j)
        moved = np.any(np.asarray(out_t) != x, axis=1)
        assert moved.any() and not moved[~active].any()


def _tet(rng):
    return [rng.normal(size=3) for _ in range(4)]


def test_barycoords_tet_matches_jax():
    rng = np.random.default_rng(0)
    v = np.stack([np.stack(_tet(rng)) for _ in range(50)])      # (50, 4, 3)
    x = rng.normal(size=(50, 3))
    bj = jcol.barycoords_tet(*map(jnp.asarray, (x, v[:, 0], v[:, 1], v[:, 2],
                                                v[:, 3])))
    bt = tcol.barycoords_tet(*map(torch.from_numpy, (x, v[:, 0], v[:, 1],
                                                     v[:, 2], v[:, 3])))
    _close(bt, bj)
    one = tcol.barycoords_tet(*map(torch.tensor, (
        [0.25, 0.25, 0.25], [0.0, 0, 0], [1.0, 0, 0], [0.0, 1, 0],
        [0.0, 0, 1])))
    _close(one, [0.25] * 4)


def test_point_in_tets_and_mesh_sdf_match_jax():
    mesh = make_tet_blocks(1, 1, 1)
    rng = np.random.default_rng(1)
    pts = np.concatenate([[[0.5, 0.5, 0.5], [2.0, 0.5, 0.5],
                           [0.01, 0.01, 0.01], [0.5, 0.5, 0.1]],
                          rng.uniform(-0.3, 1.3, size=(200, 3))])
    tv = mesh.verts[mesh.tets]
    ij, fj, bj = jcol.point_in_tets(jnp.asarray(pts), jnp.asarray(tv))
    it, ft, bt = tcol.point_in_tets(torch.from_numpy(pts),
                                    torch.from_numpy(tv))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    _close(bt, bj)
    assert it[0] and it[2] and not it[1] and 0.2 < it.float().mean() < 0.9

    jm = jcol.TetMeshSdf.create(mesh.verts, mesh.tets)
    tm = tcol.TetMeshSdf.create(mesh.verts, mesh.tets)
    dj, qj = jm.signed_distance(jnp.asarray(pts))
    dt, qt = tm.signed_distance(torch.from_numpy(pts))
    _close(dt, dj)
    _close(qt, qj)
    assert abs(float(dt[0]) + 0.5) < 1e-10 and abs(float(dt[3]) + 0.1) < 1e-10
    assert float(dt[1]) > 1e10


def test_detect_combines_scene_and_mesh_like_jax():
    box = make_tet_blocks(1, 1, 1)
    box.verts = box.verts + np.array([5.0, 0.0, 0.0])
    pts = np.array([[0.0, -0.5, 0.0], [5.5, 0.5, 0.5], [0.0, 2.0, 0.0]])
    js, ts = _scenes([("floor", dict(y=0.0))])
    pj, _ = jcol.detect(jnp.asarray(pts), scene=js, mesh_sdfs=[
        jcol.TetMeshSdf.create(box.verts, box.tets)])
    pt, _ = tcol.detect(torch.from_numpy(pts), scene=ts, mesh_sdfs=[
        tcol.TetMeshSdf.create(box.verts, box.tets)])
    assert pt.hit.tolist() == [True, True, False] == np.asarray(pj.hit).tolist()
    _close(pt.dx, pj.dx)
    _close(pt.point, pj.point)


def _deformed_block(seed=3, shape=(4, 2, 3)):
    mesh = make_tet_blocks(*shape)
    rng = np.random.default_rng(seed)
    x_all = mesh.verts + 0.15 * rng.normal(size=mesh.verts.shape)
    q = np.concatenate([mesh.verts * 0.9 + 0.05,
                        rng.uniform(-1, 5, size=(64, 3))])
    ids = np.concatenate([np.arange(len(mesh.verts)),
                          np.full(64, -1)]).astype(np.int64)
    return mesh, x_all, q, ids


def _assert_hits_equal(ht, hj):
    """hit and (where hit) face bit for bit; the payload to 1e-12. Where
    nothing is hit the face is the nearest surface to a point that far
    queries put thousands of units out, a near-tie among many faces."""
    hit = ht.hit.numpy()
    np.testing.assert_array_equal(hit, np.asarray(hj.hit))
    np.testing.assert_array_equal(ht.face.numpy()[hit], np.asarray(hj.face)[hit])
    for f in ("barys", "normal", "point"):
        _close(getattr(ht, f), getattr(hj, f))


@pytest.mark.parametrize("offset", [0, 7])
def test_dynamic_collider_matches_jax(offset):
    mesh, x_all, q, ids = _deformed_block()
    pad = np.zeros((offset, 3))
    x_pad = np.concatenate([pad, x_all])
    ids = np.where(ids >= 0, ids + offset, ids)
    jd = jcol.DynamicTetCollider.create(mesh.verts, mesh.tets, offset)
    td = tcol.DynamicTetCollider.create(mesh.verts, mesh.tets, offset)
    hj = jd.detect(jnp.asarray(q), jnp.asarray(x_pad),
                   query_ids=jnp.asarray(ids.astype(np.int32)))
    ht = td.detect(torch.from_numpy(q), torch.from_numpy(x_pad),
                   query_ids=torch.from_numpy(ids))
    _assert_hits_equal(ht, hj)
    assert 5 <= int(ht.hit.sum()) < len(q)


def _jax_tet_hashes(hc, x_all):
    """The JAX collider's bucket of every deformed tet (its own steps)."""
    tv = x_all[hc.tets]
    centroid = jnp.mean(tv, axis=1)
    rad2 = jnp.max(jnp.sum((tv - centroid[:, None, :]) ** 2, -1), axis=1)
    h = 1.05 * jnp.sqrt(jnp.max(rad2)) + 1e-30
    tc = jnp.floor(centroid / h).astype(jnp.int32)
    return np.asarray(hc._hash_cells(tc[:, 0], tc[:, 1], tc[:, 2]))


@pytest.mark.parametrize("n_buckets,cap", [(2048, 48), (64, 4), (1, 2)])
def test_hash_collider_matches_jax(n_buckets, cap):
    mesh, x_all, q, ids = _deformed_block()
    # far queries: cells of a few thousand, whose int32 products by the
    # hash primes overflow
    far = np.random.default_rng(4).uniform(-2e3, 2e3, size=(32, 3))
    q = np.concatenate([q, far])
    ids = np.concatenate([ids, np.full(32, -1)])
    jh = jcol.HashGridTetCollider.create(mesh.verts, mesh.tets,
                                         n_buckets=n_buckets, cap=cap)
    th = tcol.HashGridTetCollider.create(mesh.verts, mesh.tets,
                                         n_buckets=n_buckets, cap=cap)
    xj, xt = jnp.asarray(x_all), torch.from_numpy(x_all)
    _, t_hash, h = th._cells(xt)
    np.testing.assert_array_equal(t_hash.numpy(), _jax_tet_hashes(jh, xj))
    assert th.max_bucket_load(xt) == jh.max_bucket_load(xj)
    qc = torch.floor(torch.from_numpy(far) / h).to(torch.int64)
    assert int(qc.abs().max()) * 83492791 > 2 ** 31
    np.testing.assert_array_equal(
        th._hash_cells(qc).numpy(),
        np.asarray(jh._hash_cells(*jnp.asarray(qc.numpy().astype(
            np.int32)).T)))
    hj, oj = jh.detect_with_overflow(jnp.asarray(q), xj,
                                     query_ids=jnp.asarray(ids.astype(np.int32)))
    ht, ot = th.detect_with_overflow(torch.from_numpy(q), xt,
                                     query_ids=torch.from_numpy(ids))
    assert bool(ot) == bool(oj) == (cap < th.max_bucket_load(xt))
    _assert_hits_equal(ht, hj)
    if not bool(ot):      # no overflow: the hash is exact
        hd = tcol.DynamicTetCollider.create(mesh.verts, mesh.tets).detect(
            torch.from_numpy(q), xt, query_ids=torch.from_numpy(ids))
        np.testing.assert_array_equal(ht.hit.numpy(), hd.hit.numpy())
        np.testing.assert_array_equal(ht.face.numpy()[ht.hit.numpy()],
                                      hd.face.numpy()[ht.hit.numpy()])
