"""The slice as a whole: ``optimize_mesh`` of the PyTorch port against the JAX
package at f64 on the CPU, on the synthetic wire-mesh grid of
tests/test_wiremesh.py — the dense path, and the CG path (forced with
``dense_threshold=0`` in both packages) against a reference surface above
20,000 triangles, so the subgroup closest-point cache and every kernel twin
run — plus one ``solve_alm_chunk`` from a mid-solve state carried across
with ``aa_admm_tpu_torch.convert``.

Tolerances: function values rtol 1e-8 and solutions 1e-9 absolute (the
same iteration in f64; CG dots, scatters and the AA Gram matrix summed in
another order); reject sequences equal."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from aa_admm_tpu.apps import wire_mesh_opt as jwm
from aa_admm_tpu.core import polymesh as jpoly
from aa_admm_tpu.ops import constraints as jc
from aa_admm_tpu.solver import geometry as jg
from aa_admm_tpu_torch import convert
from aa_admm_tpu_torch.apps import wire_mesh_opt as twm
from aa_admm_tpu_torch.ops import cuda_kernels as ck
from aa_admm_tpu_torch.solver import geometry as tg

FV_RTOL = 1e-8
X_ATOL = 1e-9


def _grid(nx, ny, noise, seed=0):
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.arange(nx + 1, dtype=float),
                         np.arange(ny + 1, dtype=float), indexing="ij")
    verts = np.stack([xs.ravel(), ys.ravel(),
                      noise * rng.normal(size=xs.size)], axis=1)
    vid = lambda i, j: i * (ny + 1) + j
    faces = [[vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)]
             for i in range(nx) for j in range(ny)]
    return verts, faces


def _height_field(n=102, lo=-15.0, hi=21.0):
    """A bumpy height field triangulated to 2 (n-1)^2 = 20,402 triangles
    (above the subgroup-cache threshold of 20,000)."""
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


@pytest.fixture(scope="module")
def scene():
    verts, faces = _grid(4, 4, 0.15)
    mesh = jpoly.PolyMesh(verts=verts, faces=faces)
    el = mesh.average_edge_length() * 0.5
    sub = jpoly.subdivide_and_smooth(mesh)
    return sub.verts, sub.faces, el


def _run_both(scene, ref_v, ref_f, tmp_path, monkeypatch, cg, max_iter=20):
    verts, faces, el = scene
    if cg:
        monkeypatch.setattr(jwm, "ALMGeometrySolver", functools.partial(
            jg.ALMGeometrySolver, dense_threshold=0))
        monkeypatch.setattr(twm, "ALMGeometrySolver", functools.partial(
            tg.ALMGeometrySolver, dense_threshold=0))
    js = jwm.optimize_mesh(jpoly.PolyMesh(verts=verts, faces=faces), ref_v,
                           ref_f, max_iter=max_iter, anderson_m=5,
                           edge_length=el, result_dir=str(tmp_path / "j"))
    ck.reset_launch_counts()
    ts = twm.optimize_mesh(twm.PolyMesh(verts=verts, faces=faces), ref_v,
                           ref_f, max_iter=max_iter, anderson_m=5,
                           edge_length=el, result_dir=str(tmp_path / "t"),
                           device="cpu")
    return js, ts


def _assert_same_solve(js, ts):
    fj, ft = np.asarray(js.function_values), np.asarray(ts.function_values)
    assert len(ft) == len(fj) > 0
    np.testing.assert_allclose(ft, fj, rtol=FV_RTOL)
    assert ts.anderson_reset == js.anderson_reset
    np.testing.assert_allclose(ts.get_solution(), js.get_solution(),
                               rtol=0, atol=X_ATOL)


def test_optimize_mesh_dense_matches_jax(scene, tmp_path, monkeypatch):
    ref_v = np.array([[-1.0, -1, 0], [6, -1, 0], [6, 6, 0], [-1, 6, 0]])
    ref_f = np.array([[0, 1, 2], [0, 2, 3]])
    js, ts = _run_both(scene, ref_v, ref_f, tmp_path, monkeypatch, cg=False)
    _assert_same_solve(js, ts)
    assert ts.system.solver is not None
    assert (tmp_path / "t" / "residual-5.txt").exists()
    assert ts.stats["cg_iters"] == 0


def test_optimize_mesh_cg_group_cache_matches_jax(scene, tmp_path,
                                                  monkeypatch):
    ref_v, ref_f = _height_field()
    js, ts = _run_both(scene, ref_v, ref_f, tmp_path, monkeypatch, cg=True)
    _assert_same_solve(js, ts)
    assert ts.system.solver is None and ts.system.mg is not None
    st = ts.stats
    # the CG path ran, the cache both refreshed and took its fast path, and
    # some trials were rejected (the AA reset path ran)
    assert st["cg_iters"] > 0
    assert 1 <= st["cp_refreshes"] < st["trials"]
    assert sum(ts.anderson_reset) > 0
    # CPU tensors: every kernel call went to its twin
    assert ck.launch_counts() == {"ericson": 0, "ericson_idx": 0,
                                  "cg_update1": 0, "cg_update2": 0,
                                  "cg_dot": 0, "cg_update1_given": 0,
                                  "cg_update2_given": 0, "tet_prox": 0,
                                  "tet_grad": 0}
    # host reads per trial: the loop test, the cache test, the AA Gram
    # matrix, and one per CG loop test
    assert st["host_reads"] >= 3 * st["trials"] + st["cg_iters"]


def _fields(b):
    out = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
    out = {k: (v if isinstance(v, (int, float)) or v is None
               else np.asarray(v)) for k, v in out.items()}
    out["_host"] = getattr(b, "_host", None)
    return out


def test_solve_alm_chunk_from_carried_state(scene, tmp_path):
    """Run four iterations in JAX, carry the state across, then one more
    chunk of four iterations in both packages from that same state."""
    verts, faces, el = scene
    ref_v, ref_f = _height_field()
    mesh = jpoly.PolyMesh(verts=verts, faces=faces)
    F = np.asarray(faces)
    corners = np.concatenate([np.stack([F[:, i], F[:, (i + 1) % 4],
                                        F[:, (i + 3) % 4]], 1)
                              for i in range(4)])
    edges = np.asarray(sorted(mesh.edge_faces), np.int64)
    soft = jc.RefSurfaceBatch.create(list(range(len(verts))), 1.0, ref_v, ref_f)
    hard = [jc.AngleBatch.create(corners, 1.0, np.pi / 4, 3 * np.pi / 4),
            jc.EdgeLengthBatch.create(edges, 1.0, el)]

    js = jg.ALMGeometrySolver(dense_threshold=0)
    ts = tg.ALMGeometrySolver(dense_threshold=0, device="cpu")
    js.add_soft_constraint(soft)
    ts.add_soft_constraint(convert.batch_from_numpy("RefSurfaceBatch",
                                                    _fields(soft)))
    for b in hard:
        js.add_hard_constraint(b)
        ts.add_hard_constraint(convert.batch_from_numpy(type(b).__name__,
                                                        _fields(b)))
    for s in (js, ts):
        s.setup_ADMM(len(verts), 1000.0)
        s.solve_ADMM(verts, 1e-8, 4, 5)      # sets the anchors (chunk 4)
    mg = js.system.mg
    tsys = dataclasses.replace(ts.system, mg=convert.two_level_from_numpy(
        np.asarray(mg.agg), np.asarray(mg.Ac_inv), np.asarray(mg.inv_diag)))

    st = jg._alm_init_state(js.system, jnp.asarray(verts))
    st["max_trials"] = jnp.asarray(40, jnp.int32)
    st = jg.solve_alm_chunk(js.system, st)
    st = dict(st, it=jnp.zeros((), jnp.int32),
              fv=jnp.full((4,), jnp.nan), rj=jnp.zeros((4,), jnp.int32),
              cgit=jnp.zeros((), jnp.int32))
    carried = convert.alm_state_from_numpy(jax.device_get(st))
    assert carried["trial"] == int(st["trial"]) > 0

    out_j = jax.device_get(jg.solve_alm_chunk(js.system, st))
    out_t = tg.solve_alm_chunk(tsys, carried)
    assert int(out_j["it"]) == int(out_t["it"]) == 4
    assert int(out_j["trial"]) == out_t["trial"]
    np.testing.assert_allclose(out_t["fv"].numpy(), out_j["fv"], rtol=FV_RTOL)
    np.testing.assert_array_equal(out_t["rj"].numpy(), out_j["rj"])
    np.testing.assert_allclose(out_t["dx"].numpy(), out_j["dx"], rtol=0,
                               atol=X_ATOL)
    assert out_t["cgit"] - carried["cgit"] > 0


def test_energies_diagonal_and_solve_alm_match_jax(scene, tmp_path):
    """soft_energy, the Jacobi diagonal and a one-dispatch solve_alm on
    the systems that optimize_mesh set up (dense path, 5 iterations)."""
    import torch
    verts, faces, el = scene
    ref_v = np.array([[-1.0, -1, 0], [6, -1, 0], [6, 6, 0], [-1, 6, 0]])
    ref_f = np.array([[0, 1, 2], [0, 2, 3]])
    js = jwm.optimize_mesh(jpoly.PolyMesh(verts=verts, faces=faces), ref_v,
                           ref_f, max_iter=5, anderson_m=5, edge_length=el,
                           result_dir=str(tmp_path / "j"))
    ts = twm.optimize_mesh(twm.PolyMesh(verts=verts, faces=faces), ref_v,
                           ref_f, max_iter=5, anderson_m=5, edge_length=el,
                           result_dir=str(tmp_path / "t"), device="cpu")
    x = js.get_solution()
    np.testing.assert_allclose(
        float(tg.soft_energy(ts.system, torch.tensor(x))),
        float(jg.soft_energy(js.system, jnp.asarray(x))), rtol=1e-12)
    n = len(verts)
    d_t = tg._geometry_node_diag(n, ts.hard, ts.soft, 1000.0, None)
    d_j = jg._geometry_node_diag(n, js.hard, js.soft, 1000.0, None)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-14)
    np.testing.assert_allclose(d_t, np.diag(ts._A_host), rtol=1e-12)
    tr_j = jg.solve_alm(js.system, jnp.asarray(verts))
    tr_t = tg.solve_alm(ts.system, torch.tensor(verts))
    assert tr_t.n_trials == int(tr_j.n_trials)
    np.testing.assert_allclose(tr_t.function_values.numpy(),
                               np.asarray(tr_j.function_values), rtol=FV_RTOL)
    np.testing.assert_allclose(tr_t.x.numpy(), np.asarray(tr_j.x), rtol=0,
                               atol=X_ATOL)


def test_chunked_solve_matches_single_dispatch(scene):
    """Chunked dispatch reproduces the single-dispatch trajectory exactly
    (the trial budget is carried across chunks), and zero iterations
    return the input unchanged."""
    verts, faces, el = scene
    ref_v = np.array([[-1.0, -1, 0], [6, -1, 0], [6, 6, 0], [-1, 6, 0]])
    ref_f = np.array([[0, 1, 2], [0, 2, 3]])
    mesh = twm.PolyMesh(verts=verts, faces=faces)
    F = np.asarray(faces)
    corners = np.concatenate([np.stack([F[:, i], F[:, (i + 1) % 4],
                                        F[:, (i + 3) % 4]], 1)
                              for i in range(4)])

    def solver():
        s = tg.ALMGeometrySolver(device="cpu")
        s.add_soft_constraint(twm.RefSurfaceBatch.create(
            list(range(len(verts))), 1.0, ref_v, ref_f))
        s.add_hard_constraint(twm.AngleBatch.create(corners, 1.0, np.pi / 4,
                                                    3 * np.pi / 4))
        s.add_hard_constraint(twm.EdgeLengthBatch.create(
            np.asarray(sorted(mesh.edge_faces)), 1.0, el))
        s.setup_ADMM(len(verts), 1000.0)
        return s

    s1, s2 = solver(), solver()
    t1 = s1.solve_ADMM(verts, 1e-8, 12, 5)
    t2 = s2.solve_ADMM(verts, 1e-8, 12, 5, chunk_iters=5)
    assert s1.function_values == s2.function_values
    assert s1.anderson_reset == s2.anderson_reset
    assert t1.n_trials == t2.n_trials
    np.testing.assert_array_equal(s2.get_solution(), s1.get_solution())
    trace = s1.solve_ADMM(verts, 1e-8, 0, 5)
    np.testing.assert_array_equal(s1.get_solution(), verts)
    assert trace.function_values.shape == (0,) and s1.function_values == []
