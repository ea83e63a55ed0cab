"""The zxu physics order of the PyTorch port against the JAX package at f64
on the CPU.

Each scene is built twice, by the JAX package's PhysicsSolver and by the
port's (device="cpu"), and stepped in both: the port's step must match the
JAX ``step_zxu`` with equal reject sequences, primal residuals to 1e-10
relative (and positions to 1e-12 relative); the JAX system is also carried
across with ``convert.physics_system_from_numpy`` and stepped by the port's
``step_zxu`` from the JAX state. Scenes: the small beam of
tests/test_physics.py without and with Anderson (m = 5); a block pressed
into a floor and all five analytic obstacle kinds with collision terms
(tests/test_physics.py:144-172, moved down into them); a block pressed into
a tet-mesh obstacle (tests/test_collider.py:82-110); a 12 x 12 cloth with
jacobi and with sequential wind (and the xzu cloth with wind); the
self-collision scenes of tests/test_selfcollision.py, contact sets equal;
and the three apps on synthetic mesh files.

Combined residuals are compared to 1e-10 relative where they lie above
1e-14 of the step's first, the floor the zxu combined residual reaches
after collisions: it is the squared norm of a difference of nearly equal
positions there, so a few ulps of x (at 1e-16 relative) move it by more than
its own size. Below that floor both runs are required to be below it too.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_admm_tpu.apps import plinkohit as jhit
from aa_admm_tpu.apps import plinkopony as jpony
from aa_admm_tpu.apps import windyflag as jflag
from aa_admm_tpu.core import config as jcfg
from aa_admm_tpu.core.factory import make_plane_grid, make_tet_blocks
from aa_admm_tpu.ops import elements as jel
from aa_admm_tpu.ops.collider import DynamicTetCollider as JDense
from aa_admm_tpu.solver import linear as jlin
from aa_admm_tpu.solver import physics as jphys
from aa_admm_tpu_torch import convert
from aa_admm_tpu_torch.apps import plinkohit as thit
from aa_admm_tpu_torch.apps import plinkopony as tpony
from aa_admm_tpu_torch.apps import windyflag as tflag
from aa_admm_tpu_torch.apps._data import find_data
from aa_admm_tpu_torch.core import config as tcfg
from aa_admm_tpu_torch.core.meshio import save_elenode, save_obj
from aa_admm_tpu_torch.ops import elements as tel
from aa_admm_tpu_torch.ops.collider import DynamicTetCollider as TDense
from aa_admm_tpu_torch.ops.collider import HashGridTetCollider as THash
from aa_admm_tpu_torch.solver import linear as tlin
from aa_admm_tpu_torch.solver import physics as tphys

RTOL, XTOL, PRIM_FLOOR, COMB_FLOOR, SPREAD_K = 1e-10, 1e-12, 1e-11, 1e-12, 100
SNAP_TOL, SELF_FLOOR = 2e-6, 1e-10
STATICS = ("n_verts", "n_free", "order", "dt", "gravity", "dt2p",
           "admm_iters", "anderson_m", "accel", "collect_comb", "cg_tol",
           "cg_max_iters")
J = types.SimpleNamespace(Solver=jphys.PhysicsSolver, cfg=jcfg, kw={})
T = types.SimpleNamespace(Solver=tphys.PhysicsSolver, cfg=tcfg,
                          kw=dict(device="cpu"))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Single-threaded torch, as the other physics tests run it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _settings(P, accel, iters, m=5):
    s = P.cfg.Settings()
    s.admm_iters = iters
    s.verbose = 0
    s.dtype = np.dtype(np.float64)
    if accel:
        s.acceleration_type = P.cfg.AccelType.ANDERSON
        s.anderson_m = m
    return s


def _scene(build, accel, iters, order="zxu"):
    """make(P): the package P's solver of one scene, initialized."""
    def make(P):
        solver = P.Solver(order=order, **P.kw)
        build(P, solver)
        assert solver.initialize(_settings(P, accel, iters))
        return solver
    return make


def _pair(build, accel, iters, order="zxu"):
    """The JAX and the port's solver of one scene, initialized."""
    make = _scene(build, accel, iters, order)
    return make(J), make(T)


def _fields(b):
    """A JAX batch's (or wind's) fields as NumPy (nested scenes, mesh
    obstacles and the wind as objects of NumPy arrays), with its host
    mirror."""
    host = jax.device_get(b)
    out = {f.name: getattr(host, f.name) for f in dataclasses.fields(b)}
    if hasattr(b, "_host"):
        out["_host"] = b._host
    return out


def _system_fields(js):
    f = {k: getattr(js, k) for k in STATICS}
    f.update(masses=np.asarray(js.masses), free_mask=np.asarray(js.free_mask),
             free_idx=np.asarray(js.free_idx),
             batches=[(type(b).__name__, _fields(b)) for b in js.batches],
             Ainv=None if js.solver is None else np.asarray(js.solver.Ainv),
             precond_diag=(None if js.precond_diag is None
                           else np.asarray(js.precond_diag)),
             wind=None if js.wind is None else _fields(js.wind),
             elem_sharding=None)
    return f


def _trace(tr):
    return {k: np.asarray(getattr(tr, k)) for k in ("prim", "comb", "reject")}


def _nudged(x, seed=0):
    """x moved by one unit in the last place, up or down at random."""
    return x * (1 + 1e-16 * np.random.default_rng(seed).choice([-1, 1],
                                                               size=x.shape))


def _assert_traces(t, j, spread=None):
    """The port's trace `t` against the JAX trace `j`. Without `spread`,
    at the fixed tolerances; with it (the port's own trace after a one-ulp
    nudge), over the head before the nudged run's first different reject
    and within SPREAD_K times its differences, or the fixed tolerances,
    whichever is larger."""
    n, prim_tol, comb_tol = len(j["prim"]), 0.0, 0.0
    if spread is not None:
        split = ((spread["reject"] != t["reject"])
                 | (np.isnan(spread["prim"]) != np.isnan(t["prim"])))
        n = int(np.argmax(split)) if split.any() else n
        ok = ~np.isnan(t["prim"][:n])
        prim_tol = SPREAD_K * np.abs(spread["prim"][:n] - t["prim"][:n])[ok].max(
            initial=0.0)
        comb_tol = SPREAD_K * np.abs(spread["comb"][:n] - t["comb"][:n])[ok].max(
            initial=0.0)
    t = {k: v[:n] for k, v in t.items()}
    j = {k: v[:n] for k, v in j.items()}
    np.testing.assert_array_equal(t["reject"], j["reject"])
    np.testing.assert_array_equal(np.isnan(t["prim"]), np.isnan(j["prim"]))
    ok = ~np.isnan(j["prim"])
    assert ok.sum() >= 1
    np.testing.assert_allclose(
        t["prim"][ok], j["prim"][ok], rtol=RTOL,
        atol=max(PRIM_FLOOR * j["prim"][0], prim_tol))
    np.testing.assert_allclose(
        t["comb"][ok], j["comb"][ok], rtol=RTOL,
        atol=max(COMB_FLOOR * j["comb"][0], comb_tol))


def _assert_x(xt, xj, spread=None):
    tol = XTOL if spread is None else max(
        XTOL, SPREAD_K * np.abs(spread - xt).max())
    np.testing.assert_allclose(xt, xj, rtol=XTOL, atol=tol)


def _compare(make, frames=1, strict=None):
    """Step the JAX and the port's solver of a scene (make(P), as _scene
    returns) `frames` times, comparing each step: the first `strict`
    (default all) at the fixed tolerances, later ones against the spread of
    the port's own run from one-ulp-nudged positions. Then the JAX system
    carried across through the port's step function from the JAX state of
    the last step. Returns the two solvers."""
    strict = frames if strict is None else strict
    js, ts = make(J), make(T)
    order = ts.order.value
    nudged = None
    if strict < frames:
        nudged = make(T)
        nudged.x = _nudged(nudged.x)
    step = tphys.step_zxu if order == "zxu" else tphys.step_xzu
    for f in range(frames):
        state = (np.array(js.x), np.array(js.v), np.array(js.pin_pos))
        jt, tt = _trace(js.step()), _trace(ts.step())
        st = sx = None
        if f >= strict:
            st, sx = _trace(nudged.step()), None
            sx = nudged.x
        elif nudged is not None:
            nudged.step()
        _assert_traces(tt, jt, st)
        _assert_x(ts.x, np.asarray(js.x), sx)
    system = convert.physics_system_from_numpy(_system_fields(js.system))
    assert system.order == order and system.dt2p == js.system.dt2p
    if ts._selfcol_index is not None:       # the last step's contacts
        b = system.batches[ts._selfcol_index]
        tb = ts.system.batches[ts._selfcol_index]
        for name in ("active", "target", "normal"):
            getattr(b, name).copy_(getattr(tb, name))
    x1, _, tr = step(system, *map(torch.from_numpy, state))
    _assert_traces(_trace(tr), jt, st)
    _assert_x(x1.numpy(), np.asarray(js.x), sx)
    return js, ts


# ---------------------------------------------------------------------------
# The cloth batch and its assembly
# ---------------------------------------------------------------------------

def _cloth(n=12, size=1.9, seed=0):
    mesh = make_plane_grid(n, n, size=size)
    g = np.random.default_rng(seed)
    return mesh, mesh.verts + 0.05 * g.normal(size=mesh.verts.shape)


@pytest.mark.parametrize("variant", ["zxu", "xzu"])
def test_tri_batch_matches_jax(variant):
    mesh, x = _cloth()
    lame = (0.95, 1.05) if variant == "zxu" else (0.9, 1.1)
    jb = jel.TriBatch.from_mesh(mesh.verts, mesh.faces, jcfg.Lame.from_young_poisson(
        50, 0.1, limit_min=lame[0], limit_max=lame[1]), variant=variant)
    tb = tel.TriBatch.from_mesh(mesh.verts, mesh.faces, tcfg.Lame.from_young_poisson(
        50, 0.1, limit_min=lame[0], limit_max=lame[1]), variant=variant)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    Fj, Ft = jb.deform(xj), tb.deform(xt)
    assert Ft.shape == (6, len(mesh.faces))
    np.testing.assert_allclose(Ft.numpy(), np.asarray(Fj), rtol=1e-13,
                               atol=1e-13)
    t = np.random.default_rng(1).normal(size=Ft.shape)
    n = len(x)
    np.testing.assert_allclose(tb.scatter(torch.from_numpy(t), n).numpy(),
                               np.asarray(jb.scatter(jnp.asarray(t), n)),
                               rtol=1e-12, atol=1e-12)
    # adjoint: <D x, t> == <x, D^T t>
    lhs = float((Ft * torch.from_numpy(t)).sum())
    rhs = float((xt * tb.scatter(torch.from_numpy(t), n)).sum())
    assert abs(lhs - rhs) < 1e-9 * max(1.0, abs(lhs))
    for name in ("prox", "grad"):
        np.testing.assert_allclose(getattr(tb, name)(Ft).numpy(),
                                   np.asarray(getattr(jb, name)(Fj)),
                                   rtol=1e-11, atol=1e-11)
    for name in ("energy", "strain_violation"):
        np.testing.assert_allclose(getattr(tb, name)(Ft).numpy(),
                                   np.asarray(getattr(jb, name)(Fj)),
                                   rtol=1e-10, atol=1e-12)
    assert float(tb.strain_violation(Ft).sum()) > 0


def test_cloth_assembly_matches_jax():
    mesh, _ = _cloth(6)
    lame = (0.95, 1.05)
    jb = [jel.TriBatch.from_mesh(mesh.verts, mesh.faces,
                                 jcfg.Lame.from_young_poisson(50, 0.1, *lame)),
          jel.CollisionBatch.create(np.arange(0, 49, 3),
                                    jel.SdfScene.empty())]
    tb = [tel.TriBatch.from_mesh(mesh.verts, mesh.faces,
                                 tcfg.Lame.from_young_poisson(50, 0.1, *lame)),
          tel.CollisionBatch.create(np.arange(0, 49, 3), None)]
    n = len(mesh.verts)
    m = np.linspace(1.0, 2.0, n)
    np.testing.assert_allclose(tlin.assemble_node_matrix(n, tb, 0.3, m),
                               jlin.assemble_node_matrix(n, jb, 0.3, m),
                               rtol=1e-13, atol=1e-12)
    np.testing.assert_allclose(tlin.assemble_node_diag(n, tb),
                               jlin.assemble_node_diag(n, jb), rtol=1e-13)


# ---------------------------------------------------------------------------
# zxu steps
# ---------------------------------------------------------------------------

def _beam(P, solver):
    """tests/test_physics.py's small scene: a 4x2x2 block, x-end pinned."""
    mesh = make_tet_blocks(4, 2, 2)
    lo, hi = mesh.bounds()
    verts = (mesh.verts - 0.5 * (lo + hi)) / (hi - lo)[1]
    solver.add_tetmesh(verts, mesh.tets,
                       P.cfg.Lame.from_young_poisson(1e6, 0.35))
    solver.set_pins(np.nonzero(verts[:, 0] < verts[:, 0].min() + 1e-3)[0])


@pytest.mark.parametrize("accel", [False, True], ids=["noacc", "aa5"])
def test_beam_step_matches_jax(accel):
    js, ts = _compare(_scene(_beam, accel, 40), frames=2)
    assert ts.system.dt2p == ts.settings.penalty * ts.settings.timestep_s ** 2
    # host reads: two per accelerated iteration (the reject test and the AA
    # Gram matrix), none otherwise (dense path)
    assert ts.stats["host_reads"] == (2 * 2 * 40 if accel else 0)


def _obstacle_scene(P, solver):
    """tests/test_physics.py:144-172's block and five obstacle kinds, the
    block moved down into them so the collision terms act at once."""
    mesh = make_tet_blocks(2, 2, 2)
    solver.add_tetmesh(mesh.verts + [-0.93, -3.17, -1.07], mesh.tets,
                       P.cfg.Lame.rubber())
    solver.add_obstacle("floor", y=-2.0)
    solver.add_obstacle("slide_floor", center=[0.0, -3.0, 0.0],
                        normal=[0.5, np.sqrt(3.0) / 2.0, 0.0])
    solver.add_obstacle("sphere", center=[0.0, -2.0, 0.0], rad=0.5)
    solver.add_obstacle("plane_half_sphere", center=[0.0, -3.0, 0.0], rad=1.0)
    solver.add_obstacle("cylinder", center=[0.0, -2.5, 0.0], rad=0.4)
    solver.set_collisions(list(range(len(mesh.verts))))


def _mesh_obstacle_scene(P, solver):
    """tests/test_collider.py:82-110's box on a tet-mesh slab, moved down
    into the slab."""
    falling = make_tet_blocks(1, 1, 1)
    obstacle = make_tet_blocks(1, 1, 1)
    obstacle.verts = (obstacle.verts * np.array([3.0, 1.0, 3.0])
                      + np.array([-1.0, -1.5, -1.0]))
    solver.add_tetmesh(falling.verts + [0.13, -0.63, 0.29], falling.tets,
                       P.cfg.Lame.rubber())
    solver.add_obstacle("mesh", verts=obstacle.verts, tets=obstacle.tets)
    solver.set_collisions(list(range(len(falling.verts))))


@pytest.mark.parametrize("scene,accel", [("obstacles", False),
                                         ("obstacles", True),
                                         ("mesh_obstacle", False)])
def test_collision_step_matches_jax(scene, accel):
    """Strict on the first frame, the second within the port's one-ulp
    spread. The mesh obstacle is run without Anderson: with it the scene is
    chaotic at roundoff from its first frame on (the JAX package, its
    positions nudged by one ulp, rejects at iterations 6 and 14 where it
    did not, and its primal residual moves by 1.4e2 relative)."""
    build = _obstacle_scene if scene == "obstacles" else _mesh_obstacle_scene
    js, ts = _compare(_scene(build, accel, 15), frames=2, strict=1)
    b = ts.system.batches[-1]
    assert isinstance(b, tel.CollisionBatch)
    assert len(b.mesh_sdfs) == (scene == "mesh_obstacle")
    # the obstacles pushed some vertices back up
    x0 = np.concatenate(ts.verts)
    assert (ts.x[:, 1] > x0[:, 1]).any()


def _cloth_scene(mode):
    def build(P, solver):
        mesh, _ = _cloth()
        lame = P.cfg.Lame.from_young_poisson(50, 0.1, limit_min=0.95,
                                             limit_max=1.05)
        solver.add_trimesh(mesh.verts, mesh.faces, lame)
        solver.set_pins(tflag.get_pins(mesh.verts))
        solver.set_wind(mesh.faces, np.array([10.0, 0.0, 2.0]) * 2.5,
                        mode=mode)
    return build


@pytest.mark.parametrize("mode,order", [("jacobi", "zxu"),
                                        ("sequential", "zxu"),
                                        ("jacobi", "xzu")])
def test_cloth_wind_step_matches_jax(mode, order):
    js, ts = _compare(_scene(_cloth_scene(mode), True, 30, order), frames=2,
                      strict=1 if (mode, order) == ("jacobi", "zxu") else 2)
    assert ts.system.wind.mode == mode
    assert ts.system.batches[0].variant == order
    # the wind blew the cloth out of its plane; the pins held
    pins = sorted(ts.pins)
    x0 = np.concatenate(ts.verts)
    assert np.isfinite(ts.x).all() and np.abs(ts.x[:, 2] - x0[:, 2]).max() > 0.1
    np.testing.assert_allclose(ts.x[pins], x0[pins], atol=1e-12)


def test_wind_modes_differ_and_sequential_is_the_loop():
    """The sequential kick equals a plain per-triangle loop over the face
    order; the jacobi kick differs from it."""
    mesh, x = _cloth(4)
    v = np.random.default_rng(5).normal(size=x.shape)
    w = [tphys.WindForce(faces=torch.from_numpy(mesh.faces.astype(np.int64)),
                         direction=torch.tensor([25.0, 0.0, 5.0]),
                         alpha_n=10.0, mode=m)
         for m in ("jacobi", "sequential")]
    outs = [wi.apply(0.03, torch.from_numpy(x), torch.from_numpy(v), len(x))
            for wi in w]
    vv = v.copy()
    for f in mesh.faces:
        n = np.cross(x[f[1]] - x[f[0]], x[f[2]] - x[f[0]])
        area = 0.5 * np.linalg.norm(n)
        n = n / np.linalg.norm(n)
        vn = n @ (vv[f].mean(0) - [25.0, 0.0, 5.0])
        vv[f] += (-10.0 * area * 0.33 * 0.03) * vn * abs(vn) * n
    np.testing.assert_allclose(outs[1].numpy(), vv, rtol=1e-12, atol=1e-12)
    assert np.abs(outs[0].numpy() - vv).max() > 1e-3


# ---------------------------------------------------------------------------
# Self-collision
# ---------------------------------------------------------------------------

def _two_blocks(top_y, self_collision=True):
    def build(P, solver):
        bottom = make_tet_blocks(2, 1, 2)
        top = make_tet_blocks(1, 1, 1)
        o0 = solver.add_tetmesh(bottom.verts, bottom.tets, P.cfg.Lame.rubber(),
                                self_collision=self_collision)
        solver.add_tetmesh(top.verts + [0.5, top_y, 0.5], top.tets,
                           P.cfg.Lame.rubber(), self_collision=self_collision)
        solver.set_pins(list(range(o0, o0 + len(bottom.verts))))
    return build


def _contacts(solver):
    b = solver.system.batches[solver._selfcol_index]
    return tuple(np.asarray(getattr(b, f)) for f in ("active", "target",
                                                      "normal"))


def _assert_contacts(ct, cj):
    np.testing.assert_array_equal(ct[0], cj[0])
    for a, b in zip(ct[1:], cj[1:]):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)


def test_self_collision_steps_match_jax():
    """tests/test_selfcollision.py's falling block, started just above the
    pinned slab, each step from the JAX state: the contact set refreshed at
    the step's start equals the JAX one, and so does the step.

    Until the block lands, nothing deforms: both runs' primal residuals lie
    at the roundoff floor of the weighted deformation gradients (about
    2e-10), and over all steps without contacts the residuals differ by at
    most 4.9e-11 absolute (measured), so those are compared at rtol 1e-10
    above SELF_FLOOR = 1e-10 absolute. In a step with contacts the
    hard snap is discontinuous: a vertex that the previous iteration snapped
    onto its contact plane is snapped again or not by the sign of a
    roundoff-sized dot product. Measured on this scene: in the first
    contact step one such flip moves the primal residual by 5.3e-7
    relative, the combined residual by 1.06e-6 and the positions by 5.7e-7,
    so contact steps are held to SNAP_TOL; the second contact step agrees
    to 1.6e-14."""
    make = _scene(_two_blocks(1.05), False, 10)
    js, ts = make(J), make(T)
    contact_steps = 0
    for _ in range(12):
        x, v = np.array(js.x), np.array(js.v)
        ts.x, ts.v = x, v
        jt, tt = _trace(js.step()), _trace(ts.step())
        _assert_contacts(_contacts(ts), _contacts(js))
        if _contacts(ts)[0].any():
            contact_steps += 1
            np.testing.assert_array_equal(tt["reject"], jt["reject"])
            for k in ("prim", "comb"):
                np.testing.assert_allclose(tt[k], jt[k], rtol=SNAP_TOL)
            np.testing.assert_allclose(ts.x, np.asarray(js.x), rtol=0,
                                       atol=SNAP_TOL)
        else:
            np.testing.assert_array_equal(tt["reject"], jt["reject"])
            for k in ("prim", "comb"):
                np.testing.assert_allclose(tt[k], jt[k], rtol=RTOL,
                                           atol=SELF_FLOOR)
            _assert_x(ts.x, np.asarray(js.x))
    assert contact_steps >= 2, "too few contacts"
    with pytest.raises(RuntimeError, match="step"):
        ts.run(1)


def test_self_contact_escalation_matches_jax():
    """tests/test_selfcollision.py:59-108: a hash collider forced to
    overflow (1 bucket, cap 1) escalates to the dense collider, and its
    contact set equals the dense collider's and the JAX package's."""
    def build(overflowing, P):
        def b(_, solver):
            _two_blocks(0.95, self_collision=False)(P, solver)
            bottom, top = make_tet_blocks(2, 1, 2), make_tet_blocks(1, 1, 1)
            top.verts = top.verts + [0.5, 0.95, 0.5]
            nb = len(bottom.verts)
            if overflowing:
                solver.add_dynamic_collider(bottom.verts, bottom.tets, 0,
                                            n_buckets=1, cap=1)
                solver.add_dynamic_collider(top.verts, top.tets, nb,
                                            n_buckets=1, cap=1)
            else:
                D = JDense if P is J else TDense
                solver.dynamic_colliders = [
                    D.create(bottom.verts, bottom.tets, 0),
                    D.create(top.verts, top.tets, nb)]
        return b

    out = {}
    for P in (J, T):
        for ov in (False, True):
            solver = P.Solver(order="zxu", **P.kw)
            build(ov, P)(P, solver)
            solver.initialize(_settings(P, False, 5))
            solver._refresh_self_contacts()
            out[P is J, ov] = (solver, _contacts(solver))
    ref = out[False, False][1]
    assert ref[0].any(), "the scene must touch"
    for key in ((False, True), (True, False), (True, True)):
        _assert_contacts(out[key][1], ref)
    t_ov, j_ov = out[False, True][0], out[True, True][0]
    assert ([type(c).__name__ for c in t_ov.dynamic_colliders]
            == [type(c).__name__ for c in j_ov.dynamic_colliders])
    assert not any(isinstance(c, THash) for c in t_ov.dynamic_colliders)
    assert t_ov.stats["host_reads"] > out[False, False][0].stats["host_reads"]


# ---------------------------------------------------------------------------
# The apps on synthetic mesh files
# ---------------------------------------------------------------------------

def _block_file(tmp_path, y_low, x_mid):
    """A 3x2x2 tet block written as .ele/.node, placed so that the app's
    transform (x 13, then the app's shift) puts its lowest face at y_low
    and its x centre at x_mid, 0.5 units wide."""
    mesh = make_tet_blocks(3, 2, 2)
    v = mesh.verts / 6.0                       # 0.5 x 0.33 x 0.33
    v = v - [v[:, 0].mean(), v[:, 1].min(), v[:, 2].mean()]
    mesh.verts = (v + [x_mid, y_low, 0.0]) / 13.0
    base = str(tmp_path / "block")
    save_elenode(base, mesh)
    return base


@pytest.mark.parametrize("app", ["plinkohit", "plinkopony", "windyflag"])
def test_app_matches_jax(app, tmp_path):
    if app == "plinkohit":      # the block's foot in the plane
        path = _block_file(tmp_path, (-3.05 - 2.5), 1.6)
        mods, iters = (jhit, thit), 13
    elif app == "plinkopony":   # the block's foot on the peg at (0, 0)
        path = _block_file(tmp_path, (0.35 - 5.0), -0.1)
        mods, iters = (jpony, tpony), 13
    else:
        mesh = make_plane_grid(8, 8, size=1.9)
        path = str(tmp_path / "cloth.obj")
        save_obj(path, mesh.verts, mesh.faces)
        mods, iters = (jflag, tflag), 30
    def make(P):
        mod = mods[P is T]
        return mod.build_scene(_settings(P, True, iters), mesh_path=path,
                               **P.kw)

    # -a 1 -am 5, the goldens' protocol. The cloth is coarse (8 x 8 over
    # 1.9 units), so each triangle's wind kick is large and the scene is
    # sensitive from its first frame: one-ulp nudges move its primal
    # residual by about 1e-11 of the first; it is held to that spread.
    js, ts = _compare(make, frames=2, strict=0 if app == "windyflag" else 1)
    assert ts.order == tphys.UpdateOrder.ZXU and ts.device.type == "cpu"
    if app != "windyflag":
        x0 = np.concatenate(ts.verts)
        assert (ts.x[:, 1] > x0[:, 1] - 0.1).all()


def test_app_main_writes_reject_column(tmp_path):
    path = _block_file(tmp_path, -5.0, 0.3)
    solver = thit.main(["-a", "1", "-am", "5", "-it", "4", "--mesh", path,
                        "--cpu"], n_frames=2, result_dir=str(tmp_path / "r"))
    assert solver.device.type == "cpu"
    rows = [r.split("\t") for r in
            (tmp_path / "r" / "residual-5.txt").read_text().split("\n") if r]
    assert len(rows) == len(solver.step_prim) and 0 < len(rows) <= 8
    assert all(len(r) == 4 and r[3] in ("0", "1") for r in rows)
    try:
        find_data("horse759")
    except FileNotFoundError:     # the reference meshes are not at hand
        with pytest.raises(FileNotFoundError, match="AAADMM_DATA"):
            thit.build_scene(_settings(T, False, 2), device="cpu")
