"""The port's fixed-order scatter (aa_admm_tpu_torch.ops._batchutil): every
scatter-add of the port runs in gather form over an inverse table built on
the host, ``sum_k contrib[inv_idx[v, k]] * inv_mask[v, k]``.

On the CPU at f64, against the JAX package: ``build_inverse_table`` gives the
same arrays; every scatter site (the five constraint batches, the five
element batches, the jacobi wind, the regularization rows and the coarse
restriction) matches the JAX package's ``segment_sum`` (or ``.at[].add``) to
rtol/atol 1e-13, the bound of tests/test_geometry.py:439 (the same sums in
another order); ``with_gather_adjoint`` keeps the batch's own table, in the
device dtype after a cast, as tests/test_geometry.py:442-455 asks; the
gather sums in segment_sum's order; ``convert`` carries a JAX batch's
table or builds one. Inputs come from seeded numpy.

On the card (``cuda`` marker): two fused steps of beams and of windyflag
from one state are bit-equal without deterministic algorithms."""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_admm_tpu.core import config as jcfg
from aa_admm_tpu.core import factory as jfac
from aa_admm_tpu.ops import _batchutil as jbu
from aa_admm_tpu.ops import constraints as jc
from aa_admm_tpu.ops import elements as jel
from aa_admm_tpu.solver import geometry as jg
from aa_admm_tpu.solver import multigrid as jmg
from aa_admm_tpu.solver import physics as jph
from aa_admm_tpu_torch.core import config as tcfg
from aa_admm_tpu_torch.ops import _batchutil as tbu
from aa_admm_tpu_torch.ops import constraints as tc
from aa_admm_tpu_torch.ops import elements as tel
from aa_admm_tpu_torch.solver import geometry as tg
from aa_admm_tpu_torch.solver import multigrid as tmg
from aa_admm_tpu_torch.solver import physics as tph

TOL = dict(rtol=1e-13, atol=1e-13)
N = 40


def _both(jb, tb, shape, rng, n=N):
    t = rng.standard_normal(shape)
    return (tb.scatter(torch.from_numpy(t), n).numpy(),
            np.asarray(jb.scatter(jnp.asarray(t), n)))


def _plane(rng):
    faces = [list(rng.choice(N, size=rng.integers(3, 7), replace=False))
             for _ in range(15)]
    jb, tb = jc.PlaneBatch.create(faces, 1.0), tc.PlaneBatch.create(faces, 1.0)
    return _both(jb, tb, jb.block_shape, rng)


def _angle(rng):
    tri = rng.integers(0, N, (25, 3))
    return _both(jc.AngleBatch.create(tri, 1.0, 0.3, 2.8),
                 tc.AngleBatch.create(tri, 1.0, 0.3, 2.8), (25, 2, 3), rng)


def _edge(rng):
    e = rng.integers(0, N, (30, 2))
    return _both(jc.EdgeLengthBatch.create(e, 1.0, 0.9),
                 tc.EdgeLengthBatch.create(e, 1.0, 0.9), (30, 1, 3), rng)


def _closeness(rng):
    idx = rng.integers(0, N, 50)                 # repeats: real sums
    tgt = rng.standard_normal((50, 3))
    return _both(jc.ClosenessBatch.create(idx, 2.0, tgt),
                 tc.ClosenessBatch.create(idx, 2.0, tgt), (50, 1, 3), rng)


def _refsurface(rng):
    idx = rng.integers(0, N - 5, 60)             # the last rows stay empty
    rv = np.array([[-1.0, -1, 0], [6, -1, 0], [6, 6, 0], [-1, 6, 0]])
    rf = np.array([[0, 1, 2], [0, 2, 3]])
    return _both(jc.RefSurfaceBatch.create(idx, 1.0, rv, rf),
                 tc.RefSurfaceBatch.create(idx, 1.0, rv, rf), (60, 1, 3), rng)


def _tet(rng):
    m = jfac.make_tet_blocks(3, 2, 2)
    lame = (jcfg.Lame.rubber(), tcfg.Lame.rubber())
    jb = jel.TetBatch.from_mesh(m.verts, m.tets, lame[0])
    tb = tel.TetBatch.from_mesh(m.verts, m.tets, lame[1])
    return _both(jb, tb, (9, len(m.tets)), rng, n=len(m.verts))


def _tri(rng):
    m = jfac.make_plane_grid(5, 4)
    jb = jel.TriBatch.from_mesh(m.verts, m.faces, jcfg.Lame.rubber())
    tb = tel.TriBatch.from_mesh(m.verts, m.faces, tcfg.Lame.rubber())
    return _both(jb, tb, (6, len(m.faces)), rng, n=len(m.verts))


def _pin(rng):
    idx = rng.choice(N, 12, replace=False)
    tgt = rng.standard_normal((12, 3))
    return _both(jel.PinBatch.create(idx, tgt), tel.PinBatch.create(idx, tgt),
                 (3, 12), rng)


def _collision(rng):
    idx = np.arange(0, N - 3, 3)
    return _both(jel.CollisionBatch.create(idx, jel.SdfScene.empty()),
                 tel.CollisionBatch.create(idx, None), (3, len(idx)), rng)


def _selfcollision(rng):
    return _both(jel.SelfCollisionBatch.create(np.arange(N)),
                 tel.SelfCollisionBatch.create(np.arange(N)), (3, N), rng)


def _wind(rng):
    m = jfac.make_plane_grid(6, 5, size=1.9)
    x = m.verts + 0.05 * rng.standard_normal(m.verts.shape)
    v = rng.standard_normal(m.verts.shape)
    d = np.array([25.0, 0.0, 5.0])
    jw = jph.WindForce(faces=jnp.asarray(m.faces), direction=jnp.asarray(d),
                       alpha_n=10.0)
    tw = tph.WindForce(faces=torch.from_numpy(m.faces.astype(np.int64)),
                       direction=torch.from_numpy(d), alpha_n=10.0)
    n = len(x)
    return (tw.apply(0.03, torch.from_numpy(x), torch.from_numpy(v),
                     n).numpy(),
            np.asarray(jw.apply(0.03, jnp.asarray(x), jnp.asarray(v), n)))


def _reg(rng):
    R, K = 30, 5
    idx = rng.integers(0, N, (R, K))
    mask = np.arange(K)[None, :] < rng.integers(1, K + 1, R)[:, None]
    idx = np.where(mask, idx, 0)                 # padded slots alias 0
    coef = rng.standard_normal((R, K)) * mask
    tgt = rng.standard_normal((R, 3))
    v = rng.standard_normal((N, 3))
    jr = jg.RegRows(idx=jnp.asarray(idx), coef=jnp.asarray(coef),
                    mask=jnp.asarray(mask), target=jnp.asarray(tgt))
    tr = tg.RegRows(idx=torch.from_numpy(idx), coef=torch.from_numpy(coef),
                    mask=torch.from_numpy(mask), target=torch.from_numpy(tgt))
    # vertex 0's row holds its real slots only, not the padded aliases
    assert tr.inv_idx.shape[1] < int((idx == 0).sum())
    return (tg._reg_apply(types.SimpleNamespace(reg=tr),
                          torch.from_numpy(v)).numpy(),
            np.asarray(jg._reg_apply(types.SimpleNamespace(reg=jr),
                                     jnp.asarray(v))))


def _restriction(rng):
    nc = 7
    agg = np.concatenate([np.arange(nc), rng.integers(0, nc, N - nc)])
    rng.shuffle(agg)
    Ac_inv = rng.standard_normal((nc, nc))
    inv_diag = rng.random(N) + 0.5
    r = rng.standard_normal((N, 3))
    tp = tmg.TwoLevelPrecond(agg=torch.from_numpy(agg),
                             Ac_inv=torch.from_numpy(Ac_inv),
                             inv_diag=torch.from_numpy(inv_diag))
    jp = jmg.TwoLevelPrecond(agg=jnp.asarray(agg), Ac_inv=jnp.asarray(Ac_inv),
                             inv_diag=jnp.asarray(inv_diag))
    return tp.apply(torch.from_numpy(r)).numpy(), np.asarray(
        jp.apply(jnp.asarray(r)))


SITES = {"plane": _plane, "angle": _angle, "edge_length": _edge,
         "closeness": _closeness, "ref_surface": _refsurface, "tet": _tet,
         "tri": _tri, "pin": _pin, "collision": _collision,
         "self_collision": _selfcollision, "wind_jacobi": _wind,
         "regularization": _reg, "restriction": _restriction}


@pytest.mark.parametrize("site", sorted(SITES))
def test_scatter_site_matches_jax_segment_sum(site):
    got, want = SITES[site](np.random.default_rng(sorted(SITES).index(site)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("n_extra", [0, 3])
def test_build_inverse_table_matches_jax(n_extra):
    rng = np.random.default_rng(7 + n_extra)
    idx = rng.integers(0, 50, (80, 3))
    n = 50 + n_extra                             # rows with no entry
    ti, tm = tbu.build_inverse_table(idx, n, np.float32)
    ji, jm = jbu.build_inverse_table(idx, n, np.float32)
    assert ti.dtype == ji.dtype and tm.dtype == jm.dtype
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tm, jm)


def test_with_gather_adjoint_rows_and_scatter():
    """with_gather_adjoint keeps the batch's own table (max index + 1 rows,
    built once when the batch was made) and refuses a row count the table
    does not fit; the scatter pads to n rows and sums as the JAX package's
    table of exactly n rows does."""
    rng = np.random.default_rng(3)
    tri = rng.integers(0, 30, (25, 3))
    b = tc.AngleBatch.create(tri, 1.0, 0.3, 2.8)
    n_tab = int(tri.max()) + 1
    assert b.inv_idx.shape[0] == n_tab
    assert tc.with_gather_adjoint(b, N) is b
    with pytest.raises(ValueError):
        tc.with_gather_adjoint(b, n_tab - 1)
    t = torch.from_numpy(rng.standard_normal((25, 2, 3)))
    got = b.scatter(t, N)
    assert got.shape == (N, 3) and not got[n_tab:].any()
    jb = jc.with_gather_adjoint(jc.AngleBatch.create(tri, 1.0, 0.3, 2.8), N)
    assert jb.inv_idx.shape[0] == N
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jb.scatter(jnp.asarray(t), N)),
                               **TOL)


def test_gather_adjoint_respects_cast_dtype():
    """The port's case of tests/test_geometry.py:442-455: a cast_floats'ed
    batch armed for another row count takes the DEVICE dtype for its mask,
    and cast_floats moves a table it already has."""
    rng = np.random.default_rng(5)
    b = tc.AngleBatch.create(rng.integers(0, 20, (10, 3)), 1.0, 0.3, 2.8,
                             dtype=np.float64)
    b32 = tc.cast_floats(b, np.float32, "cpu")
    assert b32.inv_mask.dtype == torch.float32
    assert b32.inv_idx.dtype == torch.int64
    armed = tc.with_gather_adjoint(b32, 25)
    assert armed.inv_mask.dtype == torch.float32, armed.inv_mask.dtype
    assert armed.scatter(torch.zeros((10, 2, 3)), 25).dtype == torch.float32


@pytest.mark.parametrize("case", ["valid_slots", "no_valid_slot",
                                  "row_counts"])
def test_gather_scatter_sums_in_segment_sum_order(case):
    """inverse_table and _gather_scatter against np.add.at in position order
    (segment_sum's), bit for bit at f64 on the CPU: with padded slots left
    out of the table, with none left, and padded to more rows than the
    table has or to exactly its rows."""
    rng = np.random.default_rng(11)
    idx = rng.integers(0, 20, (30, 4))
    valid = {"valid_slots": rng.random((30, 4)) < 0.6,
             "no_valid_slot": np.zeros((30, 4), bool),
             "row_counts": None}[case]
    contrib = rng.standard_normal((120, 3))
    inv_idx, inv_mask = tbu.inverse_table(torch.from_numpy(idx),
                                          torch.float64, valid=valid)
    keep = np.ones(120, bool) if valid is None else valid.reshape(-1)
    if keep.any():
        counts = np.bincount(idx.reshape(-1)[keep])
        assert inv_idx.shape == (len(counts), counts.max())
    else:
        assert inv_idx.shape == (0, 0)
    for n_rows in ((25, inv_idx.shape[0]) if case == "row_counts" else (25,)):
        want = np.zeros((n_rows, 3))
        np.add.at(want, idx.reshape(-1)[keep], contrib[keep])
        got = tbu._gather_scatter(torch.from_numpy(contrib), inv_idx,
                                  inv_mask, n_rows)
        np.testing.assert_array_equal(got.numpy(), want)


def _jax_fields(b):
    out = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
    out = {k: (v if isinstance(v, (int, float)) or v is None
               else np.asarray(v)) for k, v in out.items()}
    out["_host"] = getattr(b, "_host", None)
    return out


@pytest.mark.parametrize("armed", [True, False])
def test_convert_carries_or_builds_the_table(armed):
    """A JAX PlaneBatch converted to the port: an armed one's table comes
    across as it is (int64 positions, its n rows); an unarmed one's port
    batch builds its own. Either scatters as the JAX batch does."""
    from aa_admm_tpu_torch import convert
    rng = np.random.default_rng(13)
    faces = [list(rng.choice(N - 4, size=rng.integers(3, 7), replace=False))
             for _ in range(15)]
    jb = jc.PlaneBatch.create(faces, 1.0)
    if armed:
        jb = jc.with_gather_adjoint(jb, N)
    cb = convert.batch_from_numpy("PlaneBatch", _jax_fields(jb))
    if armed:
        assert cb.inv_idx.dtype == torch.int64
        np.testing.assert_array_equal(cb.inv_idx.numpy(),
                                      np.asarray(jb.inv_idx))
        np.testing.assert_array_equal(cb.inv_mask.numpy(),
                                      np.asarray(jb.inv_mask))
    else:
        assert jb.inv_idx is None
        assert cb.inv_idx.shape[0] == 1 + max(max(f) for f in faces)
    t = rng.standard_normal(jb.block_shape)
    np.testing.assert_allclose(cb.scatter(torch.from_numpy(t), N).numpy(),
                               np.asarray(jb.scatter(jnp.asarray(t), N)),
                               **TOL)


@pytest.mark.parametrize("source", ["jax_object", "dict_without_mode"])
def test_convert_nested_skips_only_the_tables(source):
    """convert._nested takes a JAX WindForce, which has no gather table,
    and the port's WindForce builds its own (the kick then matches the
    JAX package's); a source that lacks any other field still raises."""
    from aa_admm_tpu_torch import convert
    m = jfac.make_plane_grid(4, 3, size=1.9)
    d = np.array([25.0, 0.0, 5.0])
    jw = jph.WindForce(faces=jnp.asarray(m.faces), direction=jnp.asarray(d),
                       alpha_n=10.0)
    if source == "dict_without_mode":
        with pytest.raises(KeyError):
            convert._nested(tph.WindForce, {"faces": m.faces, "direction": d,
                                            "alpha_n": 10.0}, "cpu")
        return
    tw = convert._nested(tph.WindForce, jw, "cpu")
    assert tw.mode == "jacobi" and tw.inv_idx.shape[0] == len(m.verts)
    rng = np.random.default_rng(17)
    x = m.verts + 0.05 * rng.standard_normal(m.verts.shape)
    v = rng.standard_normal(m.verts.shape)
    n = len(x)
    np.testing.assert_allclose(
        tw.apply(0.03, torch.from_numpy(x), torch.from_numpy(v), n).numpy(),
        np.asarray(jw.apply(0.03, jnp.asarray(x), jnp.asarray(v), n)), **TOL)


def _two_steps(make):
    s = make()
    s.step()
    s.step()
    s.flush_traces()
    return s


@pytest.mark.cuda
def test_fused_steps_repeat_bit_for_bit_on_card(cuda_device, tmp_path):
    """Two fused accelerated steps from one state, twice, on the card and
    without deterministic algorithms: beams-published and a windyflag
    cloth (the jacobi wind, the TriBatch adjoint) give equal bits."""
    from aa_admm_tpu_torch.apps import beams
    from aa_admm_tpu_torch.apps import windyflag as wf
    from aa_admm_tpu_torch.core.config import AccelType, Settings
    from aa_admm_tpu_torch.core.factory import make_plane_grid
    from aa_admm_tpu_torch.core.meshio import save_obj
    assert not torch.are_deterministic_algorithms_enabled()

    def settings(iters):
        s = Settings()
        s.admm_iters, s.verbose = iters, 0
        s.acceleration_type, s.anderson_m = AccelType.ANDERSON, 5
        return s

    def beams_solver():
        s = settings(30)
        solver, stretch = beams.build_scene(s, device="cuda")
        stretch(s.timestep_s)
        return solver

    grid = make_plane_grid(32, 32, size=1.9)
    cloth = str(tmp_path / "cloth32.obj")
    save_obj(cloth, grid.verts, grid.faces)
    for make in (beams_solver, lambda: wf.build_scene(
            settings(50), mesh_path=cloth, device="cuda")):
        a, b = _two_steps(make), _two_steps(make)
        assert np.array_equal(a.x, b.x)
        assert a.step_prim == b.step_prim and a.step_comb == b.step_comb


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card's scatter order is the "
                    "point)")
    return torch.device("cuda")
