"""The physics building blocks of the PyTorch port against the JAX package at
f64 on the CPU, on the same seeded inputs: the unrolled 3x3 algebra
(ops/mat3.py), eigh3x3, svd3x3, svd3x2 and polar_rotation3x3 (ops/svd3.py) on
random, near-identity, reflected and degenerate batches, the tet and
triangle proxes, gradients and energies (ops/prox.py), and the plane-form
TetBatch and PinBatch (ops/elements.py) carried across with
``convert.element_batch_from_numpy``.

Tolerances: 1e-12 absolute where both packages run the same arithmetic;
1e-10 relative for the proxes, gradients and energies. Where eigenvectors
or singular vectors are not unique (ties), reconstructions are compared,
not the vectors. The hyperelastic proxes: the port polishes the damped
singular-value Newton to roundoff (``prox._sigma_newton``), so it is held
at 1e-10 against the JAX Newton with the same polish, and against the JAX
package's own Newton at 1e-8, the resolution of its value test."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_admm_tpu.core.config import Lame as JLame
from aa_admm_tpu.core import factory as jfactory
from aa_admm_tpu.core.factory import make_tet_blocks as j_make_tet_blocks
from aa_admm_tpu.ops import elements as jel
from aa_admm_tpu.ops import mat3 as jm
from aa_admm_tpu.ops import prox as jpx
from aa_admm_tpu.ops import svd3 as js
from aa_admm_tpu_torch import convert
from aa_admm_tpu_torch.core.config import Lame as TLame
from aa_admm_tpu_torch.core import factory as tfactory
from aa_admm_tpu_torch.core.factory import make_tet_blocks
from aa_admm_tpu_torch.ops import elements as tel
from aa_admm_tpu_torch.ops import mat3 as tm
from aa_admm_tpu_torch.ops import prox as tpx
from aa_admm_tpu_torch.ops import svd3 as ts

ATOL = 1e-12
PROX_RTOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Single-threaded torch: the slice's element batches are small, and
    OpenMP workers spinning between thousands of tiny ops starve the other
    test processes (a beams step took 15x longer with three running)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _both(fn_j, fn_t, *args):
    """Run the JAX and the port function on the same NumPy inputs."""
    out_j = fn_j(*(jnp.asarray(a) for a in args))
    out_t = fn_t(*(torch.from_numpy(np.array(a)) for a in args))
    if not isinstance(out_j, tuple):
        out_j, out_t = (out_j,), (out_t,)
    return [_np(a) for a in out_j], [_np(a) for a in out_t]


def _cases():
    rng = np.random.default_rng(0)
    degenerate = np.stack([
        np.diag([1.0, 1.0, -1.0]),
        np.diag([2.0, 1e-8, 1.0]),
        np.zeros((3, 3)),
        np.diag([5.0, 5.0, 5.0]),
        np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9]], float),
    ])
    reflected = rng.normal(size=(16, 3, 3))
    reflected[:, :, 0] *= np.sign(np.linalg.det(reflected))[:, None]
    reflected[:, :, 0] *= -1.0          # every det < 0
    return {"random": rng.normal(size=(64, 3, 3)),
            "near_identity": np.eye(3) + 1e-3 * rng.normal(size=(32, 3, 3)),
            "reflected": reflected,
            "degenerate": degenerate}


CASES = _cases()
UNIQUE = ("random", "near_identity", "reflected")   # distinct spectra


# ---------------------------------------------------------------------------
# mat3
# ---------------------------------------------------------------------------

def _mat3_args(name, rng):
    a33 = rng.normal(size=(20, 3, 3))
    b33 = rng.normal(size=(20, 3, 3))
    return {
        "mmul": (a33, b33), "mtmul": (a33, b33), "mmult": (a33, b33),
        "usv": (a33, rng.normal(size=(20, 3)), b33),
        "det": (a33,), "adjugate": (a33,), "inv": (a33,),
        "solve": (a33 + 3 * np.eye(3), rng.normal(size=(20, 3))),
        "mvec": (a33, rng.normal(size=(20, 3))), "trace": (a33,),
        "frob2": (a33,),
        "mmul32_22": (rng.normal(size=(20, 3, 2)), rng.normal(size=(20, 2, 2))),
        "gram22": (rng.normal(size=(20, 3, 2)),),
        "usv32": (rng.normal(size=(20, 3, 2)), rng.normal(size=(20, 2)),
                  rng.normal(size=(20, 2, 2))),
        "mmult32": (rng.normal(size=(20, 3, 2)), rng.normal(size=(20, 2, 2))),
    }[name]


@pytest.mark.parametrize("name", ["mmul", "mtmul", "mmult", "usv", "det",
                                  "adjugate", "inv", "solve", "mvec", "trace",
                                  "frob2", "mmul32_22", "gram22", "usv32",
                                  "mmult32"])
def test_mat3_matches_jax(name):
    args = _mat3_args(name, np.random.default_rng(len(name)))
    (oj,), (ot,) = _both(getattr(jm, name), getattr(tm, name), *args)
    assert ot.shape == oj.shape
    np.testing.assert_allclose(ot, oj, rtol=0, atol=ATOL * max(1, np.abs(oj).max()))


# ---------------------------------------------------------------------------
# svd3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_eigh3x3_matches_jax(case):
    F = CASES[case]
    A = np.einsum("bki,bkj->bij", F, F)          # symmetric PSD
    (wj, Vj), (wt, Vt) = _both(js.eigh3x3, ts.eigh3x3, A)
    np.testing.assert_allclose(wt, wj, rtol=0, atol=ATOL * max(1, np.abs(wj).max()))
    rec = np.einsum("bik,bk,bjk->bij", Vt, wt, Vt)
    np.testing.assert_allclose(rec, A, rtol=0, atol=1e-10 * max(1, np.abs(A).max()))
    np.testing.assert_allclose(np.einsum("bki,bkj->bij", Vt, Vt),
                               np.broadcast_to(np.eye(3), Vt.shape), atol=ATOL)
    if case in UNIQUE:
        np.testing.assert_allclose(Vt, Vj, rtol=0, atol=1e-10)
    (wsj, Vsj), (wst, Vst) = _both(js._sort_desc3, ts._sort_desc3, wj, Vj)
    np.testing.assert_array_equal(wst, wsj)
    np.testing.assert_array_equal(Vst, Vsj)


@pytest.mark.parametrize("method", ["jacobi", "lapack"])
@pytest.mark.parametrize("case", list(CASES))
def test_svd3x3_matches_jax(case, method):
    F = CASES[case]
    (Uj, Sj, Vj), (Ut, St, Vt) = _both(
        lambda a: js.svd3x3(a, method=method),
        lambda a: ts.svd3x3(a, method=method), F)
    np.testing.assert_allclose(St, Sj, rtol=0, atol=ATOL * max(1, np.abs(Sj).max()))
    rec_t = np.einsum("bik,bk,bjk->bij", Ut, St, Vt)
    rec_j = np.einsum("bik,bk,bjk->bij", Uj, Sj, Vj)
    np.testing.assert_allclose(rec_t, rec_j, rtol=0, atol=1e-10)
    np.testing.assert_allclose(rec_t, F, rtol=0, atol=1e-8 * max(1, np.abs(F).max()))
    for M in (Ut, Vt):
        np.testing.assert_allclose(np.einsum("bki,bkj->bij", M, M),
                                   np.broadcast_to(np.eye(3), M.shape),
                                   atol=1e-10)
    if case in UNIQUE and method == "jacobi":
        np.testing.assert_allclose(Ut, Uj, rtol=0, atol=1e-10)
        np.testing.assert_allclose(Vt, Vj, rtol=0, atol=1e-10)


def test_svd3x2_and_polar_match_jax():
    rng = np.random.default_rng(2)
    F = rng.normal(size=(64, 3, 2))
    (Uj, Sj, Vj), (Ut, St, Vt) = _both(js.svd3x2, ts.svd3x2, F)
    np.testing.assert_allclose(St, Sj, rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.einsum("bik,bk,bjk->bij", Ut, St, Vt), F,
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(Ut, Uj, rtol=0, atol=1e-10)
    np.testing.assert_allclose(Vt, Vj, rtol=0, atol=1e-10)
    for case, G in CASES.items():
        (Rj,), (Rt,) = _both(js.polar_rotation3x3, ts.polar_rotation3x3, G)
        if case in UNIQUE:
            np.testing.assert_allclose(Rt, Rj, rtol=0, atol=1e-10)
        np.testing.assert_allclose(np.einsum("bki,bkj->bij", Rt, Rt),
                                   np.broadcast_to(np.eye(3), Rt.shape),
                                   atol=1e-10)


# ---------------------------------------------------------------------------
# prox
# ---------------------------------------------------------------------------

def jax_newton_polished():
    """The JAX package's singular-value Newton followed by the port's polish
    (``_POLISH_ITERS`` undamped Newton steps, each kept where it shrinks the
    gradient), built from the JAX package's own functions; the package
    itself is not changed. tests/test_torch_physics.py and
    tools/port_beams_spread.py use it as well."""
    orig = jpx._sigma_newton

    def newton(sv, mu, lam, k, grad_hess, value, iters=jpx._NEWTON_ITERS):
        s = orig(sv, mu, lam, k, grad_hess, value, iters)
        for _ in range(tpx._POLISH_ITERS):
            g, H = grad_hess(s, sv, mu, lam, k)
            cand = s - jm.solve(H, g)
            gc, _ = grad_hess(cand, sv, mu, lam, k)
            gn, gcn = jnp.sum(g * g, -1), jnp.sum(gc * gc, -1)
            ok = jnp.isfinite(gcn) & (gcn < gn)
            s = jnp.where(ok[..., None], cand, s)
        return s
    return newton


def _material(n, seed=5):
    rng = np.random.default_rng(seed)
    lame = JLame.from_young_poisson(1e7, 0.399)
    mu, lam = np.full(n, lame.mu), np.full(n, lame.lam)
    k = np.full(n, lame.bulk_modulus)
    vol = rng.uniform(1e-4, 1e-3, n)
    # stretched, compressed and slightly inverted deformation gradients
    v = np.eye(3) + 0.2 * rng.normal(size=(n, 3, 3))
    v[:4] = np.diag([1.0, 1.0, -0.05]) + 0.01 * rng.normal(size=(4, 3, 3))
    return v, mu, lam, k, vol


@pytest.mark.parametrize("kind", ["linear", "neohookean", "stvk"])
def test_tet_prox_grad_energy_match_jax(kind, monkeypatch):
    v, mu, lam, k, vol = _material(48)
    prox = f"prox_tet_{kind}"
    (pj,), (pt,) = _both(getattr(jpx, prox), getattr(tpx, prox), v, mu, lam, k)
    if kind != "linear":
        # the JAX package's own Newton: the same minimizer to the resolution
        # of its value test, and the port's is a better stationary point
        np.testing.assert_allclose(pt, pj, rtol=1e-8, atol=1e-8)
        monkeypatch.setattr(jpx, "_sigma_newton", jax_newton_polished())
        (pj,), _ = _both(getattr(jpx, prox), getattr(tpx, prox), v, mu, lam, k)
    np.testing.assert_allclose(pt, pj, rtol=PROX_RTOL, atol=PROX_RTOL)
    for fn in (f"grad_tet_{kind}", f"energy_tet_{kind}"):
        (gj,), (gt,) = _both(getattr(jpx, fn), getattr(tpx, fn), pj, mu, lam,
                             k, vol)
        np.testing.assert_allclose(gt, gj, rtol=PROX_RTOL,
                                   atol=PROX_RTOL * np.abs(gj).max())


def test_signed_svd_matches_jax():
    F = np.concatenate([CASES["random"], CASES["reflected"]])
    (Uj, Sj, Vj), (Ut, St, Vt) = _both(
        lambda a: jpx._signed_svd3x3(a, "jacobi"),
        lambda a: tpx._signed_svd3x3(a, "jacobi"), F)
    np.testing.assert_allclose(St, Sj, rtol=0, atol=ATOL * np.abs(Sj).max())
    np.testing.assert_allclose(Ut, Uj, rtol=0, atol=1e-10)
    np.testing.assert_allclose(Vt, Vj, rtol=0, atol=1e-10)
    assert np.all(np.sign(St[:, 2]) == np.sign(np.linalg.det(F)))


def test_tri_prox_grad_energy_match_jax():
    rng = np.random.default_rng(9)
    n = 40
    v = rng.normal(size=(n, 3, 2))
    lo = np.where(np.arange(n) % 2 == 0, 0.9, -100.0)   # half unlimited
    hi = np.where(np.arange(n) % 2 == 0, 1.05, 100.0)
    for fn in ("prox_tri_zxu", "prox_tri_xzu", "strain_limit_violation"):
        (oj,), (ot,) = _both(getattr(jpx, fn), getattr(tpx, fn), v, lo, hi)
        np.testing.assert_allclose(ot, oj, rtol=PROX_RTOL, atol=PROX_RTOL)
    mu, lam, k = np.full(n, 2.0), np.full(n, 3.0), np.full(n, 5.0)
    area = rng.uniform(0.1, 1.0, n)
    for fn in ("grad_tri", "energy_tri"):
        (oj,), (ot,) = _both(getattr(jpx, fn), getattr(tpx, fn), v, mu, lam,
                             k, area)
        np.testing.assert_allclose(ot, oj, rtol=PROX_RTOL, atol=PROX_RTOL)
    active = np.arange(n) % 3 == 0
    (oj,), (ot,) = _both(jpx.prox_pin, tpx.prox_pin, v[:, :, 0], v[:, :, 1],
                         active)
    np.testing.assert_array_equal(ot, oj)


# ---------------------------------------------------------------------------
# elements
# ---------------------------------------------------------------------------

def _fields(b):
    out = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
    out = {k: (v if isinstance(v, (str, int, float)) or v is None
               else np.asarray(v)) for k, v in out.items()}
    if hasattr(b, "_host"):
        out["_host"] = b._host
    return out


def _tet_batches(kind):
    mesh = make_tet_blocks(4, 2, 2)
    jmesh = j_make_tet_blocks(4, 2, 2)
    np.testing.assert_array_equal(mesh.verts, jmesh.verts)
    np.testing.assert_array_equal(mesh.tets, jmesh.tets)
    jb = jel.TetBatch.from_mesh(jmesh.verts, jmesh.tets,
                                JLame.from_young_poisson(1e6, 0.35), kind=kind)
    tb = tel.TetBatch.from_mesh(mesh.verts, mesh.tets,
                                TLame.from_young_poisson(1e6, 0.35), kind=kind)
    return mesh, jb, tb


@pytest.mark.parametrize("kind", ["linear", "neohookean", "stvk"])
def test_tet_batch_matches_jax(kind, monkeypatch):
    monkeypatch.setattr(jpx, "_sigma_newton", jax_newton_polished())
    mesh, jb, tb = _tet_batches(kind)
    cb = convert.element_batch_from_numpy("TetBatch", _fields(jb))
    for name in ("tets", "Dm_inv", "vol", "w", "mu", "lam", "k"):
        np.testing.assert_allclose(_np(getattr(tb, name)),
                                   np.asarray(getattr(jb, name)), rtol=1e-14)
    assert cb.kind == tb.kind == kind
    rng = np.random.default_rng(4)
    n = len(mesh.verts)
    x = mesh.verts * (1 + 0.05 * rng.normal(size=(n, 3)))
    Fj = np.array(jb.deform(jnp.asarray(x)))
    for b in (tb, cb):
        Ft = b.deform(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(Ft, Fj, rtol=0, atol=ATOL)
        t = rng.normal(size=Fj.shape)
        np.testing.assert_allclose(
            b.scatter(torch.from_numpy(t), n).numpy(),
            np.asarray(jb.scatter(jnp.asarray(t), n)), rtol=0, atol=1e-10)
        np.testing.assert_allclose(b.prox(torch.from_numpy(Fj)).numpy(),
                                   np.asarray(jb.prox(jnp.asarray(Fj))),
                                   rtol=PROX_RTOL, atol=PROX_RTOL)
        np.testing.assert_allclose(b.grad(torch.from_numpy(Fj)).numpy(),
                                   np.asarray(jb.grad(jnp.asarray(Fj))),
                                   rtol=PROX_RTOL, atol=1e-6)
        np.testing.assert_allclose(b.energy(torch.from_numpy(Fj)).numpy(),
                                   np.asarray(jb.energy(jnp.asarray(Fj))),
                                   rtol=PROX_RTOL, atol=1e-12)


def test_plane_form_deform_scatter_adjoint():
    """<D x, t> == <x, D^T t> for the port's tet and pin batches in the
    plane-form (C, E) convention, as tests/test_physics.py holds the JAX
    package's; and the plane-form roundtrip."""
    rng = np.random.default_rng(3)
    mesh = make_tet_blocks(4, 2, 2)
    n = len(mesh.verts)
    x = torch.from_numpy(rng.standard_normal((n, 3)))
    tb = tel.TetBatch.from_mesh(mesh.verts, mesh.tets,
                                TLame.from_young_poisson(1e6, 0.35))
    pb = tel.PinBatch.create(np.arange(0, n, 7), mesh.verts[::7])
    for b, ne in ((tb, len(mesh.tets)), (pb, len(range(0, n, 7)))):
        F = b.deform(x)
        assert F.ndim == 2 and F.shape[-1] == ne
        t = torch.from_numpy(rng.standard_normal(tuple(F.shape)))
        lhs = float((F * t).sum())
        rhs = float((x * b.scatter(t, n)).sum())
        assert abs(lhs - rhs) < 1e-9 * max(1.0, abs(lhs))
    a = torch.from_numpy(rng.standard_normal((17, 3, 3)))
    assert torch.equal(tel.p2m(tel.m2p(a), (3, 3)), a)
    np.testing.assert_array_equal(tel.m2p(a).numpy(),
                                  np.asarray(jel.m2p(jnp.asarray(a.numpy()))))


def test_pin_batch_matches_jax():
    rng = np.random.default_rng(6)
    n = 30
    idx = np.arange(0, n, 4)
    targets = rng.normal(size=(len(idx), 3))
    jb = jel.PinBatch.create(idx, targets)
    cb = convert.element_batch_from_numpy("PinBatch", _fields(jb))
    tb = tel.PinBatch.create(idx, targets)
    x = rng.normal(size=(n, 3))
    Fj = np.array(jb.deform(jnp.asarray(x)))
    t = rng.normal(size=Fj.shape)
    for b in (tb, cb):
        np.testing.assert_array_equal(b.deform(torch.from_numpy(x)).numpy(), Fj)
        np.testing.assert_array_equal(
            b.scatter(torch.from_numpy(t), n).numpy(),
            np.asarray(jb.scatter(jnp.asarray(t), n)))
        np.testing.assert_array_equal(b.prox(torch.from_numpy(t)).numpy(),
                                      np.asarray(jb.prox(jnp.asarray(t))))
        np.testing.assert_array_equal(_np(b.w), np.asarray(jb.w))


@pytest.mark.parametrize("which", ["tet_blocks", "tri_blocks", "plane_grid"])
def test_factory_matches_jax(which):
    """The port's host copy of core/factory.py builds the same meshes, in
    the same vertex order (which fixes the beams' pins), and the same
    lumped masses."""
    if which == "tet_blocks":
        j, t = jfactory.make_tet_blocks(5, 2, 3), tfactory.make_tet_blocks(5, 2, 3)
        np.testing.assert_array_equal(t.tets, j.tets)
        np.testing.assert_array_equal(t.weighted_masses(1522.0),
                                      j.weighted_masses(1522.0))
        np.testing.assert_array_equal(t.bounds(), j.bounds())
    elif which == "tri_blocks":
        j, t = jfactory.make_tri_blocks(4, 3), tfactory.make_tri_blocks(4, 3)
        np.testing.assert_array_equal(t.faces, j.faces)
    else:
        j, t = jfactory.make_plane_grid(4, 3), tfactory.make_plane_grid(4, 3)
        np.testing.assert_array_equal(t.faces, j.faces)
    np.testing.assert_array_equal(t.verts, j.verts)
