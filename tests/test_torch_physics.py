"""The xzu physics slice of the PyTorch port at f64 on the CPU: one beams
timestep against the JAX package (non-accelerated and with Anderson m = 5),
one ``step_xzu`` from the JAX package's own system carried across with
``convert.physics_system_from_numpy``, the head of the non-accelerated step
against the C++ golden (tests/golden/beams_step1_residual_no_cpp.txt, as
tests/test_parity.py holds the JAX package) and the host assembly.
tests/test_torch_physics_solver.py holds the port's solver on its own: CG
against the dense inverse, ``run`` against repeated ``step`` with moving
pins, the residual file and the entry points' device rule.

The JAX package's hyperelastic prox (a damped singular-value Newton) stops
up to about 1e-9 relative off its minimizer, wherever rounding leads, so its
beams step is not reproducible at 1e-8 even against itself
(tools/port_beams_spread.py: a 1e-15 change of x moves late primal
residuals by 4.5e-10 of the first, x by 7e-10, and with Anderson the
rejects from iteration 52 on). The port polishes that Newton to roundoff.
So the port is held twice:
  * against the JAX package with the same polish (its own Newton followed
    by the port's polish, in-process; the package is not changed): prim,
    comb and x rtol 1e-8, atol 1e-9; reject sequences equal. The eps-break
    (combined residual below 1e-20) fires on roundoff, so with Anderson the
    residuals are compared where both runs still record them;
  * against the JAX package as it is, to its own spread: prim and comb to
    1e-8 of their first values and x to 1e-8; with Anderson, over the head
    before either run's first reject or eps-break, and prim to 5e-8 of its
    first value, because there the JAX run's primal residual stalls near
    2.3e-8 of its first value, where its Newton's inexactness leaves it,
    while the port's goes on falling."""

import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch

from aa_admm_tpu.apps import beams as jbeams
from aa_admm_tpu.core.config import AccelType as JAccel
from aa_admm_tpu.core.config import Settings as JSettings
from aa_admm_tpu.ops import prox as jpx
from aa_admm_tpu.solver import linear as jlin
from aa_admm_tpu_torch import convert
from aa_admm_tpu_torch.apps import beams as tbeams
from aa_admm_tpu_torch.core.config import AccelType, Settings
from aa_admm_tpu_torch.solver import linear as tlin
from aa_admm_tpu_torch.solver import physics as tphys
from test_torch_svd_prox import jax_newton_polished

RTOL, ATOL = 1e-8, 1e-9
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "beams_step1_residual_no_cpp.txt")
STATICS = ("n_verts", "n_free", "order", "dt", "gravity", "dt2p",
           "admm_iters", "anderson_m", "accel", "collect_comb", "cg_tol",
           "cg_max_iters")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Single-threaded torch: the slice's element batches are small, and
    OpenMP workers spinning between thousands of tiny ops starve the other
    test processes (a beams step took 15x longer with three running)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _settings(S, A, accel, iters=100):
    s = S()
    s.admm_iters = iters
    s.verbose = 0
    if accel:
        s.acceleration_type = A.ANDERSON
        s.anderson_m = 5
    return s


def _fields(b):
    out = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
    out = {k: (v if isinstance(v, (str, int, float)) or v is None
               else np.asarray(v)) for k, v in out.items()}
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
             wind=js.wind, elem_sharding=js.elem_sharding)
    return f


def _jax_step(accel, polish):
    """One beams timestep of the JAX package, its Newton polished (as the
    port's) or as it is, with the system and state it started from."""
    orig = jpx._sigma_newton
    if polish:
        jpx._sigma_newton = jax_newton_polished()
    jax.clear_caches()
    try:
        s = _settings(JSettings, JAccel, accel)
        solver, stretch = jbeams.build_scene(s)
        stretch(s.timestep_s)
        x0, v0, pin_pos = (np.array(solver.x), np.array(solver.v),
                           np.array(solver.pin_pos))
        tr = solver.step()
        out = dict(accel=accel, system=_system_fields(solver.system),
                   x0=x0, v0=v0, pin_pos=pin_pos, x=np.array(solver.x),
                   prim=np.array(tr.prim), comb=np.array(tr.comb),
                   reject=np.array(tr.reject), n_valid=int(tr.n_valid))
    finally:
        jpx._sigma_newton = orig
        jax.clear_caches()
    return out


@pytest.fixture(scope="module", params=[False, True], ids=["noacc", "aa5"])
def jax_step(request):
    """One beams timestep of the JAX package with the port's polish."""
    return _jax_step(request.param, polish=True)


@pytest.fixture(scope="module", params=[False, True], ids=["noacc", "aa5"])
def jax_plain_step(request):
    """One beams timestep of the JAX package as it is."""
    return _jax_step(request.param, polish=False)


def _assert_trace_matches(prim, comb, reject, ref, x=None, n=100):
    rp, rc = ref["prim"][:n], ref["comb"][:n]
    both = ~np.isnan(prim) & ~np.isnan(rp)
    if not ref["accel"]:
        assert both.all()
    assert both.sum() >= min(n, 60)
    np.testing.assert_allclose(prim[both], rp[both], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(comb[both], rc[both], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(reject, ref["reject"][:n])
    if x is not None:
        np.testing.assert_allclose(x, ref["x"], rtol=RTOL, atol=ATOL)


@functools.lru_cache(maxsize=None)
def _port_step(accel):
    """One beams timestep of the port on the CPU: (prim, comb, reject, x,
    x0, pin_pos, host reads)."""
    s = _settings(Settings, AccelType, accel)
    solver, stretch = tbeams.build_scene(s, device="cpu")
    stretch(s.timestep_s)
    x0, pin_pos = solver.x.copy(), solver.pin_pos.copy()
    tr = solver.step()
    return (tr.prim.numpy(), tr.comb.numpy(), tr.reject.numpy(), solver.x,
            x0, pin_pos, solver.stats["host_reads"])


def test_beams_step_matches_jax(jax_step):
    prim, comb, reject, x, x0, pin_pos, reads = _port_step(jax_step["accel"])
    np.testing.assert_array_equal(x0, jax_step["x0"])
    np.testing.assert_array_equal(pin_pos, jax_step["pin_pos"])
    _assert_trace_matches(prim, comb, reject, jax_step, x)
    # host reads: one per accelerated iteration (the AA Gram matrix); the
    # dense path decides rejects on the device
    assert reads == (100 if jax_step["accel"] else 0)


def test_beams_step_matches_unpatched_jax(jax_plain_step):
    ref = jax_plain_step
    prim, comb, reject, x = _port_step(ref["accel"])[:4]
    rp, rc = ref["prim"], ref["comb"]
    if ref["accel"]:
        # the head: before either run's first reject or eps-break
        stops = [np.flatnonzero(a)[:1] for a in
                 (reject, ref["reject"], np.isnan(prim), np.isnan(rp))]
        head = min([int(i[0]) for i in stops if len(i)] + [len(prim)])
        assert head >= 40
    else:
        head = len(prim)
        assert not np.isnan(prim).any() and not np.isnan(rp).any()
        np.testing.assert_array_equal(reject, ref["reject"])
    floor = 5e-8 if ref["accel"] else 1e-8
    np.testing.assert_allclose(prim[:head], rp[:head], rtol=RTOL,
                               atol=floor * rp[0])
    assert prim[head - 1] <= rp[head - 1]
    np.testing.assert_allclose(comb[:head], rc[:head], rtol=RTOL,
                               atol=1e-8 * rc[0])
    np.testing.assert_allclose(x, ref["x"], rtol=RTOL, atol=1e-8)


def test_step_xzu_from_jax_system(jax_step):
    """The JAX package's own system and state, carried across, through the
    port's step_xzu (cut to its first 30 iterations)."""
    system = convert.physics_system_from_numpy(jax_step["system"])
    assert system.solver is not None and system.n_verts == 624
    assert system.admm_iters == 100 and system.accel == jax_step["accel"]
    system = dataclasses.replace(system, admm_iters=30)
    t = lambda a: torch.from_numpy(np.array(a))
    _, _, tr = tphys.step_xzu(system, t(jax_step["x0"]), t(jax_step["v0"]),
                              t(jax_step["pin_pos"]))
    _assert_trace_matches(tr.prim.numpy(), tr.comb.numpy(),
                          tr.reject.numpy(), jax_step, n=30)


def test_beams_noacc_head_matches_cpp_golden():
    cpp = np.loadtxt(GOLDEN)
    prim, comb = _port_step(False)[:2]
    for i in range(25):
        assert abs(prim[i] - cpp[i, 1]) / cpp[i, 1] < 1e-5, (i, prim[i])
        assert abs(comb[i] - cpp[i, 2]) / cpp[i, 2] < 1e-5, (i, comb[i])
    assert 0.1 < prim[99] / cpp[99, 1] < 10.0
    assert 0.01 < comb[99] / cpp[99, 2] < 100.0


def test_assembly_matches_jax():
    s = _settings(Settings, AccelType, False, iters=2)
    solver, _ = tbeams.build_scene(s, device="cpu")
    js = _settings(JSettings, JAccel, False, iters=2)
    jsolver, _ = jbeams.build_scene(js)
    n = solver.n_verts
    tb, jb = solver.system.batches, jsolver.system.batches
    np.testing.assert_allclose(tlin.assemble_node_matrix(n, tb, 0.3, np.ones(n)),
                               jlin.assemble_node_matrix(n, jb, 0.3, np.ones(n)),
                               rtol=1e-13, atol=1e-9)
    np.testing.assert_allclose(tlin.assemble_node_diag(n, tb),
                               jlin.assemble_node_diag(n, jb), rtol=1e-13)
    np.testing.assert_allclose(solver.system.solver.Ainv.numpy(),
                               np.asarray(jsolver.system.solver.Ainv),
                               rtol=1e-10, atol=1e-14)
    np.testing.assert_array_equal(solver.system.free_idx.numpy(),
                                  np.asarray(jsolver.system.free_idx))
    np.testing.assert_allclose(solver.system.masses.numpy(),
                               np.asarray(jsolver.system.masses), rtol=1e-14)
