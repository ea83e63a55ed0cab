"""Scene ensembles of the PyTorch port (aa_admm_tpu_torch/parallel/
ensemble.py) at f64 on the CPU, on the 40-tet beam of ``build_tiny_scene``.

* The batched Anderson ``compute`` (a leading scene axis) against S
  single-scene calls, bit for bit, with per-scene resets.
* ``ensemble_step`` against a loop of single-scene port steps (the
  ensemble's plain twin), for both orders, on the dense and the forced-CG
  global step: rtol 1e-10 / atol 1e-12 (tests/test_parallel.py:15-59), with
  equal per-scene reset counts and eps-breaks. The replicas' states differ,
  so the scenes reject, reset and break at different iterations.
* ``ensemble_step`` and ``ensemble_run_frames`` (with a pin velocity)
  against the JAX package's ``ensemble_step`` and its vmapped ``run_frames``,
  with the JAX system carried across by ``convert.py``.
* The tiled system's layout, and its cache.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_admm_tpu.parallel import ensemble as jens
from aa_admm_tpu.solver import physics as jphys
from aa_admm_tpu_torch import convert
from aa_admm_tpu_torch.parallel import ensemble as tens
from aa_admm_tpu_torch.solver import anderson
from aa_admm_tpu_torch.solver import physics as tphys
from test_torch_zxu import _system_fields

RTOL, ATOL = 1e-10, 1e-12
# Against the JAX package, residuals far down a trace are compared to a
# floor of 1e-11 of the trace's first (tests/test_torch_zxu.py's PRIM_FLOOR):
# there they are differences of nearly equal positions, and the two
# packages' roundoff in x moves them by more than 1e-10 of their own size.
PRIM_FLOOR = 1e-11
S = 4
# Scene settings whose replicas part: xzu rejects only in its fastest
# replica (30 iterations, m = 2), zxu resets 3 to 5 times per replica.
CASES = {"xzu": dict(iters=30, m=2), "zxu": dict(iters=20, m=3)}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Single-threaded torch, as the other physics tests run it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _states(solver, order, device="cpu"):
    """S replicas of the solver's state that part during the step: y
    velocities 0 ... -1 (zxu), or seeded random velocities of growing
    amplitude (xzu; the last replica's make it reject)."""
    xs, vs, pps = tens.tiny_states(solver, S, spread=1.0)
    if order == "xzu":
        g = np.random.default_rng(0).normal(size=tuple(vs.shape))
        amp = 20.0 * np.linspace(0.0, 1.0, S)[:, None, None]
        vs = torch.from_numpy(amp * g).to(device, vs.dtype)
    return xs, vs, pps


def _scene(order, path="dense", device="cpu"):
    solver, s = tens.build_tiny_scene(order, "float64", CASES[order]["iters"],
                                      CASES[order]["m"], device=device)
    if path == "cg":
        s.linear_solver = "cg"
        solver.initialize(s)
        assert solver.system.solver is None
    return solver


def _np(t):
    return t.detach().cpu().numpy()


def _assert_scene(x, prim, resets, x1, prim1, resets1, floor=0.0):
    np.testing.assert_allclose(x, x1, rtol=RTOL, atol=ATOL)
    assert np.array_equal(np.isnan(prim), np.isnan(prim1))
    ok = ~np.isnan(prim1)
    np.testing.assert_allclose(prim[ok], prim1[ok], rtol=RTOL,
                               atol=max(ATOL, floor * prim1[0]))
    assert int(resets) == int(resets1)


def looped_step(order):
    """The ensemble's plain twin: a loop of single-scene steps, stacked as
    ensemble_step stacks its results."""
    fn = tphys.step_xzu if order == "xzu" else tphys.step_zxu

    def step(system, xs, vs, pps):
        outs = [fn(system, xs[s], vs[s], pps[s]) for s in range(len(xs))]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]),
                tphys.StepTrace(*(torch.stack([getattr(o[2], f) for o in outs])
                                  for f in tphys.StepTrace._fields)))
    return step


# ---------------------------------------------------------------------------
# The batched AA compute
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batched_aa_compute_matches_single_calls_bit_for_bit(dtype):
    """S windows in one batched state against S single states, through a
    pair iterate (effective head), the first step, the ring buffer's wrap
    and per-scene resets and replaces."""
    g = torch.Generator().manual_seed(0)
    d, de, m = 60, 40, 3
    W = 0.05 * torch.randn(d, d, generator=g, dtype=dtype)
    u0 = torch.randn(S, d, generator=g, dtype=dtype)
    batched = anderson.init(m, u0, effective_dim=de)
    singles = [anderson.init(m, u0[s], effective_dim=de) for s in range(S)]
    for it in range(12):
        G = torch.tanh(batched.current_u @ W) + 0.1 * torch.randn(
            S, d, generator=g, dtype=dtype)
        batched, ub = anderson.compute(batched, G)
        outs = [anderson.compute(st, G[s]) for s, st in enumerate(singles)]
        singles = [o[0] for o in outs]
        for s in range(S):
            assert torch.equal(ub[s], outs[s][1])
            for name in anderson.AAState.__dataclass_fields__:
                assert torch.equal(getattr(batched, name)[s],
                                   getattr(singles[s], name)), (it, s, name)
        if it in (4, 8):
            pick = torch.tensor([True, False, it == 8, False])
            fn = anderson.reset if it == 4 else anderson.replace
            batched = anderson.where(pick, fn(batched, batched.current_u),
                                     batched)
            singles = [fn(st, st.current_u) if pick[s] else st
                       for s, st in enumerate(singles)]


# ---------------------------------------------------------------------------
# The ensemble against single-scene port steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["dense", "cg"])
@pytest.mark.parametrize("order", ["xzu", "zxu"])
def test_ensemble_matches_single_scene_steps(order, path):
    solver = _scene(order, path)
    xs, vs, pps = _states(solver, order)
    counts = tphys._counts()
    xe, ve, tre = tens.ensemble_step(order)(solver.system, xs, vs, pps,
                                            counts)
    x1, v1, tr1 = looped_step(order)(solver.system, xs, vs, pps)
    assert xe.shape == xs.shape and tre.prim.shape == (S, solver.system.admm_iters)
    for s in range(S):
        _assert_scene(_np(xe[s]), _np(tre.prim[s]), tre.reset_count[s],
                      _np(x1[s]), _np(tr1.prim[s]), tr1.reset_count[s])
        np.testing.assert_allclose(_np(ve[s]), _np(v1[s]), rtol=RTOL,
                                   atol=1e-10)
        assert torch.equal(tre.reject[s], tr1.reject[s])
        assert int(tre.n_valid[s]) == int(tr1.n_valid[s])
    resets = tre.reset_count.tolist()
    assert len(set(resets)) > 1 or len(set(tre.n_valid.tolist())) > 1, \
        "the replicas did not part"
    # One AA read per iteration for all scenes, plus the CG loop tests and
    # the reject reads where the path has them.
    iters = solver.system.admm_iters
    if path == "dense" and order == "xzu":
        assert counts["host_reads"] == iters
    else:
        assert counts["host_reads"] >= 2 * iters


def test_tile_system_layout_and_cache():
    solver = _scene("zxu")
    system = solver.system
    tiled = tens.tile_system(system, 3)
    assert tens.tile_system(system, 3) is tiled
    assert tens.tile_system(system, 1) is system
    n, nf = system.n_verts, system.n_free
    assert (tiled.n_verts, tiled.n_free, tiled.n_scenes) == (3 * n, 3 * nf, 3)
    assert torch.equal(tiled.free_idx[nf:2 * nf], system.free_idx + n)
    for b, tb in zip(system.batches, tiled.batches):
        E = b.w.shape[0]
        idx = b.tets if hasattr(b, "tets") else b.idx
        tidx = tb.tets if hasattr(tb, "tets") else tb.idx
        assert torch.equal(tidx[2 * E:], idx + 2 * n)
        assert torch.equal(tb.w[E:2 * E], b.w)
        # the tiled scatter of scene s's block lands on scene s's rows only
        t = torch.zeros(b.deform(solver._x_dev).shape[0], 3 * E,
                        dtype=torch.float64)
        t[:, E:2 * E] = b.deform(solver._x_dev)
        out = tb.scatter(t, 3 * n)
        assert float(out[:n].abs().max()) == 0.0 == float(out[2 * n:].abs().max())
        assert torch.equal(out[n:2 * n],
                           b.scatter(b.deform(solver._x_dev), n))
    with pytest.raises(ValueError):
        tens.tile_system(tiled, 2)


# ---------------------------------------------------------------------------
# The ensemble against the JAX package
# ---------------------------------------------------------------------------

def _jax_scene(order):
    solver, _ = jens.build_tiny_scene(order, dtype="float64",
                                      admm_iters=CASES[order]["iters"],
                                      anderson_m=CASES[order]["m"])
    return solver


@pytest.mark.parametrize("order", ["xzu", "zxu"])
def test_ensemble_step_matches_jax(order):
    js = _jax_scene(order)
    system = convert.physics_system_from_numpy(_system_fields(js.system))
    ts = _scene(order)
    xs, vs, pps = _states(ts, order)
    jx, jv, jtr = jens.ensemble_step(order)(
        js.system, *(jnp.asarray(_np(a)) for a in (xs, vs, pps)))
    for sys_ in (system, ts.system):     # carried across, and the port's own
        xe, ve, tre = tens.ensemble_step(order)(sys_, xs, vs, pps)
        for s in range(S):
            _assert_scene(_np(xe[s]), _np(tre.prim[s]), tre.reset_count[s],
                          np.asarray(jx[s]), np.asarray(jtr.prim[s]),
                          jtr.reset_count[s], PRIM_FLOOR)


@pytest.mark.parametrize("order", ["xzu", "zxu"])
def test_ensemble_run_frames_matches_jax_vmapped_run_frames(order):
    """bench.py's vmapped rollout (bench.py:153-154): three frames with a
    pin velocity on the xzu scene's pinned end (zxu has no pins, so the
    velocity moves nothing there)."""
    js = _jax_scene(order)
    system = convert.physics_system_from_numpy(_system_fields(js.system))
    ts = _scene(order)
    xs, vs, pps = _states(ts, order)
    pin_vel = np.zeros((ts.n_verts, 3))
    pin_vel[~_np(system.free_mask), 1] = 0.5
    frames = 3
    single = functools.partial(jphys.run_frames, n_frames=frames,
                               pin_vel=jnp.asarray(pin_vel))
    jx, _, jpp, jtr = jax.jit(jax.vmap(single, in_axes=(None, 0, 0, 0)))(
        js.system, *(jnp.asarray(_np(a)) for a in (xs, vs, pps)))
    xe, _, ppe, tre = tens.ensemble_run_frames(
        system, xs, vs, pps, frames, torch.from_numpy(pin_vel))
    assert tre.prim.shape == (S, frames, system.admm_iters)
    np.testing.assert_allclose(_np(ppe), np.asarray(jpp), rtol=0, atol=1e-15)
    for s in range(S):
        for f in range(frames):
            assert int(tre.reset_count[s, f]) == int(jtr.reset_count[s, f])
            p, pj = _np(tre.prim[s, f]), np.asarray(jtr.prim[s, f])
            ok = ~np.isnan(pj)
            assert np.array_equal(np.isnan(p), ~ok)
            np.testing.assert_allclose(p[ok], pj[ok], rtol=RTOL,
                                       atol=PRIM_FLOOR * pj[0])
        np.testing.assert_allclose(_np(xe[s]), np.asarray(jx[s]), rtol=RTOL,
                                   atol=ATOL)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("path", ["dense", "cg"])
@pytest.mark.parametrize("order", ["xzu", "zxu"])
def test_ensemble_matches_single_scene_steps_on_card(order, path):
    """chip_smoke phase 12's f64 parity: the tiled ensemble (CUDA graphs,
    batched AA products) against single-scene steps on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    solver = _scene(order, path, device="cuda")
    xs, vs, pps = _states(solver, order, device="cuda")
    xe, _, tre = tens.ensemble_step(order)(solver.system, xs, vs, pps)
    x1, _, tr1 = looped_step(order)(solver.system, xs, vs, pps)
    for s in range(S):
        _assert_scene(_np(xe[s]), _np(tre.prim[s]), tre.reset_count[s],
                      _np(x1[s]), _np(tr1.prim[s]), tr1.reset_count[s])
