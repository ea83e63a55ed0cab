"""The port's instrumented steps, chunked residual tracing and the AA sweep
(apps/test_anderson_admm.py) at f64 on the CPU, against the JAX package and
against the port's fused step.

Scenes: linear tets on make_tet_blocks(3, 2, 2) (no singular-value Newton,
so no Newton spread between the packages), pinned or, in zxu, on a floor
cutting through the block with collision terms on every vertex
(tests/test_instrumented.py's scenes). tests/test_torch_checkpoint.py holds
beams' log_x_star against the JAX package's.

Tolerances:
  * port instrumented against JAX instrumented: prims and combs 1e-10
    relative and 1e-10 of the step's first value (with Anderson the late
    residuals, some 1e-9 of the first, carry the AA solves' roundoff:
    3e-13 absolute), x 1e-10 relative and absolute with Anderson (2.4e-12
    measured on the floor scene), 1e-14 absolute without; equal resets
    and rejects;
  * port instrumented against port fused: tests/test_instrumented.py's own
    (1e-10 relative without acceleration; with it rtol 1e-9 plus
    np.allclose's default atol of 1e-8, x rtol 1e-9 / atol 1e-12);
  * chunked against fused: bit for bit;
  * the sweep's residual files against the JAX package's (beams, so the JAX
    side runs with the port's Newton polish, ``jax_newton_polished``):
    tests/test_torch_physics.py's rtol 1e-8, atol 1e-9.
"""

import os

import jax
import numpy as np
import pytest
import torch

from aa_admm_tpu.apps import test_anderson_admm as jsweep
from aa_admm_tpu.core.config import AccelType as JAccel
from aa_admm_tpu.core.config import Lame as JLame
from aa_admm_tpu.core.config import Settings as JSettings
from aa_admm_tpu.core.factory import make_tet_blocks as jblocks
from aa_admm_tpu.ops import prox as jpx
from aa_admm_tpu.solver.physics import PhysicsSolver as JSolver
from aa_admm_tpu_torch.apps import test_anderson_admm
from aa_admm_tpu_torch.core.config import AccelType, Lame, Settings
from aa_admm_tpu_torch.core.factory import make_tet_blocks
from aa_admm_tpu_torch.solver.physics import PhysicsSolver
from test_torch_svd_prox import jax_newton_polished

CASES = [("xzu", False, False), ("xzu", True, False),
         ("zxu", False, False), ("zxu", True, True)]
IDS = ["xzu-noacc", "xzu-aa4", "zxu-noacc", "zxu-aa4-floor"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Single-threaded torch: thousands of tiny ops per step, and OpenMP
    workers spinning between them starve the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk(order, accel, floor=False, iters=25, jax_side=False, chunk=0,
        device="cpu"):
    """tests/test_instrumented.py's scenes in either package."""
    mesh = (jblocks if jax_side else make_tet_blocks)(3, 2, 2)
    lo, hi = mesh.bounds()
    mesh.verts = (mesh.verts - 0.5 * (lo + hi)) / (hi - lo)[1]
    s = (JSettings if jax_side else Settings)()
    s.admm_iters = iters
    s.verbose = 0
    if accel:
        s.acceleration_type = (JAccel if jax_side else AccelType).ANDERSON
        s.anderson_m = 4
    if jax_side:
        solver = JSolver(order=order)
        lame = JLame.from_young_poisson(1e6, 0.3)
    else:
        solver = PhysicsSolver(order=order, device=device)
        lame = Lame.from_young_poisson(1e6, 0.3)
    solver.add_tetmesh(mesh.verts, mesh.tets, lame)
    if floor:
        solver.add_obstacle("floor", y=float(mesh.verts[:, 1].min() + 0.2))
        solver.set_collisions(list(range(len(mesh.verts))))
    else:
        solver.set_pins([0, 1])
    solver.initialize(s)
    solver.settings.trace_chunk = chunk        # read by step(), not initialize
    return solver


@pytest.mark.parametrize("order, accel, floor", CASES, ids=IDS)
def test_instrumented_matches_jax(order, accel, floor):
    j, t = _mk(order, accel, floor, jax_side=True), _mk(order, accel, floor)
    for _ in range(2):
        pj, cj = j.step_instrumented()
        pt, ct = t.step_instrumented()
        assert len(pt) == len(pj) > 0
        np.testing.assert_allclose(pt, pj, rtol=1e-10, atol=1e-10 * pj[0])
        np.testing.assert_allclose(ct, cj, rtol=1e-10, atol=1e-10 * cj[0])
        np.testing.assert_allclose(t.x, j.x, rtol=1e-10,
                                   atol=1e-10 if accel else 1e-14)
        assert t.reset_num == j.reset_num
        assert t.step_reject == j.step_reject
    assert not floor or t.reset_num > 0
    rt = t.runtime
    assert rt.global_ms > 0 and rt.local_ms > 0 and rt.initialization_ms > 0
    assert rt.inner_iters == len(t.step_prim)
    assert len(rt.step_time) == len(t.step_prim)
    # one counted host read per residual, plus one per AA Gram matrix
    per_it = 2 + (1 if accel else 0)
    assert t.stats["host_reads"] >= per_it * len(t.step_prim)


@pytest.mark.parametrize("order, accel, floor", CASES, ids=IDS)
def test_instrumented_matches_fused(order, accel, floor):
    a, b = _mk(order, accel, floor), _mk(order, accel, floor)
    tr = a.step()
    prims_i, combs_i = b.step_instrumented()
    prims_f, combs_f = tr.prim.numpy(), tr.comb.numpy()
    prims_f, combs_f = prims_f[~np.isnan(prims_f)], combs_f[~np.isnan(combs_f)]
    if accel:
        n = min(len(prims_f), len(prims_i))
        assert n > 0
        assert np.allclose(prims_f[:n], prims_i[:n], rtol=1e-9)
        np.testing.assert_allclose(a.x, b.x, rtol=1e-9, atol=1e-12)
        assert int(tr.reset_count) == b.reset_num
        assert b.runtime.acceleration_ms > 0
    else:
        assert len(prims_i) == len(prims_f)
        np.testing.assert_allclose(prims_f, prims_i, rtol=1e-10)
        np.testing.assert_allclose(combs_f, combs_i, rtol=1e-10)
        np.testing.assert_allclose(a.x, b.x, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("order", ["xzu", "zxu"])
def test_chunked_matches_fused_bitwise(order):
    """trace_chunk set after initialize: every residual, reject and x equal
    to the fused steps', over three steps."""
    a, b = _mk(order, True, iters=23), _mk(order, True, iters=23, chunk=5)
    for _ in range(3):
        a.step()
        b.step()
    a.flush_traces()
    b.flush_traces()
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.v, b.v)
    assert a.step_prim == b.step_prim
    assert a.step_comb == b.step_comb
    assert a.step_reject == b.step_reject
    assert a.reset_num == b.reset_num
    t = b.step_times
    assert all(t[i] < t[i + 1] for i in range(len(t) - 1))
    with pytest.raises(RuntimeError, match="trace_chunk"):
        b.run(1)


def test_chunk_one_every_row_measured():
    b = _mk("zxu", False, iters=6, chunk=1)
    b.step()
    b.step()
    b.flush_traces()
    t = b.step_times
    assert len(t) == 12
    assert all(t[i] < t[i + 1] for i in range(len(t) - 1))


def test_instrumented_time_rows_are_each_steps_own():
    """Two instrumented steps in a row: the second step's rows follow the
    first's, each row this step's own cumulative phase time. The JAX package
    reads runtime.step_time from its start in every step
    (aa_admm_tpu/solver/physics.py:1609-1615), so its second step repeats
    the first step's rows shifted by the first step's end (ROADMAP queue
    C)."""
    t = _mk("xzu", False, iters=6)
    t.step_instrumented()
    first = list(t.step_times)
    t.step_instrumented()
    second = t.step_times[len(first):]
    assert len(first) == len(second) == 6
    assert second[0] > first[-1]
    assert all(a < b for a, b in zip(t.step_times, t.step_times[1:]))
    rows = t.runtime.step_time
    assert len(rows) == 12
    np.testing.assert_allclose(np.diff(second), np.diff(rows[6:]), rtol=1e-12)
    np.testing.assert_allclose(np.diff(first), np.diff(rows[:6]), rtol=1e-12)
    # a fused step after them starts where they ended
    t.step()
    t.flush_traces()
    assert t.step_times[12] > second[-1]


def test_anderson_sweep_writes_seven_residual_files(tmp_path):
    """apps/test_anderson_admm.py at -it 5, one frame, --cpu: one residual
    file per setting (-a 0 and -am 1..6), five rows each."""
    params = [p + " -it 5" for p in test_anderson_admm.DEFAULT_PARAMS]
    assert test_anderson_admm.main(["1", str(tmp_path), "--cpu"],
                                   params=params) == 0
    names = sorted(os.listdir(tmp_path))
    assert names == [f"residual-{m}.txt" for m in range(1, 7)] + [
        "residual-no.txt"]
    for name in names:
        rows = np.loadtxt(tmp_path / name)
        assert rows.shape == (5, 3) and np.isfinite(rows).all()
    # the accelerated setting through the JAX package's sweep
    orig = jpx._sigma_newton
    jpx._sigma_newton = jax_newton_polished()
    jax.clear_caches()
    try:
        jsweep.main(["1", str(tmp_path / "jax")],
                    params=["-am 5 -it 5"])
    finally:
        jpx._sigma_newton = orig
        jax.clear_caches()
    mine, ref = (np.loadtxt(d / "residual-5.txt")
                 for d in (tmp_path, tmp_path / "jax"))
    np.testing.assert_allclose(mine[:, 1:], ref[:, 1:], rtol=1e-8, atol=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["xzu", "zxu"])
def test_instrumented_and_chunked_match_fused_on_card(order):
    """On CUDA tensors: the instrumented step against the fused step at
    tests/test_instrumented.py's tolerances, and a chunked step bit for bit
    against the fused step. Deterministic algorithms are switched on for
    the bit comparison: the x-step's index_add_ sums in a varying order on
    the card otherwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    def card(chunk=0):
        return _mk(order, True, iters=23, chunk=chunk, device="cuda")

    fused, inst = card(), card()
    tr = fused.step()
    prims_i, _ = inst.step_instrumented()
    prims_f = tr.prim.cpu().numpy()
    prims_f = prims_f[~np.isnan(prims_f)]
    n = min(len(prims_f), len(prims_i))
    assert n > 0 and np.allclose(prims_f[:n], prims_i[:n], rtol=1e-9)
    np.testing.assert_allclose(fused.x, inst.x, rtol=1e-9, atol=1e-12)
    assert int(tr.reset_count) == inst.reset_num
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        a, b = card(), card(chunk=5)
        for _ in range(2):
            a.step()
            b.step()
    finally:
        torch.use_deterministic_algorithms(False)
    a.flush_traces()
    b.flush_traces()
    np.testing.assert_array_equal(a.x, b.x)
    assert a.step_prim == b.step_prim and a.step_comb == b.step_comb
    assert a.step_reject == b.step_reject
