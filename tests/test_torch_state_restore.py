"""Mid-step ADMM state of the port's PhysicsSolver at f64 on the CPU
(save_admm_state / load_admm_state), against the JAX package: the
reference-format text dump written by either package and replayed by the
other against that package's uninterrupted step (within 1e-10), the port's
own .npz sidecar (the whole carry: an accelerated tail replays bit for
bit), and the ValueErrors on size and carry-structure mismatches. Scenes:
linear tets on make_tet_blocks(3, 2, 2), pinned (tests/test_state_restore.py)."""

import numpy as np
import pytest
import torch

from aa_admm_tpu.core.config import AccelType as JAccel
from aa_admm_tpu.core.config import Lame as JLame
from aa_admm_tpu.core.config import Settings as JSettings
from aa_admm_tpu.core.factory import make_tet_blocks as jblocks
from aa_admm_tpu.solver.physics import PhysicsSolver as JSolver
from aa_admm_tpu_torch.core.config import AccelType, Lame, Settings
from aa_admm_tpu_torch.core.factory import make_tet_blocks
from aa_admm_tpu_torch.solver import physics as tphys
from aa_admm_tpu_torch.solver.physics import PhysicsSolver

N, K = 20, 8
ORDERS = ["xzu", "zxu"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Single-threaded torch: thousands of tiny ops per step, and OpenMP
    workers spinning between them starve the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk(order, iters, accel=False, jax_side=False, blocks=(3, 2, 2)):
    mesh = (jblocks if jax_side else make_tet_blocks)(*blocks)
    s = (JSettings if jax_side else Settings)()
    s.admm_iters = iters
    s.verbose = 0
    if accel:
        s.acceleration_type = (JAccel if jax_side else AccelType).ANDERSON
        s.anderson_m = 4
    if jax_side:
        solver = JSolver(order=order)
        solver.add_tetmesh(mesh.verts, mesh.tets,
                           JLame.from_young_poisson(1e6, 0.3))
    else:
        solver = PhysicsSolver(order=order, device="cpu")
        solver.add_tetmesh(mesh.verts, mesh.tets,
                           Lame.from_young_poisson(1e6, 0.3))
    solver.set_pins([0, 1])
    solver.initialize(s)
    return solver


def _files(tmp_path, tag=""):
    return (str(tmp_path / f"zu{tag}.txt"), str(tmp_path / f"x{tag}.txt"),
            str(tmp_path / f"aa{tag}.npz"))


@pytest.mark.parametrize("order", ORDERS)
def test_port_dump_replays_own_tail(order, tmp_path):
    f_zu, f_x, _ = _files(tmp_path)
    a = _mk(order, N)
    a.step()
    b = _mk(order, N)
    b.save_admm_state(f_zu, f_x, at_iteration=K)
    # the dumping step still commits the whole N-iteration step
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.v, b.v)
    c = _mk(order, N - K)
    c.load_admm_state(f_zu, f_x)
    c.step()
    np.testing.assert_allclose(c.x, a.x, rtol=0, atol=1e-11)


@pytest.mark.parametrize("order", ORDERS)
def test_dumps_cross_between_packages(order, tmp_path):
    """The text dump written by each package, replayed by the other, against
    the writer's uninterrupted step; the two dumps of one state agree."""
    jf, tf = _files(tmp_path, "j"), _files(tmp_path, "t")
    j = _mk(order, N, jax_side=True)
    j.save_admm_state(*jf[:2], at_iteration=K)
    t = _mk(order, N)
    t.save_admm_state(*tf[:2], at_iteration=K)
    np.testing.assert_allclose(t.x, j.x, rtol=1e-12, atol=1e-14)
    for f_j, f_t in zip(jf[:2], tf[:2]):
        dj, dt = np.loadtxt(f_j, skiprows=1), np.loadtxt(f_t, skiprows=1)
        assert dj.shape == dt.shape
        np.testing.assert_allclose(dt, dj, rtol=1e-10, atol=1e-12)
    # a JAX dump through the port, a port dump through the JAX package
    pt = _mk(order, N - K)
    pt.load_admm_state(*jf[:2])
    pt.step()
    np.testing.assert_allclose(pt.x, j.x, rtol=1e-10, atol=1e-10)
    pj = _mk(order, N - K, jax_side=True)
    pj.load_admm_state(*tf[:2])
    pj.step()
    np.testing.assert_allclose(pj.x, t.x, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("order", ORDERS)
def test_sidecar_replays_accelerated_tail_bitwise(order, tmp_path):
    f_zu, f_x, f_aa = _files(tmp_path)
    b = _mk(order, N, accel=True)
    trace = b.save_admm_state(f_zu, f_x, at_iteration=K, aa_file=f_aa)
    c = _mk(order, N - K, accel=True)
    c.load_admm_state(f_zu, f_x, aa_file=f_aa)
    tail = c.step()
    np.testing.assert_array_equal(c.x, b.x)
    np.testing.assert_array_equal(c.v, b.v)
    np.testing.assert_array_equal(tail.prim.numpy(), trace.prim.numpy()[K:])
    assert int(tail.reset_count) == int(trace.reset_count)
    with np.load(f_aa) as d:
        assert int(d["n_leaves"]) == len(tphys._tree_leaves(
            tphys._step_setup(c.system, c._x_dev, c._v_dev,
                              c._pin_pos_dev())[0]))
    # Without the sidecar the AA window restarts: the tail differs.
    d = _mk(order, N - K, accel=True)
    d.load_admm_state(f_zu, f_x)
    d.step()
    assert np.any(d.x != b.x)
    assert np.isfinite(d.x).all()


def test_load_rejects_size_mismatch(tmp_path):
    f_zu, f_x, _ = _files(tmp_path)
    _mk("xzu", 5).save_admm_state(f_zu, f_x, at_iteration=2)
    bigger = _mk("xzu", 5, blocks=(4, 2, 2))
    with pytest.raises(ValueError, match="invalid number or values"):
        bigger.load_admm_state(f_zu, f_x)
    # the same blocks, another x file
    with open(f_x, "w") as f:
        f.write("3\n1\n2\n3\n")
    with pytest.raises(ValueError, match="from file 2"):
        _mk("xzu", 5).load_admm_state(f_zu, f_x)
    with pytest.raises(ValueError, match="at_iteration"):
        _mk("xzu", 5).save_admm_state(f_zu, f_x, at_iteration=6)


def test_load_rejects_sidecar_of_another_configuration(tmp_path):
    """A sidecar saved under another carry structure (the zxu carry has no
    dz) is refused when it is loaded, not at the next step."""
    f_zu, f_x, f_aa = _files(tmp_path)
    _mk("zxu", N, accel=True).save_admm_state(f_zu, f_x, at_iteration=K,
                                              aa_file=f_aa)
    xzu = _mk("xzu", N - K, accel=True)
    with pytest.raises(ValueError, match="carry structure mismatch"):
        xzu.load_admm_state(f_zu, f_x, aa_file=f_aa)
    assert xzu._admm_seed is None
    # another Anderson window: same keys, other AA shapes
    other_m = _mk("zxu", N - K, accel=True)
    other_m.settings.anderson_m = 3
    other_m.initialize()
    with pytest.raises(ValueError, match="carry structure mismatch"):
        other_m.load_admm_state(f_zu, f_x, aa_file=f_aa)


def test_fingerprint_and_tree_roundtrip():
    s = _mk("xzu", 3, accel=True)
    carry, _ = tphys._step_setup(s.system, s._x_dev, s._v_dev,
                                 s._pin_pos_dev())
    leaves = tphys._tree_leaves(carry)
    paths = [p for p, _ in leaves]
    assert paths[0] == ".x" and ".aa.dF" in paths and ".resets" in paths
    fp = tphys._carry_fingerprint(carry)
    assert ".done:bool()" in fp and ".aa.iter:int64()" in fp
    back = tphys._tree_unflatten(carry, [t.clone() for _, t in leaves])
    assert tphys._carry_fingerprint(back) == fp
    z = carry["z"]
    flat = tphys._flatten_ref(z)
    for a, b in zip(tphys._unflatten_ref(flat, z), z):
        assert torch.equal(a, b)
    # element-major: the first block's first element's components first
    b0 = z[0]
    np.testing.assert_array_equal(flat[:b0.shape[0]].numpy(),
                                  b0[:, 0].numpy())
