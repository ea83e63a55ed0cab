"""The port's host state modules against the JAX package: core/checkpoint.py
(text dumps byte-identical, each package reading the other's files, the
same ValueErrors; .npz checkpoints), core/solverlog.py (errors equal to
1e-15), beams' log_x_star (SolverLog fed by the instrumented step; the JAX
side with the port's Newton polish, ``jax_newton_polished``, as beams runs
NeoHookean and StVK blocks; errors within 1e-10 of the first, which is 1:
the late errors carry the AA solves' roundoff, 8e-13 measured),
core/timers.py's RuntimeData, and PhysicsSolver.save_matrix (within 1e-12
relative of the JAX package's), save_state and load_state."""

import jax
import numpy as np
import pytest
import torch

from aa_admm_tpu.apps import beams as jbeams
from aa_admm_tpu.core import checkpoint as jck
from aa_admm_tpu.core import solverlog as jlog
from aa_admm_tpu.core import timers as jtimers
from aa_admm_tpu.core.config import AccelType as JAccel
from aa_admm_tpu.core.config import Lame as JLame
from aa_admm_tpu.core.config import Settings as JSettings
from aa_admm_tpu.core.factory import make_tet_blocks as jblocks
from aa_admm_tpu.ops import prox as jpx
from aa_admm_tpu.solver.physics import PhysicsSolver as JSolver
from aa_admm_tpu_torch.apps import beams as tbeams
from aa_admm_tpu_torch.core import checkpoint as tck
from aa_admm_tpu_torch.core import solverlog as tlog
from aa_admm_tpu_torch.core import timers as ttimers
from aa_admm_tpu_torch.core.config import AccelType, Lame, Settings
from aa_admm_tpu_torch.core.factory import make_tet_blocks
from aa_admm_tpu_torch.solver.physics import PhysicsSolver
from test_torch_svd_prox import jax_newton_polished


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Single-threaded torch: thousands of tiny ops per physics step, and
    OpenMP workers spinning between them starve the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(seed=0):
    rng = np.random.default_rng(seed)
    z, u, lz = rng.normal(size=(3, 50)) * 10.0 ** rng.integers(-9, 9, (3, 50))
    return z, u, lz, rng.normal(size=30)


def test_text_dump_byte_identical_and_cross_loads(tmp_path):
    z, u, lz, x = _state()
    files = {}
    for name, mod in (("jax", jck), ("port", tck)):
        f1, f2 = str(tmp_path / f"{name}_zu.txt"), str(tmp_path / f"{name}_x.txt")
        mod.save_admm_state_text(f1, f2, z, u, lz, x)
        files[name] = (f1, f2)
    for i in range(2):
        with open(files["jax"][i], "rb") as a, open(files["port"][i], "rb") as b:
            assert a.read() == b.read()
    for writer, reader in (("jax", tck), ("port", jck)):
        out = reader.load_admm_state_text(*files[writer])
        same = tck.load_admm_state_text(*files[writer])
        for a, b, c in zip(out, same, (z, u, lz, x)):
            np.testing.assert_array_equal(a, b)
            # 16 significant digits: within 1 ulp-ish of f64
            np.testing.assert_allclose(a, c, rtol=1e-15, atol=0)


@pytest.mark.parametrize("bad_zu, bad_x, match", [
    ("0\n", "1\n1.0\n", "invalid number or values"),
    ("2\n1 2 3\n", "1\n1.0\n", "parsing distance values"),
    ("2\n1 2 3\n4 5 6\n", "0\n", "invalid number or values from file 2"),
    ("2\n1 2 3\n4 5 6\n", "3\n1.0\n2.0\n", "parsing x values"),
])
def test_text_load_errors_match_jax(tmp_path, bad_zu, bad_x, match):
    f1, f2 = tmp_path / "zu.txt", tmp_path / "x.txt"
    f1.write_text(bad_zu)
    f2.write_text(bad_x)
    for mod in (jck, tck):
        with pytest.raises(ValueError, match=match):
            mod.load_admm_state_text(str(f1), str(f2))


def test_npz_roundtrip_cross(tmp_path):
    arrays = dict(x=np.arange(6.0).reshape(2, 3), it=np.int64(7))
    for writer, reader in ((jck, tck), (tck, jck), (tck, tck)):
        p = str(tmp_path / "ck.npz")
        writer.save_solver_npz(p, **arrays)
        d = reader.load_solver_npz(p)
        np.testing.assert_array_equal(d["x"], arrays["x"])
        assert int(d["it"]) == 7


def test_solverlog_matches_jax():
    rng = np.random.default_rng(3)
    x_star = rng.normal(size=12)
    xs = [rng.normal(size=12) for _ in range(6)]
    logs = [jlog.SolverLog(), tlog.SolverLog()]
    for log in logs:
        log.add(xs[0])                  # skipped: x_star unset
        assert log.errors == []
        log.x_star = x_star
        log.add(np.zeros(5))            # skipped: wrong shape
        for x in xs:
            log.add(x)
        log.finalize(lambda v: 2.0 * v, xs[-1], 2.0 * x_star)
    assert logs[1].errors[0] == 1.0
    np.testing.assert_allclose(logs[1].errors, logs[0].errors, rtol=1e-15)
    assert len(logs[1].runtimes) == len(xs) and logs[1].runtimes[0] == 0.0
    np.testing.assert_allclose(logs[1].final_r, logs[0].final_r, rtol=1e-15)
    logs[1].reset()
    assert logs[1].errors == [] and logs[1].runtimes == []


def test_runtime_data_print_matches_jax(capsys):
    s, js = Settings(), JSettings()
    for st in (s, js):
        st.admm_iters, st.anderson_m = 7, 3
    out = []
    for mod, st in ((jtimers, js), (ttimers, s)):
        rt = mod.RuntimeData(global_ms=1.5, local_ms=2.25,
                             acceleration_ms=0.5, initialization_ms=3.0,
                             inner_iters=7)
        rt.print(st)
        out.append(capsys.readouterr().out)
    assert out[0] == out[1]
    assert ttimers.RuntimeData().step_time == []


def _solvers():
    mesh = make_tet_blocks(2, 1, 1)
    s, js = Settings(), JSettings()
    for st in (s, js):
        st.verbose, st.admm_iters = 0, 5
    t = PhysicsSolver(device="cpu")
    t.add_tetmesh(mesh.verts, mesh.tets, Lame.from_young_poisson(1e6, 0.3))
    t.set_pins([0])
    t.initialize(s)
    jm = jblocks(2, 1, 1)
    j = JSolver()
    j.add_tetmesh(jm.verts, jm.tets, JLame.from_young_poisson(1e6, 0.3))
    j.set_pins([0])
    j.initialize(js)
    return t, j


def test_save_matrix_matches_jax(tmp_path):
    t, j = _solvers()
    pt, pj = str(tmp_path / "At.txt"), str(tmp_path / "Aj.txt")
    t.save_matrix(pt)
    j.save_matrix(pj)
    A, Aj = np.loadtxt(pt), np.loadtxt(pj)
    nf = t.system.n_free
    assert A.shape == (nf, nf)
    np.testing.assert_allclose(A, Aj, rtol=1e-12, atol=1e-12 * np.abs(Aj).max())
    assert np.all(np.linalg.eigvalsh(A) > 0)


def test_save_and_load_state(tmp_path):
    t, j = _solvers()
    t.step()
    p = str(tmp_path / "state.npz")
    t.save_state(p)
    fresh, _ = _solvers()
    fresh.load_state(p)
    np.testing.assert_array_equal(fresh.x, t.x)
    np.testing.assert_array_equal(fresh.v, t.v)
    assert fresh._x_dev.dtype == torch.float64
    # the JAX package reads the port's state file
    j.load_state(p)
    np.testing.assert_array_equal(j.x, t.x)
    fresh.step()
    t.step()
    np.testing.assert_array_equal(fresh.x, t.x)


def test_log_x_star_matches_jax(tmp_path):
    """beams --log-x-star, cut to a 120-iteration star step and a
    20-iteration accelerated step, against the JAX package's log_x_star
    with the port's Newton polish."""
    def settings(S, A):
        s = S()
        s.admm_iters = 20
        s.verbose = 0
        s.acceleration_type = A.ANDERSON
        s.anderson_m = 5
        return s
    orig = jpx._sigma_newton
    jpx._sigma_newton = jax_newton_polished()
    jax.clear_caches()
    try:
        jlog = jbeams.log_x_star(settings(JSettings, JAccel),
                                 result_dir=str(tmp_path / "j"), star_iters=120)
    finally:
        jpx._sigma_newton = orig
        jax.clear_caches()
    tlog = tbeams.log_x_star(settings(Settings, AccelType),
                             result_dir=str(tmp_path / "t"), star_iters=120,
                             device="cpu")
    assert len(tlog.errors) == len(tlog.runtimes) == 20
    assert tlog.errors[0] == 1.0
    np.testing.assert_allclose(tlog.errors, jlog.errors, rtol=1e-10,
                               atol=1e-10)
    assert tlog.errors[-1] < 0.5
    data = np.loadtxt(tmp_path / "t" / "solverlog-5.txt")
    assert data.shape == (20, 2)
    np.testing.assert_allclose(data[:, 1], tlog.errors, rtol=1e-12)
