"""The JAX package's on-accelerator f32 contract (tests_tpu/test_golden_f32.py)
held on the PyTorch port: each check with its own bounds and golden files,
run through the port's entry points at float32, once on the CPU (the plain
twins, as AAADMM_TPU_FORCE_CPU=1 runs the JAX suite) and once on a CUDA card
(``cuda`` marker; skips without one).

Bounds, unchanged from the JAX suite (calibrated there on CPU-f32):

* Early-phase trajectory parity: while the C++ primal residual is above
  1e-2 of its first value, ours matches it to a relative 1e-2; the
  iteration where the residual first falls below 1e-2 of its start is
  within +/-3 of the C++ one.
* Anderson acceleration (m = 5) at f32 reaches 1e-2 of the first residual
  within 15 iterations.
* End states of 30-frame plinko rollouts within 1e-1 (hit) and 2.5e-1
  (pony) of the C++ f64 build; converged geometry metrics within 2x
  (planarity) and 3x (wire mesh) of the C++ converged values.

The beams scene is procedural, so its two checks run everywhere; the others
need the reference meshes and skip where the JAX suite's do, with the same
reason. Golden files: tests/golden/ (see its README)."""

import os

import numpy as np
import pytest
import torch

from aa_admm_tpu_torch.core.config import AccelType, Settings
# the JAX package's f32 tests' reference mounts and skip gates (the same
# paths and reason as tests_tpu/)
from test_f32_scenes import DATA, GEO, needs_data, needs_geo

HERE = os.path.dirname(__file__)
GOLDEN = os.path.join(HERE, "golden")

_EARLY_REL = 1e-2       # rel tolerance while cpp prim > 1e-2 x initial
_MILESTONE_SLACK = 3    # iterations


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Single-threaded torch: thousands of tiny ops per physics step, and
    OpenMP workers spinning between them starve the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return request.param


def _settings(iters, accel, m=5):
    s = Settings()
    s.admm_iters = iters
    s.verbose = 0
    if accel:
        s.acceleration_type = AccelType.ANDERSON
        s.anderson_m = m
    s.collect_comb_residual = True
    s.dtype = np.dtype("float32")
    return s


def _prim(tr):
    return tr.prim.cpu().numpy().astype(np.float64)


def _early_phase_check(prim, cpp):
    prim = np.asarray(prim, np.float64)
    n = min(len(prim), len(cpp))
    prim, ref = prim[:n], cpp[:n, 1]
    mask = ref > 1e-2 * ref[0]
    rel = np.abs(prim[mask] - ref[mask]) / ref[mask]
    assert rel.max() < _EARLY_REL, \
        f"early-phase rel err {rel.max():.3e} over {mask.sum()} iters"
    ours_hit = int(np.argmax(prim < 1e-2 * prim[0]))
    cpp_hit = int(np.argmax(ref < 1e-2 * ref[0]))
    assert abs(ours_hit - cpp_hit) <= _MILESTONE_SLACK, \
        f"1e-2 decay milestone: ours iter {ours_hit} vs C++ {cpp_hit}"


def test_beams_step1_residual_parity_f32(device):
    from aa_admm_tpu_torch.apps.beams import build_scene
    s = _settings(100, accel=False)
    solver, stretch = build_scene(s, device=device)
    stretch(s.timestep_s)
    tr = solver.step()
    assert tr.prim.dtype == torch.float32
    cpp = np.loadtxt(os.path.join(GOLDEN, "beams_step1_residual_no_cpp.txt"))
    _early_phase_check(_prim(tr), cpp)


@needs_data
def test_windyflag_nowind_step1_residual_parity_f32(device):
    from aa_admm_tpu_torch.apps.windyflag import build_scene
    s = _settings(100, accel=False)
    solver = build_scene(s, mesh_path=os.path.join(DATA, "cloth.obj"),
                         device=device)
    solver.wind = None     # the golden run disables wind (deterministic)
    solver.initialize(s)
    tr = solver.step()
    cpp = np.loadtxt(os.path.join(GOLDEN,
                                  "windy_nowind_step1_residual_no_cpp.txt"))
    _early_phase_check(_prim(tr), cpp)


@needs_data
def test_plinkohit_30frames_endstate_f32(device):
    from aa_admm_tpu_torch.apps.plinkohit import build_scene
    solver = build_scene(_settings(13, accel=True),
                         mesh_path=os.path.join(DATA, "horse759"),
                         device=device)
    solver.run(30)
    xref = np.loadtxt(os.path.join(
        GOLDEN, "plinkohit_final_x_30f_m5_cpp.txt")).reshape(-1, 3)
    d = np.linalg.norm(solver.x - xref, axis=1)
    assert d.max() < 1e-1, f"final_x max err {d.max():.3e}"


@needs_data
def test_plinkopony_30frames_endstate_f32(device):
    from aa_admm_tpu_torch.apps.plinkopony import build_scene
    solver = build_scene(_settings(13, accel=True),
                         mesh_path=os.path.join(DATA, "horse759"),
                         device=device)
    solver.run(30)
    xref = np.loadtxt(os.path.join(
        GOLDEN, "plinkopony_final_x_30f_m5_cpp.txt")).reshape(-1, 3)
    d = np.linalg.norm(solver.x - xref, axis=1)
    # Pony bounces through the peg grid: contact events amplify precision
    # differences.
    assert d.max() < 2.5e-1, f"final_x max err {d.max():.3e}"


def test_beams_acceleration_converges_f32(device):
    """AA m=5 at f32 must still converge fast: residual below 1e-2 x
    initial within 15 iterations (no-acc needs 11; the f32 floor triggers
    late-phase rejects but must not stall the early phase)."""
    from aa_admm_tpu_torch.apps.beams import build_scene
    s = _settings(100, accel=True)
    solver, stretch = build_scene(s, device=device)
    stretch(s.timestep_s)
    tr = solver.step()
    prim = _prim(tr)
    assert np.all(np.isfinite(prim))
    hit = np.argmax(prim < 1e-2 * prim[0])
    assert prim[hit] < 1e-2 * prim[0] and hit <= 15, \
        f"AA f32: 1e-2 decay at iter {hit}"


@needs_geo
def test_costa2k_converged_planarity_f32(device):
    from aa_admm_tpu_torch.apps.planarity_opt import (check_planarity_error,
                                                      optimize_mesh)
    from aa_admm_tpu_torch.core.meshio import load_obj, load_obj_poly
    from aa_admm_tpu_torch.core.polymesh import PolyMesh
    verts, faces = load_obj_poly(
        f"{GEO}/PQMeshData/polymesh/costa2k_poly.obj")
    mesh = PolyMesh(verts=verts, faces=faces)
    ref = load_obj(f"{GEO}/PQMeshData/trimesh/costa2k_tri.obj")
    solver = optimize_mesh(mesh, ref.verts, ref.faces, 100, 5,
                           dtype=np.dtype("float32"), device=device)
    pl_after, _ = check_planarity_error(mesh, solver.get_solution())
    # C++ converged max planarity error: 0.00408527 (BASELINE_local.json).
    assert float(np.max(pl_after)) < 2.0 * 0.00408527


@pytest.mark.slow
@needs_geo
@pytest.mark.skipif(os.environ.get("AAADMM_SLOW_TESTS") != "1",
                    reason="slow: full 57k-vert wiremesh (AAADMM_SLOW_TESTS=1)")
def test_wiremesh_converged_metrics_f32(device, tmp_path):
    from aa_admm_tpu_torch.apps import wire_mesh_opt as w
    opts = tmp_path / "opts.txt"
    opts.write_text("Iterations 100\nAndersonM 5\nPenalty 1000\n")
    solver = w.main([f"{GEO}/WireMeshData/MaleTorso.obj",
                     f"{GEO}/WireMeshData/MaleTorso_target.obj",
                     str(opts), str(tmp_path / "out.obj")],
                    dtype=np.dtype("float32"), return_solver=True,
                    chunk_iters=25, device=device)
    m = solver.after_metrics
    # C++ converged (BASELINE_local.json): edge 0.00212871, angle 0.142833.
    assert m["edge_err_max"] < 3.0 * 0.00212871
    assert m["angle_err_max"] < 3.0 * 0.142833
