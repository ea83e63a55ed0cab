"""Package rules of the PyTorch port: it imports neither jax nor the JAX
package, its entry points default to the CUDA card and raise without one,
and chip_smoke.py neither imports JAX nor runs without a card."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import aa_admm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(aa_admm_tpu_torch.__path__,
                                               'aa_admm_tpu_torch.')]
for name in names:
    importlib.import_module(name)
{extra}
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith('jax.') or m == 'aa_admm_tpu'
             or m.startswith('aa_admm_tpu.'))
print(len(names), bad)
"""


def _run(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_port_imports_no_jax():
    n, bad = _run(_IMPORT_ALL.format(extra="")).split(" ", 1)
    assert int(n) >= 14
    assert bad == "[]"


def test_chip_smoke_imports_no_jax():
    _, bad = _run(_IMPORT_ALL.format(extra="import chip_smoke")).split(" ", 1)
    assert bad == "[]"


def test_chip_smoke_fails_without_a_card():
    """No CUDA here: chip_smoke exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_entry_points_raise_without_cuda(monkeypatch):
    from aa_admm_tpu_torch import resolve_device
    from aa_admm_tpu_torch.apps import wire_mesh_opt as wm
    from aa_admm_tpu_torch.solver.geometry import ALMGeometrySolver
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ALMGeometrySolver()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    mesh = wm.PolyMesh(verts=np.zeros((4, 3)), faces=[[0, 1, 2, 3]])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        wm.optimize_mesh(mesh, np.eye(3), np.asarray([[0, 1, 2]]), 1, 5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        wm.main(["a.obj", "b.obj", "o.txt", "out.obj"])
    assert ALMGeometrySolver(device="cpu").device.type == "cpu"


def test_precision_flags_set_on_import():
    import aa_admm_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_main_runs_on_cpu(tmp_path, monkeypatch):
    """The app's command line end to end on the CPU (--cpu)."""
    from aa_admm_tpu_torch.apps import wire_mesh_opt as wm
    from aa_admm_tpu_torch.core.meshio import save_obj
    xs, ys = np.meshgrid(np.arange(4.0), np.arange(4.0), indexing="ij")
    verts = np.stack([xs.ravel(), ys.ravel(),
                      0.1 * np.random.default_rng(0).normal(size=16)], 1)
    faces = [[i * 4 + j, (i + 1) * 4 + j, (i + 1) * 4 + j + 1, i * 4 + j + 1]
             for i in range(3) for j in range(3)]
    save_obj(str(tmp_path / "in.obj"), verts, faces)
    save_obj(str(tmp_path / "ref.obj"),
             np.array([[-1.0, -1, 0], [5, -1, 0], [5, 5, 0], [-1, 5, 0]]),
             [[0, 1, 2], [0, 2, 3]])
    (tmp_path / "opts.txt").write_text("Iterations 10\nAndersonM 5\n")
    monkeypatch.chdir(tmp_path)
    rc = wm.main(["in.obj", "ref.obj", "opts.txt", "out.obj", "--cpu"])
    assert rc == 0
    assert (tmp_path / "out.obj").exists()
    assert (tmp_path / "result" / "edge_wiremeshErrAfter.txt").exists()
