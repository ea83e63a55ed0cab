"""The frozen scene generators against the sizes the configurations state
and against the program's own split of a quad grid."""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import run, scenes  # noqa: E402

FIELD = {"amplitude": 3.0, "wavelength_x": 80.0, "wavelength_y": 60.0}


def test_split_matches_the_program():
    from aa_admm_tpu_torch.core.polymesh import PolyMesh, subdivide_and_smooth
    field = scenes.height_field(FIELD)
    coarse = scenes.grid_verts(8, 6, field)
    v, f = scenes.subdivide_grid(coarse, 8, 6)
    pm = subdivide_and_smooth(PolyMesh(verts=coarse,
                                       faces=scenes.grid_faces(8, 6).tolist()))
    assert v.shape == pm.verts.shape and len(f) == len(pm.faces)
    # the same points, in another order (the program's CG stops at 1e-10)
    def ordered(x):
        return x[np.lexsort(np.round(x[:, :2], 6).T[::-1])]
    a, b = ordered(v), ordered(pm.verts)
    assert np.abs(a - b).max() < 1e-7


def test_configured_sizes():
    cfg = run.load_json(os.path.join(ROOT, "portbench", "configs",
                                     "wiremesh-maletorso.json"))
    v, f, target, rv, rf = scenes.wire_design(cfg)
    assert len(v) == cfg["vertices"] == 58081
    assert len(rf) == cfg["reference_triangles"] == 40898
    assert len(scenes.quad_edges(f)) == 115680
    assert len(scenes.quad_corners(f)) == 4 * len(f) == 230400
    assert 0.5 < target / 0.5 < 1.02
