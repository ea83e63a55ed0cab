"""Locating the reference data assets (meshes) of the physics scenes
(counterpart of aa_admm_tpu/apps/_data.py).

The published scenes load the reference's meshes (horse759 .ele/.node,
cloth.obj from admm_anderson_hard_zxu/samples/data/). They are looked up in
$AAADMM_DATA, then in ./data at the root of the repository; without them the
apps raise the JAX package's FileNotFoundError, and a caller passes
``mesh_path`` instead.
"""

import os

_CANDIDATES = [
    os.environ.get("AAADMM_DATA", ""),
    os.path.join(os.path.dirname(__file__), "..", "..", "data"),
]


def find_data(relpath: str) -> str:
    for base in _CANDIDATES:
        if not base:
            continue
        p = os.path.join(base, relpath)
        if os.path.exists(p) or os.path.exists(p + ".ele"):
            return p
    raise FileNotFoundError(
        f"data asset '{relpath}' not found; set AAADMM_DATA")
