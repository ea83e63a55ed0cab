"""Mesh IO for the geometry apps (counterpart of aa_admm_tpu/core/meshio.py,
NumPy parsers only; the native ctypes loader is not part of the port yet).

Behavioral equivalents of mclscene MeshIO (``MCL/MeshIO.hpp`` ``load_obj``:55)
and the subset of OpenMesh OBJ IO used by the geometry apps.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class TriMeshData:
    verts: np.ndarray  # (V, 3) float64
    faces: np.ndarray  # (F, 3) int32
    flags: int = 0

    def bounds(self):
        return self.verts.min(axis=0), self.verts.max(axis=0)


def _parse_obj(path: str):
    verts, faces = [], []
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tok = parts[0].lower()
            if tok == "v":
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tok == "f":
                idx = []
                for p in parts[1:]:
                    s = p.split("/")[0]
                    if s:
                        i = int(s)
                        idx.append(i - 1 if i > 0 else len(verts) + i)
                faces.append(idx)
    return np.asarray(verts, dtype=np.float64).reshape(-1, 3), faces


def load_obj(path: str) -> TriMeshData:
    """Parse vertices + triangular faces from OBJ (polygons are fan-split)."""
    verts, polys = _parse_obj(path)
    faces = [[f[0], f[k], f[k + 1]] for f in polys for k in range(1, len(f) - 1)]
    return TriMeshData(verts=verts,
                       faces=np.asarray(faces, dtype=np.int32).reshape(-1, 3))


def load_obj_poly(path: str):
    """Parse OBJ keeping polygonal faces (list of index lists) — the quad
    meshes of PlanarityOpt/WireMeshOpt need face valence preserved."""
    return _parse_obj(path)


def save_obj(path: str, verts: np.ndarray, faces) -> None:
    """16-significant-digit OBJ writer (MeshTypes.h:122-127)."""
    with open(path, "w") as f:
        for v in verts:
            f.write("v %.16g %.16g %.16g\n" % (v[0], v[1], v[2]))
        for face in faces:
            f.write("f " + " ".join(str(int(i) + 1) for i in face) + "\n")


def save_residual_file(path: str, times, prim, comb=None, reject=None) -> None:
    """Write the reference's residual artifact: rows
    ``time \\t prim [\\t comb] [\\t reject]`` at 16-digit precision
    (admm Solver.hpp:126-151; ALMGeometrySolver.h:343-365 writes time+value)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for i in range(len(times)):
            row = "%.16g\t%.16g" % (times[i], prim[i])
            if comb is not None:
                row += "\t%.16g" % comb[i]
            if reject is not None:
                row += "\t%d" % int(reject[i])
            f.write(row + "\n")
