"""Mesh IO: Wavefront OBJ and TetGen .ele/.node (counterpart of
aa_admm_tpu/core/meshio.py). ``load_obj`` and ``load_elenode`` take the
native C++ parsers (aa_admm_tpu_torch.native) when that library builds; the
NumPy parsers below are the fallback for machines without a compiler.

Behavioral equivalents of mclscene MeshIO (``MCL/MeshIO.hpp`` ``load_obj``:55,
``load_elenode``:180, ``save_elenode``) and the subset of OpenMesh OBJ IO used
by the geometry apps.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .factory import TetMeshData


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
    """Parse vertices + triangular faces from OBJ (polygons are fan-split):
    natively where the library builds, else in NumPy."""
    from .. import native
    out = native.load_obj_native(path)
    if out is not None:
        return TriMeshData(verts=out[0], faces=out[1])
    return load_obj_numpy(path)


def load_obj_numpy(path: str) -> TriMeshData:
    """load_obj's NumPy parser."""
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


def load_elenode(basename: str) -> TetMeshData:
    """TetGen pair loader (mclscene meshio::load_elenode, MeshIO.hpp:180-...).

    ``basename.ele``: header '<n_tets> ...', rows 'id v0 v1 v2 v3'.
    ``basename.node``: header '<n_verts> ...', rows 'id x y z'.
    Indices may start at 0 or 1; detected and normalized. Parsed natively
    where the library builds, else in NumPy.
    """
    from .. import native
    out = native.load_elenode_native(basename)
    if out is not None:
        return TetMeshData(verts=out[0], tets=out[1])
    return load_elenode_numpy(basename)


def load_elenode_numpy(basename: str) -> TetMeshData:
    """load_elenode's NumPy parser."""
    def read_rows(path, ncols):
        with open(path, "r") as f:
            header = f.readline().split()
            n = int(header[0])
            rows = np.zeros((n, ncols + 1))
            for i in range(n):
                parts = f.readline().split()
                rows[i] = [float(p) for p in parts[: ncols + 1]]
        return rows

    ele = read_rows(basename + ".ele", 4)
    node = read_rows(basename + ".node", 3)
    tets = ele[:, 1:].astype(np.int64)
    if tets.min() == 1:
        tets = tets - 1
    verts = node[:, 1:]
    return TetMeshData(verts=verts.astype(np.float64), tets=tets.astype(np.int32))


def save_elenode(basename: str, mesh: TetMeshData) -> None:
    with open(basename + ".ele", "w") as f:
        f.write(f"{len(mesh.tets)} 4 0\n")
        for i, t in enumerate(mesh.tets):
            f.write(f"{i} {t[0]} {t[1]} {t[2]} {t[3]}\n")
    with open(basename + ".node", "w") as f:
        f.write(f"{len(mesh.verts)} 3 0 0\n")
        for i, v in enumerate(mesh.verts):
            f.write("%d %.16g %.16g %.16g\n" % (i, v[0], v[1], v[2]))


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
