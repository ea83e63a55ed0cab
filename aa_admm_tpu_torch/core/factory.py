"""Host-side (NumPy) mesh factories for the standard test scenes (counterpart
of aa_admm_tpu/core/factory.py:1-138, a host copy: the port imports nothing
of the JAX package).

Behavioral equivalents of mclscene's ShapeFactory
(``deps/mclscene/include/MCL/ShapeFactory.hpp``): tet blocks
(``make_tet_blocks``, :296) and tri blocks (:360), used by the beams and
windyflag scenes. ``_dedupe`` is the JAX package's exactly: the vertex
order it produces fixes the beams' pins and the C++ golden comparison.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TetMeshData:
    verts: np.ndarray  # (V, 3) float64
    tets: np.ndarray   # (T, 4) int32
    flags: int = 0

    def bounds(self):
        return self.verts.min(axis=0), self.verts.max(axis=0)

    def apply_xform(self, scale=1.0, trans=(0.0, 0.0, 0.0)):
        self.verts = self.verts * np.asarray(scale) + np.asarray(trans)
        return self

    def weighted_masses(self, density_kgm3: float = 1100.0) -> np.ndarray:
        """Lumped vertex masses: tet mass = density*|vol| split over 4 verts
        (mclscene TetMesh::weighted_masses, TetMesh.hpp:297-313)."""
        v0 = self.verts[self.tets[:, 0]]
        e = self.verts[self.tets[:, 1:]] - v0[:, None, :]  # (T,3,3) rows=edges
        vol = np.abs(np.linalg.det(np.transpose(e, (0, 2, 1)))) / 6.0
        m = np.zeros(len(self.verts))
        np.add.at(m, self.tets.ravel(), np.repeat(density_kgm3 * vol / 4.0, 4))
        return m

    def surface_faces(self) -> np.ndarray:
        """Boundary triangles: faces appearing in exactly one tet."""
        f = self.tets[:, [[0, 1, 2], [0, 2, 3], [0, 3, 1], [1, 3, 2]]].reshape(-1, 3)
        key = np.sort(f, axis=1)
        _, inv, counts = np.unique(key, axis=0, return_inverse=True,
                                   return_counts=True)
        return f[counts[inv] == 1]


@dataclasses.dataclass
class TriMeshData:
    verts: np.ndarray  # (V, 3) float64
    faces: np.ndarray  # (F, 3) int32
    flags: int = 0

    def bounds(self):
        return self.verts.min(axis=0), self.verts.max(axis=0)

    def apply_xform(self, scale=1.0, trans=(0.0, 0.0, 0.0)):
        self.verts = self.verts * np.asarray(scale) + np.asarray(trans)
        return self


def _dedupe(verts: np.ndarray, elems: np.ndarray, decimals: int = 6):
    """Join colocated vertices and remap element indices (mesh->refine())."""
    key = np.round(verts, decimals)
    _, first_idx, inv = np.unique(key, axis=0, return_index=True,
                                  return_inverse=True)
    # Preserve order of first appearance (matches incremental C++ dedupe).
    order = np.argsort(first_idx)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    new_verts = verts[np.sort(first_idx)]
    return new_verts, rank[inv][elems].astype(np.int32)


def make_tet_blocks(cubes_x: int, cubes_y: int, cubes_z: int) -> TetMeshData:
    """Connected 1x1x1 cubes, 5 tets per cube, built from (0,0,0) in +x/+y/+z
    (ShapeFactory::make_tet_blocks, ShapeFactory.hpp:296-355)."""
    cubes_x, cubes_y, cubes_z = max(1, cubes_x), max(1, cubes_y), max(1, cubes_z)
    verts, tets = [], []
    # Corner layout per cube (a..h) as in the reference:
    # a=max, b=(minx,maxy,maxz), c=(minx,maxy,minz), d=(maxx,maxy,minz),
    # e=(maxx,miny,maxz), f=(minx,miny,maxz), g=min, h=(maxx,miny,minz)
    corners = np.array([
        [1, 1, 1], [0, 1, 1], [0, 1, 0], [1, 1, 0],
        [1, 0, 1], [0, 0, 1], [0, 0, 0], [1, 0, 0],
    ], dtype=np.float64)
    five = np.array([
        [0, 5, 7, 4], [5, 7, 2, 0], [5, 0, 2, 1], [7, 2, 0, 3], [5, 2, 7, 6]
    ], dtype=np.int32)
    nv = 0
    for x in range(cubes_x):
        for y in range(cubes_y):
            for z in range(cubes_z):
                lo = np.array([x, y, z], dtype=np.float64)
                verts.append(corners + lo)
                tets.append(five + nv)
                nv += 8
    verts = np.concatenate(verts, axis=0)
    tets = np.concatenate(tets, axis=0)
    verts, tets = _dedupe(verts, tets)
    return TetMeshData(verts=verts, tets=tets)


def make_tri_blocks(cubes_x: int, cubes_y: int) -> TriMeshData:
    """Connected 1x1 squares in the z=0 plane, 4 triangles per square around a
    center vertex (ShapeFactory::make_tri_blocks, ShapeFactory.hpp:360-415)."""
    cubes_x, cubes_y = max(1, cubes_x), max(1, cubes_y)
    verts, faces = [], []
    five = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0.5, 0.5, 0]])
    tris = np.array([[3, 0, 4], [0, 1, 4], [1, 2, 4], [2, 3, 4]], dtype=np.int32)
    nv = 0
    for x in range(cubes_x):
        for y in range(cubes_y):
            lo = np.array([x, y, 0], dtype=np.float64)
            verts.append(five + lo)
            faces.append(tris + nv)
            nv += 5
    verts = np.concatenate(verts, axis=0)
    faces = np.concatenate(faces, axis=0)
    verts, faces = _dedupe(verts, faces)
    return TriMeshData(verts=verts, faces=faces)


def make_plane_grid(nx: int, ny: int, size: float = 1.0) -> TriMeshData:
    """Simple regular triangulated grid (for cloth tests)."""
    xs = np.linspace(0, size, nx + 1)
    ys = np.linspace(0, size, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel(), np.zeros(X.size)], axis=1)
    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    a = (i * (ny + 1) + j).ravel()
    b, c, d = a + ny + 1, a + ny + 2, a + 1
    faces = np.stack([np.stack([a, b, c], 1), np.stack([a, c, d], 1)],
                     1).reshape(-1, 3)
    return TriMeshData(verts=verts, faces=faces.astype(np.int32))
