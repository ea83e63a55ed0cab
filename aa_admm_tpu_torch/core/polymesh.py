"""Host-side polygon-mesh connectivity (NumPy / pure Python); the port's own
copy of aa_admm_tpu/core/polymesh.py.

The minimal subset of OpenMesh used by the geometry apps
(Geometry/MeshTypes.h, PlanarityOpt.cpp, WireMeshOpt.cpp): ordered vertex
one-rings, boundary detection, face circulators, average edge length, and
the quad subdivision + smoothing preprocess."""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Set, Tuple

import numpy as np


@dataclasses.dataclass
class PolyMesh:
    verts: np.ndarray          # (V, 3)
    faces: List[List[int]]     # polygon faces, CCW

    def __post_init__(self):
        self._build()

    def _build(self):
        V = len(self.verts)
        self.edge_faces: Dict[Tuple[int, int], List[int]] = defaultdict(list)
        self.vert_faces: List[List[int]] = [[] for _ in range(V)]
        for fi, f in enumerate(self.faces):
            k = len(f)
            for i in range(k):
                a, b = f[i], f[(i + 1) % k]
                self.edge_faces[(min(a, b), max(a, b))].append(fi)
                self.vert_faces[f[i]].append(fi)
        self.boundary_edges: Set[Tuple[int, int]] = {
            e for e, fs in self.edge_faces.items() if len(fs) == 1}
        self._boundary_vert = np.zeros(V, bool)
        for (a, b) in self.boundary_edges:
            self._boundary_vert[a] = True
            self._boundary_vert[b] = True

    def n_verts(self) -> int:
        return len(self.verts)

    def n_faces(self) -> int:
        return len(self.faces)

    def is_boundary_vertex(self, v: int) -> bool:
        return bool(self._boundary_vert[v])

    def is_boundary_edge(self, a: int, b: int) -> bool:
        return (min(a, b), max(a, b)) in self.boundary_edges

    def vertex_ring(self, v: int) -> List[int]:
        """Neighbors of v in consistent cyclic order (a path for boundary
        vertices, a cycle for interior ones) — the equivalent of OpenMesh's
        vertex-vertex circulator."""
        # Ring graph: neighbors adjacent through a shared face corner at v.
        nbr_links: Dict[int, List[int]] = defaultdict(list)
        nbrs: Set[int] = set()
        for fi in self.vert_faces[v]:
            f = self.faces[fi]
            i = f.index(v)
            p, n = f[i - 1], f[(i + 1) % len(f)]
            nbrs.update((p, n))
            nbr_links[p].append(n)
            nbr_links[n].append(p)
        if not nbrs:
            return []
        # Start from a boundary neighbor (degree 1 in the ring graph) if any.
        start = None
        for u in nbrs:
            if len(nbr_links[u]) == 1:
                start = u
                break
        if start is None:
            start = min(nbrs)
        ring = [start]
        prev = None
        cur = start
        while True:
            nxt = None
            for u in nbr_links[cur]:
                if u != prev:
                    nxt = u
                    break
            if nxt is None or nxt == start or len(ring) >= len(nbrs):
                break
            ring.append(nxt)
            prev, cur = cur, nxt
        return ring

    def boundary_neighbors(self, v: int) -> Tuple[List[int], List[int]]:
        """For a boundary vertex: (neighbor vertices along boundary edges,
        the face adjacent to each such edge) — PlanarityOpt.cpp:208-230."""
        nbrs, fids = [], []
        for u in self.vertex_ring(v):
            key = (min(u, v), max(u, v))
            if key in self.boundary_edges:
                nbrs.append(u)
                fids.append(self.edge_faces[key][0])
        return nbrs, fids

    def average_edge_length(self) -> float:
        total, cnt = 0.0, 0
        for (a, b) in self.edge_faces:
            total += float(np.linalg.norm(self.verts[a] - self.verts[b]))
            cnt += 1
        return total / max(cnt, 1)

    def face_valences(self) -> np.ndarray:
        return np.asarray([len(f) for f in self.faces])


def quad_subdivide(mesh: PolyMesh) -> Tuple[PolyMesh, np.ndarray]:
    """Catmull-Clark-style topological split of a quad mesh: one new vertex
    per edge and per face; each quad becomes four
    (MeshTypes.h quad_subdivision, :158-212). Returns (mesh, is_new mask)."""
    verts = [v.copy() for v in mesh.verts]
    V = len(verts)
    edge_mid: Dict[Tuple[int, int], int] = {}
    for (a, b) in sorted(mesh.edge_faces):
        edge_mid[(a, b)] = len(verts)
        verts.append(0.5 * (mesh.verts[a] + mesh.verts[b]))
    face_center: List[int] = []
    for f in mesh.faces:
        face_center.append(len(verts))
        verts.append(np.mean(mesh.verts[f], axis=0))
    faces: List[List[int]] = []
    for fi, f in enumerate(mesh.faces):
        k = len(f)
        c = face_center[fi]
        for i in range(k):
            a = f[i]
            e_prev = edge_mid[(min(f[i - 1], a), max(f[i - 1], a))]
            e_next = edge_mid[(min(a, f[(i + 1) % k]), max(a, f[(i + 1) % k]))]
            faces.append([a, e_next, c, e_prev])
    is_new = np.zeros(len(verts), bool)
    is_new[V:] = True
    return PolyMesh(verts=np.asarray(verts), faces=faces), is_new


def quad2tri_subdivision(mesh: PolyMesh):
    """Split each polygon into triangles fanning around its centroid
    (quad2tri_subdivision, MeshTypes.h:376-426). Returns (verts, tri_faces)."""
    verts = [v.copy() for v in mesh.verts]
    faces = []
    for f in mesh.faces:
        c = len(verts)
        verts.append(np.mean(mesh.verts[f], axis=0))
        n = len(f)
        for i in range(n):
            faces.append([f[i], c, f[(i - 1) % n]])
    return np.asarray(verts), np.asarray(faces, np.int32)


def uniform_laplacian_rows(mesh: PolyMesh):
    """Vectorized uniform-Laplacian row set matching the reference's
    construction (subdivide_and_smooth_mesh, MeshTypes.h:270-302; the same
    rule PlanarityOpt applies): interior vertex -> row over [v, ring] with
    coefs [1, -1/k...]; boundary vertex -> row over [v, boundary-edge
    neighbors] only when it has exactly two boundary edges adjacent to two
    distinct faces. Returns list of (indices, coefs) with unordered rings
    (uniform weights are order-independent)."""
    V = mesh.n_verts()
    edges = np.asarray(sorted(mesh.edge_faces), np.int64)  # (E, 2)
    is_bedge = np.asarray([tuple(e) in mesh.boundary_edges for e in
                           map(tuple, edges)])
    # adjacency lists via sorting
    endpoints = np.concatenate([edges, edges[:, ::-1]])  # (2E, 2): v -> nbr
    order = np.argsort(endpoints[:, 0], kind="stable")
    sorted_v = endpoints[order, 0]
    sorted_n = endpoints[order, 1]
    starts = np.searchsorted(sorted_v, np.arange(V))
    ends = np.searchsorted(sorted_v, np.arange(V) + 1)

    bedge_flag = np.concatenate([is_bedge, is_bedge])[order]
    bedge_face = np.full(len(edges), -1, np.int64)
    for i, e in enumerate(map(tuple, edges)):
        if is_bedge[i]:
            bedge_face[i] = mesh.edge_faces[e][0]
    bface = np.concatenate([bedge_face, bedge_face])[order]

    rows = []
    for v in range(V):
        s, e = starts[v], ends[v]
        if not mesh._boundary_vert[v]:
            nbrs = sorted_n[s:e]
            k = len(nbrs)
            if k == 0:
                continue
            rows.append((np.concatenate([[v], nbrs]),
                         np.concatenate([[1.0], np.full(k, -1.0 / k)])))
        else:
            sel = bedge_flag[s:e]
            nbrs = sorted_n[s:e][sel]
            fids = bface[s:e][sel]
            if len(fids) == 2 and fids[0] != fids[1]:
                rows.append((np.asarray([v, nbrs[0], nbrs[1]]),
                             np.asarray([1.0, -0.5, -0.5])))
    return rows


def subdivide_and_smooth(mesh: PolyMesh) -> PolyMesh:
    """Topological quad split + global Laplacian smoothing of the inserted
    vertices with the originals fixed: minimize ||L x||^2 over new vertices
    (subdivide_and_smooth_mesh, MeshTypes.h:214-342; the reference solves the
    reduced normal equations with SimplicialLDLT — here scipy sparse CG)."""
    import scipy.sparse
    import scipy.sparse.linalg

    V_orig = mesh.n_verts()
    out, is_new = quad_subdivide(mesh)
    rows = uniform_laplacian_rows(out)

    n = out.n_verts()
    data, ri, ci = [], [], []
    for r, (idx, coef) in enumerate(rows):
        ri.extend([r] * len(idx))
        ci.extend(idx)
        data.extend(coef)
    L = scipy.sparse.csr_matrix((data, (ri, ci)), shape=(len(rows), n))

    free = np.nonzero(is_new)[0]
    fixed = np.nonzero(~is_new)[0]
    A = L[:, free]
    B = L[:, fixed]
    rhs = -(A.T @ (B @ out.verts[fixed]))
    M = (A.T @ A).tocsc()
    diag = M.diagonal()
    precond = scipy.sparse.linalg.LinearOperator(
        M.shape, matvec=lambda x: x / np.maximum(diag, 1e-12))
    sol = np.empty((len(free), 3))
    for c in range(3):
        x, info = scipy.sparse.linalg.cg(M, rhs[:, c], rtol=1e-10,
                                         maxiter=2000, M=precond)
        sol[:, c] = x
    verts = out.verts.copy()
    verts[free] = sol
    assert V_orig == len(fixed)
    return PolyMesh(verts=verts, faces=out.faces)
