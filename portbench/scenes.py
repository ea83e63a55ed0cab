"""Scene generators of the wire-mesh cells, frozen here so that no later
change to the program can move the inputs (after ``chip_smoke.py``'s
``quad_grid``, ``height_field_tris`` and ``full_field``). NumPy and SciPy
only.

The design is a quad grid on a bumpy height field, split once as the
wire-mesh app does before it optimizes (one new vertex per edge and per
face, the new vertices placed by minimizing the uniform Laplacian with the
old ones fixed); the reference surface is the same field triangulated over
the grid's extent plus a margin.
"""

from __future__ import annotations

import numpy as np


def height_field(f):
    """z = amplitude sin(2 pi x / wavelength_x) cos(2 pi y / wavelength_y),
    from a configuration's ``field`` (chip_smoke.py's ``full_field`` is
    amplitude 3, wavelengths 80 and 60)."""
    a, lx, ly = f["amplitude"], f["wavelength_x"], f["wavelength_y"]

    def field(x, y):
        return a * np.sin(2 * np.pi * x / lx) * np.cos(2 * np.pi * y / ly)
    return field


def grid_faces(nx, ny):
    """Faces of an (nx x ny)-face quad grid whose vertex (i, j) has the
    index i * (ny + 1) + j, counter-clockwise."""
    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    a = (i * (ny + 1) + j).ravel()
    return np.stack([a, a + ny + 1, a + ny + 2, a + 1], 1)


def grid_verts(nx, ny, field):
    """Unit-spaced (nx + 1) x (ny + 1) vertices at z = field(x, y)."""
    xs, ys = np.meshgrid(np.arange(nx + 1, dtype=float),
                         np.arange(ny + 1, dtype=float), indexing="ij")
    return np.stack([xs.ravel(), ys.ravel(), field(xs, ys).ravel()], 1)


def height_field_tris(n, lo, hi, field):
    """The height field over [lo, hi]^2 triangulated on an n x n vertex
    grid: (verts (n^2, 3), faces (2 (n-1)^2, 3))."""
    u = np.linspace(lo, hi, n)
    X, Y = np.meshgrid(u, u, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel(), field(X, Y).ravel()], 1)
    i, j = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    a = (i * n + j).ravel()
    b = a + n
    faces = np.concatenate([np.stack([a, b, a + 1], 1),
                            np.stack([b, b + 1, a + 1], 1)])
    return verts, faces


def mean_edge_length(verts, faces):
    e = quad_edges(faces)
    return float(np.linalg.norm(verts[e[:, 1]] - verts[e[:, 0]], axis=1).mean())


def quad_edges(faces):
    """The unique edges (E, 2) of a quad mesh, each as (low, high), sorted."""
    a = faces.reshape(-1)
    b = np.roll(faces, -1, axis=1).reshape(-1)
    e = np.stack([np.minimum(a, b), np.maximum(a, b)], 1)
    return np.unique(e, axis=0)


def quad_corners(faces):
    """(4F, 3) corner triples (tip, next, previous), corner i of every face
    after corner i - 1 of every face, as the wire-mesh app orders them."""
    return np.concatenate(
        [np.stack([faces[:, i], faces[:, (i + 1) % 4], faces[:, (i + 3) % 4]],
                  axis=1) for i in range(4)], axis=0)


def subdivide_grid(verts, nx, ny):
    """The quad split of an (nx x ny)-face grid (vertex (i, j) at index
    i * (ny + 1) + j) into the (2nx x 2ny)-face grid, then the new
    vertices placed by minimizing ||L x||^2 with the old ones fixed: L has
    a row v - mean(ring) for every interior vertex and v - (a + b) / 2 for
    every boundary vertex whose two boundary edges lie on two faces (not
    the corners). Solved exactly (sparse LU). Returns (verts, faces)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    NX, NY = 2 * nx, 2 * ny
    old = verts.reshape(nx + 1, ny + 1, 3)
    fine = np.zeros((NX + 1, NY + 1, 3))
    fine[0::2, 0::2] = old
    fine[1::2, 0::2] = 0.5 * (old[:-1] + old[1:])
    fine[0::2, 1::2] = 0.5 * (old[:, :-1] + old[:, 1:])
    fine[1::2, 1::2] = 0.25 * (old[:-1, :-1] + old[1:, :-1]
                               + old[:-1, 1:] + old[1:, 1:])
    idx = np.arange((NX + 1) * (NY + 1)).reshape(NX + 1, NY + 1)
    I, J = np.meshgrid(np.arange(NX + 1), np.arange(NY + 1), indexing="ij")
    rows, cols, vals = [], [], []
    r = 0
    for di, dj, sel in _laplacian_stencils(I, J, NX, NY):
        v = idx[sel]
        nb = [idx[I[sel] + a, J[sel] + b] for a, b in zip(di, dj)]
        k = len(nb)
        rr = r + np.arange(len(v))
        rows += [rr] + [rr] * k
        cols += [v] + nb
        vals += [np.ones(len(v))] + [np.full(len(v), -1.0 / k)] * k
        r += len(v)
    L = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(r, idx.size))
    is_new = np.ones((NX + 1, NY + 1), bool)
    is_new[0::2, 0::2] = False
    free, fixed = np.nonzero(is_new.ravel())[0], np.nonzero(~is_new.ravel())[0]
    x = fine.reshape(-1, 3)
    A, B = L[:, free], L[:, fixed]
    lu = spla.splu((A.T @ A).tocsc())
    x[free] = lu.solve(-(A.T @ (B @ x[fixed])))
    return x, grid_faces(NX, NY)


def _laplacian_stencils(I, J, NX, NY):
    """(row offsets, column offsets, vertex mask) of the Laplacian's rows:
    interior vertices over their four neighbours, boundary vertices other
    than the corners over their two neighbours along the boundary."""
    inner = (I > 0) & (I < NX) & (J > 0) & (J < NY)
    yield (1, -1, 0, 0), (0, 0, 1, -1), inner
    yield (0, 0), (1, -1), ((I == 0) | (I == NX)) & (J > 0) & (J < NY)
    yield (1, -1), (0, 0), ((J == 0) | (J == NY)) & (I > 0) & (I < NX)


def wire_design(cfg):
    """The configuration's design: (verts (n, 3), faces (F, 4), target edge,
    reference verts, reference faces). The target edge is half the coarse
    grid's mean edge, as the app halves its input's."""
    g = cfg["design"]
    nx = ny = int(g["grid_faces"])
    field = height_field(g["field"])
    coarse = grid_verts(nx, ny, field)
    target = 0.5 * mean_edge_length(coarse, grid_faces(nx, ny))
    verts, faces = subdivide_grid(coarse, nx, ny)
    r = cfg["reference_surface"]
    ref_v, ref_f = height_field_tris(int(r["n"]), -float(r["margin"]),
                                     nx + float(r["margin"]), field)
    return verts, faces, target, ref_v, ref_f
