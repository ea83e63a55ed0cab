"""PlanarityOpt — planar-quad-mesh optimization (counterpart of
aa_admm_tpu/apps/planarity_opt.py:1-172; Geometry/PlanarityOpt.cpp:39-332).

Usage: python -m aa_admm_tpu_torch.apps.planarity_opt IN_MESH REF_MESH
OPTIONS_FILE OUT_MESH [--cpu]

Constraints (optimize_mesh, :134-287): per-vertex PointToRefSurface soft
(closeness weight), relative uniform Laplacian regularizers split along the
quad diagonals at valence-4 interior vertices, per-face PlaneConstraint hard;
defaults penalty 1e5, closeness 1, relative Laplacian 0.1 (:322-325). Error
metrics: planarity and diagonal error normalized by the average edge length
(:67-108) and the reference-surface distance (:110-131). Runs on the CUDA
card unless device="cpu" (or --cpu).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .. import resolve_device
from ..core.config import Parameters
from ..core.meshio import load_obj, load_obj_poly, save_obj
from ..core.polymesh import PolyMesh
from ..ops.constraints import PlaneBatch, RefSurfaceBatch
from ..solver.geometry import ALMGeometrySolver
from .wire_mesh_opt import check_ref_surface_distance  # noqa: F401 (same app API)


def check_planarity_error(mesh: PolyMesh, verts=None):
    """Max deviation from the best-fit plane and the quad diagonal error,
    normalized by the average edge length (PlanarityOpt.cpp:67-108).
    Returns (planarity (F,), diag (F,))."""
    if verts is None:
        verts = mesh.verts
    F = mesh.n_faces()
    planarity = np.zeros(F)
    diag = np.zeros(F)
    for fi, f in enumerate(mesh.faces):
        p = verts[f].T  # (3, k)
        if p.shape[1] == 4:
            d1 = p[:, 2] - p[:, 0]
            d2 = p[:, 3] - p[:, 1]
            c1 = 0.5 * (p[:, 2] + p[:, 0])
            c2 = 0.5 * (p[:, 3] + p[:, 1])
            n = np.cross(d1, d2)
            n = n / max(np.linalg.norm(n), 1e-300)
            diag[fi] = abs(np.dot(n, c1 - c2))
        c = p - p.mean(axis=1, keepdims=True)
        # max |N^T c| over the face's points: the projection on the least axis
        u = np.linalg.svd(c, full_matrices=True)[0][:, 2]
        planarity[fi] = np.abs(u @ c).max()
    el = PolyMesh(verts=verts, faces=mesh.faces).average_edge_length()
    planarity /= el
    diag /= el
    print(f"Diagonal error (normalized by edge length): max {diag.max()}, "
          f"average {diag.mean()}")
    print(f"Planarity error (normalized by edge length): max "
          f"{planarity.max()}, average {planarity.mean()}")
    return planarity, diag


def optimize_mesh(mesh: PolyMesh, ref_verts, ref_faces, max_iter: int,
                  anderson_m: int, penalty_parameter: float = 1e5,
                  closeness_weight: float = 1.0,
                  laplacian_weight: float = 0.0,
                  relative_laplacian_weight: float = 0.1,
                  dtype=np.float64, device=None):
    """PlanarityOpt.cpp optimize_mesh (:134-287) on `device` (default the
    CUDA card)."""
    p = mesh.verts
    solver = ALMGeometrySolver(device=device)
    solver.dtype = np.dtype(dtype)

    if closeness_weight > 0:
        solver.add_soft_constraint(RefSurfaceBatch.create(
            list(range(mesh.n_verts())), closeness_weight,
            ref_verts, ref_faces))

    def add_rows(vhs):
        if relative_laplacian_weight > 0:
            solver.add_relative_uniform_laplacian(
                vhs, relative_laplacian_weight, p)
        if laplacian_weight > 0:
            solver.add_uniform_laplacian(vhs, laplacian_weight)

    if laplacian_weight > 0 or relative_laplacian_weight > 0:
        for v in range(mesh.n_verts()):
            if not mesh.is_boundary_vertex(v):
                vhs = [v] + mesh.vertex_ring(v)
                if len(vhs) == 5:
                    # valence 4: one row per quad diagonal (:175-193)
                    add_rows([vhs[0], vhs[1], vhs[3]])
                    add_rows([vhs[0], vhs[2], vhs[4]])
                else:
                    add_rows(vhs)
            else:
                nbrs, fids = mesh.boundary_neighbors(v)
                if len(fids) == 2 and fids[0] != fids[1]:
                    add_rows([v] + nbrs)

    plane_faces = [f for f in mesh.faces if len(f) > 3]
    if plane_faces:
        solver.add_hard_constraint(PlaneBatch.create(plane_faces, weight=1.0))

    eps_ratio = 1e-8
    rel_residual_eps = eps_ratio * mesh.average_edge_length()
    print(f"Relative residual eps (normalized by edge length): {eps_ratio}")

    if solver.setup_ADMM(mesh.n_verts(), penalty_parameter):
        solver.solve_ADMM(p, rel_residual_eps, max_iter, anderson_m)
    return solver


def main(argv=None, dtype=np.float64, device=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    if "--cpu" in argv:
        argv.remove("--cpu")
        device = "cpu"
    dev = resolve_device(device)
    if len(argv) < 4:
        print("Usage: planarity_opt IN_MESH REF_MESH OPTIONS OUT_MESH [--cpu]")
        return 1
    in_path, ref_path, opt_path, out_path = argv[:4]

    verts, faces = load_obj_poly(in_path)
    mesh = PolyMesh(verts=verts, faces=faces)
    ref = load_obj(ref_path)
    params = Parameters.load(opt_path)
    if not params.valid():
        print("Invalid options")
        return 1
    print(params.output())

    print("Before optimization:")
    pl_before, _ = check_planarity_error(mesh)
    check_ref_surface_distance(mesh.verts, mesh, ref.verts, ref.faces,
                               device=dev)

    solver = optimize_mesh(mesh, ref.verts, ref.faces, params.iterations,
                           params.anderson_m, dtype=dtype, device=dev)
    out = solver.get_solution()

    print("After optimization:")
    pl_after, _ = check_planarity_error(mesh, out)
    check_ref_surface_distance(out, mesh, ref.verts, ref.faces, device=dev)

    os.makedirs("result", exist_ok=True)
    np.savetxt("result/planarityErrBefore.txt", pl_before, fmt="%.16g")
    np.savetxt("result/planatityErrAfter.txt", pl_after, fmt="%.16g")
    solver.save(params.anderson_m)
    save_obj(out_path, out, mesh.faces)
    return 0


if __name__ == "__main__":
    sys.exit(main())
