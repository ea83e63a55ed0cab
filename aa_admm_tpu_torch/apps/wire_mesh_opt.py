"""WireMeshOpt — wire-mesh optimization (counterpart of
aa_admm_tpu/apps/wire_mesh_opt.py; Geometry/WireMeshOpt.cpp:38-444).

Usage: python -m aa_admm_tpu_torch.apps.wire_mesh_opt IN_POLY_MESH
REF_TRI_MESH OPTIONS_FILE OUT_MESH [--cpu]

Pipeline (main, :340-407): subdivide + smooth the input quad mesh, halve the
target edge length; per-face-corner AngleConstraint hard (angles in
[pi/4, 3pi/4]), per-edge EdgeLengthConstraint hard, one batched
ReferenceSurfceConstraint soft (weight 1); penalty 1000; optional quad
Laplacian (disabled by default). Runs on the CUDA card unless device="cpu".
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .. import resolve_device
from ..core.config import Parameters
from ..core.meshio import load_obj, load_obj_poly, save_obj
from ..core.polymesh import PolyMesh, subdivide_and_smooth
from ..ops.closest_point import closest_point_on_mesh
from ..ops.constraints import AngleBatch, EdgeLengthBatch, RefSurfaceBatch
from ..solver.geometry import ALMGeometrySolver

# f32 caps the warm-started CG at a small budget per ALM trial: the
# safeguarded loop absorbs the inexact solve (the JAX app's default).
F32_CG_ITERS = 15


def check_wiremesh_error(mesh: PolyMesh, verts, target_edge_length,
                         min_angle_radian, max_angle_radian):
    """Edge-length + angle error (WireMeshOpt.cpp:102-155). Returns
    (edge_err_per_corner (4F,), angle_err_deg (4F,), angle_error_deg (4F,))."""
    faces = np.asarray(mesh.faces)  # regular quad mesh
    p = verts[faces]  # (F, 4, 3)
    F = len(faces)
    angle_exceed = np.zeros((F, 4))
    angle_error = np.zeros((F, 4))
    for i in range(4):
        e1 = p[:, (i + 1) % 4] - p[:, i]
        e2 = p[:, (i + 3) % 4] - p[:, i]
        e1 = e1 / np.linalg.norm(e1, axis=-1, keepdims=True)
        e2 = e2 / np.linalg.norm(e2, axis=-1, keepdims=True)
        ang = np.arccos(np.clip(np.sum(e1 * e2, -1), -1, 1))
        angle_error[:, i] = np.abs(ang - 0.5 * np.pi)
        angle_exceed[:, i] = np.where(
            ang < min_angle_radian, min_angle_radian - ang,
            np.where(ang >= max_angle_radian, ang - max_angle_radian, 0.0))
    # Per-edge normalized length error, reported per face corner.
    edges = np.asarray(sorted(mesh.edge_faces), np.int64)
    lens = np.linalg.norm(verts[edges[:, 0]] - verts[edges[:, 1]], axis=1)
    all_edge = np.abs(lens - target_edge_length) / target_edge_length
    a, b = faces, np.roll(faces, -1, axis=1)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    key = edges[:, 0] * len(verts) + edges[:, 1]
    pos = np.searchsorted(key, lo * len(verts) + hi)
    edge_err_out = all_edge[pos]
    angle_deg = angle_exceed * 180.0 / np.pi
    print(f"Normalized edge length error: max {all_edge.max()},  "
          f"average {all_edge.mean()}")
    print(f"Angle error: max {angle_deg.max()},  average {angle_deg.mean()}")
    return (edge_err_out.ravel(), angle_deg.ravel(),
            (angle_error * 180.0 / np.pi).ravel())


def check_ref_surface_distance(verts, mesh: PolyMesh, ref_verts, ref_faces,
                               device=None):
    """Distance of every vertex to the reference surface (brute force on
    `device`), normalized by the mesh's average edge length."""
    dev = resolve_device(device)
    tri = np.asarray(ref_verts)[np.asarray(ref_faces)]
    q = closest_point_on_mesh(torch.from_numpy(np.asarray(verts, np.float64)).to(dev),
                              torch.from_numpy(tri).to(dev)).cpu().numpy()
    el = PolyMesh(verts=verts, faces=mesh.faces).average_edge_length()
    dist = np.linalg.norm(verts - q, axis=1) / el
    print(f"Reference surface distance (normalized by edge length): "
          f"Max {dist.max()}, Average {dist.mean()}")
    return dist


def setup_quad_laplacian(mesh: PolyMesh, laplacian_weight, solver):
    """setup_quad_laplacian_matrix (WireMeshOpt.cpp:185-230): coefs (2,-1,-1)
    over opposite ring pairs at valence-4, boundary rows along boundary."""
    coefs = [2.0, -1.0, -1.0]
    for v in range(mesh.n_verts()):
        ring = mesh.vertex_ring(v)
        m = len(ring)
        if m > 4:
            print("Invalid valence")
            return False
        if m == 4:
            solver.add_laplacian([v, ring[0], ring[2]], coefs, laplacian_weight)
            solver.add_laplacian([v, ring[1], ring[3]], coefs, laplacian_weight)
        elif m == 3:
            if not mesh.is_boundary_vertex(v):
                print("Not a regular quad mesh")
                return False
            nbrs, _ = mesh.boundary_neighbors(v)
            solver.add_laplacian([v] + nbrs, coefs, laplacian_weight)
    return True


def optimize_mesh(mesh: PolyMesh, ref_verts, ref_faces, max_iter, anderson_m,
                  penalty_parameter=1000.0, min_angle_radian=np.pi * 0.25,
                  max_angle_radian=np.pi * 0.75, edge_length=1.0,
                  closeness_weight=1.0, laplacian_weight=-1.0,
                  dtype=np.float64, result_dir="result", chunk_iters=None,
                  device=None, dense_threshold=None, device_mesh=None):
    """WireMeshOpt.cpp optimize_mesh (:232-337). At f32 the warm-started CG
    is capped at F32_CG_ITERS iterations per ALM trial; f64 keeps the tight
    solve. dense_threshold: set on the solver when given (the dense
    inverse up to that many vertices, else CG). device_mesh
    (parallel.geometry.make_vert_mesh): solve sharded over its ranks, each
    of which calls this; the first rank writes the residual file."""
    p = mesh.verts
    solver = ALMGeometrySolver(device=device)
    if dense_threshold is not None:
        solver.dense_threshold = dense_threshold
    solver.dtype = np.dtype(dtype)

    if closeness_weight > 0:
        solver.add_soft_constraint(RefSurfaceBatch.create(
            list(range(mesh.n_verts())), closeness_weight, ref_verts,
            ref_faces, dtype=dtype))

    faces = np.asarray(mesh.faces)
    corners = np.concatenate(
        [np.stack([faces[:, i], faces[:, (i + 1) % 4], faces[:, (i + 3) % 4]],
                  axis=1) for i in range(4)], axis=0)
    solver.add_hard_constraint(AngleBatch.create(
        corners, 1.0, min_angle_radian, max_angle_radian, dtype=dtype))

    edges = np.asarray(sorted(mesh.edge_faces), np.int64)
    solver.add_hard_constraint(EdgeLengthBatch.create(
        edges, 1.0, edge_length, dtype=dtype))

    if laplacian_weight > 0:
        if not setup_quad_laplacian(mesh, laplacian_weight, solver):
            return None

    eps_ratio = 1e-8
    rel_residual_eps = eps_ratio * mesh.average_edge_length()
    print(f"Relative residual eps (normalized by edge length): {eps_ratio}")

    if solver.setup_ADMM(mesh.n_verts(), penalty_parameter):
        if device_mesh is not None:
            solver.shard(device_mesh)
        cg_max_iters = F32_CG_ITERS if np.dtype(dtype) == np.float32 else None
        solver.solve_ADMM(p, rel_residual_eps, max_iter, anderson_m,
                          cg_max_iters=cg_max_iters, chunk_iters=chunk_iters)
        if solver.system.shard is None or solver.system.shard.lo == 0:
            solver.save(anderson_m, result_dir)
    return solver


def main(argv=None, dtype=np.float64, return_solver=False, chunk_iters=None,
         device=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    if "--cpu" in argv:
        argv.remove("--cpu")
        device = "cpu"
    dev = resolve_device(device)
    if len(argv) < 4:
        print("Usage: wire_mesh_opt IN_POLY REF_TRI OPTIONS OUT_MESH [--cpu]")
        return 1
    in_path, ref_path, opt_path, out_path = argv[:4]

    verts, faces = load_obj_poly(in_path)
    mesh = PolyMesh(verts=verts, faces=faces)
    ref = load_obj(ref_path)
    params = Parameters.load(opt_path)
    if not params.valid():
        print("Invalid filter options. Aborting...")
        return 1
    print(params.output())

    edge_length = mesh.average_edge_length()
    min_a, max_a = np.pi * 0.25, np.pi * 0.75
    sub_mesh = subdivide_and_smooth(mesh)
    edge_length *= 0.5
    print(f"target length = {edge_length}")

    solver = optimize_mesh(sub_mesh, ref.verts, ref.faces, params.iterations,
                           params.anderson_m, edge_length=edge_length,
                           min_angle_radian=min_a, max_angle_radian=max_a,
                           dtype=dtype, chunk_iters=chunk_iters, device=dev)
    if solver is None:
        return 1
    out = solver.get_solution()

    print("Before optimization:")
    e_b, a_b, _ = check_wiremesh_error(sub_mesh, sub_mesh.verts, edge_length,
                                       min_a, max_a)
    r_b = check_ref_surface_distance(sub_mesh.verts, sub_mesh,
                                     ref.verts, ref.faces, device=dev)
    print("After optimization:")
    e_a, a_a, _ = check_wiremesh_error(sub_mesh, out, edge_length, min_a, max_a)
    r_a = check_ref_surface_distance(out, sub_mesh, ref.verts, ref.faces,
                                     device=dev)

    os.makedirs("result", exist_ok=True)
    np.savetxt("result/edge_wiremeshErrBefore.txt", e_b, fmt="%.16g")
    np.savetxt("result/edge_wiremeshErrAfter.txt", e_a, fmt="%.16g")
    np.savetxt("result/angle_wiremeshErrBefore.txt", a_b, fmt="%.16g")
    np.savetxt("result/angle_wiremeshErrAfter.txt", a_a, fmt="%.16g")
    np.savetxt("result/ref_wiremeshErrBefore.txt", r_b, fmt="%.16g")
    np.savetxt("result/ref_wiremeshErrAfter.txt", r_a, fmt="%.16g")
    save_obj(out_path, out, sub_mesh.faces)
    if return_solver:
        solver.after_metrics = {
            "edge_err_max": float(np.max(e_a)),
            "edge_err_avg": float(np.mean(e_a)),
            "angle_err_max": float(np.max(a_a)),
            "angle_err_avg": float(np.mean(a_a)),
            "ref_dist_max": float(np.max(r_a)),
        }
        return solver
    return 0


if __name__ == "__main__":
    sys.exit(main())
