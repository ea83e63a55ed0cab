"""Vertex-row and constraint-element sharding of the geometry (ALM) solve
(counterpart of aa_admm_tpu/parallel/geometry.py), as explicit SPMD over
``torch.distributed``.

Every rank of a one-axis ``("elem",)`` mesh holds one contiguous, possibly
ragged, range of

* the vertex rows: the ELL operator's rows, the CG vectors, the two-level
  preconditioner's ``agg`` and ``inv_diag``, ``precond_diag``,
  ``rhs_fixed``, ``x0``, ``Ax0`` and the regularization rows;
* the elements of every hard and soft constraint batch (the fields its
  class names in ``ELEM_FIELDS``), so of the z, u and Dx blocks;

with each gather-form table rebuilt for its cut. The coarse inverse
``Ac_inv``, the dense inverse of the small-mesh path, the reference
triangles and their groups are whole on every rank. The traffic between the
ranks is then, as in the JAX package:

* the CG dot products and residual norms: sums (one for pAp and one for the
  stacked {rz, rr} per CG iteration, ``solver/linear.py``), plus the coarse
  restriction's partials (``solver/multigrid.py``);
* the gathers of neighbour vertices: the full vector assembled by a sum of
  zero-filled buffers that hold each rank's rows (exact: the other ranks
  add zeros; gloo takes only ``all_reduce`` and ``broadcast`` on CUDA
  tensors, and an ``all_gather`` or a halo table would move less), once
  per CG matvec and twice per trial;
* the x-update's scatter, the residual, the AA inner products (then the
  replicated m x m solve), the soft energies and the closest-point cache's
  refresh test: sums, so every rank takes the same branch.

On CUDA the CG's vector half runs in B2 and B3 through their given entries
(``cg_update1_given``, ``cg_update2_given``, with ``cg_dot``'s partials).
The JAX package's BSR operator is not ported; the sharded solve runs the ELL
CG path (or the replicated dense inverse below 12,000 vertices).

The ranks are placed by ``ensemble.rank_placement``: one card each under
NCCL, whose sums run on the cards, when there are no more ranks than
cards; else gloo, the ranks sharing the cards (every sum through the
host). On CUDA the tensors stay on the rank's card either way.

``dryrun_geometry(world)`` runs the JAX dryrun's scene sharded against
unsharded on spawned ranks (``ensemble.run_ranks``); ``wire_mesh_case`` is
one rank of a sharded ``optimize_mesh``, on spawned ranks or, across hosts,
on ranks that torchrun starts (``parallel/multihost.py``), which read their
scene from the file ``save_scene`` writes.
"""

from __future__ import annotations

import dataclasses
import shutil
import tempfile
import time

import numpy as np

from .. import resolve_device
from ..ops.constraints import AngleBatch, ClosenessBatch, EdgeLengthBatch
from ..solver.geometry import ALMGeometrySolver, GeometrySystem, RowShard
from .ensemble import (ElemComm, _split, check_placement, mesh_device_type,
                       rank_info, run_ranks)


def make_vert_mesh(world: int):
    """A one-axis ("elem",) DeviceMesh over the `world` ranks of the
    initialized process group (JAX geometry.py:28-35): rows and elements
    share the axis."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(mesh_device_type(), (world,),
                            mesh_dim_names=("elem",))


def _elem_fields(b):
    fields = getattr(type(b), "ELEM_FIELDS", None)
    if fields is None:
        raise TypeError(f"{type(b).__name__} declares no ELEM_FIELDS: its "
                        f"per-constraint fields are unknown")
    return fields


def _cut(b, lo, hi):
    """Batch b cut to its elements [lo, hi), its gather table rebuilt."""
    return dataclasses.replace(
        b, inv_idx=None, inv_mask=None,
        **{k: getattr(b, k)[lo:hi] for k in _elem_fields(b)})


def shard_geometry_system(system: GeometrySystem, mesh) -> GeometrySystem:
    """This rank's part of an unsharded GeometrySystem on the mesh's 'elem'
    axis (JAX geometry.py:47-129): its rows [lo, hi) of every vertex-row
    array and its range of every constraint batch (and of per-solve
    anchors already set), an ElemComm over the axis's group, and the rest
    whole. A one-rank mesh returns the system."""
    if system.shard is not None:
        raise ValueError("the system is sharded already")
    P = mesh["elem"].size()
    if P == 1:
        return system
    r = mesh["elem"].get_local_rank()
    lo, hi = _split(system.n_verts, P, r)

    def rows(t):
        return None if t is None else t[lo:hi]

    def batches(bs, t0s):
        cut, t0_cut = [], []
        for i, b in enumerate(bs):
            e0, e1 = _split(b.w.shape[0], P, r)
            cut.append(_cut(b, e0, e1))
            if t0s:
                t0_cut.append(t0s[i][e0:e1])
        return tuple(cut), tuple(t0_cut)

    hard, t0_hard = batches(system.hard, system.t0_hard)
    soft, t0_soft = batches(system.soft, system.t0_soft)
    kw = dict(hard=hard, soft=soft, t0_hard=t0_hard, t0_soft=t0_soft,
              precond_diag=rows(system.precond_diag),
              rhs_fixed=rows(system.rhs_fixed), x0=rows(system.x0),
              Ax0=rows(system.Ax0),
              shard=RowShard(lo, hi, ElemComm(mesh.get_group("elem"),
                                              system.rhs_fixed.device)))
    if system.ell is not None:
        kw["ell"] = dataclasses.replace(system.ell, idx=rows(system.ell.idx),
                                        coef=rows(system.ell.coef))
    if system.mg is not None:
        kw["mg"] = dataclasses.replace(
            system.mg, agg=rows(system.mg.agg),
            inv_diag=rows(system.mg.inv_diag), inv_idx=None, inv_mask=None)
    if system.reg is not None:
        g0, g1 = _split(system.reg.idx.shape[0], P, r)
        reg = system.reg
        kw["reg"] = dataclasses.replace(
            reg, idx=reg.idx[g0:g1], coef=reg.coef[g0:g1],
            mask=reg.mask[g0:g1], target=reg.target[g0:g1], inv_idx=None,
            inv_mask=None)
    return dataclasses.replace(system, **kw)


# ---------------------------------------------------------------------------
# Dryrun
# ---------------------------------------------------------------------------

def _dryrun_scene(device):
    """The JAX dryrun's scene (geometry.py:149-176): a 15 x 15 noisy grid
    with EdgeLength and Angle hard, Closeness soft, on the CG path."""
    rng = np.random.default_rng(3)
    nx = ny = 15
    xs, ys = np.meshgrid(np.arange(nx + 1), np.arange(ny + 1),
                         indexing="ij")
    verts = np.stack([xs.ravel(), ys.ravel(),
                      0.15 * rng.standard_normal(xs.size)],
                     axis=1).astype(np.float64)
    n = len(verts)
    edges = []
    for i in range(nx + 1):
        for j in range(ny + 1):
            v = i * (ny + 1) + j
            if i < nx:
                edges.append((v, v + ny + 1))
            if j < ny:
                edges.append((v, v + 1))
    edges = np.asarray(edges, np.int64)
    solver = ALMGeometrySolver(device=device)
    solver.add_hard_constraint(EdgeLengthBatch.create(edges, 1.0, 0.9))
    tips = edges[: n // 2, 0]
    tri = np.stack([tips, (tips + 1) % n, (tips + 2) % n], axis=1)
    solver.add_hard_constraint(AngleBatch.create(
        tri, 1.0, np.pi / 4, 3 * np.pi / 4))
    solver.add_soft_constraint(ClosenessBatch.create(np.arange(n), 1.0,
                                                     verts))
    solver.setup_ADMM(n, penalty_param=100.0, linear_solver="cg")
    return solver, verts


def _dryrun_solve(solver, verts):
    solver.solve_ADMM(verts, rel_residual_eps=1e-14, max_iter=10,
                      anderson_m=5, cg_tol=1e-13)
    return (np.asarray(solver.get_solution()),
            np.asarray(solver.function_values))


def _dryrun_rank(rank, world, device):
    """One rank of dryrun_geometry: the scene unsharded, then sharded; the
    parity, the sharded solve's counts and the rank's rank_info."""
    solver1, verts = _dryrun_scene(device)
    x1, fv1 = _dryrun_solve(solver1, verts)
    solver_n, _ = _dryrun_scene(device)
    solver_n.shard(make_vert_mesh(world))
    xn, fvn = _dryrun_solve(solver_n, verts)
    if fvn.shape != fv1.shape or \
            solver_n.anderson_reset != solver1.anderson_reset:
        raise RuntimeError(f"rank {rank}: the sharded solve took another "
                           f"path (iterations {fvn.shape} against "
                           f"{fv1.shape}, rejects {solver_n.anderson_reset} "
                           f"against {solver1.anderson_reset})")
    st = solver_n.stats
    return {"max_dx": float(np.max(np.abs(xn - x1))),
            "max_dfv_rel": float(np.max(np.abs(fvn / fv1 - 1.0))),
            "collectives": st["collectives"], "trials": st["trials"],
            "cg_iters": st["cg_iters"], **rank_info(device)}


def _geometry_summary(per_rank, world: int) -> dict:
    """The ranks' dryrun results reduced: raises beyond max|dx| 1e-9 or
    max|dfv/fv| 1e-8; prints the JAX dryrun's line."""
    dx = max(r["max_dx"] for r in per_rank)
    dfv = max(r["max_dfv_rel"] for r in per_rank)
    if not (dx < 1e-9 and dfv < 1e-8):
        raise RuntimeError(f"geometry sharded-vs-unsharded parity FAILED: "
                           f"max|dx|={dx:.3e} max|dfv/fv|={dfv:.3e}")
    coll = per_rank[0]["collectives"]
    print(f"dryrun[geometry]: sharded-vs-unsharded max|dx|={dx:.3e} "
          f"max|dfv/fv|={dfv:.3e} (ELL CG path, {world}-rank group); "
          f"collectives in the solve={coll} over "
          f"{per_rank[0]['trials']} trials", flush=True)
    return {"max_dx": dx, "max_dfv_rel": dfv, "collectives": coll}


def dryrun_geometry(world: int, device=None, n_cards=None,
                    timeout: float = 600.0) -> dict:
    """The JAX geometry dryrun (geometry.py:132-231) on `world` spawned
    ranks: its 15 x 15 scene solved sharded over the ranks against the same
    solve unsharded, on the ELL CG path, float64. The ranks run on the
    cards by ensemble.rank_placement (n_cards as there) unless `device`
    says otherwise. Raises beyond max|dx| 1e-9 or max|dfv/fv| 1e-8, or
    when a rank fails, times out or is not where the rule puts it; prints
    the JAX dryrun's line and returns {max_dx, max_dfv_rel, collectives}
    (collectives: the sharded solve's, per rank)."""
    dev_type = resolve_device(device).type
    per_rank = run_ranks(world, _dryrun_rank, device=dev_type,
                         n_cards=n_cards, timeout=timeout)
    check_placement(per_rank, world, dev_type, n_cards)
    return _geometry_summary(per_rank, world)


# ---------------------------------------------------------------------------
# One rank of a sharded wire-mesh solve
# ---------------------------------------------------------------------------

def save_scene(path: str, scene: dict):
    """wire_mesh_case's `scene` as an .npz, for ranks that are not the
    caller's children (the launch across hosts): faces flattened beside
    their sizes."""
    faces = [list(f) for f in scene["faces"]]
    np.savez(path, verts=np.asarray(scene["verts"]),
             face_sizes=np.asarray([len(f) for f in faces], np.int64),
             face_idx=np.asarray([v for f in faces for v in f], np.int64),
             ref_v=np.asarray(scene["ref_v"]),
             ref_f=np.asarray(scene["ref_f"]),
             edge_length=np.float64(scene["edge_length"]))


def load_scene(path: str) -> dict:
    """The scene save_scene wrote, as wire_mesh_case takes it."""
    with np.load(path) as z:
        cuts = np.cumsum(z["face_sizes"])[:-1]
        faces = [f.tolist() for f in np.split(z["face_idx"], cuts)]
        return dict(verts=z["verts"], faces=faces, ref_v=z["ref_v"],
                    ref_f=z["ref_f"], edge_length=float(z["edge_length"]))


def wire_mesh_case(rank, world, device, scene: dict, opts: dict):
    """One rank of ``optimize_mesh`` sharded over `world` ranks (run through
    run_ranks, which hands the rank its device). scene: verts, faces
    (lists), ref_v, ref_f, edge_length; opts: max_iter, anderson_m, dtype,
    dense_threshold (optimize_mesh's), repeat_iters (default 0: after the
    solve, that many accepted iterations again from the start, timed and
    then under torch.profiler; see _repeat_trials). Returns the rank's
    function values, rejects, gathered solution, stats (collectives and
    bytes included), kernel launch counts, solve seconds, rank_info and
    the repeat's figures."""
    from ..apps.wire_mesh_opt import optimize_mesh
    from ..core.polymesh import PolyMesh
    from ..ops import cuda_kernels as ck
    mesh = make_vert_mesh(world)
    result_dir = tempfile.mkdtemp(prefix="aaadmm_wire_")
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    solver = optimize_mesh(
        PolyMesh(verts=np.asarray(scene["verts"]), faces=scene["faces"]),
        scene["ref_v"], scene["ref_f"], max_iter=opts["max_iter"],
        anderson_m=opts.get("anderson_m", 5),
        edge_length=scene["edge_length"], dtype=opts.get("dtype", np.float64),
        result_dir=result_dir, device=device,
        dense_threshold=opts.get("dense_threshold"),
        device_mesh=mesh)
    launches = ck.launch_counts()
    wall = time.perf_counter() - t0
    shutil.rmtree(result_dir, ignore_errors=True)
    sh = solver.system.shard
    out = dict(rank=rank, rows=None if sh is None else (sh.lo, sh.hi),
               fv=np.asarray(solver.function_values),
               rejects=list(solver.anderson_reset),
               x=solver.get_solution(), stats=dict(solver.stats),
               launches=launches, setup_s=solver.setup_s, wall_s=wall,
               **rank_info(device))
    if opts.get("repeat_iters"):
        out["repeat"] = _repeat_trials(solver.system, opts["repeat_iters"])
    return out


def _repeat_trials(system, n_iter: int) -> dict:
    """The first `n_iter` accepted iterations of a solved system's loop
    again from its start, twice: timed (the kernels built, the collectives'
    connections made), then under torch.profiler. Returns the trials, the
    ms of the timed run and of the profiled one, and the profiled run's
    device ms of every kernel and of the nccl kernels (whose time includes
    their wait for the other ranks)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ..solver.geometry import _alm_init_state, solve_alm_chunk
    dev = system.rhs_fixed.device

    def run():
        state = _alm_init_state(system, system.x0)
        state["limit"] = min(n_iter, system.max_iter)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state = solve_alm_chunk(system, state)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return state["trial"], (time.perf_counter() - t0) * 1e3
    trials, ms = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, prof_ms = run()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")]
    nccl = [e for e in events if "nccl" in e.key.lower()]
    return dict(trials=trials, ms=ms, profiled_ms=prof_ms,
                device_ms=sum(dev_us(e) for e in events) / 1e3,
                nccl_ms=sum(dev_us(e) for e in nccl) / 1e3,
                nccl_kernels=sum(e.count for e in nccl))
