"""Scene ensembles on one card and element-axis sharding of the physics step
(counterpart of aa_admm_tpu/parallel/ensemble.py).

Two axes, as in the JAX package:

* ``dp``: an ensemble of independent scenes (one topology, each with its
  own state) stepped together. The JAX package vmaps its step. The port's
  step reads the host (the AA Gram matrices, the CG loop tests, the reject
  tests), which ``torch.func.vmap`` cannot carry, so ``tile_system`` makes
  one system of S copies of the scene instead: each element batch tiled S
  times with its vertex indices offset by s * n. Every deform, prox and
  scatter launch then covers S * E elements, and the system's
  ``n_scenes`` makes the residuals, the reject tests, the eps-break and the
  AA windows per scene (solver/physics.py), so each scene rejects, resets
  and breaks on its own, as one lane of the vmap does. ``ensemble_step``
  and ``ensemble_run_frames`` are the counterparts of ``jax.vmap(step)``
  and of the bench's vmapped ``run_frames`` (bench.py:128-170).
* ``elem``: each element batch split into contiguous, possibly ragged,
  ranges over the ranks of the mesh's element axis (``shard_system``). The
  vertex scatter (the right-hand side and every CG matvec), the squared
  norms and the AA inner-product partials are summed over that group by
  ``torch.distributed.all_reduce``; the m x m solve and the x-solve are
  replicated, so every branch reads a value all ranks share. Under ``dp``
  each group of the dp axis steps its own S / dp scenes (shard, then tile)
  with no communication between groups.

The JAX package pins the element arrays with in-loop sharding constraints
and checks the lowered module for them. Here the collectives are explicit
calls, and the system's ``ElemComm`` counts them.

The ranks of one process group start by one of two routes. On one host
``run_ranks`` spawns them (over a FileStore in a temporary directory, no
TCP port, one torch thread each) with a timeout. Across hosts each rank is
started by ``torchrun`` and reads its place from torchrun's ``env://``
variables (``parallel/multihost.py``: the JAX package's
``jax.distributed`` launch, with the dp axis spanning the hosts). Which
backend joins them is ``card_backend``'s rule either way: NCCL where every
rank holds a card of its own, whose sums run on the cards (the JAX
package's meshes span chips alike); gloo where ranks share a card (NCCL
takes one rank per card) and on the CPU. On one host ``rank_placement``
puts rank r on card r, round-robin when there are more ranks than cards.
``dryrun(world)`` runs both orders sharded on it, with the float64 parity
of the sharded and unsharded steps, and the sharded geometry solve's
parity (``parallel/geometry.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..core.config import AccelType, Lame, Settings
from ..core.factory import make_tet_blocks
from ..core.timers import span, spanned
from ..solver.physics import (PhysicsSolver, PhysicsSystem, StepTrace,
                              UpdateOrder, _counts, step_xzu, step_zxu)

_TABLES = ("inv_idx", "inv_mask")


def _step_fn(order):
    return step_xzu if order == "xzu" else step_zxu


def _elem_fields(b):
    """Names of an element batch's tensor fields with one row per element
    (its weights' length); the gather-form tables are rebuilt, not cut."""
    E = b.w.shape[0]
    return [f.name for f in dataclasses.fields(b) if f.name not in _TABLES
            and isinstance(getattr(b, f.name), torch.Tensor)
            and getattr(b, f.name).dim() >= 1
            and getattr(b, f.name).shape[0] == E]


def _is_index(t):
    return not t.is_floating_point() and t.dtype != torch.bool


def _tiled(t, S, n):
    """S copies of t along its first axis; vertex indices offset by s * n."""
    if _is_index(t):
        return torch.cat([t + s * n for s in range(S)])
    return torch.cat([t] * S)


def tile_system(system: PhysicsSystem, S: int) -> PhysicsSystem:
    """One system of S copies of `system`'s scene: vertex rows s*n ...
    (s+1)*n - 1 and element columns s*E ... (s+1)*E - 1 are scene s. The
    global step's inverse (or CG diagonal) is shared, as the scenes solve
    as the columns of one block. Cached per (system, S), so its CUDA graphs
    are captured once; the first build for an S runs inside the span
    ``setup.build``. A sharded system tiles its own element ranges."""
    if S == 1:
        return system
    if system.n_scenes != 1:
        raise ValueError("tile_system takes a system of one scene")
    cache = system.__dict__.setdefault("_tiled", {})
    if S not in cache:
        with span("setup.build"):
            n = system.n_verts

            def tile_batch(b):
                return dataclasses.replace(
                    b, inv_idx=None, inv_mask=None,
                    **{k: _tiled(getattr(b, k), S, n)
                       for k in _elem_fields(b)})
            wind = system.wind
            if wind is not None:
                wind = dataclasses.replace(
                    wind, faces=_tiled(wind.faces, S, n), inv_idx=None,
                    inv_mask=None)
            cache[S] = dataclasses.replace(
                system, masses=system.masses.repeat(S),
                free_mask=system.free_mask.repeat(S),
                free_idx=_tiled(system.free_idx, S, n),
                batches=tuple(tile_batch(b) for b in system.batches),
                wind=wind, n_verts=S * n, n_free=S * system.n_free,
                n_scenes=S)
    return cache[S]


def _scene_major(tr: StepTrace, S: int) -> StepTrace:
    """A tiled step's StepTrace (iterations first) with the scene axis
    first; a one-scene trace gains the axis."""
    if S == 1:
        return StepTrace(*(a[None] for a in tr))
    return StepTrace(*(a.T if a.dim() == 2 else a for a in tr))


def ensemble_step(order: str = "xzu"):
    """The `order` step over a leading scene axis, as jax.vmap(step) (JAX
    ensemble.py:89-95): ``(system, xs, vs, pps[, counts]) -> (xs, vs,
    StepTrace)`` with xs, vs, pps (S, n, 3) and every StepTrace field led
    by S. The scenes step as one tiled system. `counts` (a dict with
    host_reads and cg_iters) accumulates the batched step's counts. Each
    call runs inside the span ``ensemble.step``."""
    fn = _step_fn(order)

    @spanned("ensemble.step")
    def step(system: PhysicsSystem, xs, vs, pps, counts=None):
        if system.order != order:
            raise ValueError(f"a {system.order} system in a {order} step")
        S, n = xs.shape[:2]
        tiled = tile_system(system, S)
        x, v, tr = fn(tiled, xs.reshape(S * n, 3), vs.reshape(S * n, 3),
                      pps.reshape(S * n, 3), counts)
        return x.reshape(S, n, 3), v.reshape(S, n, 3), _scene_major(tr, S)
    return step


def ensemble_run_frames(system: PhysicsSystem, xs, vs, pps, n_frames: int,
                        pin_vel=None, counts=None):
    """n_frames ensemble steps, as the bench's vmapped ``run_frames``
    (bench.py:153-154): pin_vel ((n, 3), or (S, n, 3)) moves the pins by
    dt * pin_vel before each step. Returns (xs, vs, final pps, traces), each
    trace field (S, n_frames, ...)."""
    step = ensemble_step(system.order)
    traces = []
    for _ in range(n_frames):
        if pin_vel is not None:
            pps = pps + system.dt * pin_vel
        xs, vs, tr = step(system, xs, vs, pps, counts)
        traces.append(tr)
    return xs, vs, pps, StepTrace(*(torch.stack([getattr(t, f) for t in
                                                 traces], 1)
                                    for f in StepTrace._fields))


def build_tiny_scene(order: str = "xzu", dtype="float32", admm_iters: int = 3,
                     anderson_m: int = 3, device=None):
    """The 40-tet beam of the dryruns and sharding tests (JAX
    ensemble.py:98-130). The zxu variant adds per-vertex collision terms
    against a floor and a cylinder, so the collision prox is covered; the
    xzu variant pins the -x end. Returns (solver, settings)."""
    mesh = make_tet_blocks(8, 1, 1)
    lo, hi = mesh.bounds()
    mesh.verts = (mesh.verts - 0.5 * (lo + hi)) / (hi - lo)[1]

    s = Settings()
    s.admm_iters = admm_iters
    s.verbose = 0
    s.acceleration_type = AccelType.ANDERSON
    s.anderson_m = anderson_m
    s.dtype = np.dtype(dtype)
    solver = PhysicsSolver(order=UpdateOrder(order), device=device)
    solver.add_tetmesh(mesh.verts, mesh.tets,
                       Lame.from_young_poisson(1e6, 0.35))
    if order == "zxu":
        solver.add_obstacle("floor", y=float(mesh.verts[:, 1].min() - 0.02))
        solver.add_obstacle("cylinder", center=(0.0, -0.5, 0.0), rad=0.2)
        solver.set_collisions(list(range(len(mesh.verts))))
    else:
        min_x = mesh.verts[:, 0].min() + 1e-3
        solver.set_pins([i for i, v in enumerate(mesh.verts)
                         if v[0] < min_x])
    solver.initialize(s)
    return solver, s


def tiny_states(solver: PhysicsSolver, S: int, spread: float = 0.1,
                scenes: slice = slice(None)):
    """(xs, vs, pps) of S replicas of the solver's state, (S, n, 3) on its
    device: replica s starts with y-velocity -spread * s / (S - 1) (JAX
    ensemble.py:159-161). `scenes` (a slice of range(S)) builds only those
    replicas, with the same bits, as a rank builds only its own."""
    x = solver._x_dev
    vy = torch.linspace(0.0, -spread, S, dtype=x.dtype,
                        device=x.device)[scenes]
    k = vy.shape[0]
    xs = x.expand(k, *x.shape).clone()
    vs = solver._v_dev.expand(k, *x.shape).clone()
    vs[:, :, 1] = vy[:, None]
    pps = solver._pin_pos_dev().expand(k, *x.shape).clone()
    return xs, vs, pps


# ---------------------------------------------------------------------------
# Element-axis sharding
# ---------------------------------------------------------------------------

def card_backend(cards) -> str:
    """The backend of a group whose rank r holds cards[r]: a card's identity
    (its index on one host, its UUID across hosts), None for the CPU. NCCL
    where every rank holds a card no other rank holds (NCCL takes one rank
    per card), else gloo."""
    cards = list(cards)
    if all(c is not None for c in cards) and len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"


def rank_placement(world: int, device_type: str = "cuda", n_cards=None):
    """(backend, [device of each rank]) of `world` ranks on one host: on the
    CPU every rank on the CPU; on CUDA rank r on cuda:(r % n_cards) (ranks
    beyond the cards share them); the backend card_backend's (NCCL when
    world <= n_cards, else gloo). n_cards defaults to the cards this
    process sees."""
    if device_type == "cpu":
        return "gloo", [torch.device("cpu")] * world
    if device_type != "cuda":
        raise ValueError(f"no rank placement for device type {device_type!r}")
    if n_cards is None:
        n_cards = torch.cuda.device_count()
    if n_cards < 1:
        raise ValueError("rank_placement: CUDA ranks need at least one card")
    devices = [torch.device("cuda", r % n_cards) for r in range(world)]
    return card_backend(d.index for d in devices), devices


def mesh_device_type() -> str:
    """The DeviceMesh device type of the initialized process group: "cuda"
    under NCCL, "cpu" under gloo (whose CUDA ranks share the cards)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(world: int, prefer_dp: int = 2):
    """A (dp, elem) DeviceMesh over the `world` ranks of the initialized
    process group (JAX ensemble.py:29-38): dp = prefer_dp when it divides
    world (and world > 1), else 1."""
    from torch.distributed.device_mesh import init_device_mesh
    dp = prefer_dp if world % prefer_dp == 0 and world > 1 else 1
    return init_device_mesh(mesh_device_type(), (dp, world // dp),
                            mesh_dim_names=("dp", "elem"))


class ElemComm:
    """Sums over the element group of a sharded system whose tensors live on
    `device` (the rank's); a tensor on another device raises. ``count`` is
    the number of collectives issued, ``nbytes`` the bytes they summed (each
    tensor's size once), ``seconds`` the host's wall time inside the calls:
    under gloo the whole sum (for CUDA tensors gloo first waits for the
    device to produce them), under NCCL only the enqueue, the sum running
    on the card after it (read its device time from torch.profiler's
    ``nccl`` kernels)."""

    def __init__(self, group, device):
        self.group, self.device = group, torch.device(device)
        self.count, self.nbytes, self.seconds = 0, 0, 0.0

    def all_reduce(self, t):
        if t.device != self.device:
            raise RuntimeError(f"ElemComm: a {tuple(t.shape)} tensor on "
                               f"{t.device}, the rank's tensors are on "
                               f"{self.device}")
        t0 = time.perf_counter()
        t = t.contiguous()
        dist.all_reduce(t, group=self.group)
        self.count += 1
        self.nbytes += t.numel() * t.element_size()
        self.seconds += time.perf_counter() - t0
        return t


def _split(E: int, P: int, r: int):
    """[lo, hi) of rank r's contiguous share of E elements over P ranks;
    the first E % P ranks take one more (a rank may take none)."""
    base, extra = divmod(E, P)
    lo = r * base + min(r, extra)
    return lo, lo + base + (r < extra)


def shard_system(system: PhysicsSystem, mesh) -> PhysicsSystem:
    """This rank's part of `system` on the mesh's element axis (JAX
    ensemble.py:41-86): each element batch cut to the rank's contiguous
    range (its gather-form table rebuilt for it), everything else
    replicated (masses, the global step, the wind), and an ElemComm over
    the element group. Tile after sharding."""
    if system.n_scenes != 1:
        raise ValueError("shard a system of one scene, then tile it")
    P = mesh["elem"].size()
    if P == 1:
        return system
    r = mesh["elem"].get_local_rank()

    def part(b):
        lo, hi = _split(b.w.shape[0], P, r)
        return dataclasses.replace(
            b, inv_idx=None, inv_mask=None,
            **{k: getattr(b, k)[lo:hi] for k in _elem_fields(b)})
    return dataclasses.replace(
        system, batches=tuple(part(b) for b in system.batches),
        comm=ElemComm(mesh.get_group("elem"), system.masses.device))


def _rank_main(rank, world, store_path, results, backend, device, fn, args):
    try:
        torch.set_num_threads(1)
        kw = {}
        if device.type == "cuda":
            torch.cuda.set_device(device)     # before any CUDA work
            if backend == "nccl":
                kw["device_id"] = device      # the communicator's card
        dist.init_process_group(backend, store=dist.FileStore(store_path,
                                                              world),
                                rank=rank, world_size=world, **kw)
        try:
            out = fn(rank, world, device, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:
        results.put((rank, False, traceback.format_exc()))


def rank_info(device) -> dict:
    """This rank's placement as its result reports it: the backend of the
    initialized group, its device and (on CUDA) the current card."""
    return dict(backend=dist.get_backend(), device=str(device),
                current_device=(torch.cuda.current_device()
                                if device.type == "cuda" else None))


def check_ranks(infos, backend, devices):
    """Raises unless rank r's rank_info shows `backend`, devices[r] and, on
    CUDA, that card current."""
    for r, (info, dev) in enumerate(zip(infos, devices)):
        if (info["backend"] != backend or info["device"] != str(dev)
                or info["current_device"] != dev.index):
            raise RuntimeError(f"rank {r} runs as {info}, not on {dev} "
                               f"under {backend}")


def check_placement(infos, world, device_type="cuda", n_cards=None):
    """Raises unless every rank's rank_info is rank_placement's: its
    backend, its device and, on CUDA, that card current."""
    check_ranks(infos, *rank_placement(world, device_type, n_cards))


def run_ranks(world: int, fn, *args, device=None, n_cards=None,
              timeout: float = 600.0):
    """fn(rank, world, rank_device, *args) (a module-level function) in
    `world` spawned processes joined by one process group over a FileStore
    in a temporary directory, one torch thread each. `device` (default the
    card) names the device type; rank_placement(world, its type, n_cards)
    gives each rank its device (current on CUDA before the group starts)
    and the group's backend. Returns the results in rank order. Raises
    when a rank raises or dies, or when the ranks have not all finished
    within `timeout` seconds; every rank still running is then killed."""
    dev_type = resolve_device(device).type
    if dev_type == "cuda" and n_cards is not None and \
            not 1 <= n_cards <= torch.cuda.device_count():
        raise ValueError(f"run_ranks: n_cards={n_cards}, but "
                         f"{torch.cuda.device_count()} cards are visible")
    backend, devices = rank_placement(world, dev_type, n_cards)
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="aaadmm_ranks_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, os.path.join(tmp, "store"), results,
                               backend, devices[r], fn, args))
             for r in range(world)]
    out = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world - len(out)} of {world} ranks "
                                   f"still running after {timeout} s")
            try:
                rank, ok, val = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in
                        (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank died (exit codes {dead})")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{val}")
            out[rank] = val
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]


def sharded_case(rank, world, device, spec: dict, out_dir: str):
    """One rank of a sharded ensemble step (run through run_ranks, which
    hands the rank its device): the float64 tiny scene (`spec`: order,
    iters, m; solver "cg" forces the CG path) on a (dp, elem) mesh of
    prefer_dp, `scenes` replicas (tiny_states) split over dp, each dp group
    building and stepping its own as one tiled, element-sharded ensemble.
    Writes out_dir/rank{rank}.npz (the group's x, v and trace, its scene
    indices, its mesh coordinates, the collectives, host reads and CG
    iterations of the step) and returns the small fields and its
    rank_info."""
    order = spec["order"]
    mesh = make_mesh(world, spec.get("prefer_dp", 1))
    dp, dpr = mesh["dp"].size(), mesh["dp"].get_local_rank()
    solver, s = build_tiny_scene(order, "float64", spec.get("iters", 8),
                                 spec.get("m", 3), device=device)
    if spec.get("solver", "auto") != "auto":
        s.linear_solver = spec["solver"]
        solver.initialize(s)
    system = shard_system(solver.system, mesh)
    S = spec.get("scenes", dp)
    k = S // dp
    mine = slice(dpr * k, (dpr + 1) * k)
    xs, vs, pps = tiny_states(solver, S, scenes=mine)
    counts = _counts()
    c0 = 0 if system.comm is None else system.comm.count
    x, v, tr = ensemble_step(order)(system, xs, vs, pps, counts)
    n_coll = 0 if system.comm is None else system.comm.count - c0
    small = dict(rank=rank, dp_rank=dpr,
                 elem_rank=mesh["elem"].get_local_rank(),
                 collectives=n_coll, host_reads=counts["host_reads"],
                 cg_iters=counts["cg_iters"],
                 reset_count=tr.reset_count.cpu().numpy())
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             scenes=np.arange(S)[mine], x=x.cpu().numpy(),
             v=v.cpu().numpy(), prim=tr.prim.cpu().numpy(),
             comb=tr.comb.cpu().numpy(), reject=tr.reject.cpu().numpy(),
             **small)
    return dict(small, **rank_info(device))


# ---------------------------------------------------------------------------
# Dryrun
# ---------------------------------------------------------------------------

def _finite(tr, x):
    prim = tr.prim[~torch.isnan(tr.prim)]
    return bool(torch.isfinite(x).all()) and bool(torch.isfinite(prim).all())


def _dryrun_rank(rank, world, device):
    """One rank of dryrun(): its summary of both orders, of the geometry
    solve (parallel/geometry.py's dryrun rank) and its rank_info."""
    from .geometry import _dryrun_rank as geometry_rank
    mesh = make_mesh(world)
    dp, dpr = mesh["dp"].size(), mesh["dp"].get_local_rank()
    solver, _ = build_tiny_scene("xzu", device=device)
    system = shard_system(solver.system, mesh)
    xs, vs, pps = tiny_states(solver, 2 * dp)
    mine = slice(2 * dpr, 2 * dpr + 2)
    x, _, tr = ensemble_step("xzu")(system, xs[mine], vs[mine], pps[mine])
    if not _finite(tr, x):
        raise RuntimeError("xzu dp x elem ensemble: non-finite result")

    mesh1 = make_mesh(world, prefer_dp=1)
    solver_z, _ = build_tiny_scene("zxu", device=device)
    args = (solver_z._x_dev, solver_z._v_dev, solver_z._pin_pos_dev())
    xz, _, trz = step_zxu(shard_system(solver_z.system, mesh1), *args)
    if not _finite(trz, xz):
        raise RuntimeError("zxu all-elem: non-finite result")

    summary = {}
    for order in ("xzu", "zxu"):
        for path in ("auto", "cg"):
            key = order if path == "auto" else f"{order}_cg"
            summary[key] = _parity(order, path, mesh1, device)
    return dict(orders=summary, geometry=geometry_rank(rank, world, device),
                **rank_info(device))


def _parity(order, path, mesh, device):
    """The float64 tiny scene's step sharded on `mesh` against the same step
    unsharded, on the scene's own global step ("auto", dense at this size)
    or the forced CG path: raises beyond max|dx| 1e-10 or max|dprim| 1e-8,
    else returns both, the two iteration rates and the collectives."""
    sv, s64 = build_tiny_scene(order, dtype="float64", device=device)
    if path != "auto":
        s64.linear_solver = path
        sv.initialize(s64)
    fn = _step_fn(order)
    args = (sv._x_dev, sv._v_dev, sv._pin_pos_dev())
    sharded = shard_system(sv.system, mesh)
    x_ref, _, tr_ref = fn(sv.system, *args)
    c0 = sharded.comm.count if sharded.comm else 0
    x_sh, _, tr_sh = fn(sharded, *args)
    n_coll = (sharded.comm.count - c0) if sharded.comm else 0
    dx = float((x_sh - x_ref).abs().max())
    pr, ps = tr_ref.prim.cpu().numpy(), tr_sh.prim.cpu().numpy()
    ok = ~(np.isnan(pr) | np.isnan(ps))
    dprim = float(np.abs(pr[ok] - ps[ok]).max()) if ok.any() else 0.0
    if not (dx < 1e-10 and dprim < 1e-8):
        raise RuntimeError(f"{order} {path}: sharded against unsharded "
                           f"max|dx| {dx}, max|dprim| {dprim}")

    def rate(sys_, reps=5):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(sys_, *args)
        float(out[0][0, 0])
        return reps * s64.admm_iters / (time.perf_counter() - t0)
    return {"max_dx": dx, "max_dprim": dprim,
            "iters_per_s_ref": round(rate(sv.system), 1),
            "iters_per_s_sharded": round(rate(sharded), 1),
            "collectives": n_coll}


def dryrun(world: int, device=None, n_cards=None,
           timeout: float = 600.0) -> dict:
    """One accelerated step of both orders on `world` spawned ranks (JAX
    ensemble.py:145-289): xzu as a dp x elem sharded ensemble of two scenes
    per dp group, zxu (with its collision batch) with every rank on the
    element axis, and the float64 sharded-against-unsharded parity of both
    (max|dx| < 1e-10, max|dprim| < 1e-8) with each one's iterations/s and
    collectives per step, on the scene's dense global step (keys "xzu",
    "zxu") and on the forced CG path ("xzu_cg", "zxu_cg"); then the
    geometry dryrun's solve on the same ranks (key "geometry": max|dx| <
    1e-9, max|dfv/fv| < 1e-8; parallel/geometry.py). The ranks run on the
    cards by rank_placement (n_cards as there) unless `device` says
    otherwise. Raises if a rank fails, times out or is not where the rule
    puts it; prints and returns the summary (the JAX dryrun's keys,
    `collectives` in place of `all_reduces`); its JSON line adds the
    backend and the ranks' devices."""
    from .geometry import _geometry_summary
    dev_type = resolve_device(device).type
    per_rank = run_ranks(world, _dryrun_rank, device=dev_type,
                         n_cards=n_cards, timeout=timeout)
    check_placement(per_rank, world, dev_type, n_cards)
    summary = per_rank[0]["orders"]
    for order in summary:
        for key in ("max_dx", "max_dprim"):
            summary[order][key] = max(r["orders"][order][key]
                                      for r in per_rank)
        o = summary[order]
        print(f"dryrun[{order}]: sharded-vs-unsharded max|dx|="
              f"{o['max_dx']:.3e} max|dprim|={o['max_dprim']:.3e}; iters/s "
              f"1 rank={o['iters_per_s_ref']} {world} ranks="
              f"{o['iters_per_s_sharded']}; collectives per step="
              f"{o['collectives']}", flush=True)
    summary["geometry"] = _geometry_summary([r["geometry"] for r in per_rank],
                                            world)
    print(json.dumps({"dryrun": "ok", "n_devices": world,
                      "parity_certified": True, "orders": summary,
                      "backend": per_rank[0]["backend"],
                      "devices": [r["device"] for r in per_rank]}),
          flush=True)
    return summary
