"""ADMM physics solver, the x->z->u order with Anderson acceleration on z
(counterpart of aa_admm_tpu/solver/physics.py:1-463, :855-881 and
``PhysicsSolver`` :923-1263, :1534-1632; admm_anderson_xzu/src/Solver.cpp:
34-263). The z->x->u order, collisions, wind, the instrumented step and the
checkpoints are not ported yet: ``initialize`` raises NotImplementedError
for them.

Where the JAX package compiles one timestep as a ``lax.scan`` over the ADMM
iterations with a ``lax.cond`` for the accelerator's reject branch, the port
runs a Python loop of ``admm_iters`` eager iterations over the same carried
state:
  * the eps-break (combined residual below 1e-20) freezes the state with
    ``torch.where`` and records NaN for the frozen iterations, as the scan
    does, so the loop never reads the residual back;
  * on the dense path (a matmul by the prefactored inverse) both branches of
    the reject test are computed and chosen with ``torch.where`` — one small
    extra solve per iteration, no host read;
  * on the CG path the reject test is read on the host and the second CG
    solve runs only on a reject.
Host reads per iteration: one for the AA Gram matrix (``anderson.compute``
solves it on the CPU), the CG loop tests, and the reject test on the CG
path; ``PhysicsSolver.stats["host_reads"]`` counts them.

Where XLA fuses the local step into a few kernels, eager PyTorch launches
each elementwise op of the batched SVD and Newton: about 15,000 launches
per accelerated iteration on beams, paced by the host. On CUDA tensors the
per-batch prox and gradient and the CG operator therefore run as CUDA
graphs, each captured on first use for its system (fixed shapes, no host
reads inside) and replayed with its inputs copied in (``_graphed``); the
kernels and their results are those of the eager calls.

The free/fixed split (S_free / S_fix, Solver.cpp:285-328) is index tensors
into full-vertex tensors; every z/u block is in plane form (C, E)
(ops/elements.py).
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..core.config import Lame, Settings
from ..core.factory import TetMeshData
from ..core.meshio import save_residual_file
from ..core.timers import MicroTimer
from ..ops._batchutil import cast_floats, torch_dtype
from ..ops.elements import TetBatch
from . import anderson
from .linear import (DenseInverseSolver, assemble_node_diag,
                     assemble_node_matrix, dense_inverse, pcg)

_EPS_BREAK = 1e-20  # Solver.cpp:100 — combined-residual early-exit threshold


class UpdateOrder(str, enum.Enum):
    XZU = "xzu"  # AA on z
    ZXU = "zxu"  # AA on (u, x); penalty parameter; collision terms


@dataclasses.dataclass(frozen=True)
class PhysicsSystem:
    """Immutable per-initialize() data (the folded matrices of
    Solver::initialize, Solver.cpp:373-498)."""

    masses: torch.Tensor                 # (n,) per-node lumped mass
    free_mask: torch.Tensor              # (n,) bool
    free_idx: torch.Tensor               # (nf,) int64
    batches: tuple                       # element batches, fixed order
    solver: Optional[DenseInverseSolver]
    precond_diag: Optional[torch.Tensor]  # (nf,) for the PCG path
    n_verts: int = 0
    n_free: int = 0
    order: str = "xzu"
    dt: float = 1.0 / 30.0
    gravity: float = -9.8
    dt2p: float = 0.0                    # penalty * dt^2
    admm_iters: int = 100
    anderson_m: int = 2
    accel: bool = False
    collect_comb: bool = True
    cg_tol: float = 1e-12
    cg_max_iters: int = 400

    def deform(self, x):
        return tuple(b.deform(x) for b in self.batches)

    def scatter(self, ts):
        out = torch.zeros((self.n_verts, 3), dtype=ts[0].dtype,
                          device=ts[0].device)
        for b, t in zip(self.batches, ts):
            out = out + b.scatter(t, self.n_verts)
        return out


def _counts():
    """Host-read and CG-iteration counters of one or more steps."""
    return dict(host_reads=0, cg_iters=0)


def _wx(b, a, power=1):
    """Per-element weight applied to a plane-form (C, E) block."""
    return (b.w ** power) * a


def _tmap(fn, *trees):
    return tuple(fn(*xs) for xs in zip(*trees))


def _sqnorm_all(ts):
    """||concat(ts)||^2 as per-block sums added in block order."""
    return sum((t * t).sum() for t in ts)


def _flatten(ts):
    return torch.cat([t.reshape(-1) for t in ts])


def _unflatten(flat, templates):
    out, off = [], 0
    for t in templates:
        size = t.numel()
        out.append(flat[off:off + size].reshape(t.shape))
        off += size
    return tuple(out)


def _select(cond, a, b):
    """torch.where(cond, a, b) over a carried state (dicts, tuples, AA
    states, tensors)."""
    if isinstance(a, dict):
        return {k: _select(cond, a[k], b[k]) for k in a}
    if isinstance(a, tuple):
        return tuple(_select(cond, x, y) for x, y in zip(a, b))
    if isinstance(a, anderson.AAState):
        return anderson.where(cond, a, b)
    return torch.where(cond, a, b)


class _GraphedCall:
    """fn(x) captured once in a CUDA graph (after two warm-up calls on a
    side stream) and replayed with x copied into the captured input."""

    def __init__(self, fn, x):
        self.x = x.clone()
        side = torch.cuda.Stream(x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                fn(self.x)
        torch.cuda.current_stream(x.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = fn(self.x)

    def __call__(self, x):
        self.x.copy_(x)
        self.graph.replay()
        return self.out.clone()


def _graphed(system: PhysicsSystem, key, fn, x):
    """fn(x) for a function of one tensor that does fixed-shape device work
    only: eager on the CPU, a replayed CUDA graph on CUDA (captured on the
    first call for this system and key)."""
    if not x.is_cuda:
        return fn(x)
    graphs = system.__dict__.setdefault("_graphs", {})
    if key not in graphs:
        graphs[key] = _GraphedCall(fn, x)
    return graphs[key](x)


# ----------------------------------------------------------------------------
# Shared per-step computations
# ----------------------------------------------------------------------------

def _prox_all(system: PhysicsSystem, vs):
    return tuple(_graphed(system, ("prox", i), b.prox, v)
                 for i, (b, v) in enumerate(zip(system.batches, vs)))


def _grad_all(system: PhysicsSystem, zs):
    return tuple(_graphed(system, ("grad", i), b.grad, z)
                 for i, (b, z) in enumerate(zip(system.batches, zs)))


def _apply_A(system: PhysicsSystem, vf):
    """The x-step's operator on free positions: (M + dt2p D^T W^2 D) vf."""
    fi = system.free_idx
    v_full = torch.zeros((system.n_verts, 3), dtype=vf.dtype,
                         device=vf.device).index_copy(0, fi, vf)
    tv = _tmap(lambda b, f: _wx(b, f, 2), system.batches,
               system.deform(v_full))
    sv = system.scatter(tv)
    return system.masses[fi, None] * vf + system.dt2p * sv[fi]


def _update_z(system, x_full, u):
    """EnergyTerm::update_z (EnergyTerm.hpp:167-179): z = prox(F(x) + u/w)."""
    F = system.deform(x_full)
    v = _tmap(lambda b, f, ui: f + _wx(b, ui, -1), system.batches, F, u)
    return _prox_all(system, v)


def _prim_vec(system, x_full, z):
    """W D x - W z - C = w (F(x) - z) per block (Solver.cpp:154)."""
    F = system.deform(x_full)
    return _tmap(lambda b, f, zb: _wx(b, f - zb), system.batches, F, z)


def _solve_x(system: PhysicsSystem, M_xbar_free, z, u, c_blocks, base_full,
             x_warm=None, counts=None):
    """Global step: x = A^-1 (M xbar + dt2p * D^T W (W z + C - u))
    (Solver.cpp:148-149). c_blocks = F_b(pin embedding), constant per step.
    x_warm (full positions) warm-starts the CG path; the dense path is one
    matmul. CG iterations and host reads go into `counts`."""
    t = _tmap(lambda b, zb, ub, cb: _wx(b, zb - cb, 2) - _wx(b, ub),
              system.batches, z, u, c_blocks)
    s = system.scatter(t)
    fi = system.free_idx
    rhs = M_xbar_free + system.dt2p * s[fi]
    if system.solver is not None:
        xf = system.solver.solve(rhs)
    else:
        def operator(vf):
            return _graphed(system, "A", lambda v: _apply_A(system, v), vf)
        x0 = None if x_warm is None else x_warm[fi]
        xf, n_it, reads = pcg(operator, rhs, system.precond_diag,
                              tol=system.cg_tol,
                              max_iters=system.cg_max_iters, x0=x0)
        if counts is not None:
            counts["cg_iters"] += n_it
            counts["host_reads"] += reads
    return base_full.index_copy(0, fi, xf)


def _predict(system: PhysicsSystem, x, v, pin_pos):
    """Explicit forces + gravity + inertia prediction (Solver.cpp:50-81)."""
    dt = system.dt
    free = system.free_mask[:, None]
    if abs(system.gravity) > 0:
        g = torch.zeros((3,), dtype=x.dtype, device=x.device)
        g[1] = dt * system.gravity
        v = torch.where(free, v + g, v)
    xbar_full = torch.where(free, x + dt * v, pin_pos)
    base_full = torch.where(free, torch.zeros_like(pin_pos), pin_pos)
    return v, xbar_full, base_full


class StepTrace(NamedTuple):
    prim: torch.Tensor         # (iters,)
    comb: torch.Tensor         # (iters,)
    reject: torch.Tensor       # (iters,) int64
    n_valid: torch.Tensor      # ()
    reset_count: torch.Tensor  # ()


# ----------------------------------------------------------------------------
# x -> z -> u (AA on z) — admm_anderson_xzu/src/Solver.cpp:34-263
# ----------------------------------------------------------------------------

def _xzu_setup(system: PhysicsSystem, x, v, pin_pos, counts=None):
    """Prediction + ADMM initialization for the xzu order
    (Solver.cpp:84-117: z = F(xbar); one x-solve; one z-prox). Returns
    (carry, consts): the loop state and the per-step constants (M xbar, the
    pin-embedding blocks, the base positions)."""
    v, xbar_full, base_full = _predict(system, x, v, pin_pos)
    fi = system.free_idx
    M_xbar_free = system.masses[fi, None] * xbar_full[fi]
    c_blocks = system.deform(base_full)  # F_b of the pin embedding (= -C/w)

    z = system.deform(xbar_full)
    u = _tmap(torch.zeros_like, z)
    x_full = _solve_x(system, M_xbar_free, z, u, c_blocks, base_full,
                      counts=counts)
    z = _update_z(system, x_full, u)
    aa0 = anderson.init(system.anderson_m, _flatten(z))
    kw = dict(device=x.device)
    carry = dict(x=x_full, z=z, u=u, dx=x_full, dz=z, du=u,
                 prev=torch.tensor(1e20, dtype=x.dtype, **kw), aa=aa0,
                 done=torch.tensor(False, **kw),
                 resets=torch.zeros((), dtype=torch.int64, **kw))
    consts = dict(M=M_xbar_free, c=c_blocks, base=base_full)
    return carry, consts


def _xzu_body(system: PhysicsSystem, consts, counts=None):
    """One xzu ADMM iteration (Solver.cpp:120-250) as a function of the
    carried state: returns (carry, (prim, comb, reject))."""
    M_xbar_free, c_blocks, base_full = consts["M"], consts["c"], consts["base"]
    accel = system.accel
    counts = _counts() if counts is None else counts

    def solve(z, u, x_warm=None):
        return _solve_x(system, M_xbar_free, z, u, c_blocks, base_full,
                        x_warm=x_warm, counts=counts)

    def body(carry):
        cx, cz, cu = carry["x"], carry["z"], carry["u"]
        dx_, dz_, du_ = carry["dx"], carry["dz"], carry["du"]
        aa = carry["aa"]

        if accel:
            # u <- W^-1 grad U(z) (Solver.cpp:127-133)
            cu = _tmap(lambda b, g: _wx(b, g, -1), system.batches,
                       _grad_all(system, cz))
        else:
            # u += Dx - Wz - C (Solver.cpp:138-141)
            cu = _tmap(torch.add, cu, _prim_vec(system, cx, cz))

        cx = solve(cz, cu, x_warm=cx)
        prim = torch.sqrt(_sqnorm_all(_prim_vec(system, cx, cz)))

        if accel:
            rejected = carry["prev"] < prim

            def do_reject():
                aa2 = anderson.replace(aa, _flatten(dz_))
                cu2 = _tmap(torch.add, du_, _prim_vec(system, dx_, dz_))
                cx2 = solve(dz_, cu2)
                prim2 = torch.sqrt(_sqnorm_all(_prim_vec(system, cx2, dz_)))
                return cx2, dz_, cu2, aa2, prim2

            if system.solver is not None:
                # dense: both branches, chosen on the device
                cx, cz, cu, aa, prim = _select(
                    rejected, do_reject(), (cx, cz, cu, aa, prim))
            else:
                counts["host_reads"] += 1
                if bool(rejected):
                    cx, cz, cu, aa, prim = do_reject()
        else:
            rejected = torch.zeros((), dtype=torch.bool, device=cx.device)

        prev = prim
        ndx, ndu = cx, cu
        if accel:
            ndz = _update_z(system, cx, cu)
            aa, zflat = anderson.compute(aa, _flatten(ndz))
            counts["host_reads"] += 1
            cz = _unflatten(zflat, ndz)
        else:
            last_z = cz
            cz = _update_z(system, cx, cu)
            ndz = cz

        # Diagnostic combined residual (Solver.cpp:216-238).
        if system.collect_comb:
            if accel:
                comb_x = solve(ndz, cu)
                comb_z = _update_z(system, comb_x, cu)
                dual = _tmap(lambda b, a, c: _wx(b, a - c),
                             system.batches, comb_z, ndz)
                comb = _sqnorm_all(dual + _prim_vec(system, comb_x, comb_z))
            else:
                dual = _tmap(lambda b, a, c: _wx(b, a - c),
                             system.batches, cz, last_z)
                comb = _sqnorm_all(dual + _prim_vec(system, cx, cz))
        else:
            comb = torch.full((), float("inf"), dtype=prim.dtype,
                              device=prim.device)

        done = carry["done"]
        new = dict(x=cx, z=cz, u=cu, dx=ndx, dz=ndz, du=ndu, prev=prev, aa=aa,
                   done=done | (comb < _EPS_BREAK),
                   resets=carry["resets"] + rejected.to(torch.int64))
        # Freeze the state once the eps-break fired (the reference breaks
        # out; the breaking iteration's residuals are still recorded,
        # Solver.cpp:241-250).
        out = _select(done, carry, new)
        valid = ~done
        nan = torch.full_like(prim, float("nan"))
        return out, (torch.where(valid, prim, nan), torch.where(valid, comb, nan),
                     (rejected & valid).to(torch.int64))

    return body


def _commit_x(system: PhysicsSystem, carry):
    """The positions the reference commits after the ADMM loop: xzu commits
    curr_x (Solver.cpp:255-257)."""
    return carry["x"]


def step_xzu(system: PhysicsSystem, x, v, pin_pos, counts=None):
    """One xzu timestep: (x_new, v_new, StepTrace)."""
    carry, consts = _xzu_setup(system, x, v, pin_pos, counts)
    body = _xzu_body(system, consts, counts)
    recs = []
    for _ in range(system.admm_iters):
        carry, rec = body(carry)
        recs.append(rec)
    prims, combs, rejects = (torch.stack([r[i] for r in recs])
                             for i in range(3))
    x_new = _commit_x(system, carry)
    v_new = (x_new - x) / system.dt
    n_valid = (~torch.isnan(prims)).sum()
    return x_new, v_new, StepTrace(prims, combs, rejects, n_valid,
                                   carry["resets"])


def run_frames(system: PhysicsSystem, x, v, pin_pos, n_frames: int,
               pin_vel=None, counts=None):
    """n_frames timesteps in a row. pin_vel (n, 3) moves the pins by
    dt*pin_vel before each step, as a per-frame `set_pins` callback like
    beams' stretch does (beams.cpp:66-92). Returns (x, v, final pin_pos,
    traces) with each trace field stacked (n_frames, iters)."""
    traces = []
    for _ in range(n_frames):
        if pin_vel is not None:
            pin_pos = pin_pos + system.dt * pin_vel
        x, v, tr = step_xzu(system, x, v, pin_pos, counts)
        traces.append(tr)
    stacked = StepTrace(*(torch.stack([getattr(t, f) for t in traces])
                          for f in StepTrace._fields))
    return x, v, pin_pos, stacked


# ----------------------------------------------------------------------------
# Host orchestration — the public API surface of admm::Solver
# ----------------------------------------------------------------------------

class PhysicsSolver:
    """Host-side scene builder + stepper (admm::Solver public API:
    add_nodes / set_pins / initialize / step / save, Solver.hpp:95-151).
    ``device`` defaults to CUDA and raises without it."""

    def __init__(self, order: UpdateOrder | str = UpdateOrder.XZU,
                 dense_threshold: int = 12000, device=None):
        self.order = UpdateOrder(order)
        self.dense_threshold = dense_threshold
        self.device = resolve_device(device)
        self.verts: List[np.ndarray] = []
        self.masses: List[np.ndarray] = []
        self._tet_groups = []      # (tets, lame, kind) with global indices
        self.pins: dict[int, np.ndarray] = {}
        # Requests of parts not ported yet; initialize() refuses them.
        self.collisions: dict[int, np.ndarray] = {}
        self.obstacles: list = []
        self.dynamic_colliders: list = []
        self.wind = None
        self.system: Optional[PhysicsSystem] = None
        self._x_dev = None
        self._v_dev = None
        self._x_host: Optional[np.ndarray] = None
        self._v_host: Optional[np.ndarray] = None
        self._pending_traces: List[StepTrace] = []
        self.settings = Settings()
        self.initialized = False
        # residual history across steps (for save())
        self.step_prim: List[float] = []
        self.step_comb: List[float] = []
        self.step_reject: List[int] = []
        self.step_times: List[float] = []
        self.step_ms: List[float] = []
        self.reset_num = 0
        self.stats = _counts()

    # ---- scene assembly ----

    @property
    def n_verts(self) -> int:
        return sum(len(v) for v in self.verts)

    def add_tetmesh(self, verts, tets, lame: Lame, kind: str = "linear",
                    density: float = 1522.0, self_collision: bool = False):
        """binding::add_tetmesh (AddMeshes.hpp:97-177): lumped masses at
        rubber density 1522 kg/m^3, node append, per-tet energy terms.
        self_collision=True asks for a dynamic collider, which the xzu
        order refuses at initialize()."""
        offset = self.n_verts
        mesh = TetMeshData(verts=np.asarray(verts, np.float64),
                           tets=np.asarray(tets, np.int32))
        m = mesh.weighted_masses(density)
        if np.any(m <= 0):
            raise ValueError("TetMesh Error: Zero mass")
        self.verts.append(mesh.verts)
        self.masses.append(m)
        self._tet_groups.append((mesh.tets + offset, lame, kind))
        if self_collision:
            self.dynamic_colliders.append((mesh.verts, mesh.tets, offset))
        return offset

    def set_pins(self, inds: Sequence[int], points: Optional[Sequence] = None):
        """Solver::set_pins (Solver.cpp:330-363). Pin in place when points
        is None; the pinned vertex set may not change after initialize."""
        new_pins = {}
        x = None
        for i, idx in enumerate(inds):
            if points is None:
                if x is None:
                    x = self._all_verts() if self._x_dev is None else self.x
                new_pins[int(idx)] = x[int(idx)].copy()
            else:
                new_pins[int(idx)] = np.asarray(points[i], np.float64)
        if self.initialized and set(new_pins) != set(self.pins):
            raise ValueError("pinned vertex set may not change after initialize")
        self.pins = new_pins
        if self.initialized:
            self._refresh_pin_pos()

    def set_collisions(self, inds, points=None):
        """zxu Solver::set_collisions (Solver.cpp:318-344)."""
        x = self._all_verts() if self._x_dev is None else self.x
        self.collisions = {
            int(idx): (x[int(idx)] if points is None else np.asarray(points[i]))
            for i, idx in enumerate(inds)}

    def add_obstacle(self, kind: str, **kw):
        """Solver::add_obstacle (analytic or tet-mesh passive colliders)."""
        self.obstacles.append((kind, kw))

    def set_wind(self, faces, direction, alpha_n: float = 1000.0,
                 mode: str = "jacobi"):
        """The aerodynamic pre-ADMM velocity kick (ExplicitForce.cpp:47-104)."""
        self.wind = (faces, direction, alpha_n, mode)

    def _all_verts(self) -> np.ndarray:
        return (np.concatenate(self.verts, axis=0)
                if self.verts else np.zeros((0, 3)))

    def _refresh_pin_pos(self):
        # Only pinned rows of pin_pos are ever read (the step masks free rows).
        pp = np.zeros((self.n_verts, 3), np.dtype(self.settings.dtype))
        for idx, p in self.pins.items():
            pp[idx] = p
        self.pin_pos = pp

    def _pin_pos_dev(self):
        return torch.from_numpy(self.pin_pos).to(self.device)

    # ---- initialize ----

    def _refuse_unported(self, s: Settings):
        if self.order == UpdateOrder.ZXU:
            raise NotImplementedError("the zxu update order is not ported yet")
        if self.collisions:
            raise ValueError(
                "collision energy terms exist only in the zxu variant "
                "(reference forbids obstacles with the LDLT xzu solver, "
                "Solver.cpp:486-489)")
        if self.obstacles:
            raise ValueError("No collisions with the LDLT (xzu) solver")
        if self.dynamic_colliders:
            raise ValueError(
                "dynamic/self collision needs the zxu collision-energy path "
                "(reference forbids obstacles with the LDLT xzu solver, "
                "Solver.cpp:486-489)")
        if self.wind is not None:
            raise NotImplementedError("wind is not ported yet")
        if s.trace_chunk > 0:
            raise NotImplementedError("chunked residual tracing is not "
                                      "ported yet (trace_chunk must be 0)")

    def initialize(self, settings: Optional[Settings] = None) -> bool:
        """Solver::initialize (Solver.cpp:373-498): element batches, the
        free/fixed split, and the prefactored global system (the dense
        inverse while n_free <= dense_threshold, else the Jacobi diagonal
        for CG)."""
        if settings is not None:
            self.settings = settings
        s = self.settings
        self._refuse_unported(s)
        if s.timestep_s <= 0.0:
            s.timestep_s = 1.0 / 24.0
        dtype = np.dtype(s.dtype)
        tdt = torch_dtype(dtype)
        dev = self.device

        x = self._all_verts()
        n = len(x)
        if n < 1:
            return False
        masses = np.concatenate(self.masses)
        batches = [TetBatch.from_mesh(x, tets, lame, kind=kind, dtype=dtype)
                   for tets, lame, kind in self._tet_groups]

        free_mask = np.ones(n, bool)
        for idx in self.pins:
            free_mask[idx] = False
        free_idx = np.nonzero(free_mask)[0]
        nf = len(free_idx)
        dt2p = s.timestep_s ** 2

        use_dense = (s.linear_solver == "dense"
                     or (s.linear_solver == "auto"
                         and nf <= self.dense_threshold))
        solver = precond = None
        if use_dense:
            A = dt2p * assemble_node_matrix(n, batches, dt2p=1.0, masses=None)
            A[np.arange(n), np.arange(n)] += masses
            solver = DenseInverseSolver(Ainv=dense_inverse(
                A[np.ix_(free_idx, free_idx)], dtype=tdt, device=dev))
        else:
            diag = masses + dt2p * assemble_node_diag(n, batches)
            precond = torch.from_numpy(diag[free_idx]).to(dev, tdt)

        self.system = PhysicsSystem(
            masses=torch.from_numpy(masses).to(dev, tdt),
            free_mask=torch.from_numpy(free_mask).to(dev),
            free_idx=torch.from_numpy(free_idx.astype(np.int64)).to(dev),
            batches=tuple(cast_floats(b, tdt, dev) for b in batches),
            solver=solver, precond_diag=precond, n_verts=n, n_free=nf,
            order=self.order.value, dt=float(s.timestep_s),
            gravity=float(s.gravity), dt2p=float(dt2p),
            admm_iters=int(s.admm_iters), anderson_m=int(s.anderson_m),
            accel=bool(s.accelerated),
            collect_comb=bool(s.collect_comb_residual),
            cg_tol=float(s.cg_tol), cg_max_iters=int(s.cg_max_iters))
        self.x = x.astype(dtype)
        self.v = np.zeros_like(self.x)
        self._refresh_pin_pos()
        self.initialized = True
        if s.verbose >= 1:
            print(f"{n} nodes, {len(batches)} element batches, {nf} free, "
                  f"solver={'dense' if use_dense else 'cg'}")
        return True

    # ---- step ----

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _check_ready(self):
        if not self.initialized:
            raise RuntimeError("initialize() must run before step()")

    def step(self) -> StepTrace:
        """One timestep (Solver::step). Updates x, v on the device and
        queues the residual trace; flush_traces()/save() fetch the history.
        Returns the per-iteration trace (device tensors)."""
        self._check_ready()
        t = MicroTimer()
        x_new, v_new, trace = step_xzu(self.system, self._x_dev, self._v_dev,
                                       self._pin_pos_dev(), self.stats)
        self._sync()
        elapsed = t.elapsed_ms()
        self._x_dev, self._v_dev = x_new, v_new
        self._x_host = self._v_host = None
        self._pending_traces.append(trace)
        self.step_ms.append(elapsed)
        if self.settings.verbose > 0:
            print(f"step: {elapsed:.2f}ms, "
                  f"reset number = {int(trace.reset_count)}")
        return trace

    def run(self, n_frames: int, pin_vel=None):
        """n_frames timesteps, equivalent to n_frames step() calls (each
        after a `set_pins(pins + dt*pin_vel)` when pin_vel is given)."""
        self._check_ready()
        t = MicroTimer()
        pv = None if pin_vel is None else torch.from_numpy(
            np.asarray(pin_vel, self.pin_pos.dtype)).to(self.device)
        xf, vf, ppf, traces = run_frames(self.system, self._x_dev,
                                         self._v_dev, self._pin_pos_dev(),
                                         int(n_frames), pv, self.stats)
        self._sync()
        if pin_vel is not None:
            self.pin_pos = ppf.cpu().numpy()
            for idx in self.pins:
                self.pins[idx] = self.pin_pos[idx].copy()
        elapsed = t.elapsed_ms()
        self._x_dev, self._v_dev = xf, vf
        self._x_host = self._v_host = None
        for i in range(int(n_frames)):
            self._pending_traces.append(StepTrace(*(a[i] for a in traces)))
            self.step_ms.append(elapsed / n_frames)
        if self.settings.verbose > 0:
            print(f"run({n_frames}): {elapsed:.2f}ms total, "
                  f"{elapsed / n_frames:.2f}ms/step")
        return traces

    # Positions and velocities live on the device between steps; host
    # views are fetched when asked for.
    @property
    def x(self):
        if self._x_host is None and self._x_dev is not None:
            self._x_host = self._x_dev.cpu().numpy()
        return self._x_host

    @x.setter
    def x(self, value):
        self._x_host = None if value is None else np.asarray(value)
        self._x_dev = None if value is None else torch.from_numpy(
            self._x_host).to(self.device)

    @property
    def v(self):
        if self._v_host is None and self._v_dev is not None:
            self._v_host = self._v_dev.cpu().numpy()
        return self._v_host

    @v.setter
    def v(self, value):
        self._v_host = None if value is None else np.asarray(value)
        self._v_dev = None if value is None else torch.from_numpy(
            self._v_host).to(self.device)

    def flush_traces(self):
        """Move queued per-step traces into the residual history (one host
        fetch); per-iteration times spread each step's time uniformly."""
        if not self._pending_traces:
            return
        n = len(self._pending_traces)
        host = [StepTrace(*(a.cpu().numpy() for a in tr))
                for tr in self._pending_traces]
        self._pending_traces = []
        iters = self.system.admm_iters
        for trace, elapsed in zip(host, self.step_ms[-n:]):
            per = elapsed / max(1, iters)
            t0 = self.step_times[-1] if self.step_times else 0.0
            for i in np.nonzero(~np.isnan(trace.prim))[0]:
                self.step_prim.append(float(trace.prim[i]))
                self.step_comb.append(float(trace.comb[i]))
                self.step_reject.append(int(trace.reject[i]))
                self.step_times.append(t0 + (i + 1) * per)
            self.reset_num += int(trace.reset_count)

    # ---- persistence (Solver::save, Solver.hpp:126-151) ----

    def save(self, result_dir: str = "result"):
        self.flush_traces()
        m = self.settings.anderson_m if self.settings.accelerated else 0
        name = f"residual-{m}.txt" if m > 0 else "residual-no.txt"
        save_residual_file(os.path.join(result_dir, name),
                           [t / 1e3 for t in self.step_times],
                           self.step_prim, self.step_comb)
