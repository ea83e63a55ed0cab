"""ADMM physics solver in both update orders (counterpart of
aa_admm_tpu/solver/physics.py and its ``PhysicsSolver``):
  * x->z->u with Anderson acceleration on z (admm_anderson_xzu/src/
    Solver.cpp:34-263);
  * z->x->u with Anderson acceleration on the (u, x) pair, the ADMM penalty
    parameter and per-vertex hard-collision terms against analytic and
    tet-mesh obstacles and, refreshed every step, against deforming tet
    meshes (admm_anderson_hard_zxu/src/Solver.cpp:34-234);
  * the wind's explicit velocity kick in either order;
  * the instrumented steps (``step_{xzu,zxu}_instrumented``: the same
    algorithm as a host loop of phases, each ended by a device
    synchronization, accumulating ``RuntimeData``), chunked residual
    tracing (``Settings.trace_chunk``: the step in chunks of iterations with
    the time measured at each chunk boundary) and mid-step ADMM state dumps
    in the reference's text format with an .npz sidecar of the whole carry
    (``save_admm_state`` / ``load_admm_state``).

Where the JAX package compiles one timestep as a ``lax.scan`` over the ADMM
iterations with a ``lax.cond`` for the accelerator's reject branch, the port
runs a Python loop of ``admm_iters`` eager iterations over the same carried
state:
  * the eps-break (combined residual below 1e-20) freezes the state with
    ``torch.where`` and records NaN for the frozen iterations, as the scan
    does, so the loop never reads the residual back;
  * xzu, dense path (a matmul by the prefactored inverse): both branches of
    the reject test are computed and chosen with ``torch.where`` — one small
    extra solve per iteration, no host read;
  * xzu, CG path, and zxu on either path: the reject test is read on the
    host and the reject branch runs only on a reject. In zxu that branch
    recomputes a whole z-update (every prox), which computing both branches
    would pay in every accelerated iteration; the read costs one sync, and
    the AA Gram matrix already costs one per iteration.
Host reads (``host_read``) per iteration: one for the AA Gram matrix
(``anderson.compute`` solves it on the CPU), the CG loop tests and the
reject test where it is read; one per self-contact detection (its
overflow flag); the instrumented steps read each residual and a
``SolverLog``'s positions as well. A chunked step also synchronizes once
per chunk, which reads nothing.

Where XLA fuses the local step into a few kernels, eager PyTorch would
launch each elementwise op of the batched SVD and Newton: about 15,000
launches per accelerated iteration on beams. On CUDA tensors a tet batch's
prox and gradient are therefore one hand-written kernel launch each
(csrc/tet_prox.cu, ``_local``), and the other batches' prox and gradient
and the CG operator run as CUDA graphs, each captured on first use for its
system (fixed shapes, no host reads inside) and replayed with its inputs
copied in (``_graphed``); the kernels and their results are those of the
eager calls. Self-contacts change every step: the solver copies them into
the SelfCollisionBatch's own tensors in place, so one system and its
graphs serve every step. Every
scatter of the step (the batches' adjoints, the jacobi wind) is a gather
over an inverse table built when its batch is made (ops/_batchutil.py), so
two runs of one step from one state agree bit for bit on the card too (a
chunked step with the fused one, a sidecar replay with the uninterrupted
step), without deterministic algorithms.

The free/fixed split (S_free / S_fix, Solver.cpp:285-328) is index tensors
into full-vertex tensors; every z/u block is in plane form (C, E)
(ops/elements.py).

Two hooks serve parallel/ensemble.py, and change nothing for a plain
system:
  * ``PhysicsSystem.n_scenes`` = S > 1: the system is S copies of one scene
    tiled along every axis (vertex rows s*n ... (s+1)*n - 1, element
    columns s*E ... (s+1)*E - 1 of each batch). The residual norms, the
    reject tests, the eps-break, the reset counts and the AA windows are
    then per scene ((S,) tensors, an AA state led by the scene axis), so
    each scene rejects, resets and breaks on its own; a reject branch that
    is a host read runs when any scene rejected and is chosen per scene
    with ``torch.where``. The global step solves the S scenes as 3S
    columns of one (nf, 3S) block: one matmul by the shared inverse, or one
    CG whose per-column freeze is per-scene convergence.
  * ``PhysicsSystem.comm``: an element-sharded system holds this rank's
    range of each batch's elements; ``comm.all_reduce`` sums the vertex
    scatter (the right-hand side and every CG matvec), the squared norms
    and the AA inner-product partials over the element group, so every
    branch reads a value all ranks share. Such a system runs eagerly
    (no CUDA graphs around the collectives).
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import os
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..core.checkpoint import load_admm_state_text, save_admm_state_text
from ..core.config import Lame, Settings
from ..core.factory import TetMeshData
from ..core.meshio import save_residual_file
from ..core.timers import (MicroTimer, RuntimeData, host_read, host_reads,
                           span, spanned)
from ..ops._batchutil import GatherAdjoint, cast_floats, torch_dtype
from ..ops.collider import (DynamicTetCollider, HashGridTetCollider,
                            TetMeshSdf)
from ..ops.elements import (CollisionBatch, SelfCollisionBatch, TetBatch,
                            TriBatch)
from ..ops.sdf import SdfSceneBuilder
from . import anderson
from .linear import (DenseInverseSolver, assemble_node_diag,
                     assemble_node_matrix, dense_inverse, pcg)

_EPS_BREAK = 1e-20  # Solver.cpp:100 — combined-residual early-exit threshold


class UpdateOrder(str, enum.Enum):
    XZU = "xzu"  # AA on z
    ZXU = "zxu"  # AA on (u, x); penalty parameter; collision terms


def _dot3(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


@dataclasses.dataclass(frozen=True)
class WindForce(GatherAdjoint):
    """Wejchert-Haumann aerodynamic per-triangle normal force applied as a
    pre-ADMM velocity kick (ExplicitForce.cpp:47-104). Two deterministic
    modes, as in the JAX package:

    * ``jacobi`` (default): every force against the pre-kick velocity, then
      one scatter, in gather form over the faces' inverse table;
    * ``sequential``: the triangles in face order, each reading the live
      velocity — the reference loop run on one thread. The JAX package
      scans over the triangles; here it is a Python loop of about eight
      launches per triangle, all on the device.
    """

    faces: torch.Tensor      # (F, 3) int64
    direction: torch.Tensor  # (3,)
    alpha_n: float = 1000.0
    mode: str = "jacobi"
    inv_idx: Optional[torch.Tensor] = None   # (n, K) gather-form adjoint
    inv_mask: Optional[torch.Tensor] = None  # (n, K)

    def _adjoint_index(self):
        return self.faces, None, self.direction.dtype

    def apply(self, dt, x, v, n_verts):
        f = self.faces
        # Cast, don't promote: a f64 direction must not leak into f32 state.
        direction = self.direction.to(v.dtype)
        # Geometry factors depend on x only, so both modes hoist them.
        x0 = x[f[:, 0]]
        n = _cross(x[f[:, 1]] - x0, x[f[:, 2]] - x0)
        n_norm = torch.sqrt(_dot3(n, n))[:, None]
        normal = n / torch.clamp_min(n_norm, 1e-300)
        area = 0.5 * n_norm[:, 0]
        coef = (-self.alpha_n * area) * (0.33 * dt)

        if self.mode == "sequential":
            v = v.clone()
            for i in range(f.shape[0]):
                fi = f[i]
                vv = v[fi]
                v_n = _dot3(normal[i], (vv[0] + vv[1] + vv[2]) / 3.0 - direction)
                force = (coef[i] * v_n * v_n.abs()) * normal[i]
                # One triangle's three distinct vertices: no two of these
                # adds meet at an address, so the sum is the same on every
                # run even where index_add_ uses atomics.
                v.index_add_(0, fi, force.expand(3, 3))
            return v

        curr_v = (v[f[:, 0]] + v[f[:, 1]] + v[f[:, 2]]) / 3.0   # (F, 3)
        v_n = _dot3(normal, curr_v - direction)
        force = (coef * v_n * v_n.abs())[:, None] * normal
        dv = self._scatter(force.repeat_interleave(3, dim=0), n_verts)
        return v + dv


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
    wind: Optional[WindForce] = None
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
    n_scenes: int = 1      # S tiled copies of one scene (parallel/ensemble)
    comm: Optional[object] = None  # element group of a sharded system

    def deform(self, x):
        return tuple(b.deform(x) for b in self.batches)

    def scatter(self, ts):
        out = torch.zeros((self.n_verts, 3), dtype=ts[0].dtype,
                          device=ts[0].device)
        for b, t in zip(self.batches, ts):
            out = out + b.scatter(t, self.n_verts)
        return _reduce(self, out)


def _counts():
    """Host-read and CG-iteration counters of one or more steps."""
    return dict(host_reads=0, cg_iters=0)


@contextlib.contextmanager
def _reads_into(counts):
    """Adds the block's host reads to counts["host_reads"] (if counts)."""
    reads0 = host_reads()
    yield
    if counts is not None:
        counts["host_reads"] += host_reads() - reads0


def _wx(b, a, power=1):
    """Per-element weight applied to a plane-form (C, E) block."""
    return (b.w ** power) * a


def _tmap(fn, *trees):
    return tuple(fn(*xs) for xs in zip(*trees))


def _reduce(system, t):
    """t summed over a sharded system's element group (t is this rank's
    partial); t itself for an unsharded system."""
    return t if system.comm is None else system.comm.all_reduce(t)


def _aa_reduce(system):
    return None if system.comm is None else system.comm.all_reduce


def _by_scene(t, S):
    """An element block (C, S*E) of a tiled system as (S, C*E): each row one
    scene's block, flattened as _flatten flattens it."""
    return t.reshape(t.shape[0], S, -1).transpose(0, 1).reshape(S, -1)


def _scene_shape(system):
    """Shape of a per-scene scalar: () for one scene, (S,) for S."""
    return () if system.n_scenes == 1 else (system.n_scenes,)


def _sqnorm_all(system, ts):
    """||concat(ts)||^2 as per-block sums added in block order; per scene,
    (S,), for a tiled system."""
    S = system.n_scenes
    if S == 1:
        out = sum((t * t).sum() for t in ts)
    else:
        out = sum((r * r).sum(1) for r in (_by_scene(t, S) for t in ts))
    return _reduce(system, out)


def _flatten(ts):
    return torch.cat([t.reshape(-1) for t in ts])


def _aa_flat(system, ts):
    """The AA iterate of element blocks: (d,), or (S, d) for S scenes."""
    S = system.n_scenes
    if S == 1:
        return _flatten(ts)
    return torch.cat([_by_scene(t, S) for t in ts], dim=1)


def _aa_unflat(system, flat, templates):
    """Inverse of _aa_flat into blocks shaped as `templates`."""
    S = system.n_scenes
    if S == 1:
        return _unflatten(flat, templates)
    out, off = [], 0
    for t in templates:
        size = t.numel() // S
        out.append(flat[:, off:off + size].reshape(S, t.shape[0], -1)
                   .transpose(0, 1).reshape(t.shape))
        off += size
    return tuple(out)


def _unflatten(flat, templates):
    out, off = [], 0
    for t in templates:
        size = t.numel()
        out.append(flat[off:off + size].reshape(t.shape))
        off += size
    return tuple(out)


def _reversed_axes(t):
    return t.permute(tuple(range(t.ndim - 1, -1, -1)))


def _flatten_ref(ts):
    """Element-major flatten of plane-form (C, E) blocks: the order of the
    text checkpoint format (element index outer, components inner), which is
    not the order of the blocks in memory."""
    return torch.cat([_reversed_axes(t).reshape(-1) for t in ts])


def _unflatten_ref(flat, templates):
    """Inverse of _flatten_ref back into plane-form blocks."""
    out, off = [], 0
    for t in templates:
        size = t.numel()
        out.append(_reversed_axes(flat[off:off + size].reshape(
            tuple(reversed(t.shape)))))
        off += size
    return tuple(out)


def _tree_leaves(tree, path=""):
    """(path, tensor) leaves of a carried state in a fixed order: dict keys
    in insertion order, tuple items, AAState fields, then tensors."""
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items()
                for leaf in _tree_leaves(v, f"{path}.{k}")]
    if isinstance(tree, tuple):
        return [leaf for i, v in enumerate(tree)
                for leaf in _tree_leaves(v, f"{path}[{i}]")]
    if isinstance(tree, anderson.AAState):
        return [leaf for f in dataclasses.fields(tree)
                for leaf in _tree_leaves(getattr(tree, f.name),
                                         f"{path}.{f.name}")]
    return [(path, tree)]


def _tree_unflatten(template, leaves):
    """A carried state of `template`'s structure holding `leaves` in the
    order of _tree_leaves."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(build(v) for v in t)
        if isinstance(t, anderson.AAState):
            return anderson.AAState(**{f.name: build(getattr(t, f.name))
                                       for f in dataclasses.fields(t)})
        return next(it)
    return build(template)


def _carry_fingerprint(carry):
    """Structure fingerprint of an ADMM loop carry for the .npz sidecar:
    each leaf's path (the carry's key order, the AA state's fields) with
    its dtype and shape."""
    return ",".join(f"{p}:{str(t.dtype).removeprefix('torch.')}"
                    f"{tuple(t.shape)}" for p, t in _tree_leaves(carry))


def _sync_dev(t):
    """Wait for the device that holds t (nothing to wait for on the CPU)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


# Keys of a step's carry that hold element blocks (tuples of (C, E) planes).
_BLOCKS = ("z", "u", "dz", "du")


def _select(cond, a, b):
    """{k: torch.where(cond, a[k], b[k])} over two carried states (dicts of
    tensors, AA states and tuples of element blocks), in a's key order.
    cond is 0-d, or (S,) per scene of a tiled system; then each value is
    chosen along its scene axis: the element columns for the keys named in
    _BLOCKS (which must hold tuples of element blocks, and only those keys
    may), the leading axis for every other key (vertex rows, per-scene
    scalars, an AA state)."""
    return {k: _where_scene(cond, a[k], b[k], k in _BLOCKS) for k in a}


def _where_scene(cond, a, b, blocks):
    if isinstance(a, tuple) != blocks:
        raise TypeError("element blocks are tuples under the keys of "
                        "_BLOCKS, and only those")
    if blocks:
        return tuple(_where_tensor(cond, x, y, True) for x, y in zip(a, b))
    if isinstance(a, anderson.AAState):
        return anderson.where(cond, a, b)
    return _where_tensor(cond, a, b, False)


def _where_tensor(cond, a, b, block):
    if cond.dim() == 0:
        return torch.where(cond, a, b)
    S = cond.shape[0]
    shape, c = ((a.shape[0], S, -1), cond[None, :, None]) if block \
        else ((S, -1), cond[:, None])
    return torch.where(c, a.reshape(shape), b.reshape(shape)).reshape(a.shape)


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
    first call for this system and key). A sharded system's calls hold
    collectives and run eagerly."""
    if not x.is_cuda or system.comm is not None:
        return fn(x)
    graphs = system.__dict__.setdefault("_graphs", {})
    if key not in graphs:
        with span("setup.capture"):
            graphs[key] = _GraphedCall(fn, x)
    return graphs[key](x)


# ----------------------------------------------------------------------------
# Shared per-step computations
# ----------------------------------------------------------------------------

def _local(system: PhysicsSystem, key, b, fn, x):
    """Batch b's prox or gradient fn(x): replayed from a graph (_graphed)
    where b.graphed, else called as it is (a tet batch with the Jacobi SVD
    is one kernel launch a call on the card, ops/cuda_kernels.py tet_prox
    and tet_grad, which a graph would only wrap in a copy in and a clone
    out)."""
    return _graphed(system, key, fn, x) if b.graphed else fn(x)


def _prox_all(system: PhysicsSystem, vs):
    # A shard may hold no element of a batch: its block is empty.
    return tuple(_local(system, ("prox", i), b, b.prox, v) if v.shape[-1]
                 else v for i, (b, v) in enumerate(zip(system.batches, vs)))


def _grad_all(system: PhysicsSystem, zs):
    return tuple(_local(system, ("grad", i), b, b.grad, z) if z.shape[-1]
                 else z for i, (b, z) in enumerate(zip(system.batches, zs)))


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


def _j_prim_norm(system, x_full, z):
    return torch.sqrt(_sqnorm_all(system, _prim_vec(system, x_full, z)))


def _j_add_prim(system, u, x_full, z):
    return _tmap(torch.add, u, _prim_vec(system, x_full, z))


def _j_winv_grad(system, z):
    return _tmap(lambda b, g: _wx(b, g, -1), system.batches,
                 _grad_all(system, z))


def _j_comb(system, x_full, z, z_ref):
    dual = _tmap(lambda b, a, c: _wx(b, a - c), system.batches, z, z_ref)
    return _sqnorm_all(system, dual + _prim_vec(system, x_full, z))


def _j_comb_zxu(system, x_full, last_x, z):
    """zxu combined residual ||Dx - Wz - C||^2 + ||WD(x - x_last)||^2
    (admm_anderson_hard_zxu/src/Solver.cpp:181-185)."""
    dual = _tmap(lambda b, a, c: _wx(b, a - c), system.batches,
                 system.deform(x_full), system.deform(last_x))
    return _sqnorm_all(system, _prim_vec(system, x_full, z) + dual)


def _solve_x(system: PhysicsSystem, M_xbar_free, z, u, c_blocks, base_full,
             x_warm=None, counts=None):
    """Global step: x = A^-1 (M xbar + dt2p * D^T W (W z + C - u))
    (Solver.cpp:148-149). c_blocks = F_b(pin embedding), constant per step.
    x_warm (full positions) warm-starts the CG path; the dense path is one
    matmul. CG iterations go into `counts`. A tiled system's
    S scenes are solved as the 3S columns of one (nf, 3S) block."""
    t = _tmap(lambda b, zb, ub, cb: _wx(b, zb - cb, 2) - _wx(b, ub),
              system.batches, z, u, c_blocks)
    s = system.scatter(t)
    fi = system.free_idx
    rhs = M_xbar_free + system.dt2p * s[fi]
    S = system.n_scenes
    if S == 1:
        cols = rows = lambda v: v
    else:
        def cols(v):                       # (S*nf, 3) -> (nf, 3S)
            return v.reshape(S, -1, 3).transpose(0, 1).reshape(-1, 3 * S)

        def rows(v):                       # (nf, 3S) -> (S*nf, 3)
            return v.reshape(-1, S, 3).transpose(0, 1).reshape(-1, 3)
    if system.solver is not None:
        xf = rows(system.solver.solve(cols(rhs)))
    else:
        def operator(vc):
            return cols(_graphed(system, "A", lambda v: _apply_A(system, v),
                                 rows(vc)))
        x0 = None if x_warm is None else cols(x_warm[fi])
        xf, n_it = pcg(operator, cols(rhs), system.precond_diag,
                       tol=system.cg_tol, max_iters=system.cg_max_iters,
                       x0=x0)
        xf = rows(xf)
        if counts is not None:
            counts["cg_iters"] += n_it
    return base_full.index_copy(0, fi, xf)


def _predict(system: PhysicsSystem, x, v, pin_pos):
    """Explicit forces + gravity + inertia prediction (Solver.cpp:50-81)."""
    dt = system.dt
    free = system.free_mask[:, None]
    if system.wind is not None:
        v = system.wind.apply(dt, x, v, system.n_verts)
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
    aa0 = anderson.init(system.anderson_m, _aa_flat(system, z))
    carry = dict(x=x_full, z=z, u=u, dx=x_full, dz=z, du=u, aa=aa0,
                 **_loop_flags(system, x))
    consts = dict(M=M_xbar_free, c=c_blocks, base=base_full)
    return carry, consts


def _loop_flags(system, x):
    """The loop's per-scene scalars at its start: the last primal residual,
    the eps-break flag and the reset count."""
    shape, kw = _scene_shape(system), dict(device=x.device)
    return dict(prev=torch.full(shape, 1e20, dtype=x.dtype, **kw),
                done=torch.zeros(shape, dtype=torch.bool, **kw),
                resets=torch.zeros(shape, dtype=torch.int64, **kw))


def _xzu_body(system: PhysicsSystem, consts, counts=None):
    """One xzu ADMM iteration (Solver.cpp:120-250) as a function of the
    carried state: returns (carry, (prim, comb, reject))."""
    M_xbar_free, c_blocks, base_full = consts["M"], consts["c"], consts["base"]
    accel = system.accel

    def solve(z, u, x_warm=None):
        return _solve_x(system, M_xbar_free, z, u, c_blocks, base_full,
                        x_warm=x_warm, counts=counts)

    def body(carry):
        cx, cz, cu = carry["x"], carry["z"], carry["u"]
        dx_, dz_, du_ = carry["dx"], carry["dz"], carry["du"]
        aa = carry["aa"]

        # Spans: step.local around the gradient and the prox (kernel
        # launches and graph replays), step.global around the x-solve with
        # its residual and reject branch, step.comb around the whole
        # combined residual (its own solve and z-update open no span of
        # their own).
        if accel:
            # u <- W^-1 grad U(z) (Solver.cpp:127-133)
            with span("step.local"):
                cu = _j_winv_grad(system, cz)
        else:
            # u += Dx - Wz - C (Solver.cpp:138-141)
            cu = _j_add_prim(system, cu, cx, cz)

        with span("step.global"):
            cx = solve(cz, cu, x_warm=cx)
            prim = _j_prim_norm(system, cx, cz)

            if accel:
                rejected = carry["prev"] < prim

                def do_reject():
                    aa2 = anderson.replace(aa, _aa_flat(system, dz_))
                    cu2 = _j_add_prim(system, du_, dx_, dz_)
                    cx2 = solve(dz_, cu2)
                    prim2 = _j_prim_norm(system, cx2, dz_)
                    return dict(x=cx2, z=dz_, u=cu2, aa=aa2, prim=prim2)

                kept = dict(x=cx, z=cz, u=cu, aa=aa, prim=prim)
                # dense: both branches, chosen on the device; CG: the
                # reject branch only when the host read finds a reject
                if (system.solver is not None
                        or bool(host_read(rejected.any()))):
                    cx, cz, cu, aa, prim = _select(
                        rejected, do_reject(), kept).values()
            else:
                rejected = torch.zeros_like(prim, dtype=torch.bool)

        prev = prim
        ndx, ndu = cx, cu
        if accel:
            with span("step.local"):
                ndz = _update_z(system, cx, cu)
            aa, zflat = anderson.compute(aa, _aa_flat(system, ndz),
                                         _aa_reduce(system))
            cz = _aa_unflat(system, zflat, ndz)
        else:
            last_z = cz
            with span("step.local"):
                cz = _update_z(system, cx, cu)
            ndz = cz

        # Diagnostic combined residual (Solver.cpp:216-238).
        if system.collect_comb:
            with span("step.comb"):
                if accel:
                    comb_x = solve(ndz, cu)
                    comb_z = _update_z(system, comb_x, cu)
                    comb = _j_comb(system, comb_x, comb_z, ndz)
                else:
                    comb = _j_comb(system, cx, cz, last_z)
        else:
            comb = torch.full_like(prim, float("inf"))

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
    curr_x (Solver.cpp:255-257); accelerated zxu commits default_x, not the
    AA-mixed x (zxu Solver.cpp:216-223)."""
    if system.order == "zxu" and system.accel:
        return carry["dx"]
    return carry["x"]


def _step_setup(system: PhysicsSystem, x, v, pin_pos, counts=None):
    """The system's order's prediction and init sweep: (carry, consts).
    Its host reads and CG iterations go into `counts`."""
    setup = _xzu_setup if system.order == "xzu" else _zxu_setup
    with _reads_into(counts):
        return setup(system, x, v, pin_pos, counts)


def _step_scan_chunk(system: PhysicsSystem, carry, consts, length: int,
                     counts=None):
    """`length` (>= 1) ADMM iterations from `carry`: (carry, (prims, combs,
    rejects)), each (length,). Their host reads and CG iterations go into
    `counts`."""
    factory = _xzu_body if system.order == "xzu" else _zxu_body
    body = factory(system, consts, counts)
    recs = []
    with _reads_into(counts):
        for _ in range(length):
            carry, rec = body(carry)
            recs.append(rec)
    return carry, tuple(torch.stack([r[i] for r in recs]) for i in range(3))


def _cat_chunks(outs):
    """(prims, combs, rejects) of consecutive _step_scan_chunk outputs."""
    return tuple(torch.cat([o[i] for o in outs]) for i in range(3))


def _step_commit(system: PhysicsSystem, carry, x0, prims, combs, rejects):
    """The committed positions and velocities and the StepTrace."""
    x_new = _commit_x(system, carry)
    v_new = (x_new - x0) / system.dt
    n_valid = (~torch.isnan(prims)).sum(0)
    return x_new, v_new, StepTrace(prims, combs, rejects, n_valid,
                                   carry["resets"])


def _run_step(system: PhysicsSystem, x, v, pin_pos, counts):
    """One timestep of the system's order: (x_new, v_new, StepTrace)."""
    carry, consts = _step_setup(system, x, v, pin_pos, counts)
    carry, ys = _step_scan_chunk(system, carry, consts, system.admm_iters,
                                 counts)
    return _step_commit(system, carry, x, *ys)


def step_xzu(system: PhysicsSystem, x, v, pin_pos, counts=None):
    """One xzu timestep: (x_new, v_new, StepTrace)."""
    return _run_step(system, x, v, pin_pos, counts)


# ---- instrumented steps: the same algorithm as a host loop of phases ----

def _phase_tools(system, x, v, pin_pos, counts):
    """What both instrumented steps share: the prediction's constants, the
    x-solve and the host read of a residual."""
    v, xbar_full, base_full = _predict(system, x, v, pin_pos)
    fi = system.free_idx
    M_xbar_free = system.masses[fi, None] * xbar_full[fi]
    c_blocks = system.deform(base_full)

    def solve(z, u, x_warm=None):
        return _solve_x(system, M_xbar_free, z, u, c_blocks, base_full,
                        x_warm=x_warm, counts=counts)

    def read(s):
        return float(host_read(s))
    return xbar_full, base_full, solve, read


def step_xzu_instrumented(system: PhysicsSystem, x, v, pin_pos,
                          runtime: RuntimeData, log=None, counts=None):
    """Per-phase instrumented xzu step (JAX physics.py:465-561): the
    algorithm of ``step_xzu`` as a host loop of phases that accumulates the
    reference's RuntimeData buckets (global, local, acceleration,
    initialization ms, Solver.cpp:102-244) and appends one cumulative time
    per recorded iteration to ``runtime.step_time``. Each phase ends in a
    device synchronization; each residual is read on the host. CG
    iterations go into `counts`. On the card the prox, gradient and CG
    operator replay the fused step's CUDA graphs.

    log: optional core.solverlog.SolverLog, fed the positions after each
    global solve (SolverLog.hpp:44-60). Returns (x_new, v_new, prims,
    combs, resets) with numpy residuals."""
    t = MicroTimer()
    xbar_full, base_full, solve, read = _phase_tools(system, x, v, pin_pos,
                                                     counts)
    z = system.deform(xbar_full)
    u = _tmap(torch.zeros_like, z)
    x_full = solve(z, u)
    z = _update_z(system, x_full, u)
    aa = anderson.init(max(system.anderson_m, 1), _flatten(z))
    _sync_dev(x_full)
    runtime.initialization_ms += t.elapsed_ms()

    dx_, dz_, du_ = x_full, z, u
    prev_prim = float("inf")
    prims, combs = [], []
    resets = 0
    cx, cz, cu = x_full, z, u
    accel = system.accel
    for _ in range(system.admm_iters):
        t.reset()
        cu = (_j_winv_grad(system, cz) if accel
              else _j_add_prim(system, cu, cx, cz))
        _sync_dev(cx)
        runtime.local_ms += t.elapsed_ms()

        t.reset()
        cx = solve(cz, cu)
        _sync_dev(cx)
        runtime.global_ms += t.elapsed_ms()
        runtime.inner_iters += 1

        t.reset()
        prim = read(_j_prim_norm(system, cx, cz))
        if accel and prev_prim < prim:
            resets += 1
            cx, cz, cu = dx_, dz_, du_
            aa = anderson.replace(aa, _flatten(cz))
            cu = _j_add_prim(system, cu, cx, cz)
            cx = solve(cz, cu)
            prim = read(_j_prim_norm(system, cx, cz))
        prev_prim = prim
        runtime.acceleration_ms += t.elapsed_ms()

        t.reset()
        if accel:
            dx_, du_ = cx, cu
            dz_ = _update_z(system, cx, cu)
            aa, zflat = anderson.compute(aa, _flatten(dz_))
            cz = _unflatten(zflat, dz_)
        else:
            last_z = cz
            cz = _update_z(system, cx, cu)
            dz_ = cz
        _sync_dev(cx)
        runtime.local_ms += t.elapsed_ms()

        if system.collect_comb:
            if accel:
                comb_x = solve(dz_, cu)
                comb_z = _update_z(system, comb_x, cu)
                comb = read(_j_comb(system, comb_x, comb_z, dz_))
            else:
                comb = read(_j_comb(system, cx, cz, last_z))
        else:
            comb = float("inf")
        prims.append(prim)
        combs.append(comb)
        if log is not None:
            log.add(host_read(cx).numpy().ravel())
        runtime.step_time.append(runtime.local_ms + runtime.global_ms
                                 + runtime.acceleration_ms)
        if comb < _EPS_BREAK:
            break

    v_new = (cx - x) / system.dt
    return cx, v_new, np.asarray(prims), np.asarray(combs), resets


# ----------------------------------------------------------------------------
# z -> x -> u (AA on (u, x)) — admm_anderson_hard_zxu/src/Solver.cpp:34-234
# ----------------------------------------------------------------------------

def _flat_ux(system, u, xf):
    """The zxu AA iterate: the u blocks, then the free positions; (d,), or
    (S, d) for S scenes."""
    return torch.cat([_aa_flat(system, u),
                      xf.reshape(*_scene_shape(system), -1)], dim=-1)


def _u_size(system, u):
    """One scene's length of the u head of the zxu AA iterate."""
    return sum(t.numel() for t in u) // system.n_scenes


def _zxu_setup(system: PhysicsSystem, x, v, pin_pos, counts=None):
    """Prediction + init sweep for the zxu order (zxu Solver.cpp:97-125:
    z-prox, x-solve, u-update). Returns (carry, consts) — see _xzu_setup."""
    v, xbar_full, base_full = _predict(system, x, v, pin_pos)
    fi = system.free_idx
    M_xbar_free = system.masses[fi, None] * xbar_full[fi]
    c_blocks = system.deform(base_full)

    u = tuple(torch.zeros_like(zb) for zb in system.deform(xbar_full))
    z = _update_z(system, xbar_full, u)
    x_full = _solve_x(system, M_xbar_free, z, u, c_blocks, base_full,
                      counts=counts)
    u = _tmap(torch.add, u, _prim_vec(system, x_full, z))
    aa0 = anderson.init(max(system.anderson_m, 1),
                        _flat_ux(system, u, x_full[fi]),
                        effective_dim=_u_size(system, u))
    carry = dict(x=x_full, z=z, u=u, dx=x_full, du=u, aa=aa0,
                 **_loop_flags(system, x))
    consts = dict(M=M_xbar_free, c=c_blocks, base=base_full)
    return carry, consts


def _zxu_body(system: PhysicsSystem, consts, counts=None):
    """One zxu ADMM iteration (zxu Solver.cpp:128-212) as a function of the
    carried state: returns (carry, (prim, comb, reject))."""
    M_xbar_free, c_blocks, base_full = consts["M"], consts["c"], consts["base"]
    accel = system.accel
    fi = system.free_idx

    def body(carry):
        cx, cu, aa = carry["x"], carry["u"], carry["aa"]
        done = carry["done"]

        cz = _update_z(system, cx, cu)
        prim = _j_prim_norm(system, cx, cz)
        if accel:
            rejected = carry["prev"] < prim
            # Frozen iterations (done) discard their result: no reject run.
            redo = rejected & ~done
            if bool(host_read(redo.any())):
                ru, rx = carry["du"], carry["dx"]
                rz = _update_z(system, rx, ru)
                cu, cx, aa, cz, prim = _select(redo, dict(
                    u=ru, x=rx, aa=anderson.reset(aa, _flat_ux(system, ru,
                                                              rx[fi])),
                    z=rz, prim=_j_prim_norm(system, rx, rz)),
                    dict(u=cu, x=cx, aa=aa, z=cz, prim=prim)).values()
        else:
            rejected = torch.zeros_like(prim, dtype=torch.bool)

        last_x, prev = cx, prim
        cx = _solve_x(system, M_xbar_free, cz, cu, c_blocks, base_full,
                      x_warm=last_x, counts=counts)

        # Combined residual (zxu Solver.cpp:181-185).
        F = system.deform(cx)
        prim_v = _tmap(lambda b, f, zb: _wx(b, f - zb), system.batches, F, cz)
        dual = _tmap(lambda b, a, c: _wx(b, a - c), system.batches, F,
                     system.deform(last_x))
        comb = _sqnorm_all(system, prim_v + dual)
        done_now = comb < _EPS_BREAK

        # u-update + AA happen only if the eps-break did not fire
        # (zxu Solver.cpp:188-207: the break precedes them).
        ndu = _tmap(torch.add, cu, prim_v)
        ndx = cx
        if accel:
            aa3, mixed = anderson.compute(aa, _flat_ux(system, ndu, cx[fi]),
                                          _aa_reduce(system))
            zu = _u_size(system, ndu)
            cu3 = _aa_unflat(system, mixed[..., :zu], ndu)
            cx3 = base_full.index_copy(0, fi, mixed[..., zu:].reshape(-1, 3))
        else:
            cu3, cx3, aa3 = ndu, cx, aa
        cu3, cx3, aa3, ndu, ndx = _select(
            done_now, dict(u=cu, x=cx, aa=aa, du=carry["du"], dx=carry["dx"]),
            dict(u=cu3, x=cx3, aa=aa3, du=ndu, dx=ndx)).values()

        new = dict(x=cx3, z=cz, u=cu3, dx=ndx, du=ndu, prev=prev, aa=aa3,
                   done=done | done_now,
                   resets=carry["resets"] + rejected.to(torch.int64))
        out = _select(done, carry, new)
        # zxu records residuals only for iterations that did not break
        # (the push_back at Solver.cpp:209-212 follows the break).
        valid = ~done & ~done_now
        nan = torch.full_like(prim, float("nan"))
        return out, (torch.where(valid, prim, nan),
                     torch.where(valid, comb, nan),
                     (rejected & valid).to(torch.int64))

    return body


def step_zxu(system: PhysicsSystem, x, v, pin_pos, counts=None):
    """One zxu timestep: (x_new, v_new, StepTrace)."""
    return _run_step(system, x, v, pin_pos, counts)


def step_zxu_instrumented(system: PhysicsSystem, x, v, pin_pos,
                          runtime: RuntimeData, counts=None):
    """Per-phase instrumented zxu step (JAX physics.py:603-695), as
    step_xzu_instrumented: local = the z-prox sweep, global = the x-solve,
    acceleration = the reject test and the AA mixing. The eps-break comes
    before the u-update and is not recorded (Solver.cpp:188-212); an
    accelerated step commits default_x. Returns (x_new, v_new, prims,
    combs, rejects, resets)."""
    t = MicroTimer()
    xbar_full, base_full, solve, read = _phase_tools(system, x, v, pin_pos,
                                                     counts)
    fi = system.free_idx
    # Init sweep (zxu Solver.cpp:97-125): z-prox, x-solve, u-update.
    u = tuple(torch.zeros_like(zb) for zb in system.deform(xbar_full))
    z = _update_z(system, xbar_full, u)
    x_full = solve(z, u)
    u = _j_add_prim(system, u, x_full, z)
    zu_size = sum(t_.numel() for t_ in u)
    aa = anderson.init(max(system.anderson_m, 1),
                       _flat_ux(system, u, x_full[fi]), effective_dim=zu_size)
    _sync_dev(x_full)
    runtime.initialization_ms += t.elapsed_ms()

    accel = system.accel
    cx, cu = x_full, u
    dx_, du_ = x_full, u
    prev_prim = float("inf")
    prims, combs, rejects = [], [], []
    resets = 0
    for _ in range(system.admm_iters):
        t.reset()
        cz = _update_z(system, cx, cu)
        _sync_dev(cx)
        runtime.local_ms += t.elapsed_ms()

        t.reset()
        prim = read(_j_prim_norm(system, cx, cz))
        rejected = 0
        if accel and prev_prim < prim:
            resets += 1
            rejected = 1
            cu, cx = du_, dx_
            aa = anderson.reset(aa, _flat_ux(system, cu, cx[fi]))
            cz = _update_z(system, cx, cu)
            prim = read(_j_prim_norm(system, cx, cz))
        prev_prim = prim
        runtime.acceleration_ms += t.elapsed_ms()

        t.reset()
        last_x = cx
        cx = solve(cz, cu, x_warm=last_x)
        _sync_dev(cx)
        runtime.global_ms += t.elapsed_ms()
        runtime.inner_iters += 1

        comb = read(_j_comb_zxu(system, cx, last_x, cz))
        if comb < _EPS_BREAK:
            break

        t.reset()
        cu = _j_add_prim(system, cu, cx, cz)
        du_, dx_ = cu, cx
        if accel:
            aa, mixed = anderson.compute(aa, _flat_ux(system, cu, cx[fi]))
            cu = _unflatten(mixed[:zu_size], cu)
            cx = base_full.index_copy(0, fi, mixed[zu_size:].reshape(-1, 3))
        _sync_dev(cx)
        runtime.acceleration_ms += t.elapsed_ms()

        prims.append(prim)
        combs.append(comb)
        rejects.append(rejected)
        runtime.step_time.append(runtime.local_ms + runtime.global_ms
                                 + runtime.acceleration_ms)

    x_new = dx_ if accel else cx
    v_new = (x_new - x) / system.dt
    return (x_new, v_new, np.asarray(prims), np.asarray(combs),
            np.asarray(rejects, np.int64), resets)


def run_frames(system: PhysicsSystem, x, v, pin_pos, n_frames: int,
               pin_vel=None, counts=None):
    """n_frames timesteps in a row. pin_vel (n, 3) moves the pins by
    dt*pin_vel before each step, as a per-frame `set_pins` callback like
    beams' stretch does (beams.cpp:66-92). Returns (x, v, final pin_pos,
    traces) with each trace field stacked (n_frames, iters)."""
    step = step_xzu if system.order == "xzu" else step_zxu
    traces = []
    for _ in range(n_frames):
        if pin_vel is not None:
            pin_pos = pin_pos + system.dt * pin_vel
        x, v, tr = step(system, x, v, pin_pos, counts)
        traces.append(tr)
    stacked = StepTrace(*(torch.stack([getattr(t, f) for t in traces])
                          for f in StepTrace._fields))
    return x, v, pin_pos, stacked


def _detect_self_contacts(colliders, x, idx):
    """Penetrations of vertices `idx` into every dynamic collider at
    positions x: per-vertex (active, deformed contact point, deformed
    outward normal) and the spatial hash's overflow flag (True: candidates
    were cut, contacts may be missing, the caller must escalate). The first
    collider hit wins (the reference keeps one payload per vertex,
    Collider.hpp:159-210)."""
    q = x[idx]
    P = q.shape[0]
    active = torch.zeros((P,), dtype=torch.bool, device=x.device)
    target = q
    normal = torch.zeros((P, 3), dtype=x.dtype, device=x.device)
    overflow = torch.zeros((), dtype=torch.bool, device=x.device)
    for dc in colliders:
        h, ovf = dc.detect_with_overflow(q, x, query_ids=idx)
        overflow = overflow | ovf
        fv = dc.faces[h.face]                         # (P, 3) local ids
        tri_def = x[fv + dc.vert_offset]              # (P, 3, 3)
        b = h.barys
        tgt = (b[:, 0, None] * tri_def[:, 0] + b[:, 1, None] * tri_def[:, 1]
               + b[:, 2, None] * tri_def[:, 2])
        c_def = _cross(tri_def[:, 1] - tri_def[:, 0],
                       tri_def[:, 2] - tri_def[:, 0])
        # Carry the rest-pose outward orientation to the deformed face.
        tri_rest = dc.rest_verts[fv]
        c_rest = _cross(tri_rest[:, 1] - tri_rest[:, 0],
                        tri_rest[:, 2] - tri_rest[:, 0])
        nrm = torch.sign(_dot3(c_rest, h.normal))[:, None] * c_def
        nrm = nrm / torch.clamp_min(torch.sqrt(_dot3(nrm, nrm)), 1e-300)[:, None]
        new = (h.hit & ~active)[:, None]
        active = active | h.hit
        target = torch.where(new, tgt, target)
        normal = torch.where(new, nrm, normal)
    return active, target, normal, overflow


# ----------------------------------------------------------------------------
# Host orchestration — the public API surface of admm::Solver
# ----------------------------------------------------------------------------

class PhysicsSolver:
    """Host-side scene builder + stepper (admm::Solver public API:
    add_nodes / set_pins / add_obstacle / set_collisions / initialize /
    step / save, Solver.hpp:95-151). ``device`` defaults to CUDA and raises
    without it."""

    def __init__(self, order: UpdateOrder | str = UpdateOrder.XZU,
                 dense_threshold: int = 12000, device=None):
        self.order = UpdateOrder(order)
        self.dense_threshold = dense_threshold
        self.device = resolve_device(device)
        self.verts: List[np.ndarray] = []
        self.masses: List[np.ndarray] = []
        self._tet_groups = []      # (tets, lame, kind) with global indices
        self._tri_groups = []      # (faces, lame) with global indices
        self.pins: dict[int, np.ndarray] = {}
        self.collisions: dict[int, np.ndarray] = {}
        self.sdf_builder = SdfSceneBuilder()
        self.mesh_obstacles: List[TetMeshSdf] = []
        self.dynamic_colliders: List[DynamicTetCollider] = []
        self._selfcol_index: Optional[int] = None
        self.wind: Optional[WindForce] = None
        self.system: Optional[PhysicsSystem] = None
        self._x_dev = None
        self._v_dev = None
        self._x_host: Optional[np.ndarray] = None
        self._v_host: Optional[np.ndarray] = None
        self._pending_traces: List[StepTrace] = []
        # Per queued trace: None (the step's time spread uniformly) or
        # (chunk size, cumulative ms at each chunk boundary) of a chunked
        # step.
        self._pending_times: List[Optional[tuple]] = []
        # Mid-step ADMM state from load_admm_state, consumed by the next
        # step() (Solver::load replay, Solver.hpp:153-215).
        self._admm_seed = None
        self.settings = Settings()
        self.initialized = False
        # residual history across steps (for save())
        self.step_prim: List[float] = []
        self.step_comb: List[float] = []
        self.step_reject: List[int] = []
        self.step_times: List[float] = []
        self.step_ms: List[float] = []    # wall ms of each step()/run() step
        self.reset_num = 0
        self.stats = _counts()
        # per-phase buckets of the instrumented steps (callers may replace it)
        self.runtime = RuntimeData()

    # ---- scene assembly ----

    @property
    def n_verts(self) -> int:
        return sum(len(v) for v in self.verts)

    def add_tetmesh(self, verts, tets, lame: Lame, kind: str = "linear",
                    density: float = 1522.0, self_collision: bool = False):
        """binding::add_tetmesh (AddMeshes.hpp:97-177): lumped masses at
        rubber density 1522 kg/m^3, node append, per-tet energy terms.
        self_collision=True registers the mesh as a dynamic collider (the
        binding's default unless NOSELFCOLLISION, AddMeshes.hpp:124-137),
        which the xzu order refuses at initialize()."""
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
            self.add_dynamic_collider(mesh.verts, mesh.tets,
                                      vert_offset=offset)
        return offset

    def add_dynamic_collider(self, verts, tets, vert_offset: int = 0,
                             n_buckets: int = 2048, cap: int = 16):
        """Solver::add_dynamic_collider (Solver.hpp:103-110 /
        TetMeshCollision): a deforming tet mesh for self and mutual
        collision, detected every step through the spatial-hash grid."""
        self.dynamic_colliders.append(HashGridTetCollider.create(
            verts, tets, vert_offset=vert_offset, n_buckets=n_buckets,
            cap=cap, device=self.device))

    def add_trimesh(self, verts, faces, lame: Lame, density: float = 1.0,
                    thickness: float = 1.0):
        """binding::add_trimesh (AddMeshes.hpp:180-235): cloth surface with
        area-lumped masses at density 1.0 kg/m^2 (the reference's
        placeholder value, AddMeshes.hpp:189)."""
        offset = self.n_verts
        verts = np.asarray(verts, np.float64)
        faces = np.asarray(faces, np.int32)
        e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
        e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
        area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
        m = np.zeros(len(verts))
        np.add.at(m, faces.ravel(),
                  np.repeat(density * thickness * area / 3.0, 3))
        self.verts.append(verts)
        self.masses.append(np.maximum(m, 1e-12))
        self._tri_groups.append((faces + offset, lame))
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
        """Solver::add_obstacle — analytic passive colliders ("floor",
        "slide_floor", "sphere", "plane_half_sphere", "cylinder"), or a
        static tet-mesh obstacle (PassiveMesh) with kind='mesh'
        (verts=..., tets=...)."""
        if kind == "mesh":
            self.mesh_obstacles.append(TetMeshSdf.create(**kw))
        else:
            getattr(self.sdf_builder, f"add_{kind}")(**kw)

    def set_wind(self, faces, direction, alpha_n: float = 1000.0,
                 mode: str = "jacobi"):
        """The aerodynamic pre-ADMM velocity kick (ExplicitForce.cpp:47-104);
        mode 'jacobi' (one scatter) or 'sequential' (the reference's loop on
        one thread) — see WindForce."""
        if mode not in ("jacobi", "sequential"):
            raise ValueError(f"unknown wind mode {mode!r}")
        self.wind = WindForce(
            faces=torch.from_numpy(
                np.asarray(faces, np.int64).reshape(-1, 3)).to(self.device),
            direction=torch.from_numpy(np.asarray(
                direction, np.dtype(self.settings.dtype))).to(self.device),
            alpha_n=alpha_n, mode=mode)

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

    def _collision_batches(self, n, dtype):
        """The collision and self-collision batches, with the JAX package's
        refusals of both in the xzu order."""
        zxu = self.order == UpdateOrder.ZXU
        out = []
        if self.collisions:
            if not zxu:
                raise ValueError(
                    "collision energy terms exist only in the zxu variant "
                    "(reference forbids obstacles with the LDLT xzu solver, "
                    "Solver.cpp:486-489)")
            out.append(CollisionBatch.create(
                sorted(self.collisions), self.sdf_builder.build(dtype),
                mesh_sdfs=self.mesh_obstacles, dtype=dtype))
        elif (self.sdf_builder.n_objects or self.mesh_obstacles) and not zxu:
            raise ValueError("No collisions with the LDLT (xzu) solver")
        if self.dynamic_colliders:
            if not zxu:
                raise ValueError(
                    "dynamic/self collision needs the zxu collision-energy "
                    "path (reference forbids obstacles with the LDLT xzu "
                    "solver, Solver.cpp:486-489)")
            self.dynamic_colliders = [cast_floats(dc, None, self.device)
                                      for dc in self.dynamic_colliders]
            out.append(SelfCollisionBatch.create(np.arange(n), dtype=dtype))
        return out

    @spanned("setup.build")
    def initialize(self, settings: Optional[Settings] = None) -> bool:
        """Solver::initialize (Solver.cpp:373-498): element batches, the
        free/fixed split, and the prefactored global system (the dense
        inverse while n_free <= dense_threshold, else the Jacobi diagonal
        for CG)."""
        if settings is not None:
            self.settings = settings
        s = self.settings
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
        zxu = self.order == UpdateOrder.ZXU
        batches = [TetBatch.from_mesh(x, tets, lame, kind=kind, dtype=dtype)
                   for tets, lame, kind in self._tet_groups]
        batches += [TriBatch.from_mesh(x, faces, lame,
                                       variant="zxu" if zxu else "xzu",
                                       dtype=dtype)
                    for faces, lame in self._tri_groups]
        batches += self._collision_batches(n, dtype)
        self._selfcol_index = (len(batches) - 1 if self.dynamic_colliders
                               else None)

        free_mask = np.ones(n, bool)
        for idx in self.pins:
            free_mask[idx] = False
        free_idx = np.nonzero(free_mask)[0]
        nf = len(free_idx)
        dt2p = (s.penalty if zxu else 1.0) * s.timestep_s ** 2

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
            solver=solver, precond_diag=precond,
            wind=None if self.wind is None else cast_floats(self.wind, tdt,
                                                            dev),
            n_verts=n, n_free=nf,
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

    @spanned("step")
    def step(self) -> StepTrace:
        """One timestep (Solver::step). Updates x, v on the device and
        queues the residual trace; flush_traces()/save() fetch the history.
        Returns the per-iteration trace (device tensors). With dynamic
        colliders, this step's self-contacts are detected first. A state
        from load_admm_state seeds this step's ADMM loop; with
        ``settings.trace_chunk`` > 0 (read here, so it may be set after
        initialize) the step runs in timed chunks of that many iterations."""
        self._check_ready()
        if self._selfcol_index is not None:
            self._refresh_self_contacts()
        t = MicroTimer()
        measured = None
        chunk = int(self.settings.trace_chunk)
        if self._admm_seed is not None:
            x_new, v_new, trace = self._step_seeded(self._admm_seed)
            self._admm_seed = None
        elif chunk > 0:
            x_new, v_new, trace, bounds = self._step_chunked(chunk)
            measured = (chunk, bounds)
        else:
            fn = step_xzu if self.order == UpdateOrder.XZU else step_zxu
            x_new, v_new, trace = fn(self.system, self._x_dev, self._v_dev,
                                     self._pin_pos_dev(), self.stats)
        self._sync()
        self._finish_step(x_new, v_new, trace, t.elapsed_ms(), measured)
        return trace

    def _finish_step(self, x_new, v_new, trace, elapsed_ms, measured=None):
        self._x_dev, self._v_dev = x_new, v_new
        self._x_host = self._v_host = None
        self._pending_traces.append(trace)
        self._pending_times.append(measured)
        self.step_ms.append(elapsed_ms)
        if self.settings.verbose > 0:
            print(f"step: {elapsed_ms:.2f}ms, "
                  f"reset number = {int(trace.reset_count)}")

    def _step_chunked(self, chunk: int):
        """The fused step dispatched in chunks of `chunk` iterations, the
        device synchronized at each chunk boundary, so that the residual
        file's time column is measured there (every row with chunk 1, as
        the reference's Solver.hpp:126-151) instead of spread. Returns (x,
        v, trace, bounds): bounds = cumulative ms at [init, chunk 1, ...]."""
        x0 = self._x_dev
        t = MicroTimer()
        carry, consts = _step_setup(self.system, x0, self._v_dev,
                                    self._pin_pos_dev(), self.stats)
        self._sync()
        bounds = [t.elapsed_ms()]
        self.runtime.initialization_ms += bounds[0]
        outs = []
        done, iters = 0, self.system.admm_iters
        while done < iters:
            k = min(chunk, iters - done)
            carry, ys = _step_scan_chunk(self.system, carry, consts, k,
                                         self.stats)
            self._sync()
            bounds.append(t.elapsed_ms())
            outs.append(ys)
            done += k
        return (*_step_commit(self.system, carry, x0, *_cat_chunks(outs)),
                bounds)

    def run(self, n_frames: int, pin_vel=None):
        """n_frames timesteps, equivalent to n_frames step() calls (each
        after a `set_pins(pins + dt*pin_vel)` when pin_vel is given), for
        scenes without self-collision (which detects contacts per step),
        without a loaded ADMM state and without chunked tracing."""
        self._check_ready()
        if self._selfcol_index is not None:
            raise RuntimeError("self-collision detects contacts every "
                               "step: use step()")
        if self._admm_seed is not None or self.settings.trace_chunk > 0:
            raise RuntimeError("a loaded ADMM state or trace_chunk > 0 "
                               "needs step()")
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
            self._pending_times.append(None)
            self.step_ms.append(elapsed / n_frames)
        if self.settings.verbose > 0:
            print(f"run({n_frames}): {elapsed:.2f}ms total, "
                  f"{elapsed / n_frames:.2f}ms/step")
        return traces

    def _refresh_self_contacts(self):
        """Detect self-contacts at the current positions and copy them
        (deformed surface point + outward normal) into the
        SelfCollisionBatch's tensors in place, for this step's ADMM
        iterations — the per-step analogue of the reference's per-step BVH
        rebuild + detect (DynamicObject.hpp:65-68, Collider.hpp:152-212).
        One host read per detection (the overflow flag)."""
        b = self.system.batches[self._selfcol_index]
        with _reads_into(self.stats):
            while True:
                active, target, normal, overflow = _detect_self_contacts(
                    tuple(self.dynamic_colliders), self._x_dev, b.idx)
                if not bool(host_read(overflow)):
                    break
                # A spatial-hash bucket exceeded its candidate cap, so contacts
                # may have been dropped. Escalate and detect again (the
                # exactness of the reference BVH, DynamicObject.hpp:65-118).
                self._escalate_colliders()
        b.active.copy_(active)
        b.target.copy_(target)
        b.normal.copy_(normal)

    def _escalate_colliders(self):
        """Grow overflowing spatial-hash colliders (cap x2); swap to the
        exact dense collider when the grown candidate window would scan a
        comparable number of tets anyway."""
        out = []
        for dc in self.dynamic_colliders:
            if isinstance(dc, HashGridTetCollider):
                new_cap = dc.cap * 2
                if new_cap * 27 >= dc.tets.shape[0]:
                    dc = DynamicTetCollider(tets=dc.tets, faces=dc.faces,
                                            rest_verts=dc.rest_verts,
                                            vert_offset=dc.vert_offset)
                    if self.settings.verbose > 0:
                        print("self-collision: hash overflow -> dense")
                else:
                    dc = dataclasses.replace(dc, cap=new_cap)
                    if self.settings.verbose > 0:
                        print(f"self-collision: hash overflow -> cap={new_cap}")
            out.append(dc)
        self.dynamic_colliders = out

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
        fetch per trace)."""
        if not self._pending_traces:
            return
        n = len(self._pending_traces)
        host = [StepTrace(*(a.cpu().numpy() for a in tr))
                for tr in self._pending_traces]
        measured = self._pending_times
        self._pending_traces, self._pending_times = [], []
        for trace, elapsed, meas in zip(host, self.step_ms[-n:], measured):
            iter_t = self._iter_times(elapsed, meas)
            t0 = self.step_times[-1] if self.step_times else 0.0
            for i in np.nonzero(~np.isnan(trace.prim))[0]:
                self.step_prim.append(float(trace.prim[i]))
                self.step_comb.append(float(trace.comb[i]))
                self.step_reject.append(int(trace.reject[i]))
                self.step_times.append(t0 + iter_t[i])
            self.reset_num += int(trace.reset_count)

    def _iter_times(self, elapsed, measured):
        """Per-iteration cumulative ms within one step: a fused step's time
        spread uniformly; a chunked step's interpolated only inside each
        measured chunk (every row measured at trace_chunk 1)."""
        iters = self.system.admm_iters
        if measured is None:
            per = elapsed / max(1, iters)
            return [(i + 1) * per for i in range(iters)]
        chunk, bounds = measured
        ts = []
        for i in range(iters):
            j, r = divmod(i, chunk)
            k_j = min(chunk, iters - j * chunk)
            lo, hi = bounds[j], bounds[j + 1]
            ts.append(lo + (r + 1) / k_j * (hi - lo))
        return ts

    def step_instrumented(self, log=None):
        """One timestep with the RuntimeData buckets accumulated in
        ``self.runtime`` (RuntimeData::print, Solver.cpp:551-564): a host
        loop of phases, slower than step(). log (xzu only): a SolverLog fed
        the per-iteration positions. Returns (prims, combs) as numpy.

        Each iteration's time row is this step's own: the time of the last
        recorded row plus the phase time this step accumulated up to that
        iteration (the JAX package indexes runtime.step_time from its start
        instead, so a second instrumented step repeats the first's rows).
        Queued traces of earlier steps are flushed first, so the rows stay
        in order."""
        self._check_ready()
        if self._selfcol_index is not None:
            self._refresh_self_contacts()
        self.flush_traces()
        rt = self.runtime
        n0 = len(rt.step_time)
        c0 = rt.local_ms + rt.global_ms + rt.acceleration_ms
        args = (self.system, self._x_dev, self._v_dev, self._pin_pos_dev(),
                rt)
        with _reads_into(self.stats):
            if self.order == UpdateOrder.XZU:
                x_new, v_new, prims, combs, resets = step_xzu_instrumented(
                    *args, log=log, counts=self.stats)
                rejects = np.zeros(len(prims), np.int64)
            else:
                x_new, v_new, prims, combs, rejects, resets = \
                    step_zxu_instrumented(*args, counts=self.stats)
        self._x_dev, self._v_dev = x_new, v_new
        self._x_host = self._v_host = None
        t0 = self.step_times[-1] if self.step_times else 0.0
        for i, row in enumerate(rt.step_time[n0:n0 + len(prims)]):
            self.step_prim.append(float(prims[i]))
            self.step_comb.append(float(combs[i]))
            self.step_reject.append(int(rejects[i]))
            self.step_times.append(t0 + row - c0)
        self.reset_num += resets
        if self.settings.verbose > 0:
            rt.print(self.settings)
        return prims, combs

    # ---- mid-step ADMM state dump / restore (Solver.hpp:153-215) ----
    #
    # Text layout: z, u and last_z are the element blocks concatenated in
    # batch order, element-major within each block (_flatten_ref); x is all
    # vertex positions row-major. File 1 = "n" then rows "z u last_z";
    # file 2 = "n" then rows of x (the reference's ::load).

    def save_admm_state(self, file_zu: str, file_x: str,
                        at_iteration: int = 0, aa_file: str = None):
        """Run one timestep, dumping the ADMM state after `at_iteration`
        iterations as reference-format 16-digit text; the step still
        completes all admm_iters iterations and commits exactly like
        step(). A solver seeded with the dump by load_admm_state (admm_iters
        = the remaining iterations) replays the tail of this step.

        aa_file: an .npz sidecar holding the whole loop carry (AA history,
        rollback anchors, last residual, counters; keys n_leaves,
        fingerprint, leaf{i}), so that an accelerated tail replay is
        bit-equal (the text format carries no AA state). It is this
        package's own format."""
        self._check_ready()
        k, iters = int(at_iteration), self.system.admm_iters
        if not 0 <= k <= iters:
            raise ValueError(f"at_iteration {k} is outside [0, {iters}]")
        if self._selfcol_index is not None:
            self._refresh_self_contacts()
        t = MicroTimer()
        x0 = self._x_dev
        carry, consts = _step_setup(self.system, x0, self._v_dev,
                                    self._pin_pos_dev(), self.stats)
        outs = []
        if k:
            carry, ys = _step_scan_chunk(self.system, carry, consts, k,
                                         self.stats)
            outs.append(ys)
        last_z = carry["dz"] if "dz" in carry else carry["z"]

        def host(ts):
            return _flatten_ref(ts).cpu().numpy()
        save_admm_state_text(file_zu, file_x, host(carry["z"]),
                             host(carry["u"]), host(last_z),
                             carry["x"].cpu().numpy())
        if aa_file:
            leaves = [leaf for _, leaf in _tree_leaves(carry)]
            np.savez_compressed(
                aa_file, n_leaves=len(leaves),
                fingerprint=np.array(_carry_fingerprint(carry)),
                **{f"leaf{i}": leaf.cpu().numpy()
                   for i, leaf in enumerate(leaves)})
        if iters - k:
            carry, ys = _step_scan_chunk(self.system, carry, consts, iters - k,
                                         self.stats)
            outs.append(ys)
        x_new, v_new, trace = _step_commit(self.system, carry, x0,
                                           *_cat_chunks(outs))
        self._sync()
        self._finish_step(x_new, v_new, trace, t.elapsed_ms())
        return trace

    def load_admm_state(self, file_zu: str, file_x: str,
                        aa_file: str = None):
        """Load a mid-step ADMM dump: the NEXT step() starts its ADMM loop
        from the loaded (z, u, last_z, x) instead of the init sweep and runs
        admm_iters iterations from there (AA restarts: the reference's dump
        has no AA state). With the .npz sidecar of save_admm_state the whole
        carry is restored instead, so an accelerated tail replays bit for
        bit. Raises ValueError on a size mismatch, like the reference, and
        on a sidecar saved under another carry structure (checked here, by
        one init sweep that builds this solver's carry)."""
        self._check_ready()
        z, u, last_z, x = load_admm_state_text(file_zu, file_x)
        sys_ = self.system
        zeros = torch.zeros((sys_.n_verts, 3), dtype=self._x_dev.dtype,
                            device=self.device)
        if z.size != sum(b.numel() for b in sys_.deform(zeros)):
            raise ValueError("Error: invalid number or values")
        if x.size != sys_.n_verts * 3:
            raise ValueError("Error: invalid number or values from file 2")
        aa_leaves = None
        if aa_file:
            with np.load(aa_file) as d:
                aa_leaves = [d[f"leaf{i}"] for i in range(int(d["n_leaves"]))]
                saved_fp = str(d["fingerprint"])
            carry, _ = _step_setup(sys_, self._x_dev, self._v_dev,
                                   self._pin_pos_dev())
            expect_fp = _carry_fingerprint(carry)
            if saved_fp != expect_fp:
                raise ValueError(
                    "AA sidecar was saved under a different solver "
                    "configuration (carry structure mismatch):\n"
                    f"  saved:    {saved_fp}\n  expected: {expect_fp}")
        self._admm_seed = (z, u, last_z, x, aa_leaves)

    def _step_seeded(self, seed):
        """One timestep whose ADMM loop starts from a loaded mid-step state;
        the step's constants (prediction, pin embedding) come from the
        current (x, v), as in the step the dump was taken from."""
        zf, uf, lzf, xf, aa_leaves = seed
        sys_ = self.system
        x0 = self._x_dev
        carry, consts = _step_setup(sys_, x0, self._v_dev,
                                    self._pin_pos_dev(), self.stats)
        if aa_leaves is not None:
            template = [t for _, t in _tree_leaves(carry)]
            if len(aa_leaves) != len(template) or any(
                    tuple(t.shape) != leaf.shape
                    for t, leaf in zip(template, aa_leaves)):
                raise ValueError("Error: invalid number or values")
            carry = _tree_unflatten(carry, [
                torch.from_numpy(np.asarray(leaf)).to(t.device, t.dtype)
                for t, leaf in zip(template, aa_leaves)])
        else:
            dtype, dev = carry["x"].dtype, carry["x"].device

            def dev_t(a):
                return torch.from_numpy(np.asarray(a)).to(dev, dtype)
            zt = _unflatten_ref(dev_t(zf), carry["z"])
            ut = _unflatten_ref(dev_t(uf), carry["u"])
            x_full = dev_t(xf).reshape(sys_.n_verts, 3)
            carry = dict(carry, x=x_full, z=zt, u=ut, dx=x_full, du=ut)
            if "dz" in carry:
                carry["dz"] = _unflatten_ref(dev_t(lzf), carry["z"])
                carry["aa"] = anderson.init(sys_.anderson_m, _flatten(zt))
            else:
                carry["aa"] = anderson.init(
                    max(sys_.anderson_m, 1),
                    _flat_ux(sys_, ut, x_full[sys_.free_idx]),
                    effective_dim=sum(t.numel() for t in ut))
        carry, ys = _step_scan_chunk(sys_, carry, consts, sys_.admm_iters,
                                     self.stats)
        return _step_commit(sys_, carry, x0, *ys)

    # ---- persistence (Solver::save, Solver.hpp:126-151) ----

    def save(self, result_dir: str = "result"):
        """result/residual-{m|no}.txt: time, prim, comb and, in the zxu
        order, the reject column."""
        self.flush_traces()
        m = self.settings.anderson_m if self.settings.accelerated else 0
        name = f"residual-{m}.txt" if m > 0 else "residual-no.txt"
        reject = self.step_reject if self.order == UpdateOrder.ZXU else None
        save_residual_file(os.path.join(result_dir, name),
                           [t / 1e3 for t in self.step_times],
                           self.step_prim, self.step_comb, reject)

    def save_matrix(self, filename: str):
        """Dump the global system matrix over the free vertices (the
        per-coordinate node matrix; Solver::save_matrix, Solver.cpp:501-506)
        as 16-digit text."""
        self._check_ready()
        s = self.settings
        dt2p = (s.penalty if self.order == UpdateOrder.ZXU else 1.0) \
            * s.timestep_s ** 2
        n = self.n_verts
        A = dt2p * assemble_node_matrix(n, list(self.system.batches))
        A[np.arange(n), np.arange(n)] += np.concatenate(self.masses)
        free = self.system.free_idx.cpu().numpy()
        A_free = A[np.ix_(free, free)]
        print(f"Saving matrix ({A_free.shape[0]}x{A_free.shape[1]}) "
              f"to {filename}")
        np.savetxt(filename, A_free, fmt="%.16g")

    def save_state(self, path: str):
        np.savez(path, x=self.x, v=self.v)

    def load_state(self, path: str):
        d = np.load(path)
        self.x, self.v = d["x"], d["v"]
        self._refresh_pin_pos()
