"""ALM/ADMM geometry optimization solver (counterpart of
aa_admm_tpu/solver/geometry.py without the BSR operator).

Re-implements ``ALMGeometrySolver<N>`` (Geometry/ALMGeometrySolver.h:52-463):
hard/soft constraint transforms, exact hard projection + weighted soft
projection in the z-update, a per-coordinate global solve (dense inverse, or
CG through kernels B2/B3 with the two-level preconditioner and the ELL
matvec), a scaled-dual update on the hard block, and safeguarded Anderson
acceleration over the (u, x) pair with accept/reject on the combined
residual ``||D_h x - z_h||^2 + ||D_h x - D_h x_prev||^2``. Every scatter
(the constraints' adjoints, the regularization rows, the restriction) is a
gather over a table built at set-up, so a solve repeats bit for bit on the
card. The JAX package's Morton-blocked operator (``BsrMatrix``) is not
ported: on an H100 its CG is slower than the ELL one (PERF.md;
``tools/port_bsr_cost.py`` holds a copy and measures it).

The loop counts accepted iterations. The accept/reject choice stays on the
device (``torch.where`` over the state); the host reads the accept count once
per trial to decide whether to go on. Host reads per trial: that loop test,
one per cached closest-point projection, the CG loop tests, and the AA Gram
matrix. The state's ``reads`` counter adds them up.

Sharded over ranks (``ALMGeometrySolver.shard``, ``parallel/geometry.py``)
the system holds this rank's contiguous range of vertex rows (ELL rows,
preconditioner rows, ``rhs_fixed``, ``x0``, ``Ax0``, the regularization
rows) and of every constraint batch's elements; its ``shard`` (a
``RowShard``) names the rows and the comm that sums over the ranks. The loop state's ``x`` is then the rank's rows, its ``u`` the rank's
elements. Where a transform reads rows that other ranks own, the full
vector is assembled (``_full``: the rank's rows in a zero-filled buffer,
summed); the x-update's scatter, the residual, the AA inner products, the
soft energies and the cache-refresh test are summed, so every rank reads
the same value at each branch. The dense inverse stays whole: its solve is
replicated and each rank keeps its rows, so a replicated x never enters a
sum more than once.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.meshio import save_residual_file
from ..core.timers import MicroTimer, span, spanned
from ..ops._batchutil import GatherAdjoint
from ..ops.constraints import (AngleBatch, ClosenessBatch, EdgeLengthBatch,
                               PlaneBatch, RefSurfaceBatch,
                               assemble_geometry_node_matrix,
                               assemble_geometry_node_matrix_sparse,
                               cast_floats, hostarr, torch_dtype)
from . import anderson
from .linear import DenseInverseSolver, dense_inverse, pcg_fused
from .multigrid import TwoLevelPrecond, build_two_level


@dataclasses.dataclass(frozen=True)
class RegRows(GatherAdjoint):
    """Padded regularization rows L (LinearRegularization.h:36-153):
    row r touches idx[r, :] with coefficients coef[r, :] (already scaled by
    sqrt(weight)); target rhs per row."""

    idx: torch.Tensor     # (R, K) int64
    coef: torch.Tensor    # (R, K)
    mask: torch.Tensor    # (R, K) bool
    target: torch.Tensor  # (R, 3)
    inv_idx: Optional[torch.Tensor] = None   # (n, Kv) L^T's table
    inv_mask: Optional[torch.Tensor] = None  # (n, Kv)

    def _adjoint_index(self):
        return self.idx, self.mask, self.coef.dtype


@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """Padded-row (ELL) sparse matrix for the constant global operator:
    ``A v`` is one gather and one multiply-sum over (n, K)."""

    idx: torch.Tensor   # (n, K) int64 column indices (self-padded)
    coef: torch.Tensor  # (n, K) values (0 in padding)

    @classmethod
    def from_csr(cls, A, dtype, device="cpu"):
        n = A.shape[0]
        nnz = np.diff(A.indptr)
        K = max(int(nnz.max()), 1)
        idx = np.tile(np.arange(n, dtype=np.int64)[:, None], (1, K))
        coef = np.zeros((n, K))
        r = np.repeat(np.arange(n), nnz)
        pos = np.arange(A.nnz) - np.repeat(A.indptr[:-1], nnz)
        idx[r, pos] = A.indices
        coef[r, pos] = A.data
        return cls(idx=torch.from_numpy(idx).to(device),
                   coef=torch.from_numpy(coef).to(device=device,
                                                  dtype=torch_dtype(dtype)))

    def apply(self, v):
        """v (n, c) -> A v (n, c)."""
        return torch.einsum("nk,nkc->nc", self.coef, v[self.idx])


@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's vertex rows [lo, hi) of a sharded system and the comm
    whose ``all_reduce`` sums over the ranks."""
    lo: int
    hi: int
    comm: object


@dataclasses.dataclass(frozen=True)
class GeometrySystem:
    hard: tuple                      # hard constraint batches
    soft: tuple                      # soft constraint batches
    solver: Optional[DenseInverseSolver]
    precond_diag: Optional[torch.Tensor]
    rhs_fixed: torch.Tensor          # (n, 3) = L^T * reg_rhs
    mg: Optional[TwoLevelPrecond] = None
    ell: Optional[EllMatrix] = None
    reg: Optional[RegRows] = None
    # Delta-form anchors (set per solve): the loop state is delta = x - x0;
    # D x0 and A x0 are computed on the host in f64.
    x0: Optional[torch.Tensor] = None
    t0_hard: tuple = ()
    t0_soft: tuple = ()
    Ax0: Optional[torch.Tensor] = None
    n_verts: int = 0
    rho: float = 1.0
    max_iter: int = 100
    anderson_m: int = 5
    accel: bool = True
    cg_tol: float = 1e-12
    cg_max_iters: int = 400
    # A sharded system's part (parallel/geometry.py); None for one rank.
    shard: Optional[RowShard] = None

    def transform_hard(self, x):
        return tuple(b.transform(x) for b in self.hard)

    def transform_soft(self, x):
        return tuple(b.transform(x) for b in self.soft)

    def dx_hard(self, delta):
        """D_h (x0 + delta) = t0 + D_h delta (plain transform without
        anchors)."""
        if not self.t0_hard:
            return self.transform_hard(delta)
        return tuple(t0 + b.transform(delta)
                     for b, t0 in zip(self.hard, self.t0_hard))

    def dx_soft(self, delta):
        if not self.t0_soft:
            return self.transform_soft(delta)
        return tuple(t0 + b.transform(delta)
                     for b, t0 in zip(self.soft, self.t0_soft))


@dataclasses.dataclass(frozen=True)
class GeometryTrace:
    x: torch.Tensor
    function_values: torch.Tensor  # (n_accepted,)
    rejects: torch.Tensor          # (n_accepted,) rejects before accept i
    n_trials: int


def _flatten(ts):
    return torch.cat([t.reshape(-1) for t in ts])


def _unflatten(flat, templates):
    out, off = [], 0
    for t in templates:
        size = t.numel()
        out.append(flat[off:off + size].reshape(t.shape))
        off += size
    return tuple(out)


def _sqnorm_all(ts):
    return sum((t * t).sum() for t in ts)


def _reducer(system):
    """The sum over a sharded system's ranks; None for one rank."""
    return None if system.shard is None else system.shard.comm.all_reduce


def _reduce(system, t):
    """t summed over a sharded system's ranks (t is this rank's partial);
    t itself for one rank."""
    return t if system.shard is None else system.shard.comm.all_reduce(t)


def _own(system, v):
    """This rank's rows of a full (n, ...) vertex array."""
    sh = system.shard
    return v if sh is None else v[sh.lo:sh.hi]


def _aligned(v):
    """v, or a copy of it when it does not start on a 16-byte boundary: the
    CG kernels move 16-byte words, and a rank's rows of a ragged split may
    start anywhere (41 rows of 3 floats end at byte 492)."""
    return v if v.data_ptr() % 16 == 0 else v.clone()


def _placed(system, v):
    """v (this rank's rows) in a zero-filled full-length buffer, a partial
    whose sum over the ranks is the full vector; v itself for one rank."""
    sh = system.shard
    if sh is None:
        return v
    buf = v.new_zeros((system.n_verts,) + tuple(v.shape[1:]))
    buf[sh.lo:sh.hi] = v
    return buf


def _full(system, v):
    """The full (n, 3) vector of which v holds this rank's rows (exact:
    the other ranks add zeros)."""
    return _reduce(system, _placed(system, v))


def _w2(b, t):
    return b.w.reshape(b.w.shape + (1,) * (t.ndim - 1)) ** 2


def _solve_x(system: GeometrySystem, z_hard, u, z_soft, x_warm=None):
    """x-update (ALMGeometrySolver::ADMM_x_update, :442-450) in delta form:
    A delta = rhs_fixed + rho D_h^T (z_h - u) + D_s^T W_s z_s - A x0.
    Returns (x, cg_iterations, host_reads); x (and x_warm) are this rank's
    rows of a sharded system: its elements scatter into a full-length
    partial, the partials (with each rank's rows of the fixed terms) are
    summed, and the rank keeps its rows."""
    rhs = system.rhs_fixed
    if system.Ax0 is not None:
        rhs = rhs - system.Ax0
    rhs = _placed(system, rhs)
    s = torch.zeros_like(rhs)
    for b, zh, uh in zip(system.hard, z_hard, u):
        s = s + b.scatter(zh - uh, system.n_verts)
    rhs = rhs + system.rho * s
    for b, zs in zip(system.soft, z_soft):
        rhs = rhs + b.scatter(_w2(b, zs) * zs, system.n_verts)
    rhs = _reduce(system, rhs)
    if system.solver is not None:
        return _own(system, system.solver.solve(rhs)), 0, 0
    rhs = _own(system, rhs)

    if system.ell is not None:
        def operator(v):
            return system.ell.apply(_full(system, v))
    else:
        def operator(v):
            return _matrix_free(system, v)

    reduce = _reducer(system)
    precond = None
    if system.mg is not None:
        def precond(r):
            return system.mg.apply(r, reduce)
    return pcg_fused(operator, rhs, system.precond_diag, tol=system.cg_tol,
                     max_iters=system.cg_max_iters, x0=x_warm,
                     precond=precond, reduce=reduce)


def _matrix_free(system, v):
    """A v without a matrix, over the system's constraint batches and
    regularization rows. v and the result are this rank's rows of a sharded
    system (its rows of the summed partials, copied when that view is not
    16-byte aligned); the whole vector on one rank."""
    v = _full(system, v)
    sh = torch.zeros_like(v)
    for b in system.hard:
        sh = sh + b.scatter(b.transform(v), system.n_verts)
    out = system.rho * sh
    for b in system.soft:
        t = b.transform(v)
        out = out + b.scatter(_w2(b, t) * t, system.n_verts)
    out = _reduce(system, out + _reg_apply(system, v))
    return out if system.shard is None else _aligned(_own(system, out))


def _reg_apply(system, v):
    """Regularization normal matrix applied matrix-free (CG path), over the
    system's regularization rows (a rank's share on a sharded system: then
    a partial to be summed). v is the full vector."""
    if system.reg is None:
        return torch.zeros_like(v)
    r = system.reg
    cm = r.coef * r.mask
    rows = torch.einsum("rk,rkc->rc", cm, v[r.idx])
    contrib = cm[..., None] * rows[:, None, :]
    return r._scatter(contrib.reshape(-1, 3), v.shape[0])


def _alm_init_state(system: GeometrySystem, init_x):
    """Fresh ADMM+AA loop state (per-dispatch histories sized max_iter).
    In delta mode (system.x0 set) the carried 'x' is delta = x - x0 and
    starts at zero. Tensors live on init_x's device; trial, limit,
    max_trials, cgit and the counters are host ints."""
    x0 = torch.zeros_like(init_x) if system.x0 is not None else init_x
    u0 = tuple(torch.zeros(b.block_shape, dtype=init_x.dtype,
                           device=init_x.device) for b in system.hard)
    aa0 = anderson.init(max(system.anderson_m, 1),
                        torch.cat([_flatten(u0), x0.reshape(-1)]))
    kw = dict(device=init_x.device)
    cp0 = tuple(b.cp_cache_init(init_x.dtype)
                if hasattr(b, "cp_cache_init") else None
                for b in system.soft)
    return dict(x=x0, u=u0, dx=x0, du=u0, cp=cp0,
                prev=torch.tensor(torch.finfo(init_x.dtype).max,
                                  dtype=init_x.dtype, **kw),
                reset=torch.tensor(False, **kw), aa=aa0,
                it=torch.zeros((), dtype=torch.int64, **kw), trial=0,
                fv=torch.full((system.max_iter,), float("nan"),
                              dtype=init_x.dtype, **kw),
                rj=torch.zeros((system.max_iter,), dtype=torch.int64, **kw),
                rejects=torch.zeros((), dtype=torch.int64, **kw),
                limit=system.max_iter, max_trials=2 * system.max_iter + 4,
                cgit=0, reads=0, cp_refreshes=0)


def _alm_trial(system: GeometrySystem, st, it_h: int):
    """One accept/reject trial (the body of the JAX while_loop); `it_h` is
    the accepted count at its start, as read by the loop test."""
    cx, cu = st["x"], st["u"]
    reads, refreshes = 0, 0
    cx_full = _full(system, cx)
    dx_h = system.dx_hard(cx_full)         # D_h (x0 + delta)
    dx_s = system.dx_soft(cx_full)
    prev_dx_h = dx_h

    # z-update (:425-440): hard projects (D_h x + u); soft projects D_s x.
    # The local step: the projections, the closest-point cache's test and
    # refresh.
    with span("local"):
        z_h = tuple(b.project(d + ui)
                    for b, d, ui in zip(system.hard, dx_h, cu))
        z_s, cps = [], []
        for b, d, c in zip(system.soft, dx_s, st["cp"]):
            if c is None:
                z_s.append(b.project(d))
                cps.append(None)
            else:
                z, c2, refreshed = b.project_cached(d, c, _reducer(system))
                reads += 1
                refreshes += int(refreshed)
                z_s.append(z)
                cps.append(c2)

    # The global step: the x-update's solve.
    with span("global"):
        new_x, n_cg, cg_reads = _solve_x(system, z_h, cu, tuple(z_s),
                                         x_warm=cx)
    reads += cg_reads
    dx_h2 = system.dx_hard(_full(system, new_x))
    new_u = tuple(ui + d - zh for ui, d, zh in zip(cu, dx_h2, z_h))
    res = _reduce(system, _sqnorm_all(
        tuple(d - zh for d, zh in zip(dx_h2, z_h))
        + tuple(d - p for d, p in zip(dx_h2, prev_dx_h))))

    if system.accel:
        accept = st["reset"] | (res < st["prev"])
        aa_acc, mixed = anderson.compute(
            st["aa"], torch.cat([_flatten(new_u), new_x.reshape(-1)]),
            _reducer(system))
        reads += 1
        usize = sum(t.numel() for t in new_u)
        nu = _unflatten(mixed[:usize], new_u)
        nx = mixed[usize:].reshape(new_x.shape)
        aa_rej = anderson.reset(
            st["aa"], torch.cat([_flatten(st["du"]), st["dx"].reshape(-1)]))
        aa = anderson.where(accept, aa_acc, aa_rej)
    else:
        accept = torch.ones((), dtype=torch.bool, device=res.device)
        nu, nx, aa = new_u, new_x, st["aa"]

    def sel(a, b):
        return torch.where(accept, a, b)

    fv, rj = st["fv"].clone(), st["rj"].clone()
    fv[it_h] = sel(res, fv[it_h])
    rj[it_h] = sel(st["rejects"], rj[it_h])
    # On reject: roll back to the last accepted (un-mixed) iterate; the cp
    # caches stay valid across the rollback (they self-check against p0).
    return dict(x=sel(nx, st["dx"]),
                u=tuple(sel(a, b) for a, b in zip(nu, st["du"])),
                dx=sel(new_x, st["dx"]),
                du=tuple(sel(a, b) for a, b in zip(new_u, st["du"])),
                cp=tuple(cps), prev=sel(res, st["prev"]), reset=~accept,
                aa=aa, it=st["it"] + accept.to(torch.int64),
                trial=st["trial"] + 1, fv=fv, rj=rj,
                rejects=torch.where(accept, torch.zeros_like(st["rejects"]),
                                    st["rejects"] + 1),
                limit=st["limit"], max_trials=st["max_trials"],
                cgit=st["cgit"] + n_cg, reads=st["reads"] + reads,
                cp_refreshes=st["cp_refreshes"] + refreshes)


def solve_alm_chunk(system: GeometrySystem, state):
    """Run the accept/reject loop until ``it == limit`` (or the trial bound)
    and return the carried state. ``trial`` and ``max_trials`` are global
    over a chunked solve; ``it`` and the histories are per dispatch. The
    loop test reads ``it`` on the host once per evaluation."""
    st = dict(state)
    while st["trial"] < st["max_trials"]:
        st["reads"] += 1
        with span("sync"):
            it_h = int(st["it"])
        if it_h >= st["limit"]:
            break
        st = _alm_trial(system, st, it_h)
    return st


def solve_alm(system: GeometrySystem, init_x) -> GeometryTrace:
    """ALMGeometrySolver::solve_ADMM (ALMGeometrySolver.h:163-283).
    init_x and Trace.x hold all n vertices' absolute positions (on a
    sharded system too: its rows are gathered)."""
    st = solve_alm_chunk(system, _alm_init_state(system, _own(system,
                                                                init_x)))
    x_abs = st["dx"] if system.x0 is None else system.x0 + st["dx"]
    return GeometryTrace(x=_full(system, x_abs), function_values=st["fv"],
                         rejects=st["rj"], n_trials=st["trial"])


def soft_energy_delta(system: GeometrySystem, delta, caches):
    """soft_energy evaluated through the delta-form anchors; delta is the
    loop state's (this rank's rows on a sharded system). A batch with a
    closest-point cache (``caches``, one entry per soft batch as the loop
    state's ``cp``) projects through it, as the loop does: exact, refreshed
    where its movement test asks (one host read, taken over every rank's
    queries); a batch whose entry is None projects uncached. Returns
    (energy, caches, host reads, refreshes)."""
    total = torch.zeros((), dtype=delta.dtype, device=delta.device)
    out, reads, refreshes = [], 0, 0
    for b, d, c in zip(system.soft, system.dx_soft(_full(system, delta)),
                       caches):
        if c is None:
            p = b.project(d)
        else:
            p, c, refreshed = b.project_cached(d, c, _reducer(system))
            reads += 1
            refreshes += int(refreshed)
        out.append(c)
        total = total + 0.5 * (_w2(b, d) * (d - p) ** 2).sum()
    return _reduce(system, total), tuple(out), reads, refreshes


def soft_energy(system: GeometrySystem, x):
    """Weighted soft-constraint projection error: sum over soft constraints
    of 0.5 w^2 ||D_s x - proj(D_s x)||^2 ('Init/final energy',
    ALMGeometrySolver.h:186-192, 271-278). x holds all n vertices."""
    total = torch.zeros((), dtype=x.dtype, device=x.device)
    for b in system.soft:
        d = b.transform(x)
        p = b.project(d)
        total = total + 0.5 * (_w2(b, d) * (d - p) ** 2).sum()
    return _reduce(system, total)


def _geometry_node_diag(n_points, hard, soft, rho, reg):
    """Diagonal of the geometry global matrix without materializing it."""
    d = np.zeros(n_points)

    def add(b, scale_w, out_scale=1.0):
        idx = hostarr(b, 'idx')
        w2 = (hostarr(b, 'w') ** 2) if scale_w else np.ones(len(idx))
        if isinstance(b, PlaneBatch):
            # diag of the centering projector: (1 - 1/k) per valid slot
            cnt = hostarr(b, 'count')
            contrib = (1.0 - 1.0 / cnt)[:, None] * hostarr(b, 'mask') \
                * w2[:, None]
            np.add.at(d, idx, out_scale * contrib)
        elif isinstance(b, AngleBatch):
            rowsq = np.array([2.0, 1.0, 1.0])
            np.add.at(d, idx, out_scale * w2[:, None] * rowsq[None, :])
        elif isinstance(b, EdgeLengthBatch):
            np.add.at(d, idx, out_scale * w2[:, None] * np.ones(2)[None, :])
        elif isinstance(b, (ClosenessBatch, RefSurfaceBatch)):
            np.add.at(d, idx, out_scale * w2)
        else:
            raise TypeError(
                f"_geometry_node_diag: unknown constraint batch type "
                f"{type(b).__name__}; add its D^T D diagonal rule here")

    for b in hard:
        add(b, scale_w=False, out_scale=rho)
    for b in soft:
        add(b, scale_w=True)
    if reg is not None:
        idx, coef, mask = reg
        np.add.at(d, idx, (coef * mask) ** 2)
    return np.maximum(d, 1e-12)


class ALMGeometrySolver:
    """Host-side set-up and solve loop mirroring the reference public API
    (add_hard_constraint / add_soft_constraint / add_closeness /
    add_*laplacian / setup_ADMM / solve_ADMM / get_solution / save,
    ALMGeometrySolver.h:81-365). ``device`` defaults to CUDA."""

    def __init__(self, dense_threshold: int = 12000, device=None):
        self.device = resolve_device(device)
        self.hard: List = []
        self.soft: List = []
        self.reg_rows: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self.system: Optional[GeometrySystem] = None
        self.dense_threshold = dense_threshold
        self._solution = None
        self.function_values: List[float] = []
        self.elapsed_time: List[float] = []
        self.anderson_reset: List[int] = []
        self.stats: dict = {}
        self.setup_s = 0.0
        self.dtype = np.float64

    def add_hard_constraint(self, batch):
        self.hard.append(batch)

    def add_soft_constraint(self, batch):
        self.soft.append(batch)

    # -- regularization (LinearRegularization.h) --

    def add_closeness(self, idx, weight, target_pt):
        sw = np.sqrt(weight)
        self.reg_rows.append((np.asarray([idx]), np.asarray([sw]),
                              np.asarray(target_pt, np.float64) * sw))

    def _add_laplacian_helper(self, indices, coefs, weight, ref_points=None):
        sw = np.sqrt(weight)
        idx = np.asarray(indices, np.int64)
        coef = np.asarray(coefs, np.float64) * sw
        target = np.zeros(3)
        if ref_points is not None:
            target = (np.asarray(ref_points)[idx]
                      * np.asarray(coefs)[:, None]).sum(0) * sw
        self.reg_rows.append((idx, coef, target))

    def add_uniform_laplacian(self, indices, weight):
        n = len(indices)
        coefs = [1.0] + [-1.0 / (n - 1)] * (n - 1)
        self._add_laplacian_helper(indices, coefs, weight)

    def add_laplacian(self, indices, coefs, weight):
        self._add_laplacian_helper(indices, coefs, weight)

    def add_relative_uniform_laplacian(self, indices, weight, ref_points):
        n = len(indices)
        coefs = [1.0] + [-1.0 / (n - 1)] * (n - 1)
        self._add_laplacian_helper(indices, coefs, weight, ref_points)

    def add_relative_laplacian(self, indices, coefs, weight, ref_points):
        self._add_laplacian_helper(indices, coefs, weight, ref_points)

    # -- setup / solve --

    def _tensor(self, a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=self.device, dtype=dtype or torch_dtype(self.dtype))

    @spanned("setup.build")
    def setup_ADMM(self, n_points: int, penalty_param: float,
                   linear_solver: str = "auto") -> bool:
        t = MicroTimer()
        tdt = torch_dtype(self.dtype)
        self.hard = [cast_floats(b, tdt, self.device) for b in self.hard]
        self.soft = [cast_floats(b, tdt, self.device) for b in self.soft]
        reg = None
        rhs_fixed = np.zeros((n_points, 3))
        if self.reg_rows:
            K = max(len(r[0]) for r in self.reg_rows)
            R = len(self.reg_rows)
            idx = np.zeros((R, K), np.int64)
            coef = np.zeros((R, K))
            mask = np.zeros((R, K), bool)
            target = np.zeros((R, 3))
            for i, (ii, cc, tt) in enumerate(self.reg_rows):
                idx[i, :len(ii)] = ii
                coef[i, :len(ii)] = cc
                mask[i, :len(ii)] = True
                target[i] = tt
            np.add.at(rhs_fixed, idx.reshape(-1),
                      (coef[..., None] * target[:, None, :]).reshape(-1, 3))
            reg = (idx, coef * mask, mask)

        use_dense = (linear_solver == "dense"
                     or (linear_solver == "auto"
                         and n_points <= self.dense_threshold))
        solver = precond = mg = ell = None
        if use_dense:
            A = assemble_geometry_node_matrix(
                n_points, self.hard, self.soft, penalty_param, reg_rows=reg)
            solver = DenseInverseSolver(
                Ainv=dense_inverse(A, dtype=tdt, device=self.device))
            self._A_host = A          # f64, for the delta-form A x0 anchor
        else:
            A_csr = assemble_geometry_node_matrix_sparse(
                n_points, self.hard, self.soft, penalty_param, reg_rows=reg)
            self._A_host = A_csr
            ell = EllMatrix.from_csr(A_csr, self.dtype, self.device)
            diag = np.asarray(A_csr.diagonal())
            precond = self._tensor(diag)
            mg = build_two_level(n_points, self.hard, self.soft,
                                 penalty_param, reg, diag, dtype=tdt,
                                 device=self.device)

        reg_struct = None
        if reg is not None and not use_dense:
            idx, coef, mask = reg
            target = np.stack([tt for _, _, tt in self.reg_rows])
            reg_struct = RegRows(idx=self._tensor(idx, torch.int64),
                                 coef=self._tensor(coef),
                                 mask=self._tensor(mask, torch.bool),
                                 target=self._tensor(target))
        self.system = GeometrySystem(
            hard=tuple(self.hard), soft=tuple(self.soft),
            solver=solver, precond_diag=precond, mg=mg, ell=ell,
            rhs_fixed=self._tensor(rhs_fixed), reg=reg_struct,
            n_verts=n_points, rho=float(penalty_param))
        self.setup_s = t.elapsed_s()
        print(f"predecomposition time = {self.setup_s:.6f}")
        return True

    @spanned("solve")
    def solve_ADMM(self, init_x: np.ndarray, rel_residual_eps: float,
                   max_iter: int, anderson_m: int,
                   cg_tol: float = None, cg_max_iters: int = None,
                   chunk_iters: int = None):
        """Run the accept/reject loop, optionally in chunks of chunk_iters
        accepted iterations with carried state (one global runaway-trial
        budget of 2*iters+4 over the whole solve). The initial and final
        soft energies project through the loop's closest-point caches:
        ``stats["energy_refreshes"]`` counts the energies' cache refreshes,
        ``cp_refreshes`` the loop's, and ``host_reads`` the reads of both
        (the energies' cache tests included). On a sharded solver the
        per-solve anchors are made for this rank's rows and elements (the
        JAX package shards them again), and ``stats`` gains the collectives of
        the solve's trials and of the solution's gather (``collectives``),
        the bytes they summed (``comm_bytes``) and the host's seconds in
        them (``comm_s``)."""
        if self.system is None:
            raise RuntimeError("setup_ADMM must run before solve_ADMM")
        tdt = torch_dtype(self.dtype)
        self.stats = dict(trials=0, cg_iters=0, host_reads=0,
                          cp_refreshes=0, energy_refreshes=0, solve_s=0.0)
        if int(max_iter) < 1:
            self._solution = np.asarray(init_x, np.float64).copy()
            self.function_values, self.elapsed_time = [], []
            self.anderson_reset = []
            x0t = self._tensor(init_x)
            return GeometryTrace(x=x0t, function_values=x0t.new_zeros((0,)),
                                 rejects=torch.zeros((0,), dtype=torch.int64),
                                 n_trials=0)
        if cg_tol is None:
            # f32 cannot reach 1e-12 relative; the safeguarded loop absorbs
            # the inexact solve.
            cg_tol = 1e-12 if np.dtype(self.dtype) == np.float64 else 1e-4
        chunk = int(chunk_iters) if chunk_iters else int(max_iter)
        chunk = max(1, min(chunk, int(max_iter)))
        # Delta-form anchors: D x0 and A x0 in f64 on the host once per solve
        # (on a sharded system for its elements and rows).
        sys0 = self.system
        x0_np = np.asarray(init_x, np.float64)
        t0_h = tuple(self._tensor(b.transform_host(x0_np)) for b in sys0.hard)
        t0_s = tuple(self._tensor(b.transform_host(x0_np)) for b in sys0.soft)
        Ax0 = np.asarray(self._A_host @ x0_np)
        self.system = dataclasses.replace(
            sys0, max_iter=chunk,
            anderson_m=int(anderson_m), accel=anderson_m > 0,
            cg_tol=float(cg_tol),
            cg_max_iters=int(cg_max_iters or sys0.cg_max_iters),
            x0=self._tensor(_own(sys0, x0_np)), t0_hard=t0_h, t0_soft=t0_s,
            Ax0=self._tensor(_own(sys0, Ax0)))
        x0 = self._tensor(_own(sys0, np.asarray(init_x)))
        state = _alm_init_state(self.system, x0)
        state["max_trials"] = 2 * int(max_iter) + 4
        # The initial energy projects the first trial's points (delta 0)
        # through the loop's fresh caches; the loop starts from the caches
        # it leaves, built at those points.
        with span("solve.energy"):
            e0, state["cp"], e_reads, e_refreshes = soft_energy_delta(
                self.system, state["x"], state["cp"])
            e0 = float(e0)
        print(f"Init energy = {e0}")

        comm = None if sys0.shard is None else sys0.shard.comm
        c0 = ((comm.count, comm.nbytes, comm.seconds) if comm is not None
              else None)
        t = MicroTimer()
        fvs, rjs, times = [], [], [0.0]
        done = 0
        while done < int(max_iter):
            lim = min(chunk, int(max_iter) - done)
            state["limit"] = lim
            state["it"] = torch.zeros_like(state["it"])
            state["fv"] = torch.full((chunk,), float("nan"), dtype=tdt,
                                     device=self.device)
            state["rj"] = torch.zeros((chunk,), dtype=torch.int64,
                                      device=self.device)
            with span("alm.loop"):
                state = solve_alm_chunk(self.system, state)
            n_acc = int(state["it"])
            fvs.append(state["fv"][:n_acc].cpu().numpy())
            rjs.append(state["rj"][:n_acc].cpu().numpy())
            times.append(t.elapsed_s())
            done += lim
            if n_acc < lim:   # trial bound hit — no progress possible
                break
        total = times[-1]
        delta = state["dx"]
        self._solution = x0_np + _full(self.system, delta).cpu().numpy(
        ).astype(np.float64)
        fv = np.concatenate(fvs)
        trace = GeometryTrace(x=self._tensor(self._solution),
                              function_values=torch.from_numpy(fv),
                              rejects=torch.from_numpy(np.concatenate(rjs)),
                              n_trials=state["trial"])
        self.function_values = [float(v) for v in fv]
        self.elapsed_time = []
        t_prev = 0.0
        for chunk_fv, t_end in zip(fvs, times[1:]):
            k = len(chunk_fv)
            for j in range(k):
                self.elapsed_time.append(
                    t_prev + (t_end - t_prev) * (j + 1) / max(k, 1))
            t_prev = t_end
        self.anderson_reset = [int(r) for r in np.concatenate(rjs)]
        self.stats = dict(trials=state["trial"], cg_iters=state["cgit"],
                          host_reads=state["reads"],
                          cp_refreshes=state["cp_refreshes"], solve_s=total)
        if comm is not None:
            self.stats.update(collectives=comm.count - c0[0],
                              comm_bytes=comm.nbytes - c0[1],
                              comm_s=comm.seconds - c0[2])
        with span("solve.energy"):
            ef, _, reads, refreshes = soft_energy_delta(self.system, delta,
                                                        state["cp"])
            ef = float(ef)
        self.stats["host_reads"] += e_reads + reads
        self.stats["energy_refreshes"] = e_refreshes + refreshes
        print(f"final energy = {ef}")
        print(f"solve time = {total:.3f}s for {len(fv)} accepted iterations")
        return trace

    def shard(self, mesh):
        """Split the system over the ranks of a one-axis ('elem') device
        mesh (``parallel.geometry.make_vert_mesh``): call after setup_ADMM,
        before solve_ADMM, on every rank. Vertex rows and constraint
        elements are split, the collectives summed over the mesh's group;
        see parallel/geometry.py."""
        if self.system is None:
            raise RuntimeError("setup_ADMM must run before shard")
        from ..parallel.geometry import shard_geometry_system
        self.system = shard_geometry_system(self.system, mesh)

    def get_solution(self) -> np.ndarray:
        """The solution, all n vertices (gathered over the ranks of a
        sharded solve)."""
        return self._solution

    def output_iteration_history(self):
        for i, (t, v) in enumerate(zip(self.elapsed_time, self.function_values)):
            line = f"Iteration {i}: {t:.6f} secs,  target value {v:.16g}"
            if i < len(self.anderson_reset) and self.anderson_reset[i]:
                line += " (reject accelerator)"
            print(line)

    def save(self, anderson_m: int, result_dir: str = "result"):
        name = (f"residual-{anderson_m}.txt" if anderson_m > 0
                else "residual-no.txt")
        save_residual_file(os.path.join(result_dir, name),
                           self.elapsed_time, self.function_values)
