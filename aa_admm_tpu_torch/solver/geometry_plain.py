"""Plain AA-ADMM geometry solver (counterpart of
aa_admm_tpu/solver/geometry_plain.py) — the reference's alternate
formulation (Geometry/GeometrySolver.h:52-460; compiled but not used by the
shipped mains).

Differences from the ALM solver (solver/geometry.py):
  * one unified unweighted reduction D over hard AND soft constraints;
  * soft constraints are folded into the z-update by blending projection and
    input with a = rho/(w^2+rho) (Constraint::project_and_combine,
    Constraint.h:118-130);
  * global matrix rho D^T D (+ L^T L, refused here as in the JAX package),
    always the dense inverse; dual update over the full z block;
  * residual = ||D x - z|| gates accept/reject; AA over (u, x) with
    effective dimension = u only (GeometrySolver.h:170-176);
  * every trial counts as an iteration (GeometrySolver.h:214-224): a loop of
    exactly max_iter iterations.

Where the JAX package picks the reset branch with ``lax.cond``, the port
reads the test on the host (one read per accelerated iteration, counted in
``GeometrySolver.stats["host_reads"]`` with the AA Gram matrix's): the reset
branch recomputes a whole z-update, closest-point sweep included, which
computing both branches would pay in every iteration. The soft
``RefSurfaceBatch.project`` runs kernel B1 on CUDA tensors and its twin on
CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.timers import MicroTimer
from ..ops.constraints import (assemble_geometry_node_matrix, cast_floats,
                               torch_dtype)
from . import anderson
from .geometry import _flatten, _sqnorm_all, _unflatten
from .linear import DenseInverseSolver, dense_inverse


@dataclasses.dataclass(frozen=True)
class PlainGeometrySystem:
    hard: tuple
    soft: tuple
    solver: Optional[DenseInverseSolver]
    rhs_fixed: torch.Tensor
    n_verts: int = 0
    rho: float = 1.0
    max_iter: int = 100
    anderson_m: int = 5
    accel: bool = True


class PlainTrace(NamedTuple):
    x: torch.Tensor
    function_values: torch.Tensor   # (max_iter,)
    resets: int
    host_reads: int


def _transform_all(system, x):
    return (tuple(b.transform(x) for b in system.hard),
            tuple(b.transform(x) for b in system.soft))


def _z_update(system, dx_h, dx_s, u_h, u_s):
    """Hard: project(Dx+u). Soft: blend a*(Dx+u) + (1-a)*proj(Dx+u) with
    a = rho/(w^2+rho) (GeometrySolver::ADMM_z_update, :425-439)."""
    z_h = tuple(b.project(d + ui) for b, d, ui in zip(system.hard, dx_h, u_h))
    z_s = []
    for b, d, ui in zip(system.soft, dx_s, u_s):
        inp = d + ui
        p = b.project(inp)
        w2 = (b.w ** 2).reshape(b.w.shape + (1,) * (inp.ndim - 1))
        a = system.rho / (w2 + system.rho)
        z_s.append(a * inp + (1.0 - a) * p)
    return z_h, tuple(z_s)


def _solve_x(system, z_h, z_s, u_h, u_s):
    rhs = system.rhs_fixed
    s = torch.zeros_like(rhs)
    for b, zb, ub in zip(system.hard + system.soft, z_h + z_s, u_h + u_s):
        s = s + b.scatter(zb - ub, system.n_verts)
    return system.solver.solve(rhs + system.rho * s)


def _residual(dx, z):
    return torch.sqrt(_sqnorm_all(tuple(d - zz for d, zz in zip(dx, z))))


def solve_plain(system: PlainGeometrySystem, init_x) -> PlainTrace:
    """GeometrySolver::solve_ADMM (GeometrySolver.h:158-258) for max_iter
    iterations."""
    x0 = init_x
    kw = dict(dtype=x0.dtype, device=x0.device)
    u_h0 = tuple(torch.zeros(b.block_shape, **kw) for b in system.hard)
    u_s0 = tuple(torch.zeros(b.block_shape, **kw) for b in system.soft)

    def flat_ux(u_h, u_s, x):
        return torch.cat([_flatten(u_h + u_s), x.reshape(-1)])

    usize = sum(t.numel() for t in u_h0 + u_s0)
    reads = 0

    # ADMM_init_variables (GeometrySolver.h:404-430): one full sweep.
    dx_h, dx_s = _transform_all(system, x0)
    z_h, z_s = _z_update(system, dx_h, dx_s, u_h0, u_s0)
    dx1 = _solve_x(system, z_h, z_s, u_h0, u_s0)
    dh1, ds1 = _transform_all(system, dx1)
    u_h = tuple(u + d - z for u, d, z in zip(u_h0, dh1, z_h))
    u_s = tuple(u + d - z for u, d, z in zip(u_s0, ds1, z_s))
    aa = anderson.init(max(system.anderson_m, 1), flat_ux(u_h, u_s, dx1),
                       effective_dim=usize)
    st = dict(x=dx1, uh=u_h, us=u_s, dx=dx1, duh=u_h, dus=u_s, txh=dh1,
              txs=ds1, prev=torch.tensor(np.finfo(np.float64).max, **kw))
    resets = 0
    residuals = []
    for _ in range(system.max_iter):
        z_h, z_s = _z_update(system, st["txh"], st["txs"], st["uh"], st["us"])
        res = _residual(st["txh"] + st["txs"], z_h + z_s)
        if system.accel:
            reads += 1
            if bool(res > st["prev"]):
                # swap current <-> default; replace the AA iterate; recompute
                cx2, cuh2, cus2 = st["dx"], st["duh"], st["dus"]
                aa = anderson.replace(aa, flat_ux(cuh2, cus2, cx2))
                th, ts = _transform_all(system, cx2)
                z_h, z_s = _z_update(system, th, ts, cuh2, cus2)
                res = _residual(th + ts, z_h + z_s)
                st = dict(st, x=cx2, uh=cuh2, us=cus2, dx=st["x"],
                          duh=st["uh"], dus=st["us"], txh=th, txs=ts)
                resets += 1

        prev = res
        dx_new = _solve_x(system, z_h, z_s, st["uh"], st["us"])
        th, ts = _transform_all(system, dx_new)
        duh = tuple(u + d - z for u, d, z in zip(st["uh"], th, z_h))
        dus = tuple(u + d - z for u, d, z in zip(st["us"], ts, z_s))
        if system.accel:
            aa, mixed = anderson.compute(aa, flat_ux(duh, dus, dx_new))
            reads += 1
            u_all = _unflatten(mixed[:usize], duh + dus)
            cuh, cus = u_all[:len(duh)], u_all[len(duh):]
            cx = mixed[usize:].reshape(dx_new.shape)
        else:
            cuh, cus, cx = duh, dus, dx_new
        txh, txs = _transform_all(system, cx)
        st = dict(x=cx, uh=cuh, us=cus, dx=dx_new, duh=duh, dus=dus,
                  txh=txh, txs=txs, prev=prev)
        residuals.append(res)
    fv = (torch.stack(residuals) if residuals
          else torch.zeros((0,), **kw))
    return PlainTrace(x=st["x"], function_values=fv, resets=resets,
                      host_reads=reads)


class GeometrySolver:
    """Host API of the plain variant (GeometrySolver.h:52-460). ``device``
    defaults to CUDA and raises without it."""

    def __init__(self, dense_threshold: int = 12000, device=None):
        self.device = resolve_device(device)
        self.hard: List = []
        self.soft: List = []
        self.reg_rows = []
        self.system: Optional[PlainGeometrySystem] = None
        self.dense_threshold = dense_threshold
        self._solution = None
        self.function_values: List[float] = []
        self.elapsed_time: List[float] = []
        self.stats: dict = {}
        self.dtype = np.float64

    def add_hard_constraint(self, batch):
        self.hard.append(batch)

    def add_soft_constraint(self, batch):
        self.soft.append(batch)

    def setup_ADMM(self, n_points: int, penalty_param: float) -> bool:
        if self.reg_rows:
            raise NotImplementedError(
                "regularization rows: use the ALM solver for regularized runs")
        tdt = torch_dtype(self.dtype)
        hard = tuple(cast_floats(b, tdt, self.device) for b in self.hard)
        soft = tuple(cast_floats(b, tdt, self.device) for b in self.soft)
        # Unified unweighted D over hard + soft, scaled by rho.
        A = assemble_geometry_node_matrix(n_points, list(hard) + list(soft),
                                          [], penalty_param)
        self.system = PlainGeometrySystem(
            hard=hard, soft=soft,
            solver=DenseInverseSolver(Ainv=dense_inverse(
                A, dtype=tdt, device=self.device)),
            rhs_fixed=torch.zeros((n_points, 3), dtype=tdt,
                                  device=self.device),
            n_verts=n_points, rho=float(penalty_param))
        return True

    def solve_ADMM(self, init_x, rel_residual_eps, max_iter, anderson_m):
        self.system = dataclasses.replace(
            self.system, max_iter=int(max_iter), anderson_m=int(anderson_m),
            accel=anderson_m > 0)
        t = MicroTimer()
        x0 = torch.from_numpy(np.asarray(init_x, self.dtype)).to(self.device)
        trace = solve_plain(self.system, x0)
        self._solution = trace.x.cpu().numpy()
        fv = trace.function_values.cpu().numpy()
        total = t.elapsed_s()
        self.function_values = [float(v) for v in fv]
        n = len(fv)
        self.elapsed_time = [total * (i + 1) / max(n, 1) for i in range(n)]
        self.stats = dict(iters=n, resets=trace.resets,
                          host_reads=trace.host_reads, solve_s=total)
        return trace

    def get_solution(self):
        return self._solution
