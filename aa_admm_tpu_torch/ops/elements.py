"""Struct-of-arrays element batches of the physics solver (counterpart of
aa_admm_tpu/ops/elements.py:1-434 for the xzu slice: ``m2p``/``p2m``,
``TetBatch``, ``PinBatch``, ``wexpand`` and ``block_sqnorm``; the cloth,
collision and self-collision batches come with the zxu order).

One batch holds all elements of one type and material (the reference's
per-element ``EnergyTerm`` hierarchy, admm_anderson_xzu/src/EnergyTerm.hpp:
67-213). The reduction matrix D never exists: ``deform`` computes D x as a
gather and small per-element products, ``scatter`` applies D^T with
``index_add_`` (on CUDA, float atomics in a varying order).

z-blocks are in PLANE FORM, as in the JAX package: a rank-2 tensor (C, E)
whose rows are the C components of the per-element quantity (row-major over
its logical shape) and whose columns are the elements — tets (9, E), the
deformation gradient F = [x1-x0|x2-x0|x3-x0] B^-1 with plane 3*i+j = F[i, j];
pins (3, E), the vertex positions. On a GPU this keeps every elementwise
launch over the element axis coalesced, and per-element weights broadcast
as (C, E) * (E,). The unrolled math of ops/mat3.py and ops/prox.py sees the
logical (E, *zdim) view through ``p2m``/``m2p``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.config import Lame
from . import prox as proxops
from ._batchutil import _host_mirror, _scatter_rows, _t


def m2p(a):
    """Logical (E, *zdim) -> plane form (C, E); C = prod(zdim) row-major."""
    return a.reshape(a.shape[0], -1).T


def p2m(p, zdim):
    """Plane form (C, E) -> logical (E, *zdim) view."""
    return p.T.reshape((p.shape[-1],) + tuple(zdim))


@dataclasses.dataclass(frozen=True)
class TetBatch:
    """All tets of one material; weight w = sqrt(k*vol) per element
    (TetEnergyTerm.cpp:63-64)."""

    tets: torch.Tensor     # (E, 4) int64
    Dm_inv: torch.Tensor   # (E, 3, 3) inverse rest-edge matrix
    vol: torch.Tensor      # (E,)
    w: torch.Tensor        # (E,)
    mu: torch.Tensor       # (E,)
    lam: torch.Tensor      # (E,)
    k: torch.Tensor        # (E,) bulk modulus
    kind: str = "linear"   # linear | neohookean | stvk
    svd_method: str = "jacobi"

    zdim = (3, 3)

    @classmethod
    def from_mesh(cls, verts: np.ndarray, tets: np.ndarray, lame: Lame,
                  kind: str = "linear", dtype=np.float64,
                  svd_method: str = "jacobi") -> "TetBatch":
        v0 = verts[tets[:, 0]]
        edges = np.transpose(verts[tets[:, 1:]] - v0[:, None, :], (0, 2, 1))
        vol = np.linalg.det(edges) / 6.0
        if np.any(vol < 0):
            raise ValueError("TetBatch: inverted initial tet")
        Dm_inv = np.linalg.inv(edges)
        E = len(tets)
        k = np.full(E, lame.bulk_modulus, dtype)
        w = np.sqrt(k * vol)
        tets = np.asarray(tets, np.int64)
        out = cls(tets=_t(tets), Dm_inv=_t(Dm_inv, dtype), vol=_t(vol, dtype),
                  w=_t(w, dtype), mu=_t(np.full(E, lame.mu, dtype)),
                  lam=_t(np.full(E, lame.lam, dtype)), k=_t(k),
                  kind=kind, svd_method=svd_method)
        return _host_mirror(out, tets=tets, Dm_inv=Dm_inv.astype(np.float64),
                            w=w.astype(np.float64))

    def deform(self, x):
        """D x: per-element deformation gradients from positions x (n, 3), in
        plane form (9, E): F[i, j] = sum_k (x_{k+1} - x_0)[i] B[k, j]."""
        g = x[self.tets]                                   # (E, 4, 3)
        e = g[:, 1:] - g[:, :1]                            # (E, 3 edges, 3)
        B = self.Dm_inv
        F = (e[:, 0, :, None] * B[:, 0, None, :]
             + e[:, 1, :, None] * B[:, 1, None, :]
             + e[:, 2, :, None] * B[:, 2, None, :])        # (E, 3, 3)
        return F.reshape(-1, 9).T.contiguous()             # (9, E)

    def scatter(self, t, n_verts):
        """D^T t: the adjoint of deform (t in plane form (9, E)), scattered
        to vertex space (n, 3). dE = t_mat B^T gives the per-edge rows;
        vertex 0 receives minus their sum."""
        T = t.reshape(3, 3, -1)                            # (i, j, E)
        Bt = self.Dm_inv.permute(1, 2, 0)                  # (k, j, E)
        dE = (T[:, None, 0] * Bt[None, :, 0] + T[:, None, 1] * Bt[None, :, 1]
              + T[:, None, 2] * Bt[None, :, 2])            # (coord i, edge k, E)
        v0 = -(dE[:, 0] + dE[:, 1] + dE[:, 2])             # (i, E)
        contrib = torch.cat([v0[:, None], dE], dim=1)      # (i, vertex, E)
        return _scatter_rows(contrib.permute(2, 1, 0).reshape(-1, 3),
                             self.tets.reshape(-1), n_verts)

    def _check_kind(self):
        if self.kind not in ("linear", "neohookean", "stvk"):
            raise ValueError(self.kind)

    def prox(self, v):
        self._check_kind()
        vm = p2m(v, self.zdim)
        fn = {"linear": proxops.prox_tet_linear,
              "neohookean": proxops.prox_tet_neohookean,
              "stvk": proxops.prox_tet_stvk}[self.kind]
        return m2p(fn(vm, self.mu, self.lam, self.k, self.svd_method))

    def grad(self, z):
        """dU/dF * vol at z (EnergyTerm::get_all_gradient path)."""
        self._check_kind()
        zm = p2m(z, self.zdim)
        if self.kind == "linear":
            out = proxops.grad_tet_linear(zm, self.mu, self.lam, self.k,
                                          self.vol, self.svd_method)
        elif self.kind == "neohookean":
            out = proxops.grad_tet_neohookean(zm, self.mu, self.lam, self.k,
                                              self.vol)
        else:
            out = proxops.grad_tet_stvk(zm, self.mu, self.lam, self.k,
                                        self.vol)
        return m2p(out)

    def energy(self, z):
        self._check_kind()
        zm = p2m(z, self.zdim)
        if self.kind == "linear":
            return proxops.energy_tet_linear(zm, self.mu, self.lam, self.k,
                                             self.vol, self.svd_method)
        if self.kind == "neohookean":
            return proxops.energy_tet_neohookean(zm, self.mu, self.lam,
                                                 self.k, self.vol)
        return proxops.energy_tet_stvk(zm, self.mu, self.lam, self.k,
                                       self.vol)


@dataclasses.dataclass(frozen=True)
class PinBatch:
    """Spring pins: identity reduction on a vertex; prox snaps to the target.
    weight = sqrt(2*bulk(rubber)) (SpringEnergyTerm.hpp:53-57)."""

    idx: torch.Tensor      # (E,) int64
    target: torch.Tensor   # (E, 3)
    active: torch.Tensor   # (E,) bool
    w: torch.Tensor        # (E,)

    zdim = (3,)

    @classmethod
    def create(cls, idx, targets, dtype=np.float64) -> "PinBatch":
        E = len(idx)
        w = np.full(E, np.sqrt(Lame.rubber().bulk_modulus * 2.0), dtype)
        idx_h = np.asarray(idx, np.int64).reshape(E)
        out = cls(idx=_t(idx_h),
                  target=_t(np.asarray(targets, dtype).reshape(E, 3)),
                  active=torch.ones((E,), dtype=torch.bool), w=_t(w))
        return _host_mirror(out, idx=idx_h, w=w)

    def deform(self, x):
        return x[self.idx].T                               # (3, E)

    def scatter(self, t, n_verts):
        return _scatter_rows(t.T, self.idx, n_verts)

    def prox(self, v):
        return proxops.prox_pin(v.T, self.target, self.active).T

    def grad(self, z):
        return torch.zeros_like(z)

    def energy(self, z):
        return z.new_zeros(z.shape[-1])


def wexpand(batch, a):
    """Per-element weights for a plane-form (C, E) block: the (E,) weights
    already align with its trailing element axis."""
    return batch.w


def block_sqnorm(a):
    return (a * a).sum()
