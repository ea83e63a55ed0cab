"""Struct-of-arrays element batches of the physics solver (counterpart of
aa_admm_tpu/ops/elements.py:1-434, the whole module: ``m2p``/``p2m``,
``TetBatch``, ``TriBatch``, ``PinBatch``, ``CollisionBatch``,
``SelfCollisionBatch``, ``wexpand`` and ``block_sqnorm``).

One batch holds all elements of one type and material (the reference's
per-element ``EnergyTerm`` hierarchy, admm_anderson_xzu/src/EnergyTerm.hpp:
67-213). The reduction matrix D never exists: ``deform`` computes D x as a
gather and small per-element products, ``scatter`` applies D^T in gather
form over the batch's inverse table (``inv_idx``/``inv_mask``, built on the
host when the batch is made; ops/_batchutil.py), so it sums in one fixed
order on every run and device.

z-blocks are in PLANE FORM, as in the JAX package: a rank-2 tensor (C, E)
whose rows are the C components of the per-element quantity (row-major over
its logical shape) and whose columns are the elements — tets (9, E), the
deformation gradient F = [x1-x0|x2-x0|x3-x0] B^-1 with plane 3*i+j = F[i, j];
cloth triangles (6, E), the 3x2 deformation gradient in the 2D rest basis
with plane 2*i+j = F[i, j]; pins and collisions (3, E), the vertex positions. On a GPU this keeps every elementwise
launch over the element axis coalesced, and per-element weights broadcast
as (C, E) * (E,). The unrolled math of ops/mat3.py and ops/prox.py sees the
logical (E, *zdim) view through ``p2m``/``m2p``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.config import Lame
from . import cuda_kernels
from . import prox as proxops
from ._batchutil import GatherAdjoint, _host_mirror, _t
from .sdf import SdfScene


def m2p(a):
    """Logical (E, *zdim) -> plane form (C, E); C = prod(zdim) row-major."""
    return a.reshape(a.shape[0], -1).T


def p2m(p, zdim):
    """Plane form (C, E) -> logical (E, *zdim) view."""
    return p.T.reshape((p.shape[-1],) + tuple(zdim))


@dataclasses.dataclass(frozen=True)
class TetBatch(GatherAdjoint):
    """All tets of one material; weight w = sqrt(k*vol) per element
    (TetEnergyTerm.cpp:63-64). On a CUDA block with the Jacobi SVD (not
    ``graphed``), prox and grad are one launch each of csrc/tet_prox.cu
    (cuda_kernels.tet_prox / tet_grad); on the CPU, and with
    svd_method="lapack" (torch.linalg.svd), they are the torch math of
    ops/prox.py, on the block as the solver hands it (torch's CPU math
    rounds by layout)."""

    tets: torch.Tensor     # (E, 4) int64
    Dm_inv: torch.Tensor   # (E, 3, 3) inverse rest-edge matrix
    vol: torch.Tensor      # (E,)
    w: torch.Tensor        # (E,)
    mu: torch.Tensor       # (E,)
    lam: torch.Tensor      # (E,)
    k: torch.Tensor        # (E,) bulk modulus
    kind: str = "linear"   # linear | neohookean | stvk
    svd_method: str = "jacobi"
    inv_idx: Optional[torch.Tensor] = None   # (n, K) gather-form adjoint
    inv_mask: Optional[torch.Tensor] = None  # (n, K)

    zdim = (3, 3)

    def _adjoint_index(self):
        return self.tets, None, self.w.dtype

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
        return self._scatter(contrib.permute(2, 1, 0).reshape(-1, 3), n_verts)

    def _check_kind(self):
        if self.kind not in ("linear", "neohookean", "stvk"):
            raise ValueError(self.kind)

    @property
    def graphed(self):
        """Whether the physics step replays prox and grad from CUDA graphs:
        not with the Jacobi SVD, where each call on the card is one kernel
        launch."""
        return self.svd_method != "jacobi"

    def prox(self, v):
        self._check_kind()
        if v.is_cuda and not self.graphed:
            return cuda_kernels.tet_prox(v.contiguous(), self.mu, self.lam,
                                         self.k, self.kind)
        vm = p2m(v, self.zdim)
        fn = {"linear": proxops.prox_tet_linear,
              "neohookean": proxops.prox_tet_neohookean,
              "stvk": proxops.prox_tet_stvk}[self.kind]
        return m2p(fn(vm, self.mu, self.lam, self.k, self.svd_method))

    def grad(self, z):
        """dU/dF * vol at z (EnergyTerm::get_all_gradient path)."""
        self._check_kind()
        if z.is_cuda and not self.graphed:
            return cuda_kernels.tet_grad(z.contiguous(), self.mu, self.lam,
                                         self.k, self.vol, self.kind)
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
class TriBatch(GatherAdjoint):
    """Cloth triangles; w = sqrt(k*area) (TriEnergyTerm.cpp:50-51)."""

    tris: torch.Tensor      # (E, 3) int64
    rest_inv: torch.Tensor  # (E, 2, 2)
    area: torch.Tensor      # (E,)
    w: torch.Tensor         # (E,)
    mu: torch.Tensor
    lam: torch.Tensor
    k: torch.Tensor
    limit_min: torch.Tensor
    limit_max: torch.Tensor
    variant: str = "zxu"    # strain-limiting style: xzu | zxu
    inv_idx: Optional[torch.Tensor] = None   # (n, K) gather-form adjoint
    inv_mask: Optional[torch.Tensor] = None  # (n, K)

    zdim = (3, 2)
    graphed = True   # prox and grad replay CUDA graphs in the physics step

    def _adjoint_index(self):
        return self.tris, None, self.w.dtype

    @classmethod
    def from_mesh(cls, verts: np.ndarray, tris: np.ndarray, lame: Lame,
                  variant: str = "zxu", dtype=np.float64) -> "TriBatch":
        if lame.limit_min > 1.0:
            raise ValueError("TriBatch: strain limit min should be -inf to 1")
        if lame.limit_max < 1.0:
            raise ValueError("TriBatch: strain limit max should be 1 to inf")
        e12 = verts[tris[:, 1]] - verts[tris[:, 0]]
        e13 = verts[tris[:, 2]] - verts[tris[:, 0]]
        n1 = e12 / np.linalg.norm(e12, axis=-1, keepdims=True)
        t = e13 - np.sum(e13 * n1, axis=-1, keepdims=True) * n1
        n2 = t / np.linalg.norm(t, axis=-1, keepdims=True)
        basis = np.stack([n1, n2], axis=-1)                  # (E, 3, 2)
        edges = np.stack([e12, e13], axis=-1)                # (E, 3, 2)
        rest = np.einsum("eji,ejk->eik", basis, edges)       # (E, 2, 2)
        area = 0.5 * np.linalg.det(rest)
        if np.any(area < 0):
            raise ValueError("TriBatch: inverted initial pose")
        rest_inv = np.linalg.inv(rest)
        E = len(tris)
        k = np.full(E, lame.bulk_modulus, dtype)
        w = np.sqrt(k * area)
        tris = np.asarray(tris, np.int64)
        out = cls(tris=_t(tris), rest_inv=_t(rest_inv, dtype),
                  area=_t(area, dtype), w=_t(w, dtype),
                  mu=_t(np.full(E, lame.mu, dtype)),
                  lam=_t(np.full(E, lame.lam, dtype)), k=_t(k),
                  limit_min=_t(np.full(E, lame.limit_min, dtype)),
                  limit_max=_t(np.full(E, lame.limit_max, dtype)),
                  variant=variant)
        return _host_mirror(out, tris=tris,
                            rest_inv=rest_inv.astype(np.float64),
                            w=w.astype(np.float64))

    def deform(self, x):
        """D x in plane form (6, E): F[i, j] = sum_k e_k[i] R[k, j]."""
        g = x[self.tris]                                    # (E, 3, 3)
        e = g[:, 1:] - g[:, :1]                             # (E, 2 edges, 3)
        R = self.rest_inv
        F = (e[:, 0, :, None] * R[:, 0, None, :]
             + e[:, 1, :, None] * R[:, 1, None, :])         # (E, 3, 2)
        return F.reshape(-1, 6).T.contiguous()              # (6, E)

    def scatter(self, t, n_verts):
        """Adjoint of deform (t plane form (6, E)) -> vertex space (n, 3)."""
        T = t.reshape(3, 2, -1)                             # (i, j, E)
        Rt = self.rest_inv.permute(1, 2, 0)                 # (k, j, E)
        dE = T[:, None, 0] * Rt[None, :, 0] + T[:, None, 1] * Rt[None, :, 1]
        v0 = -(dE[:, 0] + dE[:, 1])                         # (i, E)
        contrib = torch.cat([v0[:, None], dE], dim=1)       # (i, vertex, E)
        return self._scatter(contrib.permute(2, 1, 0).reshape(-1, 3), n_verts)

    def prox(self, v):
        vm = p2m(v, self.zdim)
        fn = (proxops.prox_tri_zxu if self.variant == "zxu"
              else proxops.prox_tri_xzu)
        return m2p(fn(vm, self.limit_min, self.limit_max))

    def grad(self, z):
        return m2p(proxops.grad_tri(p2m(z, self.zdim), self.mu, self.lam,
                                    self.k, self.area))

    def energy(self, z):
        return proxops.energy_tri(p2m(z, self.zdim), self.mu, self.lam,
                                  self.k, self.area)

    def strain_violation(self, z):
        return proxops.strain_limit_violation(p2m(z, self.zdim),
                                              self.limit_min, self.limit_max)


class _VertexTerms(GatherAdjoint):
    """Identity reduction on a vertex and no elastic energy: the shared
    half of the pin and collision batches."""

    zdim = (3,)
    graphed = True   # prox and grad replay CUDA graphs in the physics step

    def deform(self, x):
        return x[self.idx].T                               # (3, E)

    def scatter(self, t, n_verts):
        return self._scatter(t.T, n_verts)

    def grad(self, z):
        return torch.zeros_like(z)

    def energy(self, z):
        return z.new_zeros(z.shape[-1])


@dataclasses.dataclass(frozen=True)
class PinBatch(_VertexTerms):
    """Spring pins: identity reduction on a vertex; prox snaps to the target.
    weight = sqrt(2*bulk(rubber)) (SpringEnergyTerm.hpp:53-57)."""

    idx: torch.Tensor      # (E,) int64
    target: torch.Tensor   # (E, 3)
    active: torch.Tensor   # (E,) bool
    w: torch.Tensor        # (E,)
    inv_idx: Optional[torch.Tensor] = None   # (n, K) gather-form adjoint
    inv_mask: Optional[torch.Tensor] = None  # (n, K)

    @classmethod
    def create(cls, idx, targets, dtype=np.float64) -> "PinBatch":
        E = len(idx)
        w = np.full(E, np.sqrt(Lame.rubber().bulk_modulus * 2.0), dtype)
        idx_h = np.asarray(idx, np.int64).reshape(E)
        out = cls(idx=_t(idx_h),
                  target=_t(np.asarray(targets, dtype).reshape(E, 3)),
                  active=torch.ones((E,), dtype=torch.bool), w=_t(w))
        return _host_mirror(out, idx=idx_h, w=w)

    def prox(self, v):
        return proxops.prox_pin(v.T, self.target, self.active).T


def _soft_rubber_w(E, dtype):
    return np.full(E, np.sqrt(Lame.soft_rubber().bulk_modulus * 2.0), dtype)


@dataclasses.dataclass(frozen=True)
class CollisionBatch(_VertexTerms):
    """Per-vertex hard-collision terms (zxu Collision energy,
    CollisionEnergyTerm.hpp:41-117): identity reduction, prox snaps to the
    nearest penetrating passive collider (analytic SDFs and/or tet-mesh
    obstacles); weight = sqrt(2*bulk(soft_rubber))."""

    idx: torch.Tensor      # (E,) int64
    active: torch.Tensor   # (E,) bool
    w: torch.Tensor        # (E,)
    scene: SdfScene
    mesh_sdfs: tuple = ()
    inv_idx: Optional[torch.Tensor] = None   # (n, K) gather-form adjoint
    inv_mask: Optional[torch.Tensor] = None  # (n, K)

    @classmethod
    def create(cls, idx, scene: SdfScene, mesh_sdfs=(),
               dtype=np.float64) -> "CollisionBatch":
        E = len(idx)
        w = _soft_rubber_w(E, dtype)
        idx_h = np.asarray(idx, np.int64).reshape(E)
        out = cls(idx=_t(idx_h), active=torch.ones((E,), dtype=torch.bool),
                  w=_t(w), scene=scene, mesh_sdfs=tuple(mesh_sdfs))
        return _host_mirror(out, idx=idx_h, w=w)

    def prox(self, v):
        return proxops.prox_collision(v.T, self.scene, self.active,
                                      self.mesh_sdfs).T


@dataclasses.dataclass(frozen=True)
class SelfCollisionBatch(_VertexTerms):
    """Per-vertex self-collision terms, the counterpart of the reference's
    dynamic TetMeshCollision path (DynamicObject.hpp:30-120 with the
    per-vertex collision-energy treatment of CollisionEnergyTerm.hpp).

    Detection runs once per timestep (PhysicsSolver.step) and its contacts
    (deformed surface point + outward normal) hold for the step's ADMM
    iterations: the prox snaps a candidate z to the contact point whenever
    it lies on the penetrating side of the contact plane. The solver copies
    each step's contacts into ``active``, ``target`` and ``normal`` in place,
    so a CUDA graph captured over ``prox`` reads them on every replay.
    Identity reduction; weight sqrt(2*bulk(soft_rubber)).
    """

    idx: torch.Tensor     # (E,) int64 — candidate vertices (usually all)
    w: torch.Tensor       # (E,)
    active: torch.Tensor  # (E,) bool — refreshed per step
    target: torch.Tensor  # (E, 3) deformed contact point, per step
    normal: torch.Tensor  # (E, 3) deformed outward normal, per step
    inv_idx: Optional[torch.Tensor] = None   # (n, K) gather-form adjoint
    inv_mask: Optional[torch.Tensor] = None  # (n, K)

    @classmethod
    def create(cls, idx, dtype=np.float64) -> "SelfCollisionBatch":
        E = len(idx)
        w = _soft_rubber_w(E, dtype)
        idx_h = np.asarray(idx, np.int64).reshape(E)
        return _host_mirror(
            cls(idx=_t(idx_h), w=_t(w),
                active=torch.zeros((E,), dtype=torch.bool),
                target=_t(np.zeros((E, 3), dtype)),
                normal=_t(np.zeros((E, 3), dtype))),
            idx=idx_h, w=w)

    def prox(self, v):
        vm = v.T
        d = vm - self.target
        pen = (d[:, 0] * self.normal[:, 0] + d[:, 1] * self.normal[:, 1]
               + d[:, 2] * self.normal[:, 2]) < 0.0
        hit = self.active & pen
        return torch.where(hit[:, None], self.target, vm).T


def wexpand(batch, a):
    """Per-element weights for a plane-form (C, E) block: the (E,) weights
    already align with its trailing element axis."""
    return batch.w


def block_sqnorm(a):
    return (a * a).sum()
