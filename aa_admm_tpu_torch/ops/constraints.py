"""Geometry constraint batches (counterpart of aa_admm_tpu/ops/constraints.py)
— the struct-of-arrays replacement for the reference's ``Constraint<N>``
virtual hierarchy (Geometry/Constraint.h:48-414).

Each batch is a frozen dataclass of tensors with
  * ``transform(x)`` — gather + invariance transform to a block (C, K, 3);
  * ``scatter(t, n)`` — D^T applied to a block, in gather form over the
    batch's inverse table (``inv_idx``/``inv_mask``, built on the host when
    the batch is made): the same bits on every run, on every device;
  * ``project(p)`` — the constraint projection.

``ELEM_FIELDS`` names the fields with one row per constraint, the ones a
split over ranks cuts (``parallel/geometry.py``); every other tensor field
(a reference surface's triangles and groups) is whole on every rank.

Weights: each constraint carries w = sqrt(weight) (Constraint.h:62-68).
Batches are created on the CPU at f64 with f64 NumPy host mirrors; the
solver's setup moves them to its dtype and device (``cast_floats``). Index
tensors are int64.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import numpy as np
import torch

from ..core.timers import span
from ._batchutil import (  # noqa: F401 (re-export)
    GatherAdjoint, _host_mirror, _t, cast_floats, hostarr, torch_dtype,
    with_gather_adjoint)
from .closest_point import (build_tri_groups, closest_point_cached,
                            closest_point_cached_group, closest_point_on_mesh,
                            closest_point_on_mesh_2stage, cp_cache_group_init,
                            cp_cache_init)
from .svd3 import eigh3x3

# Above this triangle count, RefSurfaceBatch uses the coarse-to-fine
# closest-point query (and an in-loop candidate cache) instead of brute force.
_CP_2STAGE_THRESHOLD = 4096
# Above this triangle count, the candidate cache is subgroup-granular.
_CP_GROUP_THRESHOLD = 20000
# The flat cache also keeps its candidates' coordinates in kernel B1's layout
# while Q * K stays within this bound.
_CANDT_MAX = 1_000_000


def _pad_rows(rows, pad_val=0):
    """Variable-length index rows -> ((R, K) int64 padded, (R, K) bool mask)."""
    k = max(len(r) for r in rows)
    out = np.full((len(rows), k), pad_val, np.int64)
    mask = np.zeros((len(rows), k), bool)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
        mask[i, : len(r)] = True
    return out, mask


@dataclasses.dataclass(frozen=True)
class PlaneBatch(GatherAdjoint):
    """Per-face best-fit-plane projection, MEAN_CENTERING transform
    (PlaneConstraint, Constraint.h:396-414; JAX constraints.py:74-152).
    Faces padded to the largest valence; padded slots point at vertex 0 and
    are masked to zero in every transform, scatter and projection (and
    left out of the inverse table)."""

    ELEM_FIELDS: ClassVar[tuple] = ("idx", "mask", "count", "w")
    idx: torch.Tensor    # (C, K) int64, padded
    mask: torch.Tensor   # (C, K) bool
    count: torch.Tensor  # (C,) float — valence
    w: torch.Tensor      # (C,)
    inv_idx: Optional[torch.Tensor] = None   # (n, Kv) gather-form adjoint
    inv_mask: Optional[torch.Tensor] = None  # (n, Kv)

    def _adjoint_index(self):
        return self.idx, self.mask, self.w.dtype

    @classmethod
    def create(cls, faces, weight, dtype=np.float64):
        idx, mask = _pad_rows(faces)
        C = len(faces)
        w = np.full(C, np.sqrt(weight), dtype)
        cnt = mask.sum(1).astype(dtype)
        out = cls(idx=_t(idx), mask=_t(mask), count=_t(cnt), w=_t(w))
        return _host_mirror(out, idx=idx, mask=mask, count=cnt, w=w)

    @property
    def block_shape(self):
        return tuple(self.idx.shape) + (3,)

    def transform(self, x):
        m = self.mask[..., None]
        p = x[self.idx] * m
        mean = p.sum(1) / self.count[:, None]
        return (p - mean[:, None, :]) * m

    def transform_host(self, x):
        """f64 numpy transform (delta-form precomputation of D x0)."""
        idx, mask = hostarr(self, 'idx'), hostarr(self, 'mask')
        cnt = hostarr(self, 'count').astype(np.float64)
        p = np.asarray(x, np.float64)[idx] * mask[..., None]
        mean = p.sum(1) / cnt[:, None]
        return (p - mean[:, None, :]) * mask[..., None]

    def scatter(self, t, n_verts):
        """Adjoint of the masked mean-centering: the centered block scattered
        to its vertices."""
        m = self.mask[..., None]
        tm = t * m
        mean = tm.sum(1) / self.count[:, None]
        tc = (tm - mean[:, None, :]) * m
        return self._scatter(tc.reshape(-1, 3), n_verts)

    def project(self, p):
        """Subtract the best-fit-plane normal component: the normal is the
        eigenvector of the least eigenvalue of the centered points'
        covariance (Constraint.h:406-413). argmin takes the first minimum,
        as the JAX package's does."""
        cov = (p[..., :, None] * p[..., None, :]).sum(1)     # (C, 3, 3)
        wvals, V = eigh3x3(cov)
        nidx = torch.argmin(wvals, dim=-1)
        normal = torch.gather(V, 2, nidx[:, None, None].expand(-1, 3, 1))[..., 0]
        nn = torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
        normal = normal / torch.clamp_min(nn, 1e-300)
        coef = (normal[:, None, :] * p).sum(-1)
        return (p - coef[..., None] * normal[:, None, :]) * self.mask[..., None]


@dataclasses.dataclass(frozen=True)
class AngleBatch(GatherAdjoint):
    """3-point angle clamp to [min,max] radians, SUBTRACT_FIRST transform
    (AngleConstraint, Constraint.h:220-296). Block shape (C, 2, 3)."""

    ELEM_FIELDS: ClassVar[tuple] = ("idx", "w", "min_angle", "max_angle")
    idx: torch.Tensor        # (C, 3) tip, side1, side2
    w: torch.Tensor          # (C,)
    min_angle: torch.Tensor  # (C,)
    max_angle: torch.Tensor  # (C,)
    inv_idx: Optional[torch.Tensor] = None   # (n, K) gather-form adjoint
    inv_mask: Optional[torch.Tensor] = None  # (n, K)

    @classmethod
    def create(cls, triples, weight, min_radian, max_radian, dtype=np.float64):
        C = len(triples)
        mn = np.maximum(0.0, np.broadcast_to(min_radian, (C,)).astype(dtype))
        mx = np.minimum(np.pi, np.broadcast_to(max_radian, (C,)).astype(dtype))
        idx = np.asarray(triples, np.int64).reshape(C, 3)
        w = np.full(C, np.sqrt(weight), dtype)
        out = cls(idx=_t(idx), w=_t(w), min_angle=_t(mn), max_angle=_t(mx))
        return _host_mirror(out, idx=idx, w=w)

    @property
    def block_shape(self):
        return (self.idx.shape[0], 2, 3)

    def transform(self, x):
        tip = x[self.idx[:, 0]]
        return torch.stack([x[self.idx[:, 1]] - tip, x[self.idx[:, 2]] - tip],
                           dim=1)

    def transform_host(self, x):
        idx = hostarr(self, 'idx')
        x = np.asarray(x, np.float64)
        tip = x[idx[:, 0]]
        return np.stack([x[idx[:, 1]] - tip, x[idx[:, 2]] - tip], axis=1)

    def scatter(self, t, n_verts):
        contrib = torch.cat([-(t[:, 0] + t[:, 1])[:, None, :], t], dim=1)
        return self._scatter(contrib.reshape(-1, 3), n_verts)

    def project(self, p):
        """Closed-form coplanar rotation projection (Constraint.h:243-291)."""
        v1, v2 = p[:, 0], p[:, 1]
        eps = 1e-14
        v1_sq = (v1 * v1).sum(-1)
        v2_sq = (v2 * v2).sum(-1)
        v1_n = torch.sqrt(v1_sq)
        v2_n = torch.sqrt(v2_sq)
        u1 = v1 / torch.clamp_min(v1_n, 1e-300)[:, None]
        u2 = v2 / torch.clamp_min(v2_n, 1e-300)[:, None]
        cos_g = torch.clamp((u1 * u2).sum(-1), -1.0, 1.0)

        min_cos = torch.clamp(torch.cos(self.min_angle), -1.0, 1.0)
        max_cos = torch.clamp(torch.cos(self.max_angle), -1.0, 1.0)
        needs = ((1.0 - torch.abs(cos_g) > eps)
                 & ((cos_g > min_cos) | (cos_g < max_cos)))

        gamma = torch.arccos(cos_g)
        too_small = cos_g > min_cos  # angle below range -> open it up
        eta = torch.where(too_small, self.min_angle - gamma,
                          gamma - self.max_angle)
        eta = torch.clamp_min(eta, 0.0)
        theta = 0.5 * torch.atan2(v2_sq * torch.sin(2 * eta),
                                  v1_sq + v2_sq * torch.cos(2 * eta))
        theta = torch.minimum(torch.clamp_min(theta, 0.0), eta)
        phi = eta - theta

        u3 = u2 - u1 * cos_g[:, None]
        u3 = u3 / torch.clamp_min(torch.linalg.vector_norm(
            u3, dim=-1, keepdim=True), 1e-300)
        u4 = u1 - u2 * cos_g[:, None]
        u4 = u4 / torch.clamp_min(torch.linalg.vector_norm(
            u4, dim=-1, keepdim=True), 1e-300)
        sgn = torch.where(too_small, -1.0, 1.0).to(p.dtype)[:, None]
        u3 = u3 * sgn
        u4 = u4 * sgn

        p1 = ((u1 * torch.cos(theta)[:, None] + u3 * torch.sin(theta)[:, None])
              * (v1_n * torch.cos(theta))[:, None])
        p2 = ((u2 * torch.cos(phi)[:, None] + u4 * torch.sin(phi)[:, None])
              * (v2_n * torch.cos(phi))[:, None])
        proj = torch.stack([p1, p2], dim=1)
        return torch.where(needs[:, None, None], proj, p)


@dataclasses.dataclass(frozen=True)
class EdgeLengthBatch(GatherAdjoint):
    """Edge vector projected to target length, SUBTRACT_FIRST
    (EdgeLengthConstraint, Constraint.h:194-218). Block (C, 1, 3)."""

    ELEM_FIELDS: ClassVar[tuple] = ("idx", "w", "target")
    idx: torch.Tensor      # (C, 2)
    w: torch.Tensor        # (C,)
    target: torch.Tensor   # (C,)
    inv_idx: Optional[torch.Tensor] = None   # (n, K) gather-form adjoint
    inv_mask: Optional[torch.Tensor] = None  # (n, K)

    @classmethod
    def create(cls, pairs, weight, target_length, dtype=np.float64):
        C = len(pairs)
        idx = np.asarray(pairs, np.int64).reshape(C, 2)
        w = np.full(C, np.sqrt(weight), dtype)
        out = cls(idx=_t(idx), w=_t(w), target=_t(
            np.broadcast_to(target_length, (C,)).astype(dtype)))
        return _host_mirror(out, idx=idx, w=w)

    @property
    def block_shape(self):
        return (self.idx.shape[0], 1, 3)

    def transform(self, x):
        return (x[self.idx[:, 1]] - x[self.idx[:, 0]])[:, None, :]

    def transform_host(self, x):
        idx = hostarr(self, 'idx')
        x = np.asarray(x, np.float64)
        return (x[idx[:, 1]] - x[idx[:, 0]])[:, None, :]

    def scatter(self, t, n_verts):
        contrib = torch.cat([-t, t], dim=1)  # (C, 2, 3)
        return self._scatter(contrib.reshape(-1, 3), n_verts)

    def project(self, p):
        e = p[:, 0]
        n = torch.clamp_min(torch.linalg.vector_norm(e, dim=-1, keepdim=True),
                            1e-300)
        return (e / n * self.target[:, None])[:, None, :]


@dataclasses.dataclass(frozen=True)
class ClosenessBatch(GatherAdjoint):
    """Pin a vertex toward a target, IDENTITY transform (ClosenessConstraint,
    Constraint.h:299-326, implemented correctly as in the JAX package)."""

    ELEM_FIELDS: ClassVar[tuple] = ("idx", "w", "target")
    idx: torch.Tensor     # (C,)
    w: torch.Tensor       # (C,)
    target: torch.Tensor  # (C, 3)
    inv_idx: Optional[torch.Tensor] = None   # (n, K) gather-form adjoint
    inv_mask: Optional[torch.Tensor] = None  # (n, K)

    @classmethod
    def create(cls, idx, weight, targets, dtype=np.float64):
        C = len(idx)
        idx_h = np.asarray(idx, np.int64).reshape(C)
        w = np.full(C, np.sqrt(weight), dtype)
        out = cls(idx=_t(idx_h), w=_t(w),
                  target=_t(np.asarray(targets, dtype).reshape(C, 3)))
        return _host_mirror(out, idx=idx_h, w=w)

    @property
    def block_shape(self):
        return (self.idx.shape[0], 1, 3)

    def transform(self, x):
        return x[self.idx][:, None, :]

    def transform_host(self, x):
        return np.asarray(x, np.float64)[hostarr(self, 'idx')][:, None, :]

    def scatter(self, t, n_verts):
        return self._scatter(t[:, 0], n_verts)

    def project(self, p):
        return self.target[:, None, :].expand(p.shape)


@dataclasses.dataclass(frozen=True)
class RefSurfaceBatch(GatherAdjoint):
    """Closest-point projection of vertices onto a fixed reference trimesh
    (PointToRefSurfaceConstraint, Constraint.h:328-394). Block (C, 1, 3)."""

    ELEM_FIELDS: ClassVar[tuple] = ("idx", "w")
    idx: torch.Tensor        # (C,)
    w: torch.Tensor          # (C,)
    tri_verts: torch.Tensor  # (T, 3, 3) reference surface triangles
    # Morton-grouped copies for the subgroup cache (build_tri_groups; None
    # for meshes at or below _CP_GROUP_THRESHOLD triangles).
    grp_tris: Optional[torch.Tensor] = None     # (G, S, 3, 3)
    grp_cent: Optional[torch.Tensor] = None     # (G, S, 3)
    grp_rad: Optional[torch.Tensor] = None      # (G, S)
    grp_gcenter: Optional[torch.Tensor] = None  # (G, 3)
    grp_gradius: Optional[torch.Tensor] = None  # (G,)
    tile: int = 2048
    cp_groups: int = 6          # NG candidate subgroups per query
    cp_sub: int = 16            # triangles per subgroup
    inv_idx: Optional[torch.Tensor] = None   # (n, K) gather-form adjoint
    inv_mask: Optional[torch.Tensor] = None  # (n, K)

    @classmethod
    def create(cls, idx, weight, ref_verts, ref_faces, dtype=np.float64,
               tile: int = 2048, group_size: int = 64, sub_size: int = 16,
               cp_groups: int = 6):
        C = len(idx)
        rv = np.asarray(ref_verts, dtype)
        rf = np.asarray(ref_faces, np.int64)
        idx_h = np.asarray(idx, np.int64).reshape(C)
        w = np.full(C, np.sqrt(weight), dtype)
        grp = {}
        if len(rf) > _CP_GROUP_THRESHOLD:
            with span("setup.build"):
                tp, cent, rad, gc, gr = build_tri_groups(
                    rv[rf], group_size=group_size)
            G, S = len(gc), group_size
            grp = dict(grp_tris=_t(tp.reshape(G, S, 3, 3), dtype),
                       grp_cent=_t(cent.reshape(G, S, 3), dtype),
                       grp_rad=_t(rad.reshape(G, S), dtype),
                       grp_gcenter=_t(gc, dtype),
                       grp_gradius=_t(gr, dtype),
                       cp_groups=cp_groups, cp_sub=sub_size)
        out = cls(idx=_t(idx_h), w=_t(w), tri_verts=_t(rv[rf]), tile=tile,
                  **grp)
        return _host_mirror(out, idx=idx_h, w=w)

    @property
    def block_shape(self):
        return (self.idx.shape[0], 1, 3)

    def transform(self, x):
        return x[self.idx][:, None, :]

    def transform_host(self, x):
        return np.asarray(x, np.float64)[hostarr(self, 'idx')][:, None, :]

    def scatter(self, t, n_verts):
        return self._scatter(t[:, 0], n_verts)

    def project(self, p):
        if self.tri_verts.shape[0] > _CP_2STAGE_THRESHOLD:
            q = closest_point_on_mesh_2stage(p[:, 0], self.tri_verts)
        else:
            q = closest_point_on_mesh(p[:, 0], self.tri_verts, tile=self.tile)
        return q[:, None, :]

    # -- iterative-query candidate cache (solver loop fast path) --

    def cp_cache_init(self, dtype):
        """Candidate cache for in-loop projections, or None when the mesh is
        small enough for the one-shot brute-force sweep. Subgroup-granular
        with host-built groups; otherwise flat, with the candidate
        coordinates cached in kernel B1's layout while Q * K <= 1M."""
        T = int(self.tri_verts.shape[0])
        dev = self.idx.device
        if T <= _CP_2STAGE_THRESHOLD:
            return None
        if self.grp_tris is not None:
            return cp_cache_group_init(int(self.idx.shape[0]),
                                       self.cp_groups, dtype, dev)
        Q, k = int(self.idx.shape[0]), min(48, T)
        return cp_cache_init(Q, k, dtype, dev, with_candT=Q * k <= _CANDT_MAX)

    def project_cached(self, p, cache, reduce=None):
        """project() through the movement-bounded candidate cache — exact,
        self-refreshing. Returns (proj, cache, refreshed); deciding whether
        to refresh is one host read (taken over every rank's queries when a
        split batch passes its ranks' sum as reduce)."""
        if self.grp_tris is not None:
            q, cache, refreshed = closest_point_cached_group(
                p[:, 0], self.grp_tris, self.grp_cent, self.grp_rad,
                self.grp_gcenter, self.grp_gradius, cache,
                sub_size=self.cp_sub, reduce=reduce)
        else:
            q, cache, refreshed = closest_point_cached(
                p[:, 0], self.tri_verts, cache, reduce=reduce)
        return q[:, None, :], cache, refreshed


def _local_stiffness(b, scale_w: bool):
    """(idx (C, k), K (C, k, k)) of one batch's D^T W^2 D contribution, or
    (idx (C,), w2 (C,)) for identity-transform batches."""
    w2 = (hostarr(b, 'w') ** 2) if scale_w else np.ones(len(hostarr(b, 'idx')))
    idx = hostarr(b, 'idx')
    if isinstance(b, PlaneBatch):
        # face c's rows: (I - 1 1^T / k) over its k valid slots
        mask = hostarr(b, 'mask').astype(np.float64)
        cnt = hostarr(b, 'count')
        mm = mask[:, :, None] * mask[:, None, :]
        T = (np.eye(idx.shape[1])[None] - mm / cnt[:, None, None]) * mm
        return idx, np.einsum("c,cik,cjk->cij", w2, T, T)
    if isinstance(b, AngleBatch):
        G = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
        return idx, np.einsum("c,ir,jr->cij", w2, G, G)
    if isinstance(b, EdgeLengthBatch):
        G = np.array([[-1.0], [1.0]])
        return idx, np.einsum("c,ir,jr->cij", w2, G, G)
    if isinstance(b, (ClosenessBatch, RefSurfaceBatch)):
        return idx, np.asarray(w2, np.float64)
    raise TypeError(f"unknown constraint batch type {type(b).__name__}")


def assemble_geometry_node_matrix_sparse(n_verts: int, hard, soft, rho: float,
                                         reg_rows=None):
    """Sparse (scipy CSR) per-coordinate global matrix
    ``rho D_h^T D_h + D_s^T W_s^2 D_s + L^T L`` (the ELL/CG path)."""
    import scipy.sparse as sp

    rows = [np.zeros(0, np.int64)]
    cols = [np.zeros(0, np.int64)]
    vals = [np.zeros(0, np.float64)]

    def emit(idx, K):
        C, k = idx.shape
        rows.append(np.repeat(idx[:, :, None], k, axis=2).ravel())
        cols.append(np.repeat(idx[:, None, :], k, axis=1).ravel())
        vals.append(K.ravel())

    def add_batch(b, scale_w, scale):
        idx, K = _local_stiffness(b, scale_w)
        if idx.ndim == 1:
            rows.append(idx)
            cols.append(idx)
            vals.append(K * scale)
        else:
            emit(idx, K * scale)

    for b in hard:
        add_batch(b, scale_w=False, scale=rho)
    for b in soft:
        add_batch(b, scale_w=True, scale=1.0)
    if reg_rows is not None:
        idx, coef, mask = reg_rows
        cm = coef * mask
        emit(idx, np.einsum("ri,rj->rij", cm, cm))
    A = sp.coo_matrix(
        (np.concatenate(vals),
         (np.concatenate(rows), np.concatenate(cols))),
        shape=(n_verts, n_verts)).tocsr()
    A.sum_duplicates()
    return A


def assemble_geometry_node_matrix(n_verts: int, hard, soft, rho: float,
                                  reg_rows=None, vertex_map=None) -> np.ndarray:
    """Host-side dense per-coordinate global matrix
    ``rho D_h^T D_h + D_s^T W_s^2 D_s + L^T L``
    (ALMGeometrySolver::setup_ADMM, ALMGeometrySolver.h:96-141). With
    ``vertex_map`` (n_fine,) -> [0, n_verts) it assembles the Galerkin coarse
    operator P^T A P of the piecewise-constant prolongation instead."""
    def remap(idx):
        return idx if vertex_map is None else vertex_map[idx]

    def add_batch(A, b, scale_w):
        idx, K = _local_stiffness(b, scale_w)
        idx = remap(idx)
        if idx.ndim == 1:
            np.add.at(A, (idx, idx), K)
        else:
            np.add.at(A, (idx[:, :, None], idx[:, None, :]), K)

    A = np.zeros((n_verts, n_verts))
    for b in hard:
        add_batch(A, b, scale_w=False)
    A *= rho
    for b in soft:
        add_batch(A, b, scale_w=True)
    if reg_rows is not None:
        idx, coef, mask = reg_rows
        idx = remap(idx)
        cm = coef * mask
        K = np.einsum("ri,rj->rij", cm, cm)
        np.add.at(A, (idx[:, :, None], idx[:, None, :]), K)
    return A

