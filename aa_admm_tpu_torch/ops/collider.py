"""Mesh-based colliders and collision detection, batched on the device
(counterpart of aa_admm_tpu/ops/collider.py:1-339, the whole module).

* ``TetMeshSdf`` — static tet-mesh obstacle (PassiveMesh,
  admm_anderson_xzu/src/PassiveObject.hpp:67-107 / zxu :137-178): a query
  inside any tet gets signed distance -(distance to the nearest surface
  triangle) and that surface point; outside contributes nothing.
* ``DynamicTetCollider`` — deforming tet-mesh collider (TetMeshCollision,
  admm_anderson_xzu/src/DynamicObject.hpp:30-120): point-in-deformed-tet
  test, the hit mapped to the rest pose by barycentric coordinates, then the
  nearest rest-pose surface triangle with face, barycentrics and normal.
* ``HashGridTetCollider`` — the same detection through a sorted spatial
  hash rebuilt on the device every call (fixed shapes, no host reads).
* ``detect`` — the Collider::detect sweep (Collider.hpp:152-212).

Every (query, tet) and (query, triangle) pair is dense tensor arithmetic,
as in the JAX module. Ties resolve as there: ``argmax``/``argmin`` return the
first extremum in torch as in JAX (``argmax`` of a mask is taken on its
integer cast), ``argsort`` is stable and ``searchsorted(right=True)`` is
JAX's ``side="right"``. The spatial hash multiplies int32 cell indices by
large primes, where JAX wraps on overflow: here the product is taken in
int64 and masked to the bucket count, a power of two, whose low bits are
those of the wrapped int32 product.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core.factory import TetMeshData
from . import mat3
from .closest_point import closest_point_on_triangles

_BIG = 1e16


def _t(a, dtype=None, device=None):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _normalize(n):
    nn = torch.sqrt((n * n).sum(-1, keepdim=True))
    return n / torch.clamp_min(nn, 1e-300)


def barycoords_tet(x, v0, v1, v2, v3):
    """Barycentric coordinates of x in tets (broadcasting over leading dims).
    v*: (..., 3). Returns (..., 4)."""
    T = torch.stack([v1 - v0, v2 - v0, v3 - v0], dim=-1)  # (..., 3, 3)
    b = mat3.solve(T, x - v0)
    b0 = 1.0 - (b[..., 0] + b[..., 1] + b[..., 2])
    return torch.cat([b0[..., None], b], dim=-1)


def _first_true(mask):
    """Index of the first True along the last axis (0 where none)."""
    return torch.argmax(mask.to(torch.int8), dim=-1)


def _take(a, i):
    """a[p, i[p]] for a (P, C, ...) tensor and indices i (P,)."""
    idx = i.reshape((-1, 1) + (1,) * (a.dim() - 2))
    return torch.gather(a, 1, idx.expand((a.shape[0], 1) + a.shape[2:]))[:, 0]


def point_in_tets(x, tet_verts, eps=0.0):
    """x: (P, 3); tet_verts: (T, 4, 3). Returns (inside_any (P,),
    first_tet_idx (P,), barys (P, 4))."""
    b = barycoords_tet(x[:, None, :], tet_verts[None, :, 0],
                       tet_verts[None, :, 1], tet_verts[None, :, 2],
                       tet_verts[None, :, 3])
    inside = (b >= -eps).all(-1)                  # (P, T)
    first = _first_true(inside)
    return inside.any(1), first, _take(b, first)


def nearest_surface(x, tri_verts):
    """Nearest point on a (small) triangle soup: returns (point (P,3),
    sqdist (P,), tri_idx (P,), normal (P,3))."""
    q, sqd = closest_point_on_triangles(x, tri_verts)
    i = torch.argmin(sqd, dim=1)
    d = _take(sqd, i)
    qi = _take(q, i)
    tv = tri_verts[i]
    n = _normalize(_cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]))
    return qi, d, i, n


@dataclasses.dataclass(frozen=True)
class TetMeshSdf:
    """Static tet-mesh obstacle (PassiveMesh)."""

    tet_verts: torch.Tensor  # (T, 4, 3)
    tri_verts: torch.Tensor  # (S, 3, 3) surface triangles

    @classmethod
    def create(cls, verts, tets, faces=None, dtype=np.float64,
               device=None) -> "TetMeshSdf":
        verts = np.asarray(verts, dtype)
        tets = np.asarray(tets, np.int64)
        if faces is None:
            faces = TetMeshData(verts=verts, tets=tets.astype(np.int32)
                                ).surface_faces()
        faces = np.asarray(faces, np.int64)
        return cls(tet_verts=_t(verts[tets], device=device),
                   tri_verts=_t(verts[faces], device=device))

    def signed_distance(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """(d (P,), point (P, 3)); d = -dist to the surface when inside,
        +BIG outside (the reference leaves the payload untouched there)."""
        xf = x.reshape(-1, 3)
        inside, _, _ = point_in_tets(xf, self.tet_verts)
        q, sqd, _, _ = nearest_surface(xf, self.tri_verts)
        d = torch.where(inside, -torch.sqrt(torch.clamp_min(sqd, 0.0)),
                        torch.full_like(sqd, _BIG))
        return (d.reshape(x.shape[:-1]),
                torch.where(inside[:, None], q, xf).reshape(x.shape))


class DynamicHit(NamedTuple):
    """Payload of a dynamic-collider hit (DynamicCollision::Payload,
    Collider.hpp:56-83)."""
    hit: torch.Tensor        # (P,) bool
    face: torch.Tensor       # (P,) rest-surface triangle index
    barys: torch.Tensor      # (P, 3) barycentrics on that triangle
    normal: torch.Tensor     # (P, 3) rest-pose face normal
    point: torch.Tensor      # (P, 3) rest-pose surface point


@dataclasses.dataclass(frozen=True)
class DynamicTetCollider:
    """Deforming tet-mesh collider (TetMeshCollision): the rest-pose
    geometry is fixed; current vertex positions are passed per query."""

    tets: torch.Tensor        # (T, 4) int64 (global vertex ids)
    faces: torch.Tensor       # (S, 3) int64 rest surface triangles
    rest_verts: torch.Tensor  # (V, 3) rest positions (local ids)
    vert_offset: int = 0

    @classmethod
    def create(cls, verts, tets, vert_offset=0, dtype=np.float64,
               device=None):
        mesh = TetMeshData(verts=np.asarray(verts, dtype),
                           tets=np.asarray(tets, np.int32))
        return cls(tets=_t(mesh.tets.astype(np.int64) + vert_offset,
                           device=device),
                   faces=_t(mesh.surface_faces().astype(np.int64),
                            device=device),
                   rest_verts=_t(mesh.verts, device=device),
                   vert_offset=vert_offset)

    def detect_with_overflow(self, queries, x_all, query_ids=None):
        """(DynamicHit, overflow () bool). The dense path is exact, so
        overflow is always False here; the spatial-hash subclass reports
        candidate-list truncation."""
        return (self.detect(queries, x_all, query_ids=query_ids),
                torch.zeros((), dtype=torch.bool, device=queries.device))

    def detect(self, queries, x_all, query_ids=None) -> DynamicHit:
        """queries (P, 3) against the mesh deformed to x_all (n, 3).
        query_ids: global vertex ids of the queries — a query inside a tet
        holding its own vertex is skipped (skip_vert_idx,
        DynamicObject.hpp:75-77)."""
        tv = x_all[self.tets]                      # (T, 4, 3) deformed tets
        b = barycoords_tet(queries[:, None, :], tv[None, :, 0],
                           tv[None, :, 1], tv[None, :, 2], tv[None, :, 3])
        inside = (b >= 0.0).all(-1)                # (P, T)
        if query_ids is not None:
            own = (self.tets[None, :, :] == query_ids[:, None, None]).any(-1)
            inside = inside & ~own
        first = _first_true(inside)
        return self._hit_payload(queries, inside.any(1), first,
                                 _take(b, first))

    def _hit_payload(self, queries, hit, first, barys4) -> DynamicHit:
        """Shared tail of detection: map the hit point to the rest pose via
        the containing tet's barycentrics, then find the nearest rest-pose
        surface triangle (DynamicObject.hpp:71-118)."""
        rest_tv = self.rest_verts[self.tets[first] - self.vert_offset]
        restx = (barys4[:, 0, None] * rest_tv[:, 0]
                 + barys4[:, 1, None] * rest_tv[:, 1]
                 + barys4[:, 2, None] * rest_tv[:, 2]
                 + barys4[:, 3, None] * rest_tv[:, 3])
        tri = self.rest_verts[self.faces]          # (S, 3, 3)
        q, _, tri_idx, n = nearest_surface(restx, tri)
        # Orient outward: restx is interior, so the outward normal points
        # away from it (surface extraction does not fix the orientation).
        flip = ((n * (restx - q)).sum(-1) > 0)[:, None]
        n = torch.where(flip, -n, n)
        bar = _tri_barycentrics(q, tri[tri_idx])
        zero = torch.zeros_like(q)
        h = hit[:, None]
        return DynamicHit(hit=hit, face=tri_idx,
                          barys=torch.where(h, bar, zero),
                          normal=torch.where(h, n, zero),
                          point=torch.where(h, q, queries.to(q.dtype)))


@dataclasses.dataclass(frozen=True)
class HashGridTetCollider(DynamicTetCollider):
    """Spatial-hash accelerated TetMeshCollision.

    The reference rebuilds a BVH over the deformed tets every step; here a
    sorted spatial hash is rebuilt on the device each call with fixed
    shapes:
      1. deformed tet centroids -> integer cells of side h = 1.05 x the
         largest deformed tet circumradius (a query inside a tet lies within
         the centroid's 3x3x3 cell neighbourhood);
      2. cells hashed into 2^k buckets; tets sorted by bucket id;
      3. per query, the 27 neighbour buckets give candidate ranges by two
         searchsorted calls; up to ``cap`` candidates per bucket are taken;
      4. the barycentric test runs on (P, 27 * cap) candidates.
    It matches DynamicTetCollider.detect whenever no bucket overflows
    ``cap`` (the smallest containing tet index is picked, like the dense
    argmax). ``detect_with_overflow`` also returns the overflow flag; the
    solver escalates on it (PhysicsSolver._escalate_colliders).
    """

    n_buckets: int = 2048
    cap: int = 8

    @classmethod
    def create(cls, verts, tets, vert_offset=0, dtype=np.float64,
               n_buckets=2048, cap=8, device=None):
        base = DynamicTetCollider.create(verts, tets, vert_offset, dtype,
                                         device)
        return cls(tets=base.tets, faces=base.faces,
                   rest_verts=base.rest_verts, vert_offset=base.vert_offset,
                   n_buckets=n_buckets, cap=cap)

    def _hash_cells(self, c):
        """Large-prime XOR hash (Teschner et al. 2003) of int64 cells (..., 3)
        into power-of-two buckets."""
        h = (c[..., 0] * 73856093) ^ (c[..., 1] * 19349663) \
            ^ (c[..., 2] * 83492791)
        return h & (self.n_buckets - 1)

    def _cells(self, x_all):
        """(deformed tets (T, 4, 3), tet cells' hashes (T,), cell size h)."""
        tv = x_all[self.tets]
        centroid = (tv[:, 0] + tv[:, 1] + tv[:, 2] + tv[:, 3]) / 4.0
        d = tv - centroid[:, None, :]
        rad2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                + d[..., 2] * d[..., 2]).max(dim=1).values
        h = 1.05 * torch.sqrt(rad2.max()) + 1e-30
        tc = torch.floor(centroid / h).to(torch.int32).to(torch.int64)
        return tv, self._hash_cells(tc), h

    def max_bucket_load(self, x_all) -> int:
        """Largest number of tets sharing a hash bucket at positions x_all —
        must stay <= cap for exactness."""
        _, th, _ = self._cells(x_all)
        return int(torch.bincount(th, minlength=self.n_buckets).max())

    def detect(self, queries, x_all, query_ids=None) -> DynamicHit:
        return self.detect_with_overflow(queries, x_all, query_ids)[0]

    def bucket_ranges(self, queries, x_all):
        """(sorted tet order (T,), starts (P, 27), ends (P, 27), deformed
        tets): each query's 27 neighbour buckets as ranges of the order."""
        tv, tet_hash, h = self._cells(x_all)
        order = torch.argsort(tet_hash, stable=True)
        sorted_hash = tet_hash[order]
        qc = torch.floor(queries / h).to(torch.int32).to(torch.int64)
        r = torch.arange(-1, 2, device=queries.device)
        offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                           -1).reshape(27, 3)
        nh = self._hash_cells(qc[:, None, :] + offs[None, :, :])
        starts = torch.searchsorted(sorted_hash, nh)
        ends = torch.searchsorted(sorted_hash, nh, right=True)
        return order, starts, ends, tv

    def detect_with_overflow(self, queries, x_all, query_ids=None):
        order, starts, ends, tv = self.bucket_ranges(queries, x_all)
        T = tv.shape[0]
        # Runtime exactness guard: a queried bucket range longer than cap
        # means candidates were dropped and contacts may be missed.
        overflow = ((ends - starts) > self.cap).any()
        slot = starts[..., None] + torch.arange(self.cap,
                                                device=queries.device)
        P = queries.shape[0]
        valid = (slot < ends[..., None]).reshape(P, -1)
        cand = order[slot.clamp(0, T - 1)].reshape(P, -1)   # (P, 27 cap)
        ctv = tv[cand]                                      # (P, C, 4, 3)
        b = barycoords_tet(queries[:, None, :], ctv[:, :, 0], ctv[:, :, 1],
                           ctv[:, :, 2], ctv[:, :, 3])      # (P, C, 4)
        inside = (b >= 0.0).all(-1) & valid
        if query_ids is not None:
            own = (self.tets[cand] == query_ids[:, None, None]).any(-1)
            inside = inside & ~own
        # Deterministic pick matching the dense path: smallest tet index.
        pick_key = torch.where(inside, cand, torch.full_like(cand, T))
        j = torch.argmin(pick_key, dim=1)
        first = torch.clamp_max(_take(pick_key, j), T - 1)
        return (self._hit_payload(queries, inside.any(1), first, _take(b, j)),
                overflow)


def _tri_barycentrics(p, tri):
    """Barycentric coords of p (P,3) on triangles tri (P,3,3)."""
    v0 = tri[:, 1] - tri[:, 0]
    v1 = tri[:, 2] - tri[:, 0]
    v2 = p - tri[:, 0]
    d00 = (v0 * v0).sum(-1)
    d01 = (v0 * v1).sum(-1)
    d11 = (v1 * v1).sum(-1)
    d20 = (v2 * v0).sum(-1)
    d21 = (v2 * v1).sum(-1)
    denom = torch.clamp_min(d00 * d11 - d01 * d01, 1e-300)
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    return torch.stack([1.0 - v - w, v, w], dim=-1)


class PassiveHit(NamedTuple):
    hit: torch.Tensor     # (P,) bool — penetrating some passive object
    dx: torch.Tensor      # (P,) signed distance (min over objects)
    point: torch.Tensor   # (P, 3) surface point


def detect(x, scene=None, mesh_sdfs=(), dynamic=(), query_ids=None):
    """Collider::detect (Collider.hpp:152-212): every vertex against all
    passive objects (analytic SDF scene + mesh obstacles) and dynamic
    colliders; fixed-shape masked outputs instead of hit buffers."""
    best_d = torch.full(x.shape[:1], _BIG, dtype=x.dtype, device=x.device)
    best_p = x
    sources = ([scene] if scene is not None and scene.n_objects else [])
    for src in sources + list(mesh_sdfs):
        d, p = src.signed_distance(x)
        closer = d < best_d
        best_d = torch.where(closer, d, best_d)
        best_p = torch.where(closer[:, None], p, best_p)
    passive = PassiveHit(hit=best_d < 0, dx=best_d, point=best_p)
    dyn_hits = [dc.detect(x, x, query_ids=query_ids) for dc in dynamic]
    return passive, dyn_hits
