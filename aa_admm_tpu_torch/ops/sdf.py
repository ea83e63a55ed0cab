"""Analytic signed-distance colliders, batched over query points (counterpart
of aa_admm_tpu/ops/sdf.py:1-186, the whole module).

Equivalents of the reference passive colliders
(admm_anderson_hard_zxu/src/PassiveObject.hpp:30-140): Floor, SlideFloor,
Sphere, PlaneAndHalfSphere (plinkohit), Cylinder (plinkopony). The reference
folds several colliders by keeping the minimum signed distance; here the
scene is a frozen struct of tensors and the fold runs over its objects in the
JAX module's order (floors, slide floors, spheres, plane-and-half-spheres,
cylinders), a strictly smaller distance replacing the best so far. Every
operation is fixed-shape device work without host reads, so a prox that
calls it can be captured in a CUDA graph.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ._batchutil import torch_dtype

_BIG = 1e16


def _norm3(a):
    """Euclidean norm over the last axis of size 3, summed as (x + y) + z."""
    return torch.sqrt(a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1]
                      + a[..., 2] * a[..., 2])


def _unit(d, n):
    return d / torch.clamp_min(n, 1e-300)[..., None]


def _floor_sd(x, y0):
    d = x[..., 1] - y0
    p = torch.stack([x[..., 0], y0.expand_as(x[..., 0]), x[..., 2]], dim=-1)
    return d, p


def _slide_floor_sd(x, center, normal):
    e = x - center
    d = e[..., 0] * normal[0] + e[..., 1] * normal[1] + e[..., 2] * normal[2]
    p = x - d[..., None] * normal
    return d, p


def _sphere_sd(x, center, rad):
    dir_ = x - center
    n = _norm3(dir_)
    return n - rad, center + _unit(dir_, n) * rad


def _plane_half_sphere_sd(x, center, rad):
    """PlaneAndHalfSphere::signed_distance (PassiveObject.hpp:82-116):
    outside the cylinder of radius rad -> plane at center.y; inside -> a
    half-sphere bump (distance to the sphere surface, with the above-plane
    case treated as norm+rad)."""
    px, pz = x[..., 0] - center[0], x[..., 2] - center[2]
    zero = torch.zeros_like(px)
    dc = torch.sqrt(px * px + zero * zero + pz * pz) - rad
    d_plane = x[..., 1] - center[1]
    p_plane = torch.stack([x[..., 0], center[1].expand_as(px), x[..., 2]],
                          dim=-1)
    dir_ = x - center
    n = _norm3(dir_)
    d_hs = torch.where(d_plane > 0, n + rad, rad - n)
    p_hs = center + _unit(dir_, n) * rad
    outside = dc > 0
    return (torch.where(outside, d_plane, d_hs),
            torch.where(outside[..., None], p_plane, p_hs))


def _cylinder_sd(x, center, rad):
    """Cylinder along z (Cylinder::signed_distance, PassiveObject.hpp:118-136)."""
    posxy = torch.stack([x[..., 0], x[..., 1], torch.zeros_like(x[..., 0])],
                        dim=-1)
    dir_ = posxy - center
    n = _norm3(dir_)
    p = center + _unit(dir_, n) * rad
    return n - rad, torch.cat([p[..., :2], x[..., 2:3]], dim=-1)


@dataclasses.dataclass(frozen=True)
class SdfScene:
    """Fixed collection of analytic colliders; empty tensors mean 'none'."""

    floor_y: torch.Tensor            # (Nf,)
    slide_center: torch.Tensor       # (Ns, 3)
    slide_normal: torch.Tensor       # (Ns, 3) unit
    sphere_center: torch.Tensor      # (Nsp, 3)
    sphere_rad: torch.Tensor         # (Nsp,)
    phs_center: torch.Tensor         # (Nph, 3)  plane+half-sphere
    phs_rad: torch.Tensor            # (Nph,)
    cyl_center: torch.Tensor         # (Nc, 3)
    cyl_rad: torch.Tensor            # (Nc,)

    @classmethod
    def empty(cls, dtype=torch.float64, device=None) -> "SdfScene":
        kw = dict(dtype=torch_dtype(dtype), device=device)
        z3, z1 = torch.zeros((0, 3), **kw), torch.zeros((0,), **kw)
        return cls(z1, z3, z3, z3, z1, z3, z1, z3, z1)

    @property
    def n_objects(self) -> int:
        return (self.floor_y.shape[0] + self.slide_center.shape[0]
                + self.sphere_center.shape[0] + self.phs_center.shape[0]
                + self.cyl_center.shape[0])

    def signed_distance(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """Min signed distance and its surface point over all colliders.
        x: (..., 3). Returns (d (...,), point (..., 3))."""
        best_d = torch.full(x.shape[:-1], _BIG, dtype=x.dtype, device=x.device)
        best_p = x

        def fold(ds, ps):
            closer = ds < best_d
            return (torch.where(closer, ds, best_d),
                    torch.where(closer[..., None], ps, best_p))

        for i in range(self.floor_y.shape[0]):
            best_d, best_p = fold(*_floor_sd(x, self.floor_y[i]))
        for i in range(self.slide_center.shape[0]):
            best_d, best_p = fold(*_slide_floor_sd(x, self.slide_center[i],
                                                   self.slide_normal[i]))
        for i in range(self.sphere_center.shape[0]):
            best_d, best_p = fold(*_sphere_sd(x, self.sphere_center[i],
                                              self.sphere_rad[i]))
        for i in range(self.phs_center.shape[0]):
            best_d, best_p = fold(*_plane_half_sphere_sd(
                x, self.phs_center[i], self.phs_rad[i]))
        for i in range(self.cyl_center.shape[0]):
            best_d, best_p = fold(*_cylinder_sd(x, self.cyl_center[i],
                                                self.cyl_rad[i]))
        return best_d, best_p


class SdfSceneBuilder:
    """Host-side accumulator mirroring Solver::add_obstacle."""

    def __init__(self, dtype=np.float64):
        self.dtype = dtype
        self.floors, self.slides, self.spheres = [], [], []
        self.phs, self.cyls = [], []

    def add_floor(self, y):
        self.floors.append(float(y))
        return self

    def add_slide_floor(self, center, normal):
        n = np.asarray(normal, self.dtype)
        self.slides.append((np.asarray(center, self.dtype), n / np.linalg.norm(n)))
        return self

    def add_sphere(self, center, rad):
        self.spheres.append((np.asarray(center, self.dtype), float(rad)))
        return self

    def add_plane_half_sphere(self, center, rad):
        self.phs.append((np.asarray(center, self.dtype), float(rad)))
        return self

    def add_cylinder(self, center, rad):
        self.cyls.append((np.asarray(center, self.dtype), float(rad)))
        return self

    @property
    def n_objects(self) -> int:
        return (len(self.floors) + len(self.slides) + len(self.spheres)
                + len(self.phs) + len(self.cyls))

    def build(self, dtype=None, device=None) -> SdfScene:
        """The scene's tensors, every one in `dtype` (default the builder's)
        on `device`."""
        dt = np.dtype(self.dtype if dtype is None else dtype)

        def t(a, shape):
            return torch.from_numpy(np.asarray(a, dt).reshape(shape)).to(device)

        def arr3(items):
            return t([c for c, _ in items], (-1, 3))

        def arr1(items):
            return t([r for _, r in items], (-1,))

        return SdfScene(
            floor_y=t(self.floors, (-1,)),
            slide_center=arr3(self.slides),
            slide_normal=t([n for _, n in self.slides], (-1, 3)),
            sphere_center=arr3(self.spheres), sphere_rad=arr1(self.spheres),
            phs_center=arr3(self.phs), phs_rad=arr1(self.phs),
            cyl_center=arr3(self.cyls), cyl_rad=arr1(self.cyls))
