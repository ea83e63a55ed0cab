"""The plain wire-mesh solve: the ALM/ADMM of ``Geometry/ALMGeometrySolver.h``
with safeguarded Anderson acceleration, written from the published
algorithm in plain torch, NumPy and SciPy. It imports nothing of the port
and takes nothing that the port has made.

Constraints (WireMeshOpt.cpp): every face corner's angle held in
[min, max] and every edge's length held at the target (hard, penalty rho);
every vertex drawn to its closest point on the reference surface (soft,
weight w). One trial:

    z_h = P_h(D_h x + u),  z_s = P_s(x)
    x'  = A^-1 (rho D_h^T (z_h - u) + w^2 z_s),  A = rho D_h^T D_h + w^2 I
    u'  = u + D_h x' - z_h
    r   = |D_h x' - z_h|^2 + |D_h x' - D_h x|^2

A trial is accepted when the previous one was rejected or r fell below
the last accepted r; Anderson acceleration mixes (u', x') over the last m
accepted trials, and a rejected trial returns to the last accepted
un-mixed (u', x') and restarts the window. The state lives in absolute
coordinates in ``dtype``; the global solve is a sparse LU in float64 of the
dtype's rounded right-hand side, its result rounded back to the dtype. The
hard projections P_h take their arguments rounded to ``local_dtype`` (by
default ``dtype``) and compute in it: a local step in a lower precision
than the state.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .closest_point import closest_points, triangle_groups


class Anderson:
    """Anderson acceleration (type II) over a ring of the last m differences
    of residual and iterate, each residual difference scaled to unit norm;
    the coefficients solve the normal equations by a pseudo-inverse."""

    def __init__(self, m, u0):
        d = u0.numel()
        self.m, self.u, self.iter, self.col = m, u0, 0, 0
        kw = dict(dtype=u0.dtype, device=u0.device)
        self.dF = torch.zeros((d, m), **kw)
        self.dG = torch.zeros((d, m), **kw)
        self.scale = torch.ones(m, **kw)
        self.M = torch.zeros((m, m), dtype=torch.float64)

    def reset(self, u):
        self.u, self.iter, self.col = u, 0, 0

    def compute(self, g):
        F = g - self.u
        if self.iter == 0:
            self.dF[:, 0] = -F
            self.dG[:, 0] = -g
            self.u = g
        else:
            c, m = self.col, self.m
            self.dF[:, c] += F
            self.dG[:, c] += g
            s = max(float(self.dF[:, c].double().norm()), 1e-14)
            self.scale[c] = s
            self.dF[:, c] /= s
            mk = min(m, self.iter)
            prods = (self.dF[:, c:c + 1] * self.dF[:, :mk]).sum(0)
            self.M[c, :mk] = prods.double().cpu()
            self.M[:mk, c] = prods.double().cpu()
            rhs = (self.dF[:, :mk] * F[:, None]).sum(0).double().cpu()
            eps = float(torch.finfo(g.dtype).eps)
            Mk = self.M[:mk, :mk].numpy()
            theta = np.linalg.pinv(Mk, rcond=mk * eps * 10, hermitian=True) \
                @ rhs.numpy()
            th = torch.as_tensor(theta, device=g.device).to(g.dtype)
            self.u = g - self.dG[:, :mk] @ (th / self.scale[:mk])
            self.col = (c + 1) % m
            self.dF[:, self.col] = -F
            self.dG[:, self.col] = -g
        self.iter += 1
        return self.u


class WireMeshReference:
    def __init__(self, n, corners, edges, target, min_angle, max_angle,
                 ref_tris, penalty, weight, device, dtype=torch.float64,
                 local_dtype=None):
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        self.n, self.rho, self.w2 = n, float(penalty), float(weight)
        self.dtype, self.device = dtype, torch.device(device)
        self.local = dtype if local_dtype is None else local_dtype
        self.min_a, self.max_a = float(min_angle), float(max_angle)
        self.target = float(target)
        dev = self.device
        self.corners = torch.as_tensor(corners, dtype=torch.int64, device=dev)
        self.edges = torch.as_tensor(edges, dtype=torch.int64, device=dev)
        # the surface's exact closest points at the reference's precision,
        # float32 at the least
        self.cp_dtype = (dtype if torch.finfo(dtype).bits >= 32
                         else torch.float32)
        self.tris = torch.as_tensor(ref_tris, device=dev).to(self.cp_dtype)
        self.groups = triangle_groups(self.tris)
        # A = rho D_h^T D_h + w^2 I, D_h's rows: the corners' two sides, the
        # edges
        c, e = np.asarray(corners), np.asarray(edges)
        Ca, Ce = len(c), len(e)
        r = np.arange(2 * Ca + Ce)
        rows = np.concatenate([r, r])
        cols = np.concatenate([c[:, 1], c[:, 2], e[:, 1],
                               c[:, 0], c[:, 0], e[:, 0]])
        vals = np.concatenate([np.ones(2 * Ca + Ce), -np.ones(2 * Ca + Ce)])
        D = sp.csr_matrix((vals, (rows, cols)), shape=(2 * Ca + Ce, n))
        A = self.rho * (D.T @ D) + self.w2 * sp.identity(n)
        self.lu = spla.splu(A.tocsc())

    # D_h and its adjoint
    def hard(self, x):
        c, e = self.corners, self.edges
        tip = x[c[:, 0]]
        return (torch.stack([x[c[:, 1]] - tip, x[c[:, 2]] - tip], 1),
                x[e[:, 1]] - x[e[:, 0]])

    def hard_t(self, ta, te):
        c, e = self.corners, self.edges
        out = torch.zeros((self.n, 3), dtype=ta.dtype, device=ta.device)
        out.index_add_(0, c[:, 1], ta[:, 0])
        out.index_add_(0, c[:, 2], ta[:, 1])
        out.index_add_(0, c[:, 0], -(ta[:, 0] + ta[:, 1]))
        out.index_add_(0, e[:, 1], te)
        out.index_add_(0, e[:, 0], -te)
        return out

    def project_edges(self, d):
        return d / d.norm(dim=-1, keepdim=True) * self.target

    def project_angles(self, d):
        """The nearest pair of sides whose angle lies in [min, max]: both
        sides turn in their plane, through theta and eta - theta (eta the
        angle's excess), and shrink onto the turned lines; theta minimizes
        |v1|^2 sin^2 theta + |v2|^2 sin^2 (eta - theta)."""
        v1, v2 = d[:, 0], d[:, 1]
        n1, n2 = v1.norm(dim=-1), v2.norm(dim=-1)
        u1, u2 = v1 / n1[:, None], v2 / n2[:, None]
        cos_g = (u1 * u2).sum(-1).clamp(-1.0, 1.0)
        gamma = torch.arccos(cos_g)
        low = gamma < self.min_a
        eta = torch.where(low, self.min_a - gamma, gamma - self.max_a)
        act = (eta > 0) & (1.0 - cos_g.abs() > 1e-14)
        eta = eta.clamp_min(0.0)
        theta = 0.5 * torch.atan2(n2 * n2 * torch.sin(2 * eta),
                                  n1 * n1 + n2 * n2 * torch.cos(2 * eta))
        theta = torch.minimum(theta.clamp_min(0.0), eta)
        phi = eta - theta
        # in-plane unit normals to u1 (towards u2) and to u2 (towards u1);
        # opening the angle turns each side away from the other
        t1 = u2 - u1 * cos_g[:, None]
        t2 = u1 - u2 * cos_g[:, None]
        t1 = t1 / t1.norm(dim=-1, keepdim=True)
        t2 = t2 / t2.norm(dim=-1, keepdim=True)
        sgn = torch.where(low, -1.0, 1.0).to(d.dtype)[:, None]
        p1 = (u1 * torch.cos(theta)[:, None] + sgn * t1 * torch.sin(theta)[:, None]) \
            * (n1 * torch.cos(theta))[:, None]
        p2 = (u2 * torch.cos(phi)[:, None] + sgn * t2 * torch.sin(phi)[:, None]) \
            * (n2 * torch.cos(phi))[:, None]
        return torch.where(act[:, None, None], torch.stack([p1, p2], 1), d)

    def surface(self, x):
        return closest_points(x.to(self.cp_dtype), self.tris,
                              self.groups).to(x.dtype)

    def global_solve(self, rhs):
        sol = self.lu.solve(rhs.double().cpu().numpy())
        return torch.as_tensor(sol, device=self.device).to(self.dtype)

    def solve(self, x_init, iters, m):
        """The solve from x_init (n, 3) for `iters` accepted iterations with
        Anderson window m: the final positions (n, 3) as float64 NumPy."""
        x = torch.as_tensor(np.asarray(x_init), device=self.device).to(
            self.dtype)
        ua = torch.zeros((len(self.corners), 2, 3), dtype=self.dtype,
                         device=self.device)
        ue = torch.zeros((len(self.edges), 3), dtype=self.dtype,
                         device=self.device)
        sizes = (ua.numel(), ue.numel())

        def flat(a, e, xx):
            return torch.cat([a.reshape(-1), e.reshape(-1), xx.reshape(-1)])

        def unflat(v):
            a, e, xx = torch.split(v, [sizes[0], sizes[1], 3 * self.n])
            return a.reshape(ua.shape), e.reshape(ue.shape), xx.reshape(-1, 3)

        aa = Anderson(m, flat(ua, ue, x))
        last = (ua, ue, x)                 # the last accepted un-mixed trial
        prev, reset, accepted = math.inf, False, 0
        for _ in range(2 * iters + 4):
            if accepted >= iters:
                break
            da, de = self.hard(x)
            za = self.project_angles((da + ua).to(self.local)).to(self.dtype)
            ze = self.project_edges((de + ue).to(self.local)).to(self.dtype)
            zs = self.surface(x)
            rhs = self.rho * self.hard_t(za - ua, ze - ue) + self.w2 * zs
            xn = self.global_solve(rhs)
            da2, de2 = self.hard(xn)
            ua2, ue2 = ua + da2 - za, ue + de2 - ze
            res = float(((da2 - za) ** 2).sum() + ((de2 - ze) ** 2).sum()
                        + ((da2 - da) ** 2).sum() + ((de2 - de) ** 2).sum())
            if reset or res < prev:
                accepted += 1
                prev, reset = res, False
                last = (ua2, ue2, xn)
                ua, ue, x = unflat(aa.compute(flat(ua2, ue2, xn)))
            else:
                reset = True
                ua, ue, x = last
                aa.reset(flat(*last))
        return last[2].double().cpu().numpy()


def edge_errors(x, edges, target):
    """|length - target| / target of every edge (float64 NumPy)."""
    e = np.asarray(edges)
    return np.abs(np.linalg.norm(x[e[:, 1]] - x[e[:, 0]], axis=1)
                  - target) / target


def surface_distances(x, tris, target, groups):
    """Distance of every vertex to the surface tris (T, 3, 3) tensor over
    the target edge; groups: ``triangle_groups(tris)``."""
    p = torch.as_tensor(np.asarray(x, np.float64), device=tris.device)
    q = closest_points(p, tris.double(), groups)
    return ((p - q).norm(dim=-1) / target).cpu().numpy()


def angle_excess(x, corners, min_angle, max_angle):
    """How far (radians) every corner's angle lies outside [min, max]."""
    c = np.asarray(corners)
    v1 = x[c[:, 1]] - x[c[:, 0]]
    v2 = x[c[:, 2]] - x[c[:, 0]]
    cosg = (v1 * v2).sum(1) / (np.linalg.norm(v1, axis=1)
                               * np.linalg.norm(v2, axis=1))
    g = np.arccos(np.clip(cosg, -1.0, 1.0))
    return np.maximum(np.maximum(min_angle - g, g - max_angle), 0.0)
