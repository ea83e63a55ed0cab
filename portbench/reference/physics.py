"""The plain beams step: the x -> z -> u ADMM of admm_anderson_xzu
(Solver.cpp) with Anderson acceleration on z, written from the published
algorithm in plain torch. It imports nothing of the port and takes nothing
that the port has made.

Scene (samples/Asia2019/beams.cpp): tet blocks with lumped masses
(density 1522 kg/m^3, a quarter of each tet's mass to each corner), the
extreme-x vertices pinned (hard: they leave the solve), gravity along -y,
implicit Euler with dt. Per tet, F = [x1 - x0 | x2 - x0 | x3 - x0] Dm^-1
and the weight w = sqrt(k vol), k = lambda + 2 mu / 3. Per frame:

    v += dt g (free);  xbar = x + dt v (free), the pins' targets (pinned)
    z = F(xbar), u = 0;  x = X(z, u);  z = prox(F(x) + u / w)
    repeat: u = grad psi(z) / w;  x = X(z, u);  r = |w (F(x) - z)|
            if r > r_prev: z = the last un-mixed z, u = its u + w (F(x_d) - z_d),
                           x = X(z, u), r recomputed (the window kept)
            r_prev = r;  z = AA(prox(F(x) + u / w))
    X(z, u) = A^-1 (M xbar + dt^2 D^T (w^2 (z - c) - w u)) on the free
    vertices, A = M + dt^2 D^T W^2 D, c = F of the pins' embedding;
    commit x, v = (x - x_prev) / dt.

prox is argmin_F psi(F) + (k/2)|F - v|^2: for the linear (corotated) tet
(P + v) / 2 with P the rotation nearest v; for NeoHookean and StVK a
Newton solve on the singular values of v (signed: the last carries the
sign of det v), run until the gradient stops shrinking.
"""

from __future__ import annotations

import numpy as np
import torch

from .wiremesh import Anderson

DENSITY = 1522.0
# beams.cpp's three beams (material, y offset in m) and its soft rubber
BEAMS = (("linear", 1.75), ("neohookean", 0.0), ("stvk", -1.75))
YOUNG, POISSON = 1e7, 0.399


def tet_blocks(nx, ny, nz):
    """Unit cubes of five tets each, built from (0, 0, 0) in +x, +y, +z,
    colocated corners joined in order of first appearance (mclscene
    ShapeFactory::make_tet_blocks). (verts (V, 3), tets (T, 4))."""
    corners = np.array([[1, 1, 1], [0, 1, 1], [0, 1, 0], [1, 1, 0],
                        [1, 0, 1], [0, 0, 1], [0, 0, 0], [1, 0, 0]], float)
    five = np.array([[0, 5, 7, 4], [5, 7, 2, 0], [5, 0, 2, 1], [7, 2, 0, 3],
                     [5, 2, 7, 6]])
    verts, tets = [], []
    for x in range(nx):
        for y in range(ny):
            for z in range(nz):
                tets.append(five + 8 * len(verts))
                verts.append(corners + np.array([x, y, z], float))
    verts, tets = np.concatenate(verts), np.concatenate(tets)
    key = np.round(verts, 6)
    _, first, inv = np.unique(key, axis=0, return_index=True,
                              return_inverse=True)
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first)] = np.arange(len(first))
    return verts[np.sort(first)], rank[inv.ravel()][tets]


def beams_scene(cfg):
    """The published scene: per beam (kind, y offset), its block scaled to
    1 m tall and centred; the pins with their sides (+1: max x). Returns
    dict(verts, tets per kind, pins, pin_side, lame per kind)."""
    verts, groups, pins, side = [], [], [], []
    n0 = 0
    for kind, oy in BEAMS:
        v, t = tet_blocks(*cfg["cubes"])
        lo, hi = v.min(0), v.max(0)
        v = (v - 0.5 * (lo + hi)) / (hi - lo)[1] + np.array([0.0, oy, 0.0])
        mn, mx = v[:, 0].min() + 1e-2, v[:, 0].max() - 1e-2
        for j, p in enumerate(v):
            if p[0] < mn or p[0] > mx:
                pins.append(n0 + j)
                side.append(1.0 if p[0] > mx else -1.0)
        groups.append((kind, t + n0))
        verts.append(v)
        n0 += len(v)
    return dict(verts=np.concatenate(verts), groups=groups,
                pins=np.asarray(pins), side=np.asarray(side))


def _closest_rotation(F):
    U, _, Vh = torch.linalg.svd(F)
    d = torch.det(U @ Vh)
    U = U.clone()
    U[..., :, 2] *= d[..., None]
    return U @ Vh


def _signed_svd(F):
    U, S, Vh = torch.linalg.svd(F)
    du, dv = torch.det(U), torch.det(Vh)
    U, S, Vh = U.clone(), S.clone(), Vh.clone()
    U[..., :, 2] *= du[..., None]
    Vh[..., 2, :] *= dv[..., None]
    S[..., 2] *= du * dv
    return U, S, Vh


def _energy(kind, s, mu, lam):
    if kind == "neohookean":
        L = torch.log((s[..., 0] * s[..., 1] * s[..., 2]).abs())
        return 0.5 * mu * ((s * s).sum(-1) - 3.0 - 2.0 * L) + 0.5 * lam * L * L
    e = 0.5 * (s * s - 1.0)
    return mu * (e * e).sum(-1) + 0.5 * lam * e.sum(-1) ** 2


def _grad_hess(kind, s, mu, lam):
    """Gradient and Hessian of psi over the singular values."""
    if kind == "neohookean":
        inv = 1.0 / s
        L = torch.log((s[..., 0] * s[..., 1] * s[..., 2]).abs())
        g = mu * (s - inv) + lam * L[..., None] * inv
        H = lam * inv[..., :, None] * inv[..., None, :]
        H = H + torch.diag_embed(mu * (1.0 + inv * inv)
                                 - lam * L[..., None] * inv * inv)
        return g, H
    e = 0.5 * (s * s - 1.0)
    tr = e.sum(-1, keepdim=True)
    g = (2.0 * mu * e + lam * tr) * s
    H = lam * s[..., :, None] * s[..., None, :]
    H = H + torch.diag_embed(2.0 * mu * e + lam * tr + 2.0 * mu * s * s)
    return g, H


def _sigma_min(kind, sv, mu, lam, k, iters=60):
    """argmin_s psi(s) + (k/2)|s - sv|^2 by Newton with backtracking,
    stopped once a step no longer shrinks the gradient."""
    s = sv.clone()
    eye = torch.eye(3, dtype=s.dtype, device=s.device)

    def f(x):
        return _energy(kind, x, mu, lam) + 0.5 * k * ((x - sv) ** 2).sum(-1)

    for _ in range(iters):
        g, H = _grad_hess(kind, s, mu, lam)
        g = g + k * (s - sv)
        step = torch.linalg.solve(H + k * eye, g[..., None])[..., 0]
        f0, t = f(s), torch.ones_like(s[..., 0])
        cand = s - step
        for _ in range(30):
            fc = f(cand)
            bad = ~(torch.isfinite(fc) & (fc <= f0 + 1e-12 * f0.abs()))
            if not bool(bad.any()):
                break
            t = torch.where(bad, 0.5 * t, t)
            cand = s - t[..., None] * step
        gc = _grad_hess(kind, cand, mu, lam)[0] + k * (cand - sv)
        better = (gc * gc).sum(-1) < (g * g).sum(-1)
        if not bool(better.any()):
            break
        s = torch.where(better[..., None], cand, s)
    return s


class Material:
    """One beam's tets: Dm^-1, vol, w, and their prox and gradient."""

    def __init__(self, kind, tets, x, mu, lam, dtype, device):
        self.kind, self.mu, self.lam = kind, mu, lam
        self.k = lam + 2.0 * mu / 3.0
        e = x[tets[:, 1:]] - x[tets[:, :1]]               # (T, 3, 3) rows
        Ds = np.transpose(e, (0, 2, 1))
        vol = np.linalg.det(Ds) / 6.0
        kw = dict(dtype=dtype, device=device)
        self.tets = torch.as_tensor(tets, device=device)
        self.Dm_inv = torch.as_tensor(np.linalg.inv(Ds), **kw)
        self.vol = torch.as_tensor(vol, **kw)
        self.w = torch.as_tensor(np.sqrt(self.k * vol), **kw)
        self.vol_np, self.Dm_inv_np = vol, np.linalg.inv(Ds)

    def F(self, x):
        g = x[self.tets]
        return (g[:, 1:] - g[:, :1]).transpose(1, 2) @ self.Dm_inv

    def Ft(self, G, n):
        """D^T G: the adjoint of F, scattered to (n, 3)."""
        dE = G @ self.Dm_inv.transpose(1, 2)               # (T, 3, 3): cols k
        out = torch.zeros((n, 3), dtype=G.dtype, device=G.device)
        for k in range(3):
            out.index_add_(0, self.tets[:, k + 1], dE[:, :, k])
        out.index_add_(0, self.tets[:, 0], -dE.sum(2))
        return out

    def prox(self, v):
        if self.kind == "linear":
            return 0.5 * (_closest_rotation(v) + v)
        U, S, Vh = _signed_svd(v)
        s = _sigma_min(self.kind, S, self.mu, self.lam, self.k)
        return U @ torch.diag_embed(s) @ Vh

    def grad(self, z):
        """d(vol psi)/dF at z."""
        vol = self.vol[:, None, None]
        if self.kind == "linear":
            return self.k * vol * (z - _closest_rotation(z))
        if self.kind == "neohookean":
            J = torch.det(z)
            FiT = torch.linalg.inv(z).transpose(1, 2)
            return vol * (self.mu * (z - FiT)
                          + self.lam * torch.log(J)[:, None, None] * FiT)
        I = torch.eye(3, dtype=z.dtype, device=z.device)
        E = 0.5 * (z.transpose(1, 2) @ z - I)
        tr = E.diagonal(dim1=1, dim2=2).sum(-1)[:, None, None]
        return vol * (z @ (2.0 * self.mu * E + self.lam * tr * I))


class BeamsReference:
    """The beams scene and its frames; positions and velocities in dtype."""

    def __init__(self, cfg, device, dtype=torch.float64):
        sc = beams_scene(cfg)
        self.dtype, self.device = dtype, torch.device(device)
        self.dt, self.g = float(cfg["dt"]), float(cfg["gravity"])
        self.iters, self.m = int(cfg["admm_iters"]), int(cfg["anderson_m"])
        x = sc["verts"]
        n = self.n = len(x)
        E, nu = YOUNG, POISSON
        mu, lam = E / (2 * (1 + nu)), E * nu / ((1 + nu) * (1 - 2 * nu))
        self.mats = [Material(kind, t, x, mu, lam, dtype, device)
                     for kind, t in sc["groups"]]
        masses = np.zeros(n)
        for mat, (_, t) in zip(self.mats, sc["groups"]):
            np.add.at(masses, t.ravel(), np.repeat(DENSITY * np.abs(
                mat.vol_np) / 4.0, 4))
        self.pins, self.side = sc["pins"], sc["side"]
        free = np.ones(n, bool)
        free[self.pins] = False
        self.free = torch.as_tensor(np.nonzero(free)[0], device=device)
        self.free_mask = torch.as_tensor(free, device=device)
        kw = dict(dtype=dtype, device=device)
        self.masses = torch.as_tensor(masses, **kw)
        # A = M + dt^2 D^T W^2 D on the free vertices, inverted in float64
        A = np.diag(masses)
        for mat in self.mats:
            B = mat.Dm_inv_np                                 # (T, 3, 3)
            G = np.concatenate([-B.sum(1, keepdims=True), B], 1)  # (T, 4, 3)
            K = mat.k * mat.vol_np[:, None, None] * (G @ G.transpose(0, 2, 1))
            t = np.asarray(mat.tets.cpu())
            np.add.at(A, (t[:, :, None], t[:, None, :]), self.dt ** 2 * K)
        f = np.nonzero(free)[0]
        self.Ainv = torch.as_tensor(np.linalg.inv(A[np.ix_(f, f)]), **kw)
        self.x = torch.as_tensor(x, **kw)
        self.v = torch.zeros_like(self.x)
        self.rest_pins = torch.as_tensor(x[self.pins], **kw)
        self.frames = 0

    def start(self, x, v, frames):
        """Continue from positions x and velocities v (n, 3) after `frames`
        frames."""
        self.x = torch.as_tensor(x, device=self.device).to(self.dtype)
        self.v = torch.as_tensor(v, device=self.device).to(self.dtype)
        self.frames = int(frames)

    def pin_targets(self, k):
        """The pins after k calls of the app's stretch: +-k dt along x."""
        move = np.zeros((len(self.pins), 3))
        move[:, 0] = self.side * k * self.dt
        return self.rest_pins + torch.as_tensor(move, dtype=self.dtype,
                                                device=self.device)

    def frame(self):
        """One frame (stretch, then the step); returns x (n, 3) float64."""
        dt, n = self.dt, self.n
        fm = self.free_mask[:, None]
        # the scene's first stretch precedes the first frame's
        pin = torch.zeros_like(self.x)
        pin[self.pins] = self.pin_targets(self.frames + 2)
        g = torch.zeros(3, dtype=self.dtype, device=self.device)
        g[1] = dt * self.g
        v = torch.where(fm, self.v + g, self.v)
        xbar = torch.where(fm, self.x + dt * v, pin)
        base = torch.where(fm, torch.zeros_like(pin), pin)
        Mxbar = self.masses[self.free, None] * xbar[self.free]
        c = [mat.F(base) for mat in self.mats]
        W = [mat.w[:, None, None] for mat in self.mats]

        def solve(z, u):
            s = torch.zeros((n, 3), dtype=self.dtype, device=self.device)
            for mat, zi, ui, ci, w in zip(self.mats, z, u, c, W):
                s = s + mat.Ft(w * w * (zi - ci) - w * ui, n)
            xf = self.Ainv @ (Mxbar + dt * dt * s[self.free])
            return base.index_copy(0, self.free, xf)

        def update_z(x, u):
            return [mat.prox(mat.F(x) + ui / w)
                    for mat, ui, w in zip(self.mats, u, W)]

        def prim(x, z):
            return float(sum(((w * (mat.F(x) - zi)) ** 2).sum()
                             for mat, zi, w in zip(self.mats, z, W)).sqrt())

        def flat(z):
            return torch.cat([zi.reshape(-1) for zi in z])

        def unflat(v):
            out, o = [], 0
            for mat in self.mats:
                k = mat.tets.shape[0] * 9
                out.append(v[o:o + k].reshape(-1, 3, 3))
                o += k
            return out

        z = [mat.F(xbar) for mat in self.mats]
        u = [torch.zeros_like(zi) for zi in z]
        x = solve(z, u)
        z = update_z(x, u)
        aa = Anderson(self.m, flat(z))
        dx, dz, du = x, z, u
        prev = 1e20
        for _ in range(self.iters):
            u = [mat.grad(zi) / w for mat, zi, w in zip(self.mats, z, W)]
            x = solve(z, u)
            r = prim(x, z)
            if prev < r:
                aa.u = flat(dz)
                z = dz
                u = [ui + w * (mat.F(dx) - zi)
                     for mat, ui, zi, w in zip(self.mats, du, dz, W)]
                x = solve(z, u)
                r = prim(x, z)
            prev = r
            dx, du = x, u
            dz = update_z(x, u)
            z = unflat(aa.compute(flat(dz)))
        self.v = (x - self.x) / dt
        self.x = x
        self.frames += 1
        return x.double().cpu().numpy()
