"""Batched proximal operators, energy gradients and energies of the material
models (counterpart of aa_admm_tpu/ops/prox.py:1-299, the whole module).

Replaces the per-element virtual ``EnergyTerm::prox`` of the reference
(TetEnergyTerm.cpp:101-123 linear; :171-183 hyperelastic via a 9-dim LBFGS;
TriEnergyTerm.cpp:74-105 cloth) with batched, branch-free functions. The
hyperelastic prox uses isotropy: the minimizer of psi(F) + (k/2)||F - v||^2
shares singular vectors with v, so the LBFGS collapses to a safeguarded
Newton on the three singular values (``_sigma_newton``).

``_sigma_newton`` runs its fixed 12 iterations (``_NEWTON_ITERS``, JAX :27)
as a Python loop where the JAX package scans: eager PyTorch has no scan, and
a fixed trip count needs no host read. It departs from the JAX function in
one way: two undamped Newton steps follow the damped loop, each kept where
it shrinks the gradient (``_POLISH_ITERS``). The damped loop accepts a step
only when the energy falls, which it cannot resolve once the step is below
about sqrt(eps) of s, so it stops up to ~1e-9 off the minimizer wherever
rounding leads; the JAX beams step is then not reproducible at 1e-8 even
against itself (tools/port_beams_spread.py), while the polished prox is
exact to roundoff, so the port's GPU and CPU steps agree. Every function
takes matrices shaped (..., 3, 3) or (..., 3, 2); ``k`` is the material's
bulk modulus.
"""

from __future__ import annotations

import torch

from . import mat3
from .svd3 import svd3x2, svd3x3

_NEWTON_ITERS = 12
_POLISH_ITERS = 2
_ALPHAS = (1.0, 0.5, 0.25, 0.0625)   # backtracking step scales


def _last(a, f):
    """a with its last component (over axis -1) multiplied by f (...,)."""
    one = torch.ones_like(f)
    return a * torch.stack([one, one, f], dim=-1)


# ----------------------------------------------------------------------------
# Linear (corotated) tet — TetEnergyTerm
# ----------------------------------------------------------------------------

def prox_tet_linear(v, mu, lam, k, svd_method: str = "jacobi"):
    """zi = 0.5 * (P + v) with P = U diag(1,1,s) V^T, s=-1 iff det(v) < 1e-16
    (TetEnergyTerm::prox, TetEnergyTerm.cpp:101-123; exact because
    w^2 = k*vol)."""
    del mu, lam, k
    U, S, V = svd3x3(v, method=svd_method)
    s3 = torch.where(mat3.det(v) < 1e-16, -1.0, 1.0).to(v.dtype)
    one = torch.ones_like(s3)
    P = mat3.usv(U, torch.stack([one, one, s3], dim=-1), V)
    return 0.5 * (P + v)


def grad_tet_linear(z, mu, lam, k, vol, svd_method: str = "jacobi"):
    """k*vol*(F - U V^T) (TetEnergyTerm::get_gradient, TetEnergyTerm.cpp:156-165)."""
    del mu, lam
    U, _, V = svd3x3(z, method=svd_method)
    R = mat3.mmult(U, V)
    return (k * vol)[..., None, None] * (z - R)


def energy_tet_linear(z, mu, lam, k, vol, svd_method: str = "jacobi"):
    """0.5*k*vol*||sigma - 1||^2 (TetEnergyTerm::energyLBFGS, cpp:135-142)."""
    del mu, lam
    _, S, _ = svd3x3(z, method=svd_method)
    return 0.5 * k * vol * ((S - 1.0) ** 2).sum(-1)


# ----------------------------------------------------------------------------
# Hyperelastic tets — singular-value Newton prox
# ----------------------------------------------------------------------------

def _signed_svd3x3(F, svd_method):
    """SVD with the invertible-elasticity convention: sigma_3 carries the sign
    of det(F) and the last columns of U and V are flipped accordingly
    (FastSVD::signed_svd, admm_anderson_xzu/src/FastSVD.hpp:37-62)."""
    U, S, V = svd3x3(F, method=svd_method)
    detU = mat3.det(U)
    detV = mat3.det(V)
    # Make V a rotation by flipping its last column; compensate in sigma.
    V = _last(V, detV[..., None])
    U = _last(U, detU[..., None])
    S = _last(S, detU * detV)
    return U, S, V


def _nh_grad_hess(s, sv, mu, lam, k):
    """Gradient/Hessian of 0.5*mu*(|s|^2 - 2log|J| - 3) + 0.5*lam*log^2|J|
    + 0.5*k*|s - sv|^2 in singular-value space."""
    eps = 1e-12
    s_safe = torch.where(s.abs() < eps,
                         torch.sign(s) * eps + (s == 0).to(s.dtype) * eps, s)
    inv = 1.0 / s_safe
    J = s_safe[..., 0] * s_safe[..., 1] * s_safe[..., 2]
    L = torch.log(J.abs())
    g = (mu[..., None] * (s - inv)
         + lam[..., None] * L[..., None] * inv
         + k[..., None] * (s - sv))
    diag = (mu[..., None] * (1.0 + inv * inv)
            - lam[..., None] * L[..., None] * inv * inv
            + k[..., None])
    H = lam[..., None, None] * inv[..., :, None] * inv[..., None, :]
    return g, H + torch.diag_embed(diag)


def _stvk_grad_hess(s, sv, mu, lam, k):
    """Gradient/Hessian of mu*sum(e_i^2) + 0.5*lam*(tr e)^2 + 0.5*k*|s-sv|^2
    with e_i = 0.5*(s_i^2 - 1)."""
    e = 0.5 * (s * s - 1.0)
    tre = e.sum(-1, keepdim=True)
    g = (2.0 * mu[..., None] * e + lam[..., None] * tre) * s \
        + k[..., None] * (s - sv)
    diag = 2.0 * mu[..., None] * e + lam[..., None] * tre + k[..., None]
    ss = s[..., :, None] * s[..., None, :]
    H = lam[..., None, None] * ss
    H = H + 2.0 * mu[..., None, None] * ss * torch.eye(
        3, dtype=s.dtype, device=s.device)
    return g, H + torch.diag_embed(diag)


def _nh_value(s, sv, mu, lam, k):
    J = (s[..., 0] * s[..., 1] * s[..., 2]).abs()
    L = torch.log(torch.clamp_min(J, 1e-300))
    return (0.5 * mu * ((s * s).sum(-1) - 2.0 * L - 3.0)
            + 0.5 * lam * L * L
            + 0.5 * k * ((s - sv) ** 2).sum(-1))


def _stvk_value(s, sv, mu, lam, k):
    e = 0.5 * (s * s - 1.0)
    return (mu * (e * e).sum(-1) + 0.5 * lam * e.sum(-1) ** 2
            + 0.5 * k * ((s - sv) ** 2).sum(-1))


def _sigma_newton(sv, mu, lam, k, grad_hess, value, iters=_NEWTON_ITERS):
    """Backtracking-damped Newton on singular values, fixed iteration count
    (replaces mcl::optlib::LBFGS<double,9>, LBFGS.hpp:80-120)."""
    s = sv
    eye = torch.eye(3, dtype=s.dtype, device=s.device)
    for _ in range(iters):
        g, H = grad_hess(s, sv, mu, lam, k)
        # Levenberg damping keeps H positive definite far from the optimum.
        lam_reg = 1e-9 * torch.clamp_min(mat3.trace(H).abs(), 1.0)
        step = mat3.solve(H + lam_reg[..., None, None] * eye, g)
        best_s, best_f = s, value(s, sv, mu, lam, k)
        # Backtracking over fixed candidate step scales (branch-free
        # select), the four candidates' values in one batched evaluation.
        cand = torch.stack([s - alpha * step for alpha in _ALPHAS])
        fcs = value(cand, sv, mu, lam, k)
        for i in range(len(_ALPHAS)):
            ok = torch.isfinite(fcs[i]) & (fcs[i] < best_f)
            best_s = torch.where(ok[..., None], cand[i], best_s)
            best_f = torch.where(ok, fcs[i], best_f)
        s = best_s
    # Polish: the value test above cannot resolve a step below about
    # sqrt(eps)|s| (f changes less than its own rounding), so the damped
    # loop stops up to ~1e-9 off the minimizer wherever its rounding leads.
    # Undamped Newton steps kept only where they shrink the gradient, which
    # is resolved to roundoff, settle s to roundoff whatever the device.
    for _ in range(_POLISH_ITERS):
        g, H = grad_hess(s, sv, mu, lam, k)
        cand = s - mat3.solve(H, g)
        gc, _ = grad_hess(cand, sv, mu, lam, k)
        gn, gcn = (g * g).sum(-1), (gc * gc).sum(-1)
        ok = torch.isfinite(gcn) & (gcn < gn)
        s = torch.where(ok[..., None], cand, s)
    return s


def prox_tet_neohookean(v, mu, lam, k, svd_method: str = "jacobi"):
    """argmin_F psi_NH(F) + (k/2)||F - v||^2 via singular-value Newton
    (NeoHookeanTet::NHProx, TetEnergyTerm.cpp:221-267)."""
    U, S, V = _signed_svd3x3(v, svd_method)
    s = _sigma_newton(S, mu, lam, k, _nh_grad_hess, _nh_value)
    return mat3.usv(U, s, V)


def prox_tet_stvk(v, mu, lam, k, svd_method: str = "jacobi"):
    """argmin_F psi_StVK(F) + (k/2)||F - v||^2 via singular-value Newton
    (StVKTet::StVKProx, TetEnergyTerm.cpp:272-319)."""
    U, S, V = _signed_svd3x3(v, svd_method)
    s = _sigma_newton(S, mu, lam, k, _stvk_grad_hess, _stvk_value)
    return mat3.usv(U, s, V)


def grad_tet_neohookean(z, mu, lam, k, vol):
    """vol * (mu*(F - F^-T) + lam*log(J)*F^-T)
    (NHProx::U_gradient, TetEnergyTerm.cpp:262-267, scaled by vol as in
    HyperElasticTet::get_gradient, cpp:204-215)."""
    del k
    J = mat3.det(z)
    FinvT = mat3.adjugate(z).transpose(-1, -2) / torch.where(
        J == 0, torch.full_like(J, 1e-300), J)[..., None, None]
    logJ = torch.log(torch.clamp_min(J, 1e-300))
    G = mu[..., None, None] * (z - FinvT) + (lam * logJ)[..., None, None] * FinvT
    return vol[..., None, None] * G


def grad_tet_stvk(z, mu, lam, k, vol):
    """vol * F (2 mu E + lam tr(E) I), E = (F^T F - I)/2
    (StVKProx::U_gradient, TetEnergyTerm.cpp:313-319)."""
    del k
    I = torch.eye(3, dtype=z.dtype, device=z.device)
    E = 0.5 * (mat3.mtmul(z, z) - I)
    trE = mat3.trace(E)
    G = mat3.mmul(z, 2.0 * mu[..., None, None] * E
                  + (lam * trE)[..., None, None] * I)
    return vol[..., None, None] * G


def energy_tet_neohookean(z, mu, lam, k, vol):
    """vol * psi_NH (NHProx::energy_density, TetEnergyTerm.cpp:221-237)."""
    del k
    J = mat3.det(z)
    I1 = mat3.frob2(z)
    logI3 = torch.log(torch.clamp_min(J * J, 1e-300))
    return vol * (0.5 * mu * (I1 - logI3 - 3.0) + 0.125 * lam * logI3 * logI3)


def energy_tet_stvk(z, mu, lam, k, vol):
    del k
    I = torch.eye(3, dtype=z.dtype, device=z.device)
    E = 0.5 * (mat3.mtmul(z, z) - I)
    trE = mat3.trace(E)
    return vol * (mu * mat3.frob2(E) + 0.5 * lam * trE * trE)


# ----------------------------------------------------------------------------
# Triangle (cloth) energy — TriEnergyTerm, both strain-limiting styles
# ----------------------------------------------------------------------------

def _limits_on(limit_min, limit_max):
    return (limit_min > 0.0) | (limit_max < 99.0)


def prox_tri_zxu(v, limit_min, limit_max):
    """3x2 SVD; averaged singular values clamped into [limit_min, limit_max],
    rebuild U Sigma V^T (zxu TriEnergyTerm::prox, TriEnergyTerm.cpp:74-105)."""
    U, S, V = svd3x2(v)
    sig = 0.5 * (1.0 + S)
    clamped = torch.minimum(torch.maximum(sig, limit_min[..., None]),
                            limit_max[..., None])
    sig = torch.where(_limits_on(limit_min, limit_max)[..., None], clamped, sig)
    return mat3.usv32(U, sig, V)


def prox_tri_xzu(v, limit_min, limit_max):
    """xzu variant: singular values toward 1 (averaged), then the column
    norms of z clamped (admm_anderson_xzu/src/TriEnergyTerm.cpp:67-105)."""
    U, S, V = svd3x2(v)
    sig = 0.5 * (1.0 + S)
    z = mat3.usv32(U, sig, V)
    norms = torch.linalg.vector_norm(z, dim=-2, keepdim=True)  # per column
    scale = torch.minimum(torch.maximum(norms, limit_min[..., None, None]),
                          limit_max[..., None, None]) \
        / torch.clamp_min(norms, 1e-300)
    return torch.where(_limits_on(limit_min, limit_max)[..., None, None],
                       z * scale, z)


def strain_limit_violation(v, limit_min, limit_max):
    """Sum of singular-value excursions outside [limit_min, limit_max]
    (TriEnergyTerm::prox_for_strain_limiting_energy, zxu cpp:107-132)."""
    _, S, _ = svd3x2(v)
    sig = 0.5 * (1.0 + S)
    under = torch.clamp_min(limit_min[..., None] - sig, 0.0)
    over = torch.clamp_min(sig - limit_max[..., None], 0.0)
    return torch.where(_limits_on(limit_min, limit_max),
                       (under + over).sum(-1), torch.zeros_like(sig[..., 0]))


def grad_tri(z, mu, lam, k, area):
    """k*area*(F - U V^T), the cloth analogue of the linear-tet gradient."""
    del mu, lam
    U, _, V = svd3x2(z)
    P = mat3.mmult32(U, V)
    return (k * area)[..., None, None] * (z - P)


def energy_tri(z, mu, lam, k, area):
    """0.5*k*area*||F - UV^T||^2 (TriEnergyTerm::energy, zxu cpp:134-144)."""
    del mu, lam
    U, _, V = svd3x2(z)
    P = mat3.mmult32(U, V)
    return 0.5 * k * area * ((z - P) ** 2).sum(dim=(-2, -1))


# ----------------------------------------------------------------------------
# Pins and collisions (3-dim z blocks)
# ----------------------------------------------------------------------------

def prox_pin(v, pin_pos, active):
    """SpringPin::prox — snap z to the pin when active (SpringEnergyTerm.hpp:67-71)."""
    return torch.where(active[..., None], pin_pos, v)


def prox_collision(v, sdf_scene, active, mesh_sdfs=()):
    """Collision::prox — snap z to the surface point of the nearest
    penetrating passive collider (analytic SDFs and/or mesh obstacles,
    CollisionEnergyTerm.hpp:79-91: all passive_objs are folded by min
    distance)."""
    d, point = sdf_scene.signed_distance(v)
    for m in mesh_sdfs:
        dm, pm = m.signed_distance(v)
        closer = dm < d
        d = torch.where(closer, dm, d)
        point = torch.where(closer[..., None], pm, point)
    hit = active & (d < 0.0)
    return torch.where(hit[..., None], point, v)
