"""Batched small-matrix eigen- and singular-value decompositions, 3x3 and
3x2 (counterpart of aa_admm_tpu/ops/svd3.py:1-198, the whole module).

The reference calls Eigen::JacobiSVD per element (TetEnergyTerm.cpp:101-123,
TriEnergyTerm.cpp:74-105). As in the JAX package, the whole element batch is
one branch-free computation: a cyclic Jacobi eigendecomposition of F^T F
with a fixed sweep count (``eigh3x3``, JAX :70), a sorting network
(``_sort_desc3``), then a safeguarded recovery of U with per-column
fallbacks (``_orthonormal_u``, JAX :103-135). ``method="lapack"`` is
``torch.linalg.svd`` (in the JAX package it is XLA's SVD, not a kernel).
"""

from __future__ import annotations

import torch

from . import mat3

_JACOBI_SWEEPS = 6  # cyclic sweeps; 3-4 converge for well-conditioned F


def _tiny(dtype, f64, f32):
    return f64 if dtype == torch.float64 else f32


def _jacobi_rotation(app, aqq, apq):
    """Stable Jacobi rotation (c, s) zeroing A[p,q]; branch-free."""
    small = _tiny(app.dtype, 1e-300, 1e-30)
    denom = 2.0 * apq
    tau = (aqq - app) / torch.where(denom.abs() < small,
                                    torch.full_like(denom, small), denom)
    t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(apq.abs() < small, torch.zeros_like(t), t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    return c, s


def _apply_jacobi(A, V, p, q):
    """One Jacobi rotation on symmetric A (batch..., 3, 3), accumulated into
    V, as component updates."""
    c, s = _jacobi_rotation(A[..., p, p], A[..., q, q], A[..., p, q])
    r = 3 - p - q  # the untouched index
    app, aqq, apq = A[..., p, p], A[..., q, q], A[..., p, q]
    apr, aqr = A[..., p, r], A[..., q, r]
    new_pp = c * c * app - 2.0 * c * s * apq + s * s * aqq
    new_qq = s * s * app + 2.0 * c * s * apq + c * c * aqq
    new_pr = c * apr - s * aqr
    new_qr = s * apr + c * aqr
    zero = torch.zeros_like(app)
    vals = {(p, p): new_pp, (q, q): new_qq, (r, r): A[..., r, r],
            (p, q): zero, (q, p): zero,
            (p, r): new_pr, (r, p): new_pr,
            (q, r): new_qr, (r, q): new_qr}
    A_new = torch.stack([vals[(i, j)] for i in range(3) for j in range(3)],
                        dim=-1).unflatten(-1, (3, 3))
    # V's columns p and q rotate, each entry as c vp_i - s vq_i and
    # s vp_i + c vq_i, over the whole column at once
    vp, vq = V[..., :, p], V[..., :, q]
    c1, s1 = c[..., None], s[..., None]
    cols = {p: c1 * vp - s1 * vq, q: s1 * vp + c1 * vq, r: V[..., :, r]}
    V_new = torch.stack([cols[0], cols[1], cols[2]], dim=-1)
    return A_new, V_new


def eigh3x3(A, sweeps: int = _JACOBI_SWEEPS):
    """Eigendecomposition of a symmetric 3x3 batch via cyclic Jacobi.

    Returns (eigvals (..., 3), V (..., 3, 3)), unsorted."""
    V = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape)
    for _ in range(sweeps):
        for (p, q) in ((0, 1), (0, 2), (1, 2)):
            A, V = _apply_jacobi(A, V, p, q)
    w = torch.stack([A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]], dim=-1)
    return w, V


def _sort_desc3(w, V):
    """Descending sort of 3 eigenpairs via a branch-free sorting network
    (3 compare-swaps), no gathers."""
    def swap(wi, wj, vi, vj):
        cond = wi < wj
        return (torch.where(cond, wj, wi), torch.where(cond, wi, wj),
                [torch.where(cond, b, a) for a, b in zip(vi, vj)],
                [torch.where(cond, a, b) for a, b in zip(vi, vj)])

    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    v0 = [V[..., i, 0] for i in range(3)]
    v1 = [V[..., i, 1] for i in range(3)]
    v2 = [V[..., i, 2] for i in range(3)]
    w0, w1, v0, v1 = swap(w0, w1, v0, v1)
    w1, w2, v1, v2 = swap(w1, w2, v1, v2)
    w0, w1, v0, v1 = swap(w0, w1, v0, v1)
    w = torch.stack([w0, w1, w2], -1)
    V = mat3._mat([[v0[i], v1[i], v2[i]] for i in range(3)])
    return w, V


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _least_axis(u, eye):
    """The unit axis along u's smallest |component| (first on ties)."""
    return eye[torch.argmin(u.abs(), dim=-1)]


def _orthonormal_u(F, V, S):
    """Recover U from F V = U diag(S) by Gram-Schmidt with per-column
    fallbacks: a column whose singular value is below noise gets an
    orthogonal completion; columns of reliable magnitude keep their exact
    direction and sign, so det(U) = -1 cases (reflections) reconstruct."""
    tiny = _tiny(F.dtype, 1e-300, 1e-30)
    eye = torch.eye(3, dtype=F.dtype, device=F.device)
    FV = mat3.mmul(F, V)
    tol = (torch.clamp_min(S[..., 0], 1.0)
           * _tiny(F.dtype, 1e-12, 1e-5))[..., None]

    def norm(v):
        return v / torch.clamp_min(_norm(v), tiny)

    c0 = FV[..., :, 0]
    n0 = _norm(c0)
    e0 = torch.zeros_like(c0)
    e0[..., 0] = 1.0
    u0 = torch.where(n0 > tol, c0 / torch.clamp_min(n0, tiny), e0)

    c1 = FV[..., :, 1]
    c1 = c1 - (c1 * u0).sum(-1, keepdim=True) * u0
    n1 = _norm(c1)
    alt1 = _least_axis(u0, eye)
    alt1 = norm(alt1 - (alt1 * u0).sum(-1, keepdim=True) * u0)
    u1 = torch.where(n1 > tol, c1 / torch.clamp_min(n1, tiny), alt1)

    c2 = FV[..., :, 2]
    c2 = (c2 - (c2 * u0).sum(-1, keepdim=True) * u0
          - (c2 * u1).sum(-1, keepdim=True) * u1)
    n2 = _norm(c2)
    alt2 = torch.linalg.cross(u0, u1, dim=-1)
    u2 = torch.where(n2 > tol, c2 / torch.clamp_min(n2, tiny), alt2)
    return torch.stack([u0, u1, u2], dim=-1)


def svd3x3(F, method: str = "jacobi"):
    """Batched SVD of (..., 3, 3): returns U, S (descending, >= 0), V with
    F = U S V^T. U and V are orthogonal but not necessarily rotations (the
    convention of Eigen::JacobiSVD in the reference's prox kernels)."""
    if method == "lapack":
        U, S, Vh = torch.linalg.svd(F, full_matrices=True)
        return U, S, Vh.transpose(-1, -2)
    A = mat3.mtmul(F, F)
    w, V = eigh3x3(A)
    w, V = _sort_desc3(w, V)
    S = torch.sqrt(torch.clamp_min(w, 0.0))
    U = _orthonormal_u(F, V, S)
    return U, S, V


def svd3x2(F):
    """Batched thin SVD of (..., 3, 2): U (..., 3, 2), S (..., 2),
    V (..., 2, 2). Closed form via the 2x2 symmetric eigenproblem of F^T F."""
    eps = _tiny(F.dtype, 1e-150, 1e-20)
    A = mat3.gram22(F)
    a, b, d = A[..., 0, 0], A[..., 0, 1], A[..., 1, 1]
    tr = a + d
    disc = torch.sqrt(torch.clamp_min((a - d) ** 2 + 4.0 * b * b, 0.0))
    l1 = 0.5 * (tr + disc)
    l2 = 0.5 * (tr - disc)
    # Eigenvector for l1: (b, l1-a) or (l1-d, b), the better-conditioned.
    v1a = torch.stack([b, l1 - a], dim=-1)
    v1b = torch.stack([l1 - d, b], dim=-1)
    use_a = ((l1 - a).abs() > (l1 - d).abs())[..., None]
    v1 = torch.where(use_a, v1a, v1b)
    n1 = _norm(v1)
    ex = torch.zeros_like(v1)
    ex[..., 0] = 1.0
    v1 = torch.where(n1 > eps, v1 / torch.clamp_min(n1, eps), ex)
    v2 = torch.stack([-v1[..., 1], v1[..., 0]], dim=-1)
    V = torch.stack([v1, v2], dim=-1)
    S = torch.sqrt(torch.clamp_min(torch.stack([l1, l2], dim=-1), 0.0))
    FV = mat3.mmul32_22(F, V)
    U = FV / torch.clamp_min(S[..., None, :], eps)

    def norm(v):
        return v / torch.clamp_min(_norm(v), eps)

    u0 = norm(U[..., :, 0])
    u1 = U[..., :, 1] - (U[..., :, 1] * u0).sum(-1, keepdim=True) * u0
    u1n = _norm(u1)
    alt = _least_axis(u0, torch.eye(3, dtype=F.dtype, device=F.device))
    alt = norm(alt - (alt * u0).sum(-1, keepdim=True) * u0)
    u1 = torch.where(u1n > eps, u1 / torch.clamp_min(u1n, eps), alt)
    U = torch.stack([u0, u1], dim=-1)
    return U, S, V


def polar_rotation3x3(F, method: str = "jacobi"):
    """R = U V^T from the SVD (the corotation of the linear-tet gradient,
    TetEnergyTerm.cpp:144-165)."""
    U, _, V = svd3x3(F, method=method)
    return mat3.mmult(U, V)
