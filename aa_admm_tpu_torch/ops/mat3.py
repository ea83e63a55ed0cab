"""Unrolled batched small-matrix algebra (counterpart of
aa_admm_tpu/ops/mat3.py:1-155, the whole module).

Batched 3x3 and 3x2 products, determinants, inverses and solves written as
component arithmetic in the same order of operations as the JAX module, so
that the port's f64 local steps round like the reference's. Where the JAX
module writes one expression per entry (i, j), the port broadcasts the same
expression over whole rows or columns (for example a[..., :, k, None] *
b[..., None, k, :] for every (i, j) at once): each entry is still the same
left-to-right sum of products, but a product is five elementwise launches
instead of forty-five, which is what an eager GPU step pays for.
"""

from __future__ import annotations

import torch


def _mat(rows):
    """[[(...,) x ncols] x nrows] -> (..., nrows, ncols)."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def mmul(a, b):
    """(..., 3, 3) @ (..., 3, 3): out[i, j] = sum_k a[i, k] b[k, j]."""
    return (a[..., :, 0, None] * b[..., None, 0, :]
            + a[..., :, 1, None] * b[..., None, 1, :]
            + a[..., :, 2, None] * b[..., None, 2, :])


def mtmul(a, b):
    """a^T b for (..., 3, 3)."""
    return (a[..., 0, :, None] * b[..., 0, None, :]
            + a[..., 1, :, None] * b[..., 1, None, :]
            + a[..., 2, :, None] * b[..., 2, None, :])


def mmult(a, b):
    """a b^T for (..., 3, 3)."""
    return (a[..., :, 0, None] * b[..., None, :, 0]
            + a[..., :, 1, None] * b[..., None, :, 1]
            + a[..., :, 2, None] * b[..., None, :, 2])


def usv(U, s, V):
    """U diag(s) V^T for (..., 3, 3), (..., 3), (..., 3, 3)."""
    return ((U[..., :, 0] * s[..., 0, None])[..., :, None] * V[..., None, :, 0]
            + (U[..., :, 1] * s[..., 1, None])[..., :, None] * V[..., None, :, 1]
            + (U[..., :, 2] * s[..., 2, None])[..., :, None] * V[..., None, :, 2])


def det(a):
    """Closed-form determinant of (..., 3, 3)."""
    return (a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2]
                            - a[..., 1, 2] * a[..., 2, 1])
            - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2]
                              - a[..., 1, 2] * a[..., 2, 0])
            + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1]
                              - a[..., 1, 1] * a[..., 2, 0]))


def adjugate(a):
    """Adjugate (transposed cofactor matrix) of (..., 3, 3). Its column j is
    the cross product of rows j+1 and j+2 (indices mod 3); every entry is
    the JAX module's two products and one difference, e.g. c00 = a11 a22 -
    a12 a21, with the products' factors at most swapped. (Rolls, not list
    indices: a list index is a host-to-device copy, which a CUDA graph
    cannot capture.)"""
    u = torch.roll(a, -1, dims=-2)                # rows j+1 for j = 0..2
    v = torch.roll(a, -2, dims=-2)                # rows j+2
    cross = (torch.roll(u, -1, dims=-1) * torch.roll(v, -2, dims=-1)
             - torch.roll(u, -2, dims=-1) * torch.roll(v, -1, dims=-1))
    return cross.transpose(-1, -2)


def inv(a, eps=0.0):
    d = det(a)
    sign = torch.where(d >= 0, 1.0, -1.0).to(d.dtype)
    safe = torch.where(d.abs() > eps, d, sign * 1e-300)
    return adjugate(a) / safe[..., None, None]


def solve(a, b):
    """a^-1 b for (..., 3, 3) and (..., 3) via the adjugate (Cramer)."""
    d = det(a)
    safe = torch.where(d == 0, torch.full_like(d, 1e-300), d)
    return mvec(adjugate(a), b) / safe[..., None]


def mvec(a, v):
    """(..., 3, 3) @ (..., 3)."""
    return (a[..., :, 0] * v[..., 0, None] + a[..., :, 1] * v[..., 1, None]
            + a[..., :, 2] * v[..., 2, None])


def trace(a):
    return a[..., 0, 0] + a[..., 1, 1] + a[..., 2, 2]


def frob2(a):
    return (a * a).sum(dim=(-2, -1))


# ---- 3x2 (cloth) ----

def mmul32_22(a, b):
    """(..., 3, 2) @ (..., 2, 2)."""
    return (a[..., :, 0, None] * b[..., None, 0, :]
            + a[..., :, 1, None] * b[..., None, 1, :])


def gram22(a):
    """a^T a for (..., 3, 2) -> (..., 2, 2)."""
    return mtmul(a, a)


def usv32(U, s, V):
    """U diag(s) V^T for (..., 3, 2), (..., 2), (..., 2, 2)."""
    return ((U[..., :, 0] * s[..., 0, None])[..., :, None] * V[..., None, :, 0]
            + (U[..., :, 1] * s[..., 1, None])[..., :, None] * V[..., None, :, 1])


def mmult32(a, b):
    """a b^T for a (..., 3, 2) and b (..., 2, 2): returns (..., 3, 2)."""
    return (a[..., :, 0, None] * b[..., None, :, 0]
            + a[..., :, 1, None] * b[..., None, :, 1])
