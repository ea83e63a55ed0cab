"""Global-step linear solvers (counterpart of aa_admm_tpu/solver/linear.py).

* ``assemble_node_matrix`` / ``assemble_node_diag`` — the physics system
  M + dt^2 p D^T W^2 D and its diagonal, assembled on the host in f64.
* ``DenseInverseSolver`` — the per-coordinate system matrix is
  Cholesky-inverted once on the host in f64; each solve is one matmul
  ``A^-1 @ rhs`` over all coordinate columns.
* ``pcg`` — preconditioned CG on (n, c) blocks with per-column alpha/beta
  and frozen converged columns, in plain torch.
* ``pcg_fused`` — the same iteration with its vector half in kernels B2 and
  B3 (``ops.cuda_kernels.cg_update1/2``; their twins on CPU tensors). The
  counterpart of ``pcg_banded`` without the TPU band layout: vectors stay
  (n, c), x/r/p are updated in place.

The loop condition is read on the host once per iteration; both CG
functions return ``(x, iterations, host_reads)``.

Row-sharded CG (the counterpart of ``row_sharding``): ``pcg_fused`` with
``reduce`` (a function that sums a tensor over the ranks) takes the
vectors, the operator and the preconditioner as this rank's rows, and sums
the column dots over the ranks: one sum for pAp and one for {rz, rr}
(written into the rows of one buffer) per iteration, as the JAX pcg's
psums (one more at the start for the stacked {rz, rr, rhs.rhs}). Every rank then reads the same loop test.
The operator assembles the rows of p that it reads from other ranks
itself. B2 and B3 run there through their given entries (their twins on
CPU tensors).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..ops import cuda_kernels as ck
from ..ops._batchutil import hostarr


def _node_stencil(b):
    """(idx (E, k), G (E, k, r)) of an element batch's per-coordinate
    reduction rows (tets: -sum(B) then B's rows; cloth triangles the same
    with the 2x2 rest inverse R), or (idx (E,), None) for identity
    reductions on a vertex."""
    for name, elems in (("Dm_inv", "tets"), ("rest_inv", "tris")):
        if hasattr(b, name):
            B = hostarr(b, name).astype(np.float64)      # (E,3,3) / (E,2,2)
            G = np.concatenate([-B.sum(axis=1, keepdims=True), B], axis=1)
            return hostarr(b, elems), G                  # (E,4,3) / (E,3,2)
    return hostarr(b, 'idx'), None


def assemble_node_matrix(n_verts: int, batches, dt2p: float = 1.0,
                         masses: Optional[np.ndarray] = None) -> np.ndarray:
    """Host-side dense assembly of the per-coordinate system matrix
    ``M + dt2p * D^T W^2 D`` (n x n over nodes; identical for x/y/z because
    the reduction acts per coordinate — Solver.cpp:459-470; JAX
    linear.py:37-71). ``batches``: element batches (TetBatch, TriBatch,
    PinBatch, CollisionBatch, SelfCollisionBatch)."""
    A = np.zeros((n_verts, n_verts))
    diag = np.arange(n_verts)
    if masses is not None:
        A[diag, diag] += np.asarray(masses)
    for b in batches:
        w2 = hostarr(b, 'w').astype(np.float64) ** 2
        idx, G = _node_stencil(b)
        if G is None:
            np.add.at(A, (idx, idx), w2)
        else:
            K = np.einsum("e,eir,ejr->eij", w2, G, G)
            np.add.at(A, (idx[:, :, None], idx[:, None, :]), K)
    if dt2p != 1.0:
        if masses is not None:
            A[diag, diag] -= np.asarray(masses)
        A *= dt2p
        if masses is not None:
            A[diag, diag] += np.asarray(masses)
    return A


def assemble_node_diag(n_verts: int, batches) -> np.ndarray:
    """Diagonal of D^T W^2 D per node (the Jacobi preconditioner) without
    the matrix — O(E) host work (JAX linear.py:74-90)."""
    d = np.zeros(n_verts)
    for b in batches:
        w2 = hostarr(b, 'w').astype(np.float64) ** 2
        idx, G = _node_stencil(b)
        if G is None:
            np.add.at(d, idx, w2)
        else:
            np.add.at(d, idx, w2[:, None] * (G ** 2).sum(axis=-1))
    return d


def dense_inverse(A_free: np.ndarray, dtype=torch.float64,
                  device="cpu") -> torch.Tensor:
    """Cholesky-based SPD inverse computed once on the host in f64."""
    import scipy.linalg
    c, low = scipy.linalg.cho_factor(A_free.astype(np.float64))
    inv = scipy.linalg.cho_solve((c, low), np.eye(A_free.shape[0]))
    return torch.from_numpy(inv).to(device=device, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class DenseInverseSolver:
    Ainv: torch.Tensor  # (nf, nf)

    def solve(self, rhs):
        """rhs (nf, ncoord) -> (nf, ncoord): one matmul."""
        return self.Ainv @ rhs


def _jacobi(diag):
    Minv_diag = (1.0 / diag)[:, None]
    return lambda r: Minv_diag * r


def pcg(operator: Callable, rhs, diag, tol: float = 1e-12,
        max_iters: int = 400, x0=None, precond: Optional[Callable] = None):
    """Preconditioned CG on (n, ncoord) blocks (plain torch).

    operator: v (n, c) -> A v (n, c). diag: (n,) Jacobi diagonal, used when
    precond (an SPD M^-1 r callable) is None. Returns (x, n_iters,
    host_reads). Per-column alpha/beta; converged columns freeze."""
    if precond is None:
        precond = _jacobi(diag)
    x = torch.zeros_like(rhs) if x0 is None else x0
    r = rhs - operator(x)
    z = precond(r)
    p = z
    rz, rr = (r * z).sum(0), (r * r).sum(0)
    rhs_norm2 = torch.clamp_min((rhs * rhs).sum(0), 1e-300)
    tol2 = tol * tol
    it = reads = 0
    while it < max_iters:
        reads += 1
        if not bool((rr / rhs_norm2 > tol2).any()):
            break
        Ap = operator(p)
        pAp = (p * Ap).sum(0)
        active = (rr / rhs_norm2) > tol2
        alpha = torch.where(
            active, rz / torch.where(pAp == 0, torch.ones_like(pAp), pAp),
            torch.zeros_like(rz))
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * Ap
        z = precond(r)
        rz_new, rr = (r * z).sum(0), (r * r).sum(0)
        beta = torch.where(
            active, rz_new / torch.where(rz == 0, torch.ones_like(rz), rz),
            torch.zeros_like(rz))
        p = z + beta[None, :] * p
        rz = rz_new
        it += 1
    return x, it, reads


def pcg_fused(operator: Callable, rhs, diag, tol: float = 1e-12,
              max_iters: int = 400, x0=None,
              precond: Optional[Callable] = None,
              reduce: Optional[Callable] = None):
    """pcg with the vector half of each iteration in kernels B2
    ({pAp, alpha, x +=, r -=, rr}) and B3 ({rz, beta, p =}). Same semantics
    as pcg; the column dots are summed in another order. x0 is not
    modified. Returns (x, n_iters, host_reads). With reduce (a row-sharded
    solve) B2 and B3 run through their given entries, fed the all-rank
    pAp and {rz, rr}."""
    if precond is None:
        precond = _jacobi(diag)
    x = torch.zeros_like(rhs) if x0 is None else x0.clone()
    r = rhs - operator(x)
    p = precond(r)
    if reduce is not None:
        return _pcg_given(operator, rhs, tol, max_iters, x, r, p, precond,
                          reduce)
    rz, rr = (r * p).sum(0), (r * r).sum(0)
    thresh = torch.clamp_min((rhs * rhs).sum(0), 1e-300) * (tol * tol)
    it = reads = 0
    while it < max_iters:
        reads += 1
        if not bool((rr > thresh).any()):
            break
        Ap = operator(p)
        rr_new = ck.cg_update1(rz, p, Ap, x, r, rr, thresh)
        z = precond(r)
        rz = ck.cg_update2(rz, r, z, p, rr, thresh)
        rr = rr_new
        it += 1
    return x, it, reads


def _pcg_given(operator, rhs, tol, max_iters, x, r, p, precond, reduce):
    """pcg_fused's loop on a rank's rows: the rank's column dots (cg_dot)
    summed over the ranks, then B2 and B3 through their given entries. rz
    and this rank's rr are written into the rows of one (2, c) buffer and
    summed in one collective; two such buffers alternate, so that the sums
    of the last iteration stay intact while the next are written."""
    rz, rr, rhs2 = reduce(torch.stack(((r * p).sum(0), (r * r).sum(0),
                                       (rhs * rhs).sum(0)))).unbind(0)
    thresh = torch.clamp_min(rhs2, 1e-300) * (tol * tol)
    sums = torch.empty((2, 2, x.shape[1]), dtype=x.dtype, device=x.device)
    it = reads = 0
    while it < max_iters:
        reads += 1
        if not bool((rr > thresh).any()):
            break
        Ap = operator(p)
        pAp = reduce(ck.cg_dot(p, Ap))
        buf = sums[it % 2]
        ck.cg_update1_given(pAp, rz, p, Ap, x, r, rr, thresh, out=buf[1])
        z = precond(r)
        ck.cg_dot(r, z, out=buf[0])
        rz_new, rr_new = reduce(buf).unbind(0)
        ck.cg_update2_given(rz_new, rz, z, p, rr, thresh)
        rz, rr = rz_new, rr_new
        it += 1
    return x, it, reads
