"""Anderson acceleration as a function of fixed-shape state (counterpart of
aa_admm_tpu/solver/anderson.py).

Effective-dim AA on a (u, x) pair (Geometry/AndersonAcceleration.h:154-211):
mixing coefficients from the head block, mixing applied to the whole vector;
per-column rescaling of dF with eps=1e-14; an eigh pseudo-inverse of the
masked m x m normal equations; ring-buffer columns; ``replace``/``reset``.

The ring-buffer column and the first-step choice stay on the device (one-hot
masks and ``torch.where``, both branches computed), so ``compute`` never
reads the iteration counters back. Its one host read is the m x m Gram
matrix, moved to the CPU for the eigendecomposition.
"""

from __future__ import annotations

import dataclasses

import torch

_EPS = 1e-14


@dataclasses.dataclass(frozen=True)
class AAState:
    current_u: torch.Tensor  # (d,)
    dF: torch.Tensor         # (de, m) scaled residual-difference history
    dG: torch.Tensor         # (d, m) iterate-difference history
    dF_scale: torch.Tensor   # (m,)
    M: torch.Tensor          # (m, m) normal-equations Gram matrix
    iter: torch.Tensor       # () int64 iterations since (re)init
    col_idx: torch.Tensor    # () int64 ring-buffer column

    def _replace(self, **kw) -> "AAState":
        return dataclasses.replace(self, **kw)


def where(cond, a: AAState, b: AAState) -> AAState:
    """Field-wise torch.where(cond, a, b) over two states."""
    return AAState(**{f.name: torch.where(cond, getattr(a, f.name),
                                          getattr(b, f.name))
                      for f in dataclasses.fields(AAState)})


def init(m: int, u0: torch.Tensor, effective_dim: int | None = None) -> AAState:
    """AndersonAcceleration::init — u0 is the flat initial iterate; for pair
    variants the effective block must be the head of the vector."""
    d = u0.shape[0]
    de = d if effective_dim is None else effective_dim
    kw = dict(dtype=u0.dtype, device=u0.device)
    zero = torch.zeros((), dtype=torch.int64, device=u0.device)
    return AAState(current_u=u0, dF=torch.zeros((de, m), **kw),
                   dG=torch.zeros((d, m), **kw), dF_scale=torch.ones((m,), **kw),
                   M=torch.zeros((m, m), **kw), iter=zero, col_idx=zero)


def replace(state: AAState, u: torch.Tensor) -> AAState:
    """Overwrite the accepted iterate, keep history."""
    return state._replace(current_u=u)


def reset(state: AAState, u: torch.Tensor) -> AAState:
    """Restart the window (geometry reject path,
    Geometry/AndersonAcceleration.h:74-91)."""
    zero = torch.zeros((), dtype=torch.int64, device=u.device)
    return state._replace(current_u=u, iter=zero, col_idx=zero)


def _solve_theta(M, rhs, valid):
    """Least-squares solve of the masked normal equations: invalid rows/cols
    become identity (theta=0 there); the valid block is solved with an eigh
    pseudo-inverse (relative cutoff). The eigendecomposition runs on the CPU
    (one host read of the m x m system)."""
    m = M.shape[0]
    eye = torch.eye(m, dtype=M.dtype, device=M.device)
    vmask = valid[:, None] & valid[None, :]
    Mm = torch.where(vmask, M, eye)
    rhs_m = torch.where(valid, rhs, torch.zeros_like(rhs))
    host = torch.cat([Mm, rhs_m[None, :]]).cpu()
    w, Q = torch.linalg.eigh(host[:m])
    cutoff = (torch.clamp_min(w.abs().max(), _EPS)
              * (m * torch.finfo(M.dtype).eps * 10))
    w_inv = torch.where(w.abs() > cutoff, 1.0 / w, torch.zeros_like(w))
    theta = (Q @ (w_inv * (Q.T @ host[m]))).to(M.device)
    return torch.where(valid, theta, torch.zeros_like(theta))


def _col(a, col):
    """Column `col` (0-d device index) of a (d, m) matrix, as (d,)."""
    return a.index_select(1, col.reshape(1))[:, 0]


def _set_col(a, col, v):
    """Copy of a (d, m) matrix with column `col` set to v (d,)."""
    return a.index_copy(1, col.reshape(1), v[:, None])


def compute(state: AAState, G: torch.Tensor) -> tuple[AAState, torch.Tensor]:
    """One AA mixing step: consumes the fixed-point image G of the current
    iterate, returns (state, accelerated iterate)
    (compute_impl, Geometry/AndersonAcceleration.h:154-211)."""
    de, m = state.dF.shape
    F = G[:de] - state.current_u[:de]
    col = state.col_idx
    onehot = torch.arange(m, device=G.device) == col

    # general step
    dF_col = _col(state.dF, col) + F
    dG_col = _col(state.dG, col) + G
    dF_base = _set_col(state.dF, col, dF_col)
    P = torch.stack([dF_col, F]) @ dF_base            # (2, m)
    scale2 = P[0].index_select(0, col.reshape(1))[0]
    scale = torch.clamp_min(torch.sqrt(torch.clamp_min(scale2, 0.0)), _EPS)
    dF = dF_base * torch.where(onehot, 1.0 / scale,
                               torch.ones_like(scale))[None, :]
    dG = _set_col(state.dG, col, dG_col)
    dF_scale = torch.where(onehot, scale, state.dF_scale)

    m_k = torch.clamp_max(state.iter, m)
    valid = torch.arange(m, device=G.device) < m_k
    inner = torch.where(onehot, scale2 / (scale * scale), P[0] / scale)
    M = torch.where(onehot[:, None], inner[None, :], state.M)
    M = torch.where(onehot[None, :], inner[:, None], M)
    rhs = torch.where(onehot, P[1] / scale, P[1])
    theta = _solve_theta(M, rhs, valid)
    u_gen = G - dG @ (theta / dF_scale)
    col2 = (col + 1) % m
    general = AAState(current_u=u_gen, dF=_set_col(dF, col2, -F),
                      dG=_set_col(dG, col2, -G), dF_scale=dF_scale, M=M,
                      iter=state.iter, col_idx=col2)

    # first step (iter == 0)
    zero = torch.zeros((), dtype=torch.int64, device=G.device)
    first = state._replace(current_u=G, dF=_set_col(state.dF, zero, -F),
                           dG=_set_col(state.dG, zero, -G))

    new_state = where(state.iter == 0, first, general)
    return new_state._replace(iter=state.iter + 1), new_state.current_u
