"""Anderson acceleration as a function of fixed-shape state (counterpart of
aa_admm_tpu/solver/anderson.py).

Effective-dim AA on a (u, x) pair (Geometry/AndersonAcceleration.h:154-211):
mixing coefficients from the head block, mixing applied to the whole vector;
per-column rescaling of dF with eps=1e-14; an eigh pseudo-inverse of the
masked m x m normal equations; ring-buffer columns; ``replace``/``reset``.

The ring-buffer column and the first-step choice stay on the device (one-hot
masks and ``torch.where``, both branches computed), so ``compute`` never
reads the iteration counters back. Its one host read (``host_read``) is
the m x m Gram matrix, moved to the CPU for the eigendecomposition.

A state may carry a leading scene axis S (``init`` of an (S, d) iterate):
S independent windows, each with its own column, counters and Gram
matrix, mixed by one ``compute`` whose S Gram systems reach the CPU in one
host read and one batched ``eigh``. One implementation serves both: every
step runs over the leading axes, if any. Each scene's result is that of
``compute`` on that scene alone, bit for bit on the CPU; on CUDA the
products of S > 1 scenes are one batched product each, which may round
differently.

``compute(..., reduce=...)`` sums the (..., 2, m) inner-product partials of
an element-sharded iterate over its group before they are used; the Gram
solve and the mixing of the (local or replicated) rows need nothing else.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.timers import host_read

_EPS = 1e-14


@dataclasses.dataclass(frozen=True)
class AAState:
    """One window, or S of them with every field led by the scene axis."""
    current_u: torch.Tensor  # (d,)
    dF: torch.Tensor         # (de, m) scaled residual-difference history
    dG: torch.Tensor         # (d, m) iterate-difference history
    dF_scale: torch.Tensor   # (m,)
    M: torch.Tensor          # (m, m) normal-equations Gram matrix
    iter: torch.Tensor       # () int64 iterations since (re)init
    col_idx: torch.Tensor    # () int64 ring-buffer column

    def _replace(self, **kw) -> "AAState":
        return dataclasses.replace(self, **kw)


_FIELDS = tuple(f.name for f in dataclasses.fields(AAState))


def where(cond, a: AAState, b: AAState) -> AAState:
    """Field-wise torch.where(cond, a, b) over two states; cond is 0-d, or
    (S,) per scene of a batched state (broadcast along each field's leading
    axis)."""
    shaped, out = {}, {}
    for k in _FIELDS:
        x = getattr(a, k)
        n = x.dim()
        if n not in shaped:
            shaped[n] = cond if cond.dim() == 0 else cond.reshape(
                cond.shape + (1,) * (n - cond.dim()))
        out[k] = torch.where(shaped[n], x, getattr(b, k))
    return AAState(**out)


def init(m: int, u0: torch.Tensor, effective_dim: int | None = None) -> AAState:
    """AndersonAcceleration::init — u0 is the flat initial iterate (d,), or
    (S, d) for S scenes; for pair variants the effective block must be the
    head of the vector (effective_dim counts one scene's)."""
    lead, d = tuple(u0.shape[:-1]), u0.shape[-1]
    de = d if effective_dim is None else effective_dim
    kw = dict(dtype=u0.dtype, device=u0.device)
    zero = torch.zeros(lead, dtype=torch.int64, device=u0.device)
    return AAState(current_u=u0, dF=torch.zeros(lead + (de, m), **kw),
                   dG=torch.zeros(lead + (d, m), **kw),
                   dF_scale=torch.ones(lead + (m,), **kw),
                   M=torch.zeros(lead + (m, m), **kw), iter=zero,
                   col_idx=zero)


def replace(state: AAState, u: torch.Tensor) -> AAState:
    """Overwrite the accepted iterate, keep history."""
    return state._replace(current_u=u)


def reset(state: AAState, u: torch.Tensor) -> AAState:
    """Restart the window (geometry reject path,
    Geometry/AndersonAcceleration.h:74-91)."""
    zero = torch.zeros_like(state.iter)
    return state._replace(current_u=u, iter=zero, col_idx=zero)


def _prod(a, b, batched):
    """a @ b over the trailing axes (a matrix times a matrix or a vector),
    for one window or for every scene s of S. One window: the single call.
    batched (compute passes it for a state of S > 1 scenes on CUDA, where S
    calls would cost more than the products): one bmm, on the device and
    for the theta solve's host products alike. Otherwise each scene's
    product is the single call, so S scenes on the CPU compute bit for bit
    as S single windows; that is the branch the CPU tests cover, and the
    cuda-marked ensemble tests hold the bmm branch at 1e-10."""
    if a.dim() == 2:
        return a @ b
    if batched:
        return (torch.bmm(a, b) if b.dim() == 3
                else torch.bmm(a, b.unsqueeze(2)).squeeze(2))
    return torch.stack([x @ y for x, y in zip(a, b)])


def _solve_theta(M, rhs, valid, batched):
    """Least-squares solve of the masked normal equations (M (..., m, m),
    rhs and valid (..., m), one window or S): invalid rows/cols become
    identity (theta=0 there); the valid block is solved with an eigh
    pseudo-inverse (relative cutoff). The systems reach the CPU in one host
    read, for one (batched) eigh."""
    m = M.shape[-1]
    eye = torch.eye(m, dtype=M.dtype, device=M.device)
    vmask = valid[..., :, None] & valid[..., None, :]
    Mm = torch.where(vmask, M, eye)
    rhs_m = torch.where(valid, rhs, torch.zeros_like(rhs))
    systems = torch.cat([Mm, rhs_m[..., None, :]], dim=-2)
    host = host_read(systems)
    w, Q = torch.linalg.eigh(host[..., :m, :])
    cutoff = (torch.clamp_min(w.abs().amax(-1, keepdim=True), _EPS)
              * (m * torch.finfo(M.dtype).eps * 10))
    w_inv = torch.where(w.abs() > cutoff, 1.0 / w, torch.zeros_like(w))
    proj = _prod(Q.transpose(-1, -2), host[..., m, :], batched)
    theta = _prod(Q, w_inv * proj, batched).to(M.device)
    return torch.where(valid, theta, torch.zeros_like(theta))


def _col(a, c):
    """Column c of a (..., d, m) matrix, as (..., d); c is the column
    index shaped (..., 1, 1)."""
    return a.gather(-1, c.expand(*a.shape[:-1], 1)).squeeze(-1)


def _set_col(a, c, v):
    """Copy of a (..., d, m) matrix with column c set to v (..., d)."""
    return a.scatter(-1, c.expand(*a.shape[:-1], 1), v.unsqueeze(-1))


def compute(state: AAState, G: torch.Tensor, reduce=None
            ) -> tuple[AAState, torch.Tensor]:
    """One AA mixing step: consumes the fixed-point image G of the current
    iterate, returns (state, accelerated iterate)
    (compute_impl, Geometry/AndersonAcceleration.h:154-211). G is (d,) for
    one window, or (S, d) for the S scenes of a batched state, each mixed
    on its own (every step below runs over the leading axes, if any).
    reduce: None, or a function that sums the inner-product partials
    (..., 2, m) of a sharded iterate over its group."""
    de, m = state.dF.shape[-2:]
    batched = G.is_cuda and G.dim() == 2 and G.shape[0] > 1
    F = G[..., :de] - state.current_u[..., :de]
    col = state.col_idx
    c = col[..., None, None]
    onehot = torch.arange(m, device=G.device) == c[..., 0]        # (..., m)

    # general step
    dF_col = _col(state.dF, c) + F
    dG_col = _col(state.dG, c) + G
    dF_base = _set_col(state.dF, c, dF_col)
    P = _prod(torch.stack([dF_col, F], -2), dF_base, batched)    # (..., 2, m)
    if reduce is not None:
        P = reduce(P)
    scale2 = P[..., 0, :].gather(-1, c[..., 0]).squeeze(-1)
    scale = torch.clamp_min(torch.sqrt(torch.clamp_min(scale2, 0.0)), _EPS)
    sc = scale[..., None]
    dF = dF_base * torch.where(onehot, 1.0 / sc, 1.0)[..., None, :]
    dG = _set_col(state.dG, c, dG_col)
    dF_scale = torch.where(onehot, sc, state.dF_scale)

    m_k = torch.clamp_max(state.iter, m)
    valid = torch.arange(m, device=G.device) < m_k[..., None]
    inner = torch.where(onehot, (scale2 / (scale * scale))[..., None],
                        P[..., 0, :] / sc)
    M = torch.where(onehot[..., :, None], inner[..., None, :], state.M)
    M = torch.where(onehot[..., None, :], inner[..., :, None], M)
    rhs = torch.where(onehot, P[..., 1, :] / sc, P[..., 1, :])
    theta = _solve_theta(M, rhs, valid, batched)
    u_gen = G - _prod(dG, theta / dF_scale, batched)
    col2 = (col + 1) % m
    c2 = col2[..., None, None]
    general = AAState(u_gen, _set_col(dF, c2, -F), _set_col(dG, c2, -G),
                      dF_scale, M, state.iter, col2)

    # first step (iter == 0)
    zero = torch.zeros_like(c)
    first = AAState(G, _set_col(state.dF, zero, -F),
                    _set_col(state.dG, zero, -G), state.dF_scale, state.M,
                    state.iter, col)

    new_state = where(state.iter == 0, first, general)
    return new_state._replace(iter=state.iter + 1), new_state.current_u
