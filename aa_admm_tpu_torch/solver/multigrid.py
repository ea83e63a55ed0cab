"""Two-level aggregation preconditioner for the large-mesh global step
(counterpart of aa_admm_tpu/solver/multigrid.py).

Built once on the host at setup: greedy graph aggregation over the
constraint connectivity until the coarse problem is small enough to
dense-invert, the Galerkin coarse operator ``A_c = P^T A P`` assembled by
index remapping, and its dense inverse. One application is
``M^-1 r = r / diag(A) + P (A_c^-1 (P^T r))``: a restriction (a sum over
each aggregate's rows, in gather form over an inverse table built at set-up,
so in one fixed order), one (nc, nc) @ (nc, 3) matmul and a gather
(prolongation). The additive form keeps the preconditioner SPD.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops._batchutil import GatherAdjoint
from ..ops.constraints import assemble_geometry_node_matrix, hostarr
from .linear import dense_inverse


def collect_pair_edges(batches, reg_rows=None):
    """Vertex-adjacency edges implied by constraint batches: every pair of
    vertices sharing a constraint row. Host-side, setup only."""
    pairs = []
    for b in batches:
        idx = hostarr(b, 'idx')
        if idx.ndim == 1:
            continue  # single-vertex constraints carry no adjacency
        C, K = idx.shape
        for i in range(K):
            for j in range(i + 1, K):
                pairs.append(np.stack([idx[:, i], idx[:, j]], axis=1))
    if reg_rows is not None:
        idx, coef, mask = reg_rows
        C, K = idx.shape
        for i in range(K):
            for j in range(i + 1, K):
                keep = mask[:, i] & mask[:, j]
                pairs.append(np.stack([idx[keep, i], idx[keep, j]], axis=1))
    if not pairs:
        return np.zeros((0, 2), np.int64)
    e = np.concatenate(pairs, axis=0).astype(np.int64)
    e = np.sort(e, axis=1)
    e = e[e[:, 0] != e[:, 1]]
    return np.unique(e, axis=0)


def _aggregate_once(n: int, edges: np.ndarray) -> np.ndarray:
    """One round of greedy aggregation: sweep vertices; an unaggregated
    vertex whose whole neighborhood is free roots a new aggregate absorbing
    it; leftovers attach to the most-connected neighboring aggregate."""
    if len(edges):
        src = np.concatenate([edges[:, 0], edges[:, 1]])
        dst = np.concatenate([edges[:, 1], edges[:, 0]])
        order = np.argsort(src, kind='stable')
        src, dst = src[order], dst[order]
        starts = np.searchsorted(src, np.arange(n + 1))
    else:
        dst = np.zeros(0, np.int64)
        starts = np.zeros(n + 1, np.int64)

    agg = np.full(n, -1, np.int64)
    next_agg = 0
    for v in range(n):
        if agg[v] >= 0:
            continue
        nbrs = dst[starts[v]:starts[v + 1]]
        free = nbrs[agg[nbrs] < 0]
        if len(free) == len(nbrs) or len(nbrs) == 0:
            agg[v] = next_agg
            agg[free] = next_agg
            next_agg += 1
    for v in range(n):
        if agg[v] >= 0:
            continue
        nbrs = dst[starts[v]:starts[v + 1]]
        anbrs = agg[nbrs]
        anbrs = anbrs[anbrs >= 0]
        if len(anbrs):
            vals, counts = np.unique(anbrs, return_counts=True)
            agg[v] = vals[np.argmax(counts)]
        else:
            agg[v] = next_agg
            next_agg += 1
    return agg


def greedy_aggregate(n_verts: int, edges: np.ndarray,
                     target_coarse: int = 4000,
                     max_rounds: int = 4) -> np.ndarray:
    """Repeat aggregation until the coarse side is <= 1.5 * target_coarse
    (or coarsening stalls). Returns agg (n_verts,) int64."""
    agg = np.arange(n_verts, dtype=np.int64)
    cur_n, cur_edges = n_verts, edges
    for _ in range(max_rounds):
        if cur_n <= target_coarse * 1.5:
            break
        a = _aggregate_once(cur_n, cur_edges)
        nc = int(a.max()) + 1 if len(a) else 0
        if nc >= cur_n:  # stalled
            break
        agg = a[agg]
        ce = a[cur_edges]
        ce = np.sort(ce, axis=1)
        ce = ce[ce[:, 0] != ce[:, 1]]
        cur_edges = np.unique(ce, axis=0)
        cur_n = nc
    return agg


@dataclasses.dataclass(frozen=True)
class TwoLevelPrecond(GatherAdjoint):
    """Additive two-level preconditioner; `apply` is the M^-1 r operator
    handed to pcg."""

    agg: torch.Tensor       # (n,) int64 vertex -> aggregate
    Ac_inv: torch.Tensor    # (nc, nc) dense inverse of the coarse operator
    inv_diag: torch.Tensor  # (n,) 1/diag(A) — the Jacobi (smoother) term
    # The restriction's table: each aggregate's rows of r (nc, K).
    inv_idx: Optional[torch.Tensor] = None
    inv_mask: Optional[torch.Tensor] = None

    def _adjoint_index(self):
        return self.agg, None, self.inv_diag.dtype

    def apply(self, r):
        rc = self._scatter(r, self.Ac_inv.shape[0])
        yc = self.Ac_inv @ rc
        return self.inv_diag[:, None] * r + yc[self.agg]


def build_two_level(n_verts, hard, soft, rho, reg_rows, diag,
                    dtype=torch.float64, device="cpu",
                    target_coarse: int = None):
    """Assemble the preconditioner on the host (setup time). `diag` is the
    fine-grid diagonal of A. target_coarse defaults to n/24 clipped to
    [4000, 6000]: each application streams the dense (nc, nc) inverse."""
    if target_coarse is None:
        target_coarse = int(np.clip(n_verts // 24, 4000, 6000))
    if target_coarse < 100:
        raise ValueError(
            f"target_coarse={target_coarse}: the coarse space must have at "
            f"least 100 aggregates")
    edges = collect_pair_edges(list(hard) + list(soft), reg_rows)
    agg = greedy_aggregate(n_verts, edges, target_coarse=target_coarse)
    nc = int(agg.max()) + 1
    Ac = assemble_geometry_node_matrix(nc, hard, soft, rho,
                                       reg_rows=reg_rows, vertex_map=agg)
    # Aggregates can zero out difference-form constraints; keep SPD.
    Ac[np.arange(nc), np.arange(nc)] += 1e-10 * max(Ac.max(), 1.0)
    inv_diag = 1.0 / np.maximum(diag, 1e-300)
    return TwoLevelPrecond(
        agg=torch.from_numpy(agg).to(device),
        Ac_inv=dense_inverse(Ac, dtype=dtype, device=device),
        inv_diag=torch.from_numpy(inv_diag).to(device=device, dtype=dtype))
