"""Batched point-to-triangle-mesh closest-point queries (counterpart of
aa_admm_tpu/ops/closest_point.py).

Replaces the reference's igl::AABB traversals (Geometry/TriMeshAABB.h:38-77)
with tiled brute force (small meshes), a coarse-to-fine 2-stage query (large
meshes) and movement-bounded candidate caches for the solver loop. Every
exact sweep over per-query candidates goes through kernel B1: the indexed
entry ``cuda_kernels.ericson_candidates_idx``, which gathers each query's
candidates from the triangle table itself, or, for the candT cache, the
(9, K, Q) entry ``ericson_candidates_T``. On CUDA tensors the hand-written
kernel runs, on CPU tensors its plain twin.

Host reads: each cached query decides on the host whether the cache is still
valid (one read of ``need``) and returns that decision, so the caller can
count it. A query set split over ranks passes ``reduce`` (a sum over the
ranks): the test is then taken over every rank's queries, so all ranks
refresh together, on the trials where the whole set would. Top-k selections whose order feeds cache contents use a stable
ascending sort, which puts the lower index first on ties, as
``jax.lax.top_k`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import cuda_kernels as ck


def _dot3(u, v):
    """u . v over the last axis of size 3, summed as (x + y) + z whatever
    the layout (a torch sum's order depends on it), as kernel B1 sums."""
    return u[..., 0] * v[..., 0] + u[..., 1] * v[..., 1] + u[..., 2] * v[..., 2]


def _ericson_regions(p, a, b, c):
    """Ericson closest point on triangles (a, b, c) for points p, all
    broadcast to (..., 3). Branch-free region tests (RTCD 5.1.5)."""
    ab, ac, ap = b - a, c - a, p - a
    d1 = _dot3(ab, ap)
    d2 = _dot3(ac, ap)
    bp = p - b
    d3 = _dot3(ab, bp)
    d4 = _dot3(ac, bp)
    cp = p - c
    d5 = _dot3(ab, cp)
    d6 = _dot3(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    def safe_div(n, d):
        return n / torch.where(d == 0, torch.ones_like(d), d)

    def clip01(v):
        return torch.clamp(v, 0.0, 1.0)

    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ac = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)
    v_ab = clip01(safe_div(d1, d1 - d3))
    w_ac = clip01(safe_div(d2, d2 - d6))
    w_bc = clip01(safe_div(d4 - d3, (d4 - d3) + (d5 - d6)))
    s = va + vb + vc
    denom = torch.where(s == 0, torch.ones_like(s), s)
    v_in = vb / denom
    w_in = vc / denom
    q = a + v_in[..., None] * ab + w_in[..., None] * ac
    q = torch.where(on_bc[..., None], b + w_bc[..., None] * (c - b), q)
    q = torch.where(on_ac[..., None], a + w_ac[..., None] * ac, q)
    q = torch.where(on_ab[..., None], a + v_ab[..., None] * ab, q)
    q = torch.where(in_c[..., None], c.expand_as(q), q)
    q = torch.where(in_b[..., None], b.expand_as(q), q)
    q = torch.where(in_a[..., None], a.expand_as(q), q)
    e = p - q
    return q, _dot3(e, e)


def closest_point_on_triangles(p, tri_verts):
    """Closest point on each triangle to each query point.
    p: (P, 3); tri_verts: (T, 3, 3). Returns (points (P, T, 3), sqd (P, T))."""
    a = tri_verts[:, 0][None]
    b = tri_verts[:, 1][None]
    c = tri_verts[:, 2][None]
    return _ericson_regions(p[:, None, :], a, b, c)


def closest_point_on_mesh(p, tri_verts, tile: int = 1024,
                          query_tile: int = 8192):
    """Closest surface point for each query: (P, 3), (T, 3, 3) -> (P, 3).
    Doubly tiled over query chunks and triangle chunks (peak memory
    O(query_tile * tile)); per tile the first minimum wins, across tiles a
    strictly smaller distance does."""
    tri_verts = tri_verts.to(p.dtype)
    T, P = tri_verts.shape[0], p.shape[0]
    out = torch.empty_like(p)
    for q0 in range(0, P, query_tile):
        pc = p[q0:q0 + query_tile]
        best_d = torch.full((pc.shape[0],), float("inf"), dtype=p.dtype,
                            device=p.device)
        best_q = torch.zeros_like(pc)
        for t0 in range(0, T, tile):
            q, sqd = closest_point_on_triangles(pc, tri_verts[t0:t0 + tile])
            i = torch.argmin(sqd, dim=1)
            d = torch.gather(sqd, 1, i[:, None])[:, 0]
            qi = torch.gather(q, 1, i[:, None, None].expand(-1, 1, 3))[:, 0]
            better = d < best_d
            best_d = torch.where(better, d, best_d)
            best_q = torch.where(better[:, None], qi, best_q)
        out[q0:q0 + query_tile] = best_q
    return out


def _smallest_k(x, k: int):
    """(values, indices) of the k smallest entries per row, ascending, lower
    index first on ties (stable sort: the tie order of jax.lax.top_k)."""
    vals, idx = torch.sort(x, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


def _centered_bounds(tri_verts):
    """Per-triangle centroid (centered on their mean), |centroid|^2, the
    bounding radius about the centroid, and the centering offset."""
    cent = tri_verts.mean(1)
    rad = torch.sqrt(((tri_verts - cent[:, None, :]) ** 2).sum(-1).amax(1))
    c0 = cent.mean(0)
    cent = cent - c0
    return cent, (cent * cent).sum(-1), rad, c0


def _lower_bounds(pc, cent, c2, rad, c0):
    """max(0, |p - centroid| - radius) for every (query, triangle) via one
    (q, 3) x (3, T) matmul on centered coordinates."""
    pcc = pc - c0
    d2c = ((pcc * pcc).sum(-1, keepdim=True) - 2.0 * pcc @ cent.T
           + c2[None, :])
    dist_c = torch.sqrt(torch.clamp_min(d2c, 0.0))
    return torch.clamp_min(dist_c - rad[None, :], 0.0)


def closest_point_on_mesh_2stage(p, tri_verts, k: int = 48,
                                 query_tile: int = 4096):
    """Coarse-to-fine closest point for large reference meshes: triangle
    lower bounds from one matmul per query chunk, the k smallest kept, the
    exact sweep (kernel B1) over those candidates."""
    tri_verts = tri_verts.to(p.dtype)
    cent, c2, rad, c0 = _centered_bounds(tri_verts)
    k = min(k, tri_verts.shape[0])
    out = torch.empty_like(p)
    for q0 in range(0, p.shape[0], query_tile):
        pc = p[q0:q0 + query_tile]
        lower = _lower_bounds(pc, cent, c2, rad, c0)
        _, idx = torch.topk(lower, k, dim=1, largest=False, sorted=True)
        q, _ = ck.ericson_candidates_idx(pc, tri_verts, idx)
        out[q0:q0 + query_tile] = q
    return out


def build_tri_groups(tri_verts_np, group_size: int = 64):
    """Host-side Morton grouping of a static triangle soup (identical to
    aa_admm_tpu.ops.closest_point.build_tri_groups). Returns
    (tri_perm (Tp,3,3), tri_cent (Tp,3), tri_rad (Tp,), gcenter (G,3),
    gradius (G,)); padded slots hold far-away dummies (1e15)."""
    tv = np.asarray(tri_verts_np, np.float64)
    T = tv.shape[0]
    cent = tv.mean(1)
    rad = np.sqrt(((tv - cent[:, None, :]) ** 2).sum(-1).max(1))
    lo, hi = cent.min(0), cent.max(0)
    q = np.clip((cent - lo) / np.maximum(hi - lo, 1e-30) * 1023.0,
                0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 32)) & np.uint64(0x1F00000000FFFF)
        x = (x | (x << 16)) & np.uint64(0x1F0000FF0000FF)
        x = (x | (x << 8)) & np.uint64(0x100F00F00F00F00F)
        x = (x | (x << 4)) & np.uint64(0x10C30C30C30C30C3)
        x = (x | (x << 2)) & np.uint64(0x1249249249249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) \
        | (spread(q[:, 2]) << np.uint64(2))
    perm = np.argsort(code, kind="stable")
    G = -(-T // group_size)
    Tp = G * group_size
    FAR = 1e15
    tri_p = np.full((Tp, 3, 3), FAR, tv.dtype)
    cent_p = np.full((Tp, 3), FAR, tv.dtype)
    rad_p = np.zeros((Tp,), tv.dtype)
    tri_p[:T] = tv[perm]
    cent_p[:T] = cent[perm]
    rad_p[:T] = rad[perm]
    cg = cent_p.reshape(G, group_size, 3)
    valid = np.zeros((Tp,), bool)
    valid[:T] = True
    vg = valid.reshape(G, group_size)
    nval = np.maximum(vg.sum(1), 1)[:, None]
    gcenter = np.where(vg[..., None], cg, 0.0).sum(1) / nval
    d = np.sqrt(((cg - gcenter[:, None, :]) ** 2).sum(-1)) \
        + rad_p.reshape(G, group_size)
    gradius = np.where(vg, d, 0.0).max(1)
    gcenter = np.where(vg.any(1)[:, None], gcenter, FAR)
    return tri_p, cent_p, rad_p, gcenter, gradius


@dataclasses.dataclass(frozen=True)
class CPCache:
    """Movement-bounded candidate cache (flat, per-triangle candidates).
    Candidates chosen at p0 stay exact while ``2 |p - p0| < slack``; any
    violation refreshes the whole batch. ``candT`` optionally caches the
    candidate coordinates in kernel B1's (9, K, Q) layout, so the fast path
    is the kernel alone."""

    idx: torch.Tensor                       # (Q, K) int64 triangle ids
    p0: torch.Tensor                        # (Q, 3) positions at cache time
    slack: torch.Tensor                     # (Q,) margin (-inf forces refresh)
    candT: Optional[torch.Tensor] = None    # (9, K, Q)


@dataclasses.dataclass(frozen=True)
class CPCacheGroup:
    """Subgroup-granular candidate cache (large reference meshes): each
    query keeps NG Morton subgroups of S triangles; exact while
    ``2 |p - p0| < slack``."""

    gidx: torch.Tensor    # (Q, NG) int64 subgroup ids
    p0: torch.Tensor      # (Q, 3)
    slack: torch.Tensor   # (Q,)


def cp_cache_init(n_queries: int, k: int, dtype, device,
                  with_candT: bool = False) -> CPCache:
    candT = None
    if with_candT:
        candT = torch.zeros((9, k, n_queries), dtype=dtype, device=device)
    return CPCache(
        idx=torch.zeros((n_queries, k), dtype=torch.int64, device=device),
        p0=torch.zeros((n_queries, 3), dtype=dtype, device=device),
        slack=torch.full((n_queries,), float("-inf"), dtype=dtype,
                         device=device),
        candT=candT)


def cp_cache_group_init(n_queries: int, n_groups: int, dtype,
                        device) -> CPCacheGroup:
    return CPCacheGroup(
        gidx=torch.zeros((n_queries, n_groups), dtype=torch.int64,
                         device=device),
        p0=torch.zeros((n_queries, 3), dtype=dtype, device=device),
        slack=torch.full((n_queries,), float("-inf"), dtype=dtype,
                         device=device))


def _cand_T(cand):
    """(Q, K, 3, 3) candidates -> kernel layout (9, K, Q)."""
    Q, K = cand.shape[0], cand.shape[1]
    return cand.reshape(Q, K, 9).permute(2, 1, 0).contiguous()


def _cp_refresh(p, tri_verts, k: int, query_tile: int,
                with_candT: bool = False):
    """Full 2-stage query + fresh flat cache (idx, p0=p, slack). Keeps the k
    nearest candidates by EXACT distance out of a 2k lower-bound prefilter;
    slack = min((k+1)-th exact distance, 2k-th lower bound) - d_true."""
    T = tri_verts.shape[0]
    k2 = min(2 * k, T)
    cent, c2, rad, c0 = _centered_bounds(tri_verts)
    qs, idxs, slacks = [], [], []
    for q0 in range(0, p.shape[0], query_tile):
        pc = p[q0:q0 + query_tile]
        lower = _lower_bounds(pc, cent, c2, rad, c0)
        vals, idx2 = _smallest_k(lower, k2)
        qk, sqd = _closest_point_candidates_all(pc, tri_verts[idx2])
        d = torch.sqrt(sqd)
        dk, j = _smallest_k(d, k + 1)                # ascending distance
        idxs.append(torch.gather(idx2, 1, j[:, :k]))
        qs.append(torch.gather(qk, 1, j[:, :1, None].expand(-1, 1, 3))[:, 0])
        excl = torch.minimum(dk[:, k], vals.amax(1))
        slacks.append(excl - dk[:, 0])
    q, idx, slack = torch.cat(qs), torch.cat(idxs), torch.cat(slacks)
    candT = _cand_T(tri_verts[idx]) if with_candT else None
    return q, CPCache(idx=idx, p0=p, slack=slack, candT=candT)


def _cp_refresh_group(p, tri_blk, cent_blk, rad_blk, gcenter, gradius,
                      n_sub: int, sub_size: int, query_tile: int,
                      prefilter: int = 32, k: int = 48):
    """Group-cache refresh: the value from the hierarchical 2-stage query
    (group bounds -> per-triangle bounds on the surviving groups -> exact
    sweep over the top k), the cache from the NG best subgroups, and the
    slack from the best excluded bound (see the JAX twin's docstring)."""
    G = gcenter.shape[0]
    S = tri_blk.shape[1]
    n_per_g = S // sub_size
    g0 = min(prefilter, G - 1)
    if n_sub + 1 > g0 * n_per_g:
        raise ValueError(
            f"cp_groups={n_sub} needs at least cp_groups+1 candidate "
            f"subgroups after prefilter, but prefilter={g0} groups x "
            f"{n_per_g} subgroups/group = {g0 * n_per_g}; lower cp_groups "
            f"or raise prefilter/group_size")
    ng = n_sub
    tri_flat = tri_blk.reshape(-1, 3, 3)
    ar_s = torch.arange(S, device=p.device)
    ar_n = torch.arange(n_per_g, device=p.device)
    qs, gidxs, slacks = [], [], []
    for q0 in range(0, p.shape[0], query_tile):
        pc = p[q0:q0 + query_tile]
        qn = pc.shape[0]
        dg = torch.sqrt(((pc[:, None, :] - gcenter[None]) ** 2).sum(-1))
        lower_g = torch.clamp_min(dg - gradius[None, :], 0.0)
        vg, gsel = _smallest_k(lower_g, g0 + 1)
        excl_group = vg[:, g0]
        gsel = gsel[:, :g0]
        cc = cent_blk[gsel].reshape(qn, g0 * S, 3)
        rr = rad_blk[gsel].reshape(qn, g0 * S)
        slots = (gsel[..., None] * S + ar_s).reshape(qn, -1)
        dt_ = torch.sqrt(((pc[:, None, :] - cc) ** 2).sum(-1))
        lower = torch.clamp_min(dt_ - rr, 0.0)
        _, j = _smallest_k(lower, k)
        idx = torch.gather(slots, 1, j)
        q, sqd = ck.ericson_candidates_idx(pc, tri_flat, idx)
        sub_score = lower.reshape(qn, -1, sub_size).amin(-1)
        sslots = (gsel[..., None] * n_per_g + ar_n).reshape(qn, -1)
        vs, js = _smallest_k(sub_score, ng + 1)
        gidxs.append(torch.gather(sslots, 1, js[:, :ng]))
        excl = torch.minimum(vs[:, ng], excl_group)
        slacks.append(excl - torch.sqrt(sqd))
        qs.append(q)
    return (torch.cat(qs),
            CPCacheGroup(gidx=torch.cat(gidxs), p0=p, slack=torch.cat(slacks)))


def _needs_refresh(p, cache, reduce=None) -> bool:
    """The cache-validity test, read on the host (one device sync); with
    reduce, "any" over every rank's queries (the ranks' counts summed)."""
    moved = torch.sqrt(((p - cache.p0) ** 2).sum(-1))
    need = (2.0 * moved >= cache.slack).any()
    if reduce is not None:
        need = reduce(need.to(p.dtype).reshape(1))[0] > 0
    return bool(need)


def closest_point_cached_group(p, tri_blk, cent_blk, rad_blk, gcenter,
                               gradius, cache: CPCacheGroup,
                               sub_size: int = 16, query_tile: int = 8192,
                               fast_tile: int = 65536, reduce=None):
    """Exact closest point via the subgroup cache; self-refreshing.
    Returns (points (Q, 3), cache, refreshed). The fast path sweeps each
    query's NG subgroups of ``sub_size`` contiguous triangles with kernel B1
    (indexed entry), in tiles of ``fast_tile`` queries, which bound the
    candidate buffer of the twin on CPU tensors."""
    ng = int(cache.gidx.shape[1])
    tri_blk = tri_blk.to(p.dtype)
    if _needs_refresh(p, cache, reduce):
        q, cache = _cp_refresh_group(
            p, tri_blk, cent_blk.to(p.dtype), rad_blk.to(p.dtype),
            gcenter.to(p.dtype), gradius.to(p.dtype), ng, sub_size,
            query_tile)
        return q, cache, True
    tri_flat = tri_blk.reshape(-1, 3, 3)
    out = torch.empty_like(p)
    for q0 in range(0, p.shape[0], fast_tile):
        sl = slice(q0, q0 + fast_tile)
        out[sl], _ = ck.ericson_candidates_idx(p[sl], tri_flat,
                                               cache.gidx[sl], sub=sub_size)
    return out, cache, False


def closest_point_cached(p, tri_verts, cache: CPCache,
                         query_tile: int = 4096, reduce=None):
    """Exact closest point using the flat candidate cache; self-refreshing.
    Returns (points (Q, 3), cache, refreshed). With ``cache.candT`` the fast
    path is kernel B1 alone on the cached coordinates."""
    k = int(cache.idx.shape[1])
    tri_verts = tri_verts.to(p.dtype)
    with_candT = cache.candT is not None
    if _needs_refresh(p, cache, reduce):
        q, cache = _cp_refresh(p, tri_verts, k, query_tile,
                               with_candT=with_candT)
        return q, cache, True
    if with_candT:
        qv, _ = ck.ericson_candidates_T(p.T.contiguous(), cache.candT)
        return qv.T, cache, False
    out = torch.empty_like(p)
    for q0 in range(0, p.shape[0], query_tile):
        sl = slice(q0, q0 + query_tile)
        out[sl], _ = ck.ericson_candidates_idx(p[sl], tri_verts,
                                               cache.idx[sl])
    return out, cache, False


def _closest_point_candidates_all(p, cand):
    """Per-candidate exact closest points (no reduction).
    p: (Q, 3); cand: (Q, K, 3, 3). Returns (points (Q, K, 3), sqd (Q, K))."""
    return _ericson_regions(p[:, None, :], cand[:, :, 0], cand[:, :, 1],
                            cand[:, :, 2])
