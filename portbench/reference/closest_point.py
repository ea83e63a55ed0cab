"""Exact closest points on a triangle mesh, in plain torch.

Triangles are grouped by recursive median splits, each group bounded by
a sphere. A query's candidates are the triangles of the groups whose
spheres lie nearest; the nearest point among them is exact when its
distance is no more than the next sphere's lower bound, since every other
triangle lies at least that far. Queries for which that fails are swept
over every triangle. The point on one triangle follows Ericson, Real-Time Collision
Detection, 5.1.5, written here with selects in place of early returns.
"""

from __future__ import annotations

import numpy as np
import torch


def _dot(u, v):
    return (u * v).sum(-1)


def point_triangle(p, a, b, c):
    """The closest point to p on triangle (a, b, c); all (..., 3)."""
    ab, ac, ap = b - a, c - a, p - a
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    bp, cp = p - b, p - c
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    d5, d6 = _dot(ab, cp), _dot(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    def div(n, d):
        return n / torch.where(d == 0, torch.ones_like(d), d)

    # the face's interior
    den = va + vb + vc
    v = div(vb, den)
    w = div(vc, den)
    out = a + ab * v[..., None] + ac * w[..., None]
    regions = [
        # edge bc
        ((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0),
         b + (c - b) * div(d4 - d3, (d4 - d3) + (d5 - d6))[..., None]),
        # edge ac
        ((vb <= 0) & (d2 >= 0) & (d6 <= 0), a + ac * div(d2, d2 - d6)[..., None]),
        # vertex c, edge ab, vertex b, vertex a
        ((d6 >= 0) & (d5 <= d6), c),
        ((vc <= 0) & (d1 >= 0) & (d3 <= 0), a + ab * div(d1, d1 - d3)[..., None]),
        ((d3 >= 0) & (d4 <= d3), b),
        ((d1 <= 0) & (d2 <= 0), a),
    ]
    # RTCD tests these in the reverse order and returns on the first that
    # holds: here the later select wins
    for cond, q in regions:
        out = torch.where(cond[..., None], q, out)
    return out


def triangle_groups(tris, size=64):
    """Groups of at most `size` triangles by recursive median splits of
    their centroids along the widest axis, each with a bounding sphere:
    (members (G, size) int64, padded with a member's own index; centres
    (G, 3); radii (G,))."""
    t = tris.detach().cpu().double().numpy()
    cent = t.mean(1)
    groups, stack = [], [np.arange(len(t))]
    while stack:
        idx = stack.pop()
        if len(idx) <= size:
            groups.append(idx)
            continue
        c = cent[idx]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        o = idx[np.argsort(c[:, axis], kind="stable")]
        stack += [o[:len(o) // 2], o[len(o) // 2:]]
    members = np.stack([np.resize(g, size) for g in groups])
    pts = t[members].reshape(len(groups), -1, 3)
    centre = 0.5 * (pts.min(1) + pts.max(1))
    radius = np.linalg.norm(pts - centre[:, None], axis=-1).max(1)
    kw = dict(device=tris.device)
    return (torch.as_tensor(members, **kw),
            torch.as_tensor(centre, dtype=tris.dtype, **kw),
            torch.as_tensor(radius * (1 + 1e-12), dtype=tris.dtype, **kw))


def closest_points(p, tris, groups=None, k=8, block=8192):
    """Closest points (Q, 3) on the triangles tris (T, 3, 3) to p (Q, 3),
    in p's dtype. A query's candidates are the triangles of the k groups
    (``triangle_groups``) whose spheres lie nearest; the nearest point
    among them is exact when its distance is no more than the (k+1)-th
    sphere's lower bound, since every other triangle lies at least that
    far. The other queries are swept over every triangle."""
    members, centre, radius = groups or triangle_groups(tris)
    G = members.shape[0]
    k = min(k, G)
    out = torch.empty_like(p)
    for s in range(0, p.shape[0], block):
        q = p[s:s + block]
        d2 = sum((q[:, None, i] - centre[None, :, i]) ** 2 for i in range(3))
        lb = torch.clamp_min(d2.sqrt() - radius[None], 0.0)
        lbk, gi = torch.topk(lb, min(k + 1, G), dim=1, largest=False)
        cand = members[gi[:, :k]].reshape(q.shape[0], -1)    # (b, k * size)
        t = tris[cand]
        pts = point_triangle(q[:, None], t[:, :, 0], t[:, :, 1], t[:, :, 2])
        dist = (pts - q[:, None]).norm(dim=-1)
        best = dist.argmin(1)
        rows = torch.arange(q.shape[0], device=p.device)
        res = pts[rows, best]
        if k < G:
            miss = dist[rows, best] > lbk[:, k]
            if bool(miss.any()):
                res[miss] = _sweep(q[miss], tris)
        out[s:s + block] = res
    return out


def _sweep(q, tris, chunk=4096):
    """Closest points of q over every triangle (the exactness fallback)."""
    best_d = torch.full((q.shape[0],), float("inf"), dtype=q.dtype,
                        device=q.device)
    best_p = q.clone()
    for s in range(0, tris.shape[0], chunk):
        t = tris[s:s + chunk]
        pts = point_triangle(q[:, None], t[None, :, 0], t[None, :, 1],
                             t[None, :, 2])
        dist = (pts - q[:, None]).norm(dim=-1)
        d, j = dist.min(1)
        better = d < best_d
        best_d = torch.where(better, d, best_d)
        best_p = torch.where(better[:, None],
                             pts[torch.arange(q.shape[0], device=q.device), j],
                             best_p)
    return best_p
