"""Closest-point tiers of the PyTorch port (aa_admm_tpu_torch.ops.
closest_point) against the JAX package at f64 on the CPU: brute force, the
2-stage query, the flat candidate cache (with and without the kernel-layout
candidate coordinates) and the subgroup cache, including a forced refresh
and a small move that takes the fast path.

Tolerance: 1e-9 relative / 1e-11 absolute on distances, as in
tests/test_geometry.py's closest-point tests (both sides are exact closest
points computed in f64; only rounding differs). Points are compared through
distances and within 1e-8, not through cache indices: the two packages may
order tied candidates differently."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_admm_tpu.ops import closest_point as jcp
from aa_admm_tpu_torch.ops import closest_point as tcp


def _bumpy_sphere(n_u, n_v):
    us = np.linspace(0, 2 * np.pi, n_u, endpoint=False)
    vs = np.linspace(0.05, np.pi - 0.05, n_v)
    U, V = np.meshgrid(us, vs, indexing="ij")
    r = 1.0 + 0.1 * np.sin(3 * U) * np.cos(2 * V)
    verts = np.stack([r * np.sin(V) * np.cos(U), r * np.sin(V) * np.sin(U),
                      r * np.cos(V)], axis=-1).reshape(-1, 3)
    faces = []
    for i in range(n_u):
        for j in range(n_v - 1):
            a = i * n_v + j
            b = ((i + 1) % n_u) * n_v + j
            faces.append([a, b, a + 1])
            faces.append([b, b + 1, a + 1])
    return verts[np.asarray(faces)]


@pytest.fixture(scope="module")
def sphere_6k():
    return _bumpy_sphere(80, 40)          # 6,240 triangles: flat cache


@pytest.fixture(scope="module")
def sphere_22k():
    return _bumpy_sphere(150, 75)         # 22,200 triangles: group cache


def _near_surface(tri, n, seed, scale=1.04):
    """Queries just off the surface: radial offsets of triangle centroids."""
    rng = np.random.default_rng(seed)
    c = tri[rng.choice(len(tri), n, replace=False)].mean(1)
    return c * scale


def _dist(q, p):
    return np.linalg.norm(np.asarray(p) - np.asarray(q), axis=1)


def _assert_same_points(p, q_torch, q_jax):
    np.testing.assert_allclose(_dist(q_torch, p), _dist(q_jax, p),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(np.asarray(q_torch), np.asarray(q_jax),
                               atol=1e-8)


def test_brute_force_matches_jax():
    tri = _bumpy_sphere(60, 30)
    p = np.random.default_rng(7).normal(size=(400, 3)) * 1.3
    q_j = jcp.closest_point_on_mesh(jnp.asarray(p), jnp.asarray(tri),
                                    tile=512, query_tile=128)
    q_t = tcp.closest_point_on_mesh(torch.from_numpy(p), torch.from_numpy(tri),
                                    tile=512, query_tile=128)
    _assert_same_points(p, q_t, q_j)


def test_2stage_matches_jax_and_brute_force(sphere_6k):
    tri = sphere_6k
    p = np.random.default_rng(3).normal(size=(300, 3)) * 1.3
    q_j = jcp.closest_point_on_mesh_2stage(jnp.asarray(p), jnp.asarray(tri))
    q_t = tcp.closest_point_on_mesh_2stage(torch.from_numpy(p),
                                           torch.from_numpy(tri))
    _assert_same_points(p, q_t, q_j)
    q_b = tcp.closest_point_on_mesh(torch.from_numpy(p), torch.from_numpy(tri))
    np.testing.assert_allclose(_dist(q_t, p), _dist(q_b, p), rtol=1e-9,
                               atol=1e-11)


@pytest.mark.parametrize("with_candT", [False, True])
def test_flat_cache_matches_jax(sphere_6k, with_candT):
    tri = sphere_6k
    Q = 500
    p = _near_surface(tri, Q, 5)
    tri_j, tri_t = jnp.asarray(tri), torch.from_numpy(tri)
    cj = jcp.cp_cache_init(Q, 48, np.float64)
    ct = tcp.cp_cache_init(Q, 48, torch.float64, "cpu", with_candT=with_candT)
    # first call: slack -inf forces a refresh in both
    q_j, cj = jcp.closest_point_cached(jnp.asarray(p), tri_j, cj)
    q_t, ct, refreshed = tcp.closest_point_cached(torch.from_numpy(p), tri_t,
                                                  ct)
    assert refreshed
    assert (ct.candT is not None) == with_candT
    _assert_same_points(p, q_t, q_j)
    np.testing.assert_allclose(ct.slack.numpy(), np.asarray(cj.slack),
                               rtol=1e-9, atol=1e-11)
    slack = ct.slack.numpy()
    assert slack.min() > 0
    # small move: the fast path in both (p0 stays), still the same points
    p2 = p + 0.2 * slack.min() * np.asarray([0.6, 0.0, 0.8])
    q_j2, cj2 = jcp.closest_point_cached(jnp.asarray(p2), tri_j, cj)
    q_t2, ct2, refreshed = tcp.closest_point_cached(torch.from_numpy(p2),
                                                    tri_t, ct)
    assert not refreshed
    np.testing.assert_array_equal(np.asarray(cj2.p0), p)
    np.testing.assert_array_equal(ct2.p0.numpy(), p)
    _assert_same_points(p2, q_t2, q_j2)
    # large move: refresh again, exact against brute force
    p3 = p * 1.5
    q_t3, ct3, refreshed = tcp.closest_point_cached(torch.from_numpy(p3),
                                                    tri_t, ct2)
    assert refreshed
    q_b = tcp.closest_point_on_mesh(torch.from_numpy(p3), tri_t)
    np.testing.assert_allclose(_dist(q_t3, p3), _dist(q_b, p3), rtol=1e-9,
                               atol=1e-11)


def test_group_cache_matches_jax(sphere_22k):
    tri = sphere_22k
    S = 64
    tp, cent, rad, gc, gr = jcp.build_tri_groups(tri, group_size=S)
    tp_t, cent_t, rad_t, gc_t, gr_t = tcp.build_tri_groups(tri, group_size=S)
    # the JAX layout in another Morton order (the port quantizes the three
    # axes on one scale): the same rows and padding, and group bounds that
    # hold every member. The queries below run both packages on the JAX
    # layout.
    T, G = len(tri), len(gc)
    for a, b in [(tp, tp_t), (cent, cent_t), (rad, rad_t), (gc, gc_t),
                 (gr, gr_t)]:
        assert a.shape == b.shape
    rows_j = np.concatenate([tp.reshape(-1, 9), cent, rad[:, None]], 1)
    rows_t = np.concatenate([tp_t.reshape(-1, 9), cent_t, rad_t[:, None]], 1)
    np.testing.assert_array_equal(rows_t[T:], rows_j[T:])
    np.testing.assert_array_equal(rows_t[:T][np.lexsort(rows_t[:T].T)],
                                  rows_j[:T][np.lexsort(rows_j[:T].T)])
    valid = (np.arange(G * S) < T).reshape(G, S)
    cg = cent_t.reshape(G, S, 3)
    np.testing.assert_allclose(
        gc_t, (cg * valid[..., None]).sum(1) / valid.sum(1)[:, None],
        rtol=1e-12, atol=1e-12)
    reach = np.linalg.norm(cg - gc_t[:, None], axis=-1) + rad_t.reshape(G, S)
    np.testing.assert_allclose(gr_t, np.where(valid, reach, 0.0).max(1),
                               rtol=1e-12, atol=1e-12)
    jargs = (jnp.asarray(tp.reshape(G, S, 3, 3)), jnp.asarray(cent.reshape(G, S, 3)),
             jnp.asarray(rad.reshape(G, S)), jnp.asarray(gc), jnp.asarray(gr))
    targs = (torch.from_numpy(tp.reshape(G, S, 3, 3)),
             torch.from_numpy(cent.reshape(G, S, 3)),
             torch.from_numpy(rad.reshape(G, S)), torch.from_numpy(gc),
             torch.from_numpy(gr))
    Q = 400
    p = _near_surface(tri, Q, 9, scale=1.0)
    cj = jcp.cp_cache_group_init(Q, 6, np.float64)
    ct = tcp.cp_cache_group_init(Q, 6, torch.float64, "cpu")
    q_j, cj = jcp.closest_point_cached_group(jnp.asarray(p), *jargs, cj)
    q_t, ct, refreshed = tcp.closest_point_cached_group(torch.from_numpy(p),
                                                        *targs, ct)
    assert refreshed
    _assert_same_points(p, q_t, q_j)
    np.testing.assert_allclose(ct.slack.numpy(), np.asarray(cj.slack),
                               rtol=1e-9, atol=1e-11)
    q_b = tcp.closest_point_on_mesh(torch.from_numpy(p), torch.from_numpy(tri))
    np.testing.assert_allclose(_dist(q_t, p), _dist(q_b, p), rtol=1e-9,
                               atol=1e-11)
    slack = ct.slack.numpy()
    assert slack.min() > 0
    p2 = p + 0.2 * slack.min() * np.asarray([0.0, 0.6, 0.8])
    q_j2, cj2 = jcp.closest_point_cached_group(jnp.asarray(p2), *jargs, cj)
    q_t2, ct2, refreshed = tcp.closest_point_cached_group(
        torch.from_numpy(p2), *targs, ct)
    assert not refreshed
    np.testing.assert_array_equal(np.asarray(cj2.p0), p)
    _assert_same_points(p2, q_t2, q_j2)


def test_sweeps_gather_their_own_candidates(sphere_6k, sphere_22k,
                                            monkeypatch):
    """Every exact sweep outside the candT cache goes through B1's indexed
    entry (no (Q, K, 3, 3) candidate buffer is built by the callers): the
    2-stage query and the flat cache's fast path with sub = 1, the subgroup
    refresh with sub = 1 and its fast path with sub = 16 — and the answers
    stay exact against brute force."""
    from aa_admm_tpu_torch.ops import cuda_kernels as ck
    subs = []
    real = ck.ericson_candidates_idx

    def counted(p, tris, idx, sub=1):
        subs.append(sub)
        return real(p, tris, idx, sub=sub)

    def forbidden(*args, **kwargs):
        raise AssertionError("materialised candidates on a cached path")

    monkeypatch.setattr(ck, "ericson_candidates_idx", counted)
    monkeypatch.setattr(ck, "ericson_candidates", forbidden)
    tri = torch.from_numpy(sphere_6k)
    p = torch.from_numpy(_near_surface(sphere_6k, 300, 21))
    q = tcp.closest_point_on_mesh_2stage(p, tri)
    assert subs == [1]
    cache = tcp.cp_cache_init(300, 48, torch.float64, "cpu")
    _, cache, refreshed = tcp.closest_point_cached(p, tri, cache)
    q2, _, refreshed2 = tcp.closest_point_cached(p, tri, cache)
    assert refreshed and not refreshed2 and subs == [1, 1]
    q_b = tcp.closest_point_on_mesh(p, tri)
    for got in (q, q2):
        np.testing.assert_allclose(_dist(got, p), _dist(q_b, p), rtol=1e-9,
                                   atol=1e-11)

    S = 64
    tp, cent, rad, gc, gr = tcp.build_tri_groups(sphere_22k, group_size=S)
    G = len(gc)
    targs = (torch.from_numpy(tp.reshape(G, S, 3, 3)),
             torch.from_numpy(cent.reshape(G, S, 3)),
             torch.from_numpy(rad.reshape(G, S)), torch.from_numpy(gc),
             torch.from_numpy(gr))
    p = torch.from_numpy(_near_surface(sphere_22k, 300, 23, scale=1.0))
    cache = tcp.cp_cache_group_init(300, 6, torch.float64, "cpu")
    subs.clear()
    q, cache, refreshed = tcp.closest_point_cached_group(p, *targs, cache,
                                                         fast_tile=128)
    q2, _, refreshed2 = tcp.closest_point_cached_group(p, *targs, cache,
                                                       fast_tile=128)
    assert refreshed and not refreshed2
    assert subs == [1, 16, 16, 16]          # one refresh tile, 3 fast tiles
    q_b = tcp.closest_point_on_mesh(p, torch.from_numpy(sphere_22k))
    for got in (q, q2):
        np.testing.assert_allclose(_dist(got, p), _dist(q_b, p), rtol=1e-9,
                                   atol=1e-11)
