"""Closest-point accuracy at float32 (the port's counterpart of
tests_tpu/test_closest_point_tpu.py): queries through the 2-stage sweep and
the subgroup cache, both of which run kernel B1's indexed entry
(``cuda_kernels.ericson_candidates_idx``) on a CUDA card (``cuda`` marker;
skips without one) and its plain twin on the CPU, held against brute force
(``closest_point_on_mesh``, plain torch on the same device).

Surfaces: the real MaleTorso target (40,756 triangles, the wire mesh's
soft-constraint surface) when the reference data is mounted, as in the JAX
test; and the bumpy sphere of tests/test_geometry.py (3,480 uniform
triangles), which is always there.

Two regimes, asserted separately with the JAX test's bounds:
* NEAR-surface queries (surface points + noise of ~2 edge lengths), the
  solver's regime: must match brute force to f32 roundoff (rtol 2e-5, atol
  1e-4), through the 2-stage sweep, a cache refresh and the cache after a
  small motion.
* FAR-field queries (random points in the bounding box): held to the JAX
  test's recall bound, at most 2% of queries off and at most 6% relative.
  The JAX bound was set for ``approx_min_k``'s recall misses on the TPU;
  the port's prefilter is an exact ``torch.topk``, so the count printed
  here should be 0.

The cpu case also holds the JAX package's 2-stage query (its plain path on
the CPU) on the same queries to the near-surface bound. A third test holds
the group refresh to brute force at f64 on a height field, where the JAX
package's Morton grouping misses (see build_tri_groups)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_admm_tpu.ops import closest_point as jcp
from aa_admm_tpu_torch.ops import closest_point as tcp
from aa_admm_tpu_torch.ops import cuda_kernels as ck
# the JAX package's f32 tests' reference mount and skip gate (the same path
# and reason as tests_tpu/)
from test_f32_scenes import GEO, needs_geo

N_QUERIES = 2000
NEAR = dict(rtol=2e-5, atol=1e-4)


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return request.param


def _bumpy_sphere(n_u=60, n_v=30):
    """tests/test_geometry.py's structured bumpy sphere: (T, 3, 3) f64."""
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
    return verts, np.asarray(faces)


def _male_torso():
    from aa_admm_tpu_torch.core.meshio import load_obj
    ref = load_obj(GEO + "/WireMeshData/MaleTorso_target.obj")
    return ref.verts, np.asarray(ref.faces)


SURFACES = [pytest.param(_bumpy_sphere, id="sphere"),
            pytest.param(_male_torso, id="male_torso", marks=needs_geo)]


def _dist(q, pts):
    return np.linalg.norm(np.asarray(q) - np.asarray(pts), axis=1)


def _np(t):
    return t.cpu().numpy()


def _jax_2stage(q, tv):
    return np.asarray(jcp.closest_point_on_mesh_2stage(
        jnp.asarray(q), jnp.asarray(tv), k=48))


@pytest.mark.parametrize("surface", SURFACES)
def test_near_surface_exact_vs_bruteforce_f32(surface, device):
    verts, faces = surface()
    tv = verts[faces].astype(np.float32)
    rng = np.random.default_rng(11)
    edge = float(np.linalg.norm(tv[:, 0] - tv[:, 1], axis=1).mean())
    base = tv[rng.integers(0, len(tv), N_QUERIES)].mean(axis=1)
    q = (base + 2.0 * edge * rng.standard_normal((N_QUERIES, 3))) \
        .astype(np.float32)
    tri = torch.from_numpy(tv).to(device)
    qt = torch.from_numpy(q).to(device)
    ck.reset_launch_counts()

    d_brute = _dist(q, _np(tcp.closest_point_on_mesh(qt, tri)))
    d_2s = _dist(q, _np(tcp.closest_point_on_mesh_2stage(qt, tri, k=48)))
    np.testing.assert_allclose(d_2s, d_brute, **NEAR)
    if device == "cpu":
        np.testing.assert_allclose(_dist(q, _jax_2stage(q, tv)), d_2s,
                                   **NEAR)

    # group cache: refresh, then the cache after a small motion
    S = 64
    tp, cent, rad, gc, gr = tcp.build_tri_groups(tv, group_size=S)
    G = len(gc)
    args = [torch.from_numpy(a).to(device, torch.float32)
            for a in (tp.reshape(G, S, 3, 3), cent.reshape(G, S, 3),
                      rad.reshape(G, S), gc, gr)]
    cache = tcp.cp_cache_group_init(N_QUERIES, 6, torch.float32, device)
    out, cache, refreshed = tcp.closest_point_cached_group(qt, *args, cache)
    assert refreshed
    np.testing.assert_allclose(_dist(q, _np(out)), d_brute, **NEAR)

    sl = _np(cache.slack)
    assert np.median(sl) > 0
    step = min(0.1 * float(np.median(sl)), 0.2 * edge)
    q2 = q + np.asarray([step, 0.0, 0.0], np.float32)
    q2t = torch.from_numpy(q2).to(device)
    out2, _, _ = tcp.closest_point_cached_group(q2t, *args, cache)
    d2_brute = _dist(q2, _np(tcp.closest_point_on_mesh(q2t, tri)))
    np.testing.assert_allclose(_dist(q2, _np(out2)), d2_brute, **NEAR)

    # the cache's fast path (B1 over each query's cached subgroups): any
    # query whose slack is not positive refreshes the whole batch, so it is
    # taken by the queries with a positive slack, moved by 0.4 of the least
    q3 = q[sl > 0]
    q3t = torch.from_numpy(q3).to(device)
    cache = tcp.cp_cache_group_init(len(q3), 6, torch.float32, device)
    _, cache, _ = tcp.closest_point_cached_group(q3t, *args, cache)
    q3 = q3 + np.asarray([0.4 * float(cache.slack.min()), 0.0, 0.0],
                         np.float32)
    q3t = torch.from_numpy(q3).to(device)
    out3, _, refreshed = tcp.closest_point_cached_group(q3t, *args, cache)
    assert not refreshed
    d3_brute = _dist(q3, _np(tcp.closest_point_on_mesh(q3t, tri)))
    np.testing.assert_allclose(_dist(q3, _np(out3)), d3_brute, **NEAR)
    if device == "cuda":
        assert ck.launch_counts()["ericson_idx"] > 0


@pytest.mark.parametrize("surface", SURFACES)
def test_far_field_recall_characterization_f32(surface, device):
    verts, faces = surface()
    tv = verts[faces].astype(np.float32)
    rng = np.random.default_rng(11)
    lo, hi = verts.min(0), verts.max(0)
    q = (lo + (hi - lo) * rng.random((N_QUERIES, 3))).astype(np.float32)
    tri = torch.from_numpy(tv).to(device)
    qt = torch.from_numpy(q).to(device)
    ck.reset_launch_counts()
    d_brute = _dist(q, _np(tcp.closest_point_on_mesh(qt, tri)))
    d_2s = _dist(q, _np(tcp.closest_point_on_mesh_2stage(qt, tri, k=48)))
    rel = np.abs(d_2s - d_brute) / np.maximum(d_brute, 1e-6)
    n_off = int((rel > 1e-4).sum())
    print(f"far field on {len(tv)} triangles ({device}): {n_off} of "
          f"{N_QUERIES} queries off, worst relative error {rel.max():.3e}")
    assert n_off / N_QUERIES <= 0.02, f"recall regression: {n_off} off"
    assert float(rel.max()) <= 0.06, f"worst far-field error {rel.max():.3%}"
    if device == "cuda":
        assert ck.launch_counts()["ericson_idx"] > 0


def _height_field(n=100, extent=100.0, amp=1.5):
    """z = amp sin(2 pi x / 20) cos(2 pi y / 15) over [0, extent]^2 on an
    n x n vertex grid: (2 (n - 1)^2, 3, 3) triangles, flat like the wire
    mesh's reference in chip_smoke.py."""
    u = np.linspace(0.0, extent, n)
    X, Y = np.meshgrid(u, u, indexing="ij")
    Z = amp * np.sin(2 * np.pi * X / 20.0) * np.cos(2 * np.pi * Y / 15.0)
    verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], 1)
    i, j = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    a = (i * n + j).ravel()
    b = a + n
    faces = np.concatenate([np.stack([a, b, a + 1], 1),
                            np.stack([b, b + 1, a + 1], 1)])
    return verts[faces]


def test_group_refresh_exact_on_a_height_field(device):
    """The fault the near-surface check found on the main path's reference
    surface: with the JAX layout's Morton order (each axis scaled to its
    own extent) the groups of a flat surface spread across it, more than
    the 32 kept groups tie at a lower bound of 0, and the refresh returns
    a farther point. The port's groups (one scale for the three axes) give
    the exact points; the JAX layout, through the same query, does not.
    Float64, so any miss is not roundoff (the tolerance of
    tests/test_torch_closest_point.py)."""
    tv = _height_field()
    rng = np.random.default_rng(11)
    base = tv[rng.integers(0, len(tv), 500)].mean(1)
    q = base + 0.05 * rng.standard_normal((500, 3))
    qt = torch.from_numpy(q).to(device)
    d_brute = _dist(q, _np(tcp.closest_point_on_mesh(
        qt, torch.from_numpy(tv).to(device))))
    S = 64
    misses = {}
    for name, build in (("port", tcp.build_tri_groups),
                        ("jax", jcp.build_tri_groups)):
        tp, cent, rad, gc, gr = build(tv, group_size=S)
        G = len(gc)
        args = [torch.from_numpy(a).to(device)
                for a in (tp.reshape(G, S, 3, 3), cent.reshape(G, S, 3),
                          rad.reshape(G, S), gc, gr)]
        cache = tcp.cp_cache_group_init(len(q), 6, torch.float64, device)
        out, cache, _ = tcp.closest_point_cached_group(qt, *args, cache)
        d = _dist(q, _np(out))
        misses[name] = int((~np.isclose(d, d_brute, rtol=1e-9,
                                        atol=1e-11)).sum())
        if name == "port":
            np.testing.assert_allclose(d, d_brute, rtol=1e-9, atol=1e-11)
            assert _np(cache.slack).min() > 0
    print(f"group refresh misses of {len(q)} ({device}): {misses}")
    assert misses["jax"] > 0
