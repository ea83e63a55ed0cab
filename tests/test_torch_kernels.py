"""Kernels B1-B3 of the PyTorch port (aa_admm_tpu_torch.ops.cuda_kernels):
their plain twins, run here on CPU tensors, against the JAX package's Pallas
kernels in interpret mode and against its jnp closest-point path, at the
shapes and tolerances of tests/test_pallas_kernels.py. B1's indexed entry
(candidates named by index into a triangle table) is held against the JAX
sweep over the same candidates gathered. The kernels themselves run only
on a CUDA card (``cuda`` marker)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_admm_tpu.ops import pallas_kernels as pk
from aa_admm_tpu.ops.closest_point import (
    _closest_point_candidates as jax_candidates)
from aa_admm_tpu.ops.closest_point import (
    _closest_point_candidates_all as jax_candidates_all)
from aa_admm_tpu_torch.ops import cuda_kernels as ck

# Tolerances: f64 compares the same arithmetic in another summation order
# (1e-12); f32 uses tests/test_pallas_kernels.py's bounds — 2e-6 on squared
# distances and 1e-5 on points (rounding of the Ericson chain), 1e-3 on the
# CG updates (column dots summed in another order, amplified through
# cancelling entries).
ERICSON_TOL = {np.float64: (1e-12, 1e-12), np.float32: (2e-6, 1e-5)}
CG_TOL = {np.float64: 1e-12, np.float32: 1e-3}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("Q,K", [(300, 7), (128, 48), (1000, 16)])
def test_ericson_twin_matches_pallas(Q, K, dtype):
    rng = np.random.default_rng(Q + K)
    p = rng.standard_normal((Q, 3)).astype(dtype)
    cand = rng.standard_normal((Q, K, 3, 3)).astype(dtype)
    q_pal, d_pal = pk.ericson_candidates(jnp.asarray(p), jnp.asarray(cand))
    q_t, d_t = ck.ericson_candidates(torch.from_numpy(p),
                                     torch.from_numpy(cand))
    dtol, qtol = ERICSON_TOL[dtype]
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_pal),
                               rtol=dtol, atol=dtol)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_pal),
                               rtol=qtol, atol=qtol)
    # and against the jnp first-argmin over all candidates
    qa, da = jax_candidates_all(jnp.asarray(p), jnp.asarray(cand))
    i = np.argmin(np.asarray(da), axis=1)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(da)[np.arange(Q), i],
                               rtol=dtol, atol=dtol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ericson_twin_degenerate_triangles(dtype):
    """Zero-area triangles and exact-on-surface queries must not NaN."""
    p = np.asarray([[0.0, 0.0, 0.0], [1.0, 2.0, 3.0]], dtype)
    tri = np.asarray([[[0, 0, 0], [0, 0, 0], [0, 0, 0]],
                      [[1, 2, 3], [1, 2, 3], [4, 5, 6]]], dtype)
    cand = np.stack([tri, tri])
    q_pal, d_pal = pk.ericson_candidates(jnp.asarray(p), jnp.asarray(cand))
    q_t, d_t = ck.ericson_candidates(torch.from_numpy(p),
                                     torch.from_numpy(cand))
    assert np.isfinite(q_t.numpy()).all()
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_pal), atol=1e-6)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_pal), atol=1e-6)


def test_ericson_first_minimum_wins():
    """Two identical candidates: the first one's point is returned (the
    argmin rule the kernel's strict running minimum reproduces)."""
    p = torch.tensor([[0.0, 0.0, 1.0]], dtype=torch.float64)
    tri = torch.tensor([[0, 0, 0], [1, 0, 0], [0, 1, 0]], dtype=torch.float64)
    tri2 = torch.tensor([[0, 0, 0], [-1, 0, 0], [0, -1, 0]],
                        dtype=torch.float64)
    q, d = ck.ericson_candidates(p, torch.stack([tri, tri2])[None])
    assert float(d[0]) == 1.0
    np.testing.assert_array_equal(q.numpy(), [[0.0, 0.0, 0.0]])


def _expand_idx(idx, sub):
    """Table rows of each query's candidates: idx[i, k // sub] * sub + k % sub."""
    return (idx[:, :, None] * sub + np.arange(sub)).reshape(len(idx), -1)


def _idx_case(dtype, Q, G, sub, seed):
    rng = np.random.default_rng(seed)
    n_runs = 4 * G + 5
    tris = rng.standard_normal((n_runs * sub, 3, 3)).astype(dtype)
    p = rng.standard_normal((Q, 3)).astype(dtype)
    idx = rng.integers(0, n_runs, size=(Q, G))
    return p, tris, idx


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("Q,G,sub", [(300, 7, 1), (128, 48, 1), (200, 6, 16)])
def test_ericson_idx_twin_matches_jax(Q, G, sub, dtype):
    """The indexed entry against the JAX sweep over the same candidates,
    gathered: sub = 1 (the refresh and 2-stage sweeps) and sub = 16 (the
    subgroup cache's fast path)."""
    p, tris, idx = _idx_case(dtype, Q, G, sub, Q + G + sub)
    q_j, d_j = jax_candidates(jnp.asarray(p),
                              jnp.asarray(tris[_expand_idx(idx, sub)]))
    q_t, d_t = ck.ericson_candidates_idx(torch.from_numpy(p),
                                         torch.from_numpy(tris),
                                         torch.from_numpy(idx), sub=sub)
    dtol, qtol = ERICSON_TOL[dtype]
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=dtol,
                               atol=dtol)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), rtol=qtol,
                               atol=qtol)


def _tie_case(dtype, sub, seed=3):
    """Queries at the origin whose candidates hold a triangle A, nearest at
    its vertex (0, 0, 1), and its mirror -A, nearest at (0, 0, -1), at
    several positions k: both lie at squared distance exactly 1 (the
    mirror negates every intermediate exactly), so the point tells which
    candidate won. Every other row is a far triangle or a far-away dummy
    row like build_tri_groups' padding (1e15), which must lose without
    overflowing. Returns (p, tris, idx, expected q)."""
    n_runs, G = (64, 48) if sub == 1 else (8, 6)
    rng = np.random.default_rng(seed)
    T = n_runs * sub
    tris = rng.standard_normal((T, 3, 3)) + 50.0
    tris[T - sub // 2 - 1:] = 1e15                 # dummy tail
    tri_a = np.asarray([[0.0, 0, 1], [1, 0, 2], [0, 1, 2]])
    rows_a, rows_b = [1 * sub + sub // 2, 2 * sub], [5 * sub + sub - 1, 3 * sub]
    tris[rows_a] = tri_a
    tris[rows_b] = -tri_a
    idx, want = [], []
    for perm_seed in range(40):
        runs = np.random.default_rng(perm_seed).permutation(n_runs)[:G]
        k = {r: int(np.where(runs == r // sub)[0][0]) * sub + r % sub
             for r in rows_a + rows_b if r // sub in runs}
        if not k.keys() & set(rows_a) or not k.keys() & set(rows_b):
            continue
        idx.append(runs)
        want.append([0.0, 0.0, 1.0 if min(k, key=k.get) in rows_a else -1.0])
    # a duplicated run (sub > 1) or index (sub = 1): A twice, still A
    dup = np.full(G, n_runs - 1)
    dup[[1, G - 2]] = rows_a[0] // sub
    idx.append(dup)
    want.append([0.0, 0.0, 1.0])
    return (np.zeros((len(idx), 3), dtype), tris.astype(dtype),
            np.asarray(idx, np.int64), np.asarray(want, dtype))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("sub", [1, 16])
def test_ericson_idx_first_minimum_dummies(sub, dtype):
    """Exact ties go to the lowest k, duplicated candidates are harmless,
    and 1e15 dummy rows lose with a finite distance — as the JAX sweep
    (first argmin) has it."""
    p, tris, idx, want = _tie_case(dtype, sub)
    q_t, d_t = ck.ericson_candidates_idx(torch.from_numpy(p),
                                         torch.from_numpy(tris),
                                         torch.from_numpy(idx), sub=sub)
    cand = jnp.asarray(tris[_expand_idx(idx, sub)])
    q_j, _ = jax_candidates(jnp.asarray(p), cand)
    _, sqd_all = jax_candidates_all(jnp.asarray(p), cand)
    assert len(want) > 3 and len(set(want[:, 2])) == 2
    np.testing.assert_array_equal(q_t.numpy(), want)
    np.testing.assert_array_equal(np.asarray(q_j), want)
    np.testing.assert_array_equal(d_t.numpy(), np.ones(len(idx)))
    assert np.isfinite(np.asarray(sqd_all)).all()


def _cg_case(dtype, n=1024, c=3, seed=7):
    rng = np.random.default_rng(seed)
    v = {k: rng.standard_normal((n, c)).astype(dtype)
         for k in ("x", "r", "p", "ap", "z")}
    rz = (rng.random(c) + 0.5).astype(dtype)
    return v, rz


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cg_update_twins_match_pallas(dtype):
    """B2/B3 twins against the Pallas kernels (interpret mode, band
    layout), active columns."""
    v, rz = _cg_case(dtype)
    n = v["x"].shape[0]
    xb, rb, rr = pk.cg_update1(jnp.asarray(rz), pk.to_band(jnp.asarray(v["p"])),
                               pk.to_band(jnp.asarray(v["ap"])),
                               pk.to_band(jnp.asarray(v["x"])),
                               pk.to_band(jnp.asarray(v["r"])))
    pb, rz_new = pk.cg_update2(jnp.asarray(rz), rb,
                               pk.to_band(jnp.asarray(v["z"])),
                               pk.to_band(jnp.asarray(v["p"])))
    t = {k: torch.from_numpy(a.copy()) for k, a in v.items()}
    ones = torch.ones(3, dtype=t["x"].dtype)
    zeros = torch.zeros(3, dtype=t["x"].dtype)
    rr_t = ck.cg_update1(torch.from_numpy(rz), t["p"], t["ap"], t["x"],
                         t["r"], ones, zeros)
    rz_t = ck.cg_update2(torch.from_numpy(rz), t["r"], t["z"], t["p"],
                         ones, zeros)
    tol = CG_TOL[dtype]
    np.testing.assert_allclose(t["x"].numpy(), np.asarray(pk.from_band(xb, n)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(t["r"].numpy(), np.asarray(pk.from_band(rb, n)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(rr_t.numpy(), np.asarray(rr),
                               rtol=max(tol, 1e-10))
    np.testing.assert_allclose(rz_t.numpy(), np.asarray(rz_new),
                               rtol=max(tol, 1e-10))
    np.testing.assert_allclose(t["p"].numpy(), np.asarray(pk.from_band(pb, n)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cg_update_twins_frozen_and_zero_divisor(dtype):
    """Column 1 frozen (rr_prev <= thresh: alpha = beta = 0, x and r
    untouched); column 2 with pAp = 0 and column 0 with rz_old = 0 (both
    divide by 1) — against the Pallas kernels given the same rr_prev and
    thresh."""
    v, rz = _cg_case(dtype, seed=11)
    n = v["x"].shape[0]
    v["p"][:, 2] = 0.0
    rz_old = rz.copy()
    rz_old[0] = 0.0
    rr_prev = np.asarray([1.0, 1e-30, 1.0], dtype)
    thresh = np.full(3, 1e-20, dtype)
    xb, rb, rr = pk.cg_update1(jnp.asarray(rz), pk.to_band(jnp.asarray(v["p"])),
                               pk.to_band(jnp.asarray(v["ap"])),
                               pk.to_band(jnp.asarray(v["x"])),
                               pk.to_band(jnp.asarray(v["r"])),
                               rr_prev=jnp.asarray(rr_prev),
                               thresh=jnp.asarray(thresh))
    pb, rz_new = pk.cg_update2(jnp.asarray(rz_old), rb,
                               pk.to_band(jnp.asarray(v["z"])),
                               pk.to_band(jnp.asarray(v["p"])),
                               rr_prev=jnp.asarray(rr_prev),
                               thresh=jnp.asarray(thresh))
    t = {k: torch.from_numpy(a.copy()) for k, a in v.items()}
    rr_t = ck.cg_update1(torch.from_numpy(rz), t["p"], t["ap"], t["x"],
                         t["r"], torch.from_numpy(rr_prev),
                         torch.from_numpy(thresh))
    rz_t = ck.cg_update2(torch.from_numpy(rz_old), t["r"], t["z"], t["p"],
                         torch.from_numpy(rr_prev), torch.from_numpy(thresh))
    tol = CG_TOL[dtype]
    np.testing.assert_array_equal(t["x"][:, 1].numpy(), v["x"][:, 1])
    np.testing.assert_array_equal(t["r"][:, 1].numpy(), v["r"][:, 1])
    np.testing.assert_array_equal(t["p"][:, 1].numpy(), v["z"][:, 1])
    for got, want in [(t["x"], pk.from_band(xb, n)), (t["r"], pk.from_band(rb, n)),
                      (t["p"], pk.from_band(pb, n))]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=tol, atol=tol)
    np.testing.assert_allclose(rr_t.numpy(), np.asarray(rr), rtol=max(tol, 1e-10))
    np.testing.assert_allclose(rz_t.numpy(), np.asarray(rz_new),
                               rtol=max(tol, 1e-10))


def _cg_cols_case(dtype, c, n=1000, seed=13):
    """c columns: column 1 frozen (c >= 2), column 2 with pAp = 0 (c >= 3)."""
    v, rz = _cg_case(dtype, n=n, c=c, seed=seed)
    rr_prev = np.asarray([1.0, 1e-30, 1.0, 1.0][:c], dtype)
    thresh = np.full(c, 1e-20, dtype)
    if c >= 3:
        v["p"][:, 2] = 0.0
    return v, rz, rr_prev, thresh


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_cg_update1_twin_matches_pallas_columns(c, dtype):
    """B2's twin at c = 1..4 columns against the Pallas kernel (interpret
    mode, band layout)."""
    v, rz, rr_prev, thresh = _cg_cols_case(dtype, c)
    n = v["x"].shape[0]
    xb, rb, rr = pk.cg_update1(jnp.asarray(rz), pk.to_band(jnp.asarray(v["p"])),
                               pk.to_band(jnp.asarray(v["ap"])),
                               pk.to_band(jnp.asarray(v["x"])),
                               pk.to_band(jnp.asarray(v["r"])),
                               rr_prev=jnp.asarray(rr_prev),
                               thresh=jnp.asarray(thresh))
    t = {k: torch.from_numpy(a.copy()) for k, a in v.items()}
    rr_t = ck.cg_update1(torch.from_numpy(rz), t["p"], t["ap"], t["x"],
                         t["r"], torch.from_numpy(rr_prev),
                         torch.from_numpy(thresh))
    tol = CG_TOL[dtype]
    np.testing.assert_allclose(t["x"].numpy(),
                               np.asarray(pk.from_band(xb, n, c)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(t["r"].numpy(),
                               np.asarray(pk.from_band(rb, n, c)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(rr_t.numpy(), np.asarray(rr),
                               rtol=max(tol, 1e-10))
    if c >= 2:
        np.testing.assert_array_equal(t["x"][:, 1].numpy(), v["x"][:, 1])


def _pallas_cg_update2(v, rz_old, rr_prev, thresh):
    """The Pallas cg_update2 (interpret mode, band layout) on numpy inputs:
    (p, rz)."""
    n, c = v["p"].shape
    pb, rz = pk.cg_update2(jnp.asarray(rz_old), pk.to_band(jnp.asarray(v["r"])),
                           pk.to_band(jnp.asarray(v["z"])),
                           pk.to_band(jnp.asarray(v["p"])),
                           rr_prev=jnp.asarray(rr_prev),
                           thresh=jnp.asarray(thresh))
    return np.asarray(pk.from_band(pb, n, c)), np.asarray(rz)


def _rz_old(rz, c):
    """rz_old for B3's cases: rz, with a zero divisor in column 0 when c >= 2
    (column 1 is the frozen one)."""
    rz_old = rz.copy()
    if c >= 2:
        rz_old[0] = 0.0
    return rz_old


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_cg_update2_twin_matches_pallas_columns(c, dtype):
    """B3's twin at c = 1..4 columns against the Pallas kernel (interpret
    mode, band layout): a frozen column and a zero divisor rz_old."""
    v, rz, rr_prev, thresh = _cg_cols_case(dtype, c)
    rz_old = _rz_old(rz, c)
    p_want, rz_want = _pallas_cg_update2(v, rz_old, rr_prev, thresh)
    t = {k: torch.from_numpy(a.copy()) for k, a in v.items()}
    rz_t = ck.cg_update2(torch.from_numpy(rz_old), t["r"], t["z"], t["p"],
                         torch.from_numpy(rr_prev), torch.from_numpy(thresh))
    tol = CG_TOL[dtype]
    np.testing.assert_allclose(t["p"].numpy(), p_want, rtol=tol, atol=tol)
    np.testing.assert_allclose(rz_t.numpy(), rz_want, rtol=max(tol, 1e-10))
    if c >= 2:        # frozen: beta = 0, p = z
        np.testing.assert_array_equal(t["p"][:, 1].numpy(), v["z"][:, 1])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("c", [1, 3])
def test_cg_update2_given_twin_matches_pallas(c, dtype):
    """cg_update2_given's twin, handed rz = r.z (what the ranks' dots sum
    to), gives the Pallas cg_update2's p."""
    v, rz, rr_prev, thresh = _cg_cols_case(dtype, c, seed=17)
    rz_old = _rz_old(rz, c)
    p_want, _ = _pallas_cg_update2(v, rz_old, rr_prev, thresh)
    t = {k: torch.from_numpy(a.copy()) for k, a in v.items()}
    rz_new = ck.cg_dot(t["r"], t["z"])
    ck.cg_update2_given(rz_new, torch.from_numpy(rz_old), t["z"], t["p"],
                        torch.from_numpy(rr_prev), torch.from_numpy(thresh))
    tol = CG_TOL[dtype]
    np.testing.assert_allclose(t["p"].numpy(), p_want, rtol=tol, atol=tol)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
@pytest.mark.parametrize("entry", ["cg_update2", "cg_update2_given"])
def test_cg2_grid_one_wave(entry, c, monkeypatch):
    """The grids of B3 and of cg_update2_given are functions of (n, c) on a
    card: the same on every call, at least 1, at most the 4-row chunks, a
    chunk per thread while the card holds that many, and never more blocks
    than it holds at once (here a stand-in two blocks per SM of 132), which
    B3's grid-wide barrier needs. B3 issues all the loads of up to two
    chunks a thread at once, and has one chunk a thread at the main path's
    n."""
    blocks, threads = {"cg_update2": (ck.cg2_blocks, ck.CG2_THREADS),
                       "cg_update2_given": (ck.cg2_given_blocks,
                                            ck.CG2_GIVEN_THREADS)}[entry]
    most = 2 * 132
    card = torch.device("cuda", 0)
    for dtype in (torch.float32, torch.float64):
        monkeypatch.setitem(ck._MAX_BLOCKS,
                            (entry + "_max_blocks", 0, dtype, c), most)
        for n in (0, 1, 81, 4099, 57600, 70001, 115200, 230400, 300001,
                  10**7):
            nb = blocks(n, c, dtype, card)
            chunks = -(-n // ck.CG1_ROWS)
            assert nb == blocks(n, c, dtype, card)
            assert nb == ck.one_wave_blocks(n, most, threads)
            assert 1 <= nb <= max(1, chunks) and nb <= most
            if chunks <= most * threads:
                assert nb * threads >= chunks
            if entry == "cg_update2":
                unrolled = -(-chunks // (nb * threads)) <= 2
                assert unrolled == (n <= 2 * most * threads * ck.CG1_ROWS)


def test_wrappers_validate_inputs():
    """Shape, dtype and device checks raise before any launch; a device
    with no kernel raises instead of falling back."""
    p = torch.zeros((4, 3), dtype=torch.float64)
    with pytest.raises(ValueError):
        ck.ericson_candidates_T(torch.zeros((2, 4)), torch.zeros((9, 1, 4)))
    with pytest.raises(ValueError):
        ck.ericson_candidates_T(torch.zeros((3, 4)), torch.zeros((9, 1, 5)))
    with pytest.raises(ValueError):
        ck.ericson_candidates(p, torch.zeros((4, 2, 3, 3), dtype=torch.float32))
    tris = torch.zeros((8, 3, 3), dtype=torch.float64)
    with pytest.raises(ValueError):       # idx must be int64
        ck.ericson_candidates_idx(p, tris, torch.zeros((4, 2), dtype=torch.int32))
    with pytest.raises(ValueError):       # one idx row per query
        ck.ericson_candidates_idx(p, tris, torch.zeros((5, 2), dtype=torch.int64))
    with pytest.raises(ValueError):       # p and tris share a dtype
        ck.ericson_candidates_idx(p, tris.float(),
                                  torch.zeros((4, 2), dtype=torch.int64))
    s = torch.zeros(3, dtype=torch.float64)
    with pytest.raises(ValueError):
        ck.cg_update1(s, p, p[:2], p, p, s, s)
    with pytest.raises(ValueError):
        ck.cg_update2(s[:2], p, p, p, s, s)
    with pytest.raises(ValueError):
        ck.cg_update1(s.int(), p.int(), p.int(), p.int(), p.int(), s.int(),
                      s.int())
    meta = torch.zeros((4, 3), dtype=torch.float64, device="meta")
    sm = torch.zeros(3, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ck.cg_update2(sm, meta, meta, meta, sm, sm)


def test_twins_do_not_count_launches():
    """CPU tensors run the twins: no kernel launch is counted."""
    ck.reset_launch_counts()
    v, rz = _cg_case(np.float64, n=64)
    t = {k: torch.from_numpy(a) for k, a in v.items()}
    s = torch.ones(3, dtype=torch.float64)
    ck.cg_update1(torch.from_numpy(rz), t["p"], t["ap"], t["x"], t["r"], s,
                  s * 0)
    ck.cg_update2(torch.from_numpy(rz), t["r"], t["z"], t["p"], s, s * 0)
    ck.ericson_candidates(t["x"], torch.zeros((64, 2, 3, 3),
                                              dtype=torch.float64))
    ck.ericson_candidates_idx(t["x"], torch.zeros((5, 3, 3),
                                                  dtype=torch.float64),
                              torch.zeros((64, 2), dtype=torch.int64))
    ck.cg_dot(t["p"], t["ap"])
    ck.cg_update1_given(s, torch.from_numpy(rz), t["p"], t["ap"], t["x"],
                        t["r"], s, s * 0)
    ck.cg_update2_given(s, torch.from_numpy(rz), t["z"], t["p"], s, s * 0)
    assert ck.launch_counts() == {"ericson": 0, "ericson_idx": 0,
                                  "cg_update1": 0, "cg_update2": 0,
                                  "cg_dot": 0, "cg_update1_given": 0,
                                  "cg_update2_given": 0, "tet_prox": 0,
                                  "tet_grad": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernels_match_twins_on_card(cuda_device, dtype):
    """B1-B3 on the card against their twins on the same inputs."""
    dtol, qtol = ERICSON_TOL[np.float64 if dtype == torch.float64
                             else np.float32]
    g = torch.Generator().manual_seed(0)
    p = torch.randn((1000, 3), generator=g, dtype=dtype).to(cuda_device)
    cand = torch.randn((1000, 16, 3, 3), generator=g,
                       dtype=dtype).to(cuda_device)
    before = ck.launch_counts()["ericson"]
    q, d = ck.ericson_candidates(p, cand)
    assert ck.launch_counts()["ericson"] == before + 1
    qv, dv = ck.ericson_candidates_T_plain(
        p.T.contiguous(), cand.reshape(1000, 16, 9).permute(2, 1, 0).contiguous())
    torch.testing.assert_close(d, dv[0], rtol=dtol, atol=dtol)
    torch.testing.assert_close(q, qv.T, rtol=qtol, atol=qtol)

    n, c = 4096, 3
    vec = {k: torch.randn((n, c), generator=g, dtype=dtype).to(cuda_device)
           for k in ("x", "r", "p", "ap", "z")}
    rz = torch.rand(c, generator=g, dtype=dtype).to(cuda_device) + 0.5
    rr_prev = torch.tensor([1.0, 1e-30, 1.0], dtype=dtype, device=cuda_device)
    thresh = torch.full((c,), 1e-20, dtype=dtype, device=cuda_device)
    xk, rk, pk_ = vec["x"].clone(), vec["r"].clone(), vec["p"].clone()
    rr_k = ck.cg_update1(rz, vec["p"], vec["ap"], xk, rk, rr_prev, thresh)
    rz_k = ck.cg_update2(rz, rk, vec["z"], pk_, rr_prev, thresh)
    xt, rt, pt = vec["x"].clone(), vec["r"].clone(), vec["p"].clone()
    rr_t = ck.cg_update1_plain(rz, vec["p"], vec["ap"], xt, rt, rr_prev,
                               thresh)
    rz_t = ck.cg_update2_plain(rz, rt, vec["z"], pt, rr_prev, thresh)
    tol = CG_TOL[np.float64 if dtype == torch.float64 else np.float32]
    for a, b in [(xk, xt), (rk, rt), (rr_k, rr_t), (pk_, pt), (rz_k, rz_t)]:
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ericson_idx_matches_twin_on_card(cuda_device, dtype):
    """B1's indexed entry on the card against its twin on the same inputs:
    equal to the last bit (the kernel rounds op by op like the twin), at
    sub = 1 and 16, on random tables and on exact ties and dummy rows."""
    def both(p, tris, idx, sub):
        args = [torch.from_numpy(a).to(cuda_device) for a in (p, tris, idx)]
        before = ck.launch_counts()["ericson_idx"]
        q, d = ck.ericson_candidates_idx(*args, sub=sub)
        assert ck.launch_counts()["ericson_idx"] == before + 1
        qt, dt = ck.ericson_candidates_idx_plain(*args, sub=sub)
        torch.testing.assert_close(q, qt, rtol=0, atol=0)
        torch.testing.assert_close(d, dt, rtol=0, atol=0)
        return q

    for Q, G, sub in [(300, 7, 1), (8192, 48, 1), (2000, 6, 16)]:
        both(*_idx_case(dtype, Q, G, sub, Q + G + sub), sub)
    for sub in (1, 16):
        p, tris, idx, want = _tie_case(dtype, sub)
        q = both(p, tris, idx, sub)
        np.testing.assert_array_equal(q.cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n,c", [(1000, 1), (4099, 2), (81, 3), (230400, 3),
                                 (70001, 4), (300001, 3)])
def test_cg_update1_on_card_twin_and_repeatable(cuda_device, n, c, dtype):
    """B2 in one launch against its twin, and bit-equal on a second call
    with the same inputs (fixed grid, fixed reduction order, no float
    atomics)."""
    v, rz, rr_prev, thresh = _cg_cols_case(dtype, c, n=n)
    dev = {k: torch.from_numpy(a).to(cuda_device) for k, a in v.items()}
    rz, rr_prev, thresh = (torch.from_numpy(a).to(cuda_device)
                           for a in (rz, rr_prev, thresh))
    outs = []
    for _ in range(2):
        x, r = dev["x"].clone(), dev["r"].clone()
        rr = ck.cg_update1(rz, dev["p"], dev["ap"], x, r, rr_prev, thresh)
        outs.append((x, r, rr))
    xt, rt = dev["x"].clone(), dev["r"].clone()
    rr_t = ck.cg_update1_plain(rz, dev["p"], dev["ap"], xt, rt, rr_prev, thresh)
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
    tol = CG_TOL[dtype]
    for a, b in zip(outs[0], (xt, rt, rr_t)):
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)


def _device_kernels(fn, warm):
    """The device kernels that fn() launches, by torch.profiler: [name],
    or None when the profiler recorded no device event at all (no trace).
    A first profiler step runs warm() and is discarded (the schedule's
    warm-up, for the tracer's start-up)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    seen = []

    def ready(prof):
        seen.extend(e.name for e in prof.events()
                    if str(e.device_type).endswith("CUDA"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=ready) as prof:
        for step in (warm, fn):
            step()
            torch.cuda.synchronize()
            prof.step()
    if not seen:
        return None
    # kernels: not copies, not the step's range
    return [n for n in seen if not n.startswith("ProfilerStep")
            and "memcpy" not in n.lower() and "memset" not in n.lower()]


def _b3_cases(dev, dtype, c, ns):
    """[(n, inputs on dev)] of B3 and cg_update2_given: _cg_cols_case's
    vectors with rz, rz_old (_rz_old), rr_prev and thresh."""
    cases = []
    for n in ns:
        v, rz, rr_prev, thresh = _cg_cols_case(dtype, c, n=n, seed=n + c)
        v.update(rz=rz, rz_old=_rz_old(rz, c), rr_prev=rr_prev,
                 thresh=thresh)
        cases.append((n, {k: torch.from_numpy(a).to(dev)
                          for k, a in v.items()}))
    return cases


def _one_launch_each(cases, call, entry, kernel):
    """call(t, p) once per case from a copy of its p (one counted launch
    each), then again from other copies, all of those in one
    torch.profiler step, which must see one device kernel per call, named
    `kernel`. Returns [(first p, first result, second p, second
    result)]."""
    runs = []
    for _, t in cases:
        p = t["p"].clone()
        before = ck.launch_counts()[entry]
        runs.append([p, call(t, p)])
        assert ck.launch_counts()[entry] == before + 1
    # a session that the profiler did not trace (no device event at all;
    # it happens now and then on the card's machine) is run again
    for _ in range(3):
        again = [t["p"].clone() for _, t in cases]
        outs = []
        spare = cases[-1][1]["p"].clone()
        kernels = _device_kernels(
            lambda: outs.extend(call(t, p)
                                for (_, t), p in zip(cases, again)),
            lambda: call(cases[-1][1], spare))
        if kernels is not None:
            break
    assert kernels is not None, "torch.profiler traced no session of three"
    assert len(kernels) == len(cases), kernels
    assert all(kernel in k for k in kernels), kernels
    return [run + [p, out] for run, p, out in zip(runs, again, outs)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_cg_update2_one_launch_on_card(cuda_device, c, dtype):
    """B3 on the card at ragged n, a rank's shares, the main path's n and
    an n past two chunks a thread (all the loads of one or two chunks a
    thread issued at once; grid-stride loops past that): against its twin,
    bit-equal on a repeat and under CUDA-graph replay, one device kernel
    per call (torch.profiler) and one counted launch."""
    tol = CG_TOL[dtype]
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    wave = (ck.cg2_blocks(1 << 40, c, tdt, cuda_device) * ck.CG2_THREADS
            * ck.CG1_ROWS)
    cases = _b3_cases(cuda_device, dtype, c,
                      GIVEN_NS + (230400, 300001, wave + 5, 2 * wave + 5))

    def call(t, p):
        return ck.cg_update2(t["rz_old"], t["r"], t["z"], p, t["rr_prev"],
                             t["thresh"])
    runs = _one_launch_each(cases, call, "cg_update2", "cg2_fused")
    for (n, t), (p1, rz1, p2, rz2) in zip(cases, runs):
        assert torch.equal(p1, p2) and torch.equal(rz1, rz2)
        pt = t["p"].clone()
        rz_t = ck.cg_update2_plain(t["rz_old"], t["r"], t["z"], pt,
                                   t["rr_prev"], t["thresh"])
        torch.testing.assert_close(p1, pt, rtol=tol, atol=tol)
        # rz: n terms of size ~1, also at atol tol * sqrt(n)
        torch.testing.assert_close(rz1, rz_t, rtol=tol,
                                   atol=tol * max(n, 1) ** 0.5)
        gp = t["p"].clone()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            gp.copy_(t["p"])
            grz = call(t, gp)
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(gp, p1) and torch.equal(grz, rz1)


# ---------------------------------------------------------------------------
# cg_dot and cg_update1_given: one launch each over a one-wave grid
# ---------------------------------------------------------------------------

GIVEN_NS = (0, 1, 3, 81, 4099, 70001, 57600, 115200)


@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_given_grid_fixed_and_within_chunks(c, monkeypatch):
    """The grid of cg_dot and cg_update1_given is a function of (n, c) on a
    card: the same on every call, at least 1 and at most the 4-row chunks
    (and never more than the card holds at once, here a stand-in 3 blocks
    per SM of 132)."""
    most = 3 * 132
    card = torch.device("cuda", 0)
    for dtype in (torch.float32, torch.float64):
        monkeypatch.setitem(ck._MAX_BLOCKS,
                            ("cg_given_max_blocks", 0, dtype, c), most)
        for n in GIVEN_NS + (10**7,):
            nb = ck.cg_given_blocks(n, c, dtype, card)
            chunks = -(-n // ck.CG1_ROWS)
            assert nb == ck.cg_given_blocks(n, c, dtype, card)
            assert nb == ck.one_wave_blocks(n, most)
            assert 1 <= nb <= max(1, chunks) and nb <= most
            # one chunk per thread while the card holds that many threads
            if chunks <= most * ck.CG1_THREADS:
                assert nb * ck.CG1_THREADS >= chunks


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_given_out_argument_twins(dtype):
    """cg_dot and cg_update1_given write into `out` (rows of one (2, c)
    buffer, as the sharded CG hands them) the bits they return without
    it, and return it."""
    v, rz, rr_prev, thresh = _cg_cols_case(dtype, 3, n=500)
    t = {k: torch.from_numpy(a) for k, a in v.items()}
    rz, rr_prev, thresh = (torch.from_numpy(a) for a in (rz, rr_prev, thresh))
    pap = ck.cg_dot(t["p"], t["ap"])
    buf = torch.full((2, 3), float("nan"), dtype=t["x"].dtype)
    assert ck.cg_dot(t["p"], t["ap"], out=buf[0]).data_ptr() == buf.data_ptr()
    assert torch.equal(buf[0], pap)
    x1, r1, x2, r2 = (t[k].clone() for k in ("x", "r", "x", "r"))
    rr = ck.cg_update1_given(pap, rz, t["p"], t["ap"], x1, r1, rr_prev, thresh)
    got = ck.cg_update1_given(pap, rz, t["p"], t["ap"], x2, r2, rr_prev,
                              thresh, out=buf[1])
    assert got.data_ptr() == buf[1].data_ptr()
    for a, b in [(buf[1], rr), (x1, x2), (r1, r2)]:
        assert torch.equal(a, b)


def test_given_wrappers_validate_inputs():
    """cg_dot and cg_update1_given raise on mismatched shapes, on an `out`
    that is not a contiguous (c,) tensor of the inputs' dtype, and on a
    device with no kernel."""
    p = torch.zeros((8, 3), dtype=torch.float64)
    s = torch.zeros(3, dtype=torch.float64)
    with pytest.raises(ValueError):
        ck.cg_dot(p, p[:4])
    with pytest.raises(ValueError):
        ck.cg_dot(p, p.float())
    with pytest.raises(ValueError):
        ck.cg_update1_given(s[:2], s, p, p, p, p, s, s)
    for bad in (torch.zeros(4, dtype=torch.float64), s.float(),
                torch.zeros((3, 2), dtype=torch.float64)[:, 0]):
        with pytest.raises(ValueError, match="out must be"):
            ck.cg_dot(p, p, out=bad)
        with pytest.raises(ValueError, match="out must be"):
            ck.cg_update1_given(s, s, p, p, p, p, s, s, out=bad)
    meta = torch.zeros((8, 3), dtype=torch.float64, device="meta")
    sm = torch.zeros(3, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ck.cg_dot(meta, meta, out=sm)
    with pytest.raises(ValueError, match="no kernel for device"):
        ck.cg_update1_given(sm, sm, meta, meta, meta, meta, sm, sm)


def _given_on_card(dev, dtype, c, n, seed):
    v, rz, rr_prev, thresh = _cg_cols_case(dtype, c, n=n, seed=seed)
    t = {k: torch.from_numpy(a).to(dev) for k, a in v.items()}
    rz, rr_prev, thresh = (torch.from_numpy(a).to(dev)
                           for a in (rz, rr_prev, thresh))
    return t, (t["p"] * t["ap"]).sum(0), rz, rr_prev, thresh


def _given_calls(t, pap, rz, rr_prev, thresh):
    """cg_dot(p, Ap) and cg_update1_given from fresh copies of x, r:
    (dot, x, r, rr)."""
    x, r = t["x"].clone(), t["r"].clone()
    d = ck.cg_dot(t["p"], t["ap"])
    rr = ck.cg_update1_given(pap, rz, t["p"], t["ap"], x, r, rr_prev, thresh)
    return d, x, r, rr


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_given_one_launch_on_card(cuda_device, c, dtype):
    """cg_dot and cg_update1_given on the card at ragged n and a rank's
    shares of 230,400 rows: against their twins, bit-equal on a repeat and
    under CUDA-graph replay, one counted launch per call."""
    tol = CG_TOL[dtype]
    for n in GIVEN_NS:
        t, pap, rz, rr_prev, thresh = _given_on_card(cuda_device, dtype, c,
                                                     n, seed=n + c)
        before = ck.launch_counts()
        first = _given_calls(t, pap, rz, rr_prev, thresh)
        after = ck.launch_counts()
        assert after["cg_dot"] == before["cg_dot"] + 1
        assert after["cg_update1_given"] == before["cg_update1_given"] + 1
        second = _given_calls(t, pap, rz, rr_prev, thresh)
        assert all(torch.equal(a, b) for a, b in zip(first, second))
        x, r = t["x"].clone(), t["r"].clone()
        d = ck.cg_dot_plain(t["p"], t["ap"])
        rr = ck.cg_update1_given_plain(pap, rz, t["p"], t["ap"], x, r,
                                       rr_prev, thresh)
        # the column sums (n terms of size ~1) also at atol tol * sqrt(n)
        for i, (a, b) in enumerate(zip(first, (d, x, r, rr))):
            atol = tol * (max(n, 1) ** 0.5 if i in (0, 3) else 1)
            torch.testing.assert_close(a, b, rtol=tol, atol=atol)
        gx, gr = t["x"].clone(), t["r"].clone()
        gd, grr = rz.clone(), rz.clone()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            gx.copy_(t["x"])
            gr.copy_(t["r"])
            ck.cg_dot(t["p"], t["ap"], out=gd)
            ck.cg_update1_given(pap, rz, t["p"], t["ap"], gx, gr, rr_prev,
                                thresh, out=grr)
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            assert all(torch.equal(a, b)
                       for a, b in zip((gd, gx, gr, grr), first))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_given_two_sizes_alternate_on_card(cuda_device, dtype):
    """Two n whose grids differ, called in turns on one stream: each keeps
    its own bits (the scratch is kept per grid size)."""
    sizes = (115200, 4099)
    cases = [_given_on_card(cuda_device, dtype, 3, n, seed=n) for n in sizes]
    x = cases[0][0]["x"]
    assert len({ck.cg_given_blocks(n, 3, x.dtype, x.device)
                for n in sizes}) == 2
    runs = [[_given_calls(*case) for case in cases] for _ in range(3)]
    for k in range(len(sizes)):
        for later in runs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(runs[0][k], later[k]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_given2_one_launch_on_card(cuda_device, c, dtype):
    """cg_update2_given on the card at ragged n, a rank's shares and an n
    with more chunks than the card holds threads (its grid-stride loop):
    against its twin, bit-equal on a repeat and under CUDA-graph replay,
    one device kernel per call (torch.profiler) and one counted launch."""
    tol = CG_TOL[dtype]
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    most = ck.cg2_given_blocks(1 << 40, c, tdt, cuda_device)
    cases = _b3_cases(cuda_device, dtype, c, GIVEN_NS + (
        most * ck.CG2_GIVEN_THREADS * ck.CG1_ROWS + 5,))

    def call(t, p):
        ck.cg_update2_given(t["rz"], t["rz_old"], t["z"], p, t["rr_prev"],
                            t["thresh"])
        return p
    runs = _one_launch_each(cases, call, "cg_update2_given", "cg2_given")
    for (n, t), (p1, _, p2, _) in zip(cases, runs):
        assert torch.equal(p1, p2)
        pt = t["p"].clone()
        ck.cg_update2_given_plain(t["rz"], t["rz_old"], t["z"], pt,
                                  t["rr_prev"], t["thresh"])
        torch.testing.assert_close(p1, pt, rtol=tol, atol=tol)
        gp = t["p"].clone()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            gp.copy_(t["p"])
            call(t, gp)
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(gp, p1)
