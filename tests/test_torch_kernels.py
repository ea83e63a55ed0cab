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
    assert ck.launch_counts() == {"ericson": 0, "ericson_idx": 0,
                                  "cg_update1": 0, "cg_update2": 0}


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
