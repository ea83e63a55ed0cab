"""Global-step pieces of the PyTorch port against the JAX package at f64 on
the CPU: pcg and pcg_fused (kernels B2/B3 through their twins) against pcg
and pcg_banded, the two-level preconditioner, the dense inverse, and
Anderson acceleration step by step.

Tolerances: CG solutions 1e-8 relative (as tests/test_pallas_kernels.py's
pcg_banded-vs-pcg check: the same iteration, dots summed in another order);
preconditioner and AA iterates 1e-12 (same arithmetic, f64 roundoff)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_admm_tpu.solver import anderson as janderson
from aa_admm_tpu.solver import linear as jlinear
from aa_admm_tpu.solver import multigrid as jmg
from aa_admm_tpu.ops import constraints as jcons
from aa_admm_tpu_torch.core.timers import host_reads
from aa_admm_tpu_torch.solver import anderson as tanderson
from aa_admm_tpu_torch.solver import linear as tlinear
from aa_admm_tpu_torch.solver import multigrid as tmg
from aa_admm_tpu_torch.ops import constraints as tcons


def _spd_system(n=256, c=3, seed=3):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    A = M @ M.T + n * np.eye(n)
    rhs = rng.standard_normal((n, c))
    # columns at different scales converge at different iteration counts
    # (the frozen-column path runs)
    rhs = rhs * np.asarray([1.0, 1e-3, 1e3])[None, :]
    return A, rhs


@pytest.mark.parametrize("fused", [False, True])
def test_pcg_matches_jax(fused):
    A, rhs = _spd_system()
    Aj, At = jnp.asarray(A), torch.from_numpy(A)
    x_j, it_j = jlinear.pcg(lambda v: Aj @ v, jnp.asarray(rhs), jnp.diagonal(Aj),
                            tol=1e-10, max_iters=300)
    x_b, it_b = jlinear.pcg_banded(lambda v: Aj @ v, jnp.asarray(rhs),
                                   jnp.diagonal(Aj), tol=1e-10, max_iters=300)
    fn = tlinear.pcg_fused if fused else tlinear.pcg
    reads0 = host_reads()
    x_t, it_t = fn(lambda v: At @ v, torch.from_numpy(rhs),
                   torch.diagonal(At), tol=1e-10, max_iters=300)
    assert it_t == int(it_j) == int(it_b)
    # one loop test per iteration + the exit
    assert host_reads() - reads0 == it_t + 1
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_b), rtol=1e-8,
                               atol=1e-10)
    r = np.linalg.norm(A @ x_t.numpy() - rhs, axis=0) / np.linalg.norm(rhs, axis=0)
    assert (r < 1e-9).all()


def test_pcg_fused_warm_start_and_cap():
    """A capped warm-started solve (the f32 app setting) stops at the cap,
    matches JAX's capped iterate, and leaves x0 untouched."""
    A, rhs = _spd_system(seed=5)
    Aj, At = jnp.asarray(A), torch.from_numpy(A)
    x0 = np.random.default_rng(1).standard_normal(rhs.shape)
    x_j, it_j = jlinear.pcg(lambda v: Aj @ v, jnp.asarray(rhs), jnp.diagonal(Aj),
                            tol=1e-14, max_iters=4, x0=jnp.asarray(x0))
    x0_t = torch.from_numpy(x0.copy())
    reads0 = host_reads()
    x_t, it_t = tlinear.pcg_fused(lambda v: At @ v, torch.from_numpy(rhs),
                                  torch.diagonal(At), tol=1e-14,
                                  max_iters=4, x0=x0_t)
    assert it_t == int(it_j) == 4 and host_reads() - reads0 == 4
    np.testing.assert_array_equal(x0_t.numpy(), x0)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-10,
                               atol=1e-10)


def test_dense_inverse_matches_jax():
    A, rhs = _spd_system(n=64)
    inv_j = np.asarray(jlinear.dense_inverse(A))
    inv_t = tlinear.dense_inverse(A).numpy()
    np.testing.assert_allclose(inv_t, inv_j, rtol=1e-12, atol=1e-15)
    x = tlinear.DenseInverseSolver(Ainv=torch.from_numpy(inv_t)).solve(
        torch.from_numpy(rhs))
    np.testing.assert_allclose(A @ x.numpy(), rhs, rtol=1e-9, atol=1e-9)


def _grid_batches(pkg, nx=30, ny=30):
    """Angle + edge batches of a regular quad grid (wire-mesh layout)."""
    vid = lambda i, j: i * (ny + 1) + j
    faces = np.asarray([[vid(i, j), vid(i + 1, j), vid(i + 1, j + 1),
                         vid(i, j + 1)] for i in range(nx) for j in range(ny)])
    corners = np.concatenate([np.stack([faces[:, i], faces[:, (i + 1) % 4],
                                        faces[:, (i + 3) % 4]], 1)
                              for i in range(4)])
    edges = set()
    for f in faces:
        for i in range(4):
            a, b = f[i], f[(i + 1) % 4]
            edges.add((min(a, b), max(a, b)))
    edges = np.asarray(sorted(edges))
    n = (nx + 1) * (ny + 1)
    hard = [pkg.AngleBatch.create(corners, 1.0, np.pi / 4, 3 * np.pi / 4),
            pkg.EdgeLengthBatch.create(edges, 1.0, 1.0)]
    soft = [pkg.ClosenessBatch.create(np.arange(n), 1.0, np.zeros((n, 3)))]
    return n, hard, soft


def test_two_level_precond_matches_jax():
    n, hard_j, soft_j = _grid_batches(jcons)
    _, hard_t, soft_t = _grid_batches(tcons)
    rho = 1000.0
    A = jcons.assemble_geometry_node_matrix_sparse(n, hard_j, soft_j, rho)
    diag = np.asarray(A.diagonal())
    e_j = jmg.collect_pair_edges(hard_j + soft_j)
    e_t = tmg.collect_pair_edges(hard_t + soft_t)
    np.testing.assert_array_equal(e_t, e_j)
    agg_j = jmg.greedy_aggregate(n, e_j, target_coarse=100)
    agg_t = tmg.greedy_aggregate(n, e_t, target_coarse=100)
    np.testing.assert_array_equal(agg_t, agg_j)
    mg_j = jmg.build_two_level(n, hard_j, soft_j, rho, None, diag,
                               target_coarse=100)
    mg_t = tmg.build_two_level(n, hard_t, soft_t, rho, None, diag,
                               target_coarse=100)
    np.testing.assert_array_equal(mg_t.agg.numpy(), np.asarray(mg_j.agg))
    np.testing.assert_allclose(mg_t.Ac_inv.numpy(), np.asarray(mg_j.Ac_inv),
                               rtol=1e-12, atol=1e-15)
    r = np.random.default_rng(2).standard_normal((n, 3))
    np.testing.assert_allclose(mg_t.apply(torch.from_numpy(r)).numpy(),
                               np.asarray(mg_j.apply(jnp.asarray(r))),
                               rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("effective_dim", [None, 12])
def test_anderson_step_by_step(effective_dim):
    """One fixed input sequence (random fixed-point images, so the window's
    Gram matrix stays well conditioned and f64 roundoff is not amplified),
    including a reset mid-way: the mixed iterates and the window state
    match JAX at every step."""
    rng = np.random.default_rng(4)
    d, m = 20, 5
    u0 = rng.standard_normal(d)
    Gs = rng.standard_normal((14, d))
    sj = janderson.init(m, jnp.asarray(u0), effective_dim)
    st = tanderson.init(m, torch.from_numpy(u0), effective_dim)
    for k, G in enumerate(Gs):
        if k == 8:   # reject path: restart the window
            sj = janderson.reset(sj, jnp.asarray(Gs[k - 1]))
            st = tanderson.reset(st, torch.from_numpy(Gs[k - 1]))
        sj, uj = janderson.compute(sj, jnp.asarray(G))
        st, ut = tanderson.compute(st, torch.from_numpy(G))
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-12,
                                   atol=1e-12)
        for name in ("dF", "dG", "dF_scale", "M"):
            np.testing.assert_allclose(getattr(st, name).numpy(),
                                       np.asarray(getattr(sj, name)),
                                       rtol=1e-12, atol=1e-12)
        assert int(st.iter) == int(sj.iter)
        assert int(st.col_idx) == int(sj.col_idx)
