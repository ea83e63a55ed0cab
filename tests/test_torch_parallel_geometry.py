"""Vertex-row and constraint-element sharding of the port's geometry solve
(aa_admm_tpu_torch/parallel/geometry.py) at f64 on the CPU.

* The scene of tests/test_parallel_geometry.py (a 15 x 15 noisy grid with
  EdgeLength and Angle hard, Closeness soft and uniform-Laplacian
  regularization rows) on the CG path, sharded at world 2 and world 3
  (ragged rows and elements), the ranks as threads summing through a
  barrier: held to the port's unsharded solve, the JAX package's unsharded
  solve and the JAX package's solve sharded over its 8 virtual devices, to
  that file's bounds (fv rtol 1e-8, x rtol 1e-9 / atol 1e-10) with equal
  reject sequences. The same on the dense path at world 2.
* The exact count of collectives: per CG iteration (pcg_fused on a row
  shard) and per trial; a stray collective fails it. Every value the ranks
  branch on (function values, rejects, trial and CG counts) is bit-equal
  across the ranks.
* The solve's soft energies through the closest-point cache (subgroup and
  flat) at world 2 and world 3: every rank prints the unsharded solve's
  energies and counts its energy refreshes.
* The field-selection guard: a reference-surface batch whose query count
  equals its triangle (or group) count keeps its triangles whole.
* Spawned gloo ranks in two tests: the wire-mesh app on the reference
  surface of tests/test_torch_geometry.py (20,402 triangles, the subgroup
  cache) sharded over 2 ranks, with the unsharded solve's cache refreshes;
  and dryrun_geometry(2, device="cpu").
* The matrix-free operator (the CG path without its ELL matrix) at the
  81-vertex grid's ragged 41/40 split: the rows it hands the CG start on
  a 16-byte boundary and equal the view they replace.
* On the card (``cuda``): the given entries of B2 and B3 against their
  twins, bit-equal on a repeat; that ragged split solved through the
  matrix-free operator on two gloo ranks.
"""

import dataclasses
import re
import threading

import jax
import numpy as np
import pytest
import torch

from aa_admm_tpu.ops import constraints as jc
from aa_admm_tpu.parallel.geometry import make_vert_mesh as jax_vert_mesh
from aa_admm_tpu.solver.geometry import ALMGeometrySolver as JaxSolver
from aa_admm_tpu_torch.apps import wire_mesh_opt as twm
from aa_admm_tpu_torch.core.polymesh import PolyMesh, subdivide_and_smooth
from aa_admm_tpu_torch.ops import constraints as tc
from aa_admm_tpu_torch.ops import cuda_kernels as ck
from aa_admm_tpu_torch.parallel import ensemble as tens
from aa_admm_tpu_torch.parallel import geometry as pg
from aa_admm_tpu_torch.solver import geometry as tg
from aa_admm_tpu_torch.solver import linear as tl
from aa_admm_tpu_torch.solver.geometry import ALMGeometrySolver

FV_RTOL, X_RTOL, X_ATOL = 1e-8, 1e-9, 1e-10
ITERS, M = 12, 5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _noisy_quad_grid(nx=15, ny=15, noise=0.15, seed=3):
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.arange(nx + 1), np.arange(ny + 1), indexing="ij")
    verts = np.stack([xs.ravel(), ys.ravel(),
                      noise * rng.standard_normal(xs.size)],
                     axis=1).astype(np.float64)
    edges = []
    for i in range(nx + 1):
        for j in range(ny + 1):
            v = i * (ny + 1) + j
            if i < nx:
                edges.append((v, v + ny + 1))
            if j < ny:
                edges.append((v, v + 1))
    return verts, np.asarray(edges, np.int64)


def _build(solver, c, path, nx=15, dtype=np.float64):
    """tests/test_parallel_geometry.py::_build_wire_solver in either
    package (`c` its constraints module); path "cg" or "dense"; on an
    nx x nx grid, solved in dtype (the port's solver only)."""
    verts, edges = _noisy_quad_grid(nx, nx)
    n = len(verts)
    solver.add_hard_constraint(c.EdgeLengthBatch.create(edges, 1.0, 0.9))
    tips = edges[: n // 2, 0]
    tri = np.stack([tips, (tips + 1) % n, (tips + 2) % n], axis=1)
    solver.add_hard_constraint(c.AngleBatch.create(
        tri, 1.0, np.pi / 4, 3 * np.pi / 4))
    solver.add_soft_constraint(c.ClosenessBatch.create(np.arange(n), 1.0,
                                                       verts))
    for i in range(1, n - 1):
        solver.add_uniform_laplacian([i, i - 1, i + 1], 0.05)
    if dtype != np.float64:
        solver.dtype = np.dtype(dtype)
    solver.setup_ADMM(n, penalty_param=100.0, linear_solver=path)
    return solver, verts


def _solve(solver, verts, cg_tol=1e-13):
    solver.solve_ADMM(verts, rel_residual_eps=1e-14, max_iter=ITERS,
                      anderson_m=M, cg_tol=cg_tol)
    return (np.asarray(solver.get_solution()),
            np.asarray(solver.function_values), list(solver.anderson_reset))


@pytest.fixture(scope="module")
def references():
    """{path: [(name, x, fv, rejects)]}: the port's and the JAX package's
    unsharded solves, and on the CG path also the JAX package's solve
    sharded over its 8 virtual devices."""
    out = {}
    for path in ("cg", "dense"):
        refs = [("port",) + _solve(*_build(ALMGeometrySolver(device="cpu"),
                                           tc, path)),
                ("jax",) + _solve(*_build(JaxSolver(), jc, path))]
        if path == "cg":
            assert len(jax.devices()) >= 8
            js, verts = _build(JaxSolver(), jc, path)
            js.shard(jax_vert_mesh(8))
            refs.append(("jax sharded 8",) + _solve(js, verts))
        out[path] = refs
    return out


# ---------------------------------------------------------------------------
# Ranks as threads
# ---------------------------------------------------------------------------

class _Mesh:
    """A stand-in for make_vert_mesh: rank r of P; its group is the
    (slots, barrier, rank) of the thread sums."""

    def __init__(self, P, r, slots, barrier):
        self.P, self.r, self.group = P, r, (slots, barrier, r)

    def __getitem__(self, name):
        assert name == "elem"
        return self

    def size(self):
        return self.P

    def get_local_rank(self):
        return self.r

    def get_group(self, name):
        return self.group


class _ThreadComm:
    """all_reduce of P threads: each deposits its partial and sums all of
    them in rank order after a barrier; counts like ElemComm."""

    def __init__(self, group, device):
        self.slots, self.barrier, self.r = group
        self.count = self.nbytes = 0
        self.seconds = 0.0

    def all_reduce(self, t):
        self.slots[self.r] = t
        self.barrier.wait()
        out = sum(self.slots[1:], self.slots[0].clone())
        self.barrier.wait()
        self.count += 1
        self.nbytes += t.numel() * t.element_size()
        return out


@pytest.fixture
def thread_comm(monkeypatch):
    monkeypatch.setattr(pg, "ElemComm", _ThreadComm)


def _meshes(P):
    slots, barrier = [None] * P, threading.Barrier(P, timeout=120)
    return [_Mesh(P, r, slots, barrier) for r in range(P)]


def _in_threads(fns):
    """Run fns (one per rank) in threads; returns their results."""
    out = [None] * len(fns)
    errors = []

    def run(r):
        try:
            out[r] = fns[r]()
        except BaseException as e:      # surfaced below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(r,))
               for r in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
        assert not t.is_alive()
    if errors:
        raise errors[0]
    return out


def _sharded_solves(P, path):
    """The scene solved sharded over P thread ranks: [(solver, x, fv,
    rejects)] in rank order."""
    solvers, verts = [], None
    for mesh in _meshes(P):
        s, verts = _build(ALMGeometrySolver(device="cpu"), tc, path)
        s.shard(mesh)
        solvers.append(s)
    outs = _in_threads([lambda s=s: _solve(s, verts) for s in solvers])
    return [(s,) + o for s, o in zip(solvers, outs)]


def _assert_matches(x, fv, rejects, refs):
    for name, rx, rfv, rrej in refs:
        assert fv.shape == rfv.shape, name
        np.testing.assert_allclose(fv, rfv, rtol=FV_RTOL, err_msg=name)
        np.testing.assert_allclose(x, rx, rtol=X_RTOL, atol=X_ATOL,
                                   err_msg=name)
        assert rejects == rrej, name


def _assert_ranks_agree(ranks):
    s0, x0, fv0, rej0 = ranks[0]
    for s, x, fv, rej in ranks[1:]:
        assert np.array_equal(fv, fv0) and rej == rej0
        assert np.array_equal(x, x0)
        for k in ("trials", "cg_iters", "cp_refreshes", "host_reads",
                  "collectives", "comm_bytes"):
            assert s.stats[k] == s0.stats[k], k


@pytest.mark.parametrize("world", [2, 3])
def test_cg_path_sharded_matches_unsharded_and_jax(world, references,
                                                   thread_comm):
    ranks = _sharded_solves(world, "cg")
    n = len(ranks[0][1])
    rows = [(s.system.shard.lo, s.system.shard.hi) for s, *_ in ranks]
    assert rows[0][0] == 0 and rows[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    for s, *_ in ranks:
        assert s.system.mg is not None and s.system.solver is None
        sh = s.system.shard
        assert s.system.ell.idx.shape[0] == sh.hi - sh.lo
    # elements split too, raggedly at world 3
    sizes = [[b.w.shape[0] for b in s.system.hard + s.system.soft]
             for s, *_ in ranks]
    if world == 3:
        assert any(len(set(col)) > 1 for col in zip(*sizes))
    for _, x, fv, rej in ranks:
        _assert_matches(x, fv, rej, references["cg"])
    _assert_ranks_agree(ranks)
    st = ranks[0][0].stats
    # per trial: assemblies of x and of the new x, the x-update's sum, the
    # residual, the AA inner products, and the CG's start (A x0's
    # assembly, the coarse sum, the stacked dots); 4 per CG iteration;
    # one gather of the solution
    assert st["collectives"] == st["trials"] * 8 + 4 * st["cg_iters"] + 1
    # each assembly moves the full (n, 3) vector
    assert st["comm_bytes"] > (2 * st["trials"] + st["cg_iters"]) * n * 3 * 8


def test_dense_path_sharded_matches_unsharded_and_jax(references,
                                                      thread_comm):
    ranks = _sharded_solves(2, "dense")
    for s, x, fv, rej in ranks:
        assert s.system.solver is not None and s.system.ell is None
        _assert_matches(x, fv, rej, references["dense"])
    _assert_ranks_agree(ranks)
    st = ranks[0][0].stats
    # the replicated solve: the assemblies, the rhs sum, the residual and
    # the AA inner products per trial; no CG
    assert st["cg_iters"] == 0
    assert st["collectives"] == st["trials"] * 5 + 1


def _wavy_grid(m, lo=-1.0, hi=16.0):
    """z = 0.2 sin x cos y on an m x m vertex grid: 2 (m-1)^2 triangles
    (4,418 at m = 48: the flat closest-point cache)."""
    u = np.linspace(lo, hi, m)
    X, Y = np.meshgrid(u, u, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel(),
                      (0.2 * np.sin(X) * np.cos(Y)).ravel()], 1)
    i, j = np.meshgrid(np.arange(m - 1), np.arange(m - 1), indexing="ij")
    a = (i * m + j).ravel()
    faces = np.concatenate([np.stack([a, a + m, a + 1], 1),
                            np.stack([a + m, a + m + 1, a + 1], 1)])
    return verts, faces


def _build_on_surface(solver, ref):
    """The scene's grid and hard constraints on the CG path, held to a
    reference surface (soft) through the subgroup cache ("group", 20,402
    triangles) or the flat cache ("flat", 4,418)."""
    verts, edges = _noisy_quad_grid()
    n = len(verts)
    solver.add_hard_constraint(tc.EdgeLengthBatch.create(edges, 1.0, 0.9))
    tips = edges[: n // 2, 0]
    tri = np.stack([tips, (tips + 1) % n, (tips + 2) % n], axis=1)
    solver.add_hard_constraint(tc.AngleBatch.create(
        tri, 1.0, np.pi / 4, 3 * np.pi / 4))
    rv, rf = _height_field() if ref == "group" else _wavy_grid(48)
    solver.add_soft_constraint(tc.RefSurfaceBatch.create(np.arange(n), 1.0,
                                                         rv, rf))
    solver.setup_ADMM(n, penalty_param=100.0, linear_solver="cg")
    return solver, verts


def _printed(out, what):
    """The energies (``what``: "Init" or "final") the solves printed; the
    ranks' lines may interleave, each number is printed whole."""
    num = r"([-+]?\d+\.?\d*(?:e[-+]?\d+)?)"
    return [float(v) for v in re.findall(what + r" energy = " + num, out)]


@pytest.mark.parametrize("ref", ["group", "flat"])
@pytest.mark.parametrize("world", [2, 3])
def test_sharded_energies_match_unsharded(world, ref, thread_comm, capsys):
    """The solve's energies through the closest-point cache on row shards:
    every rank prints the unsharded solve's initial and final energies
    (rtol 1e-12: the ranks' partials are summed in another order) and
    counts its energy refreshes (the cache test is taken over every rank's
    queries)."""
    s, verts = _build_on_surface(ALMGeometrySolver(device="cpu"), ref)
    capsys.readouterr()
    _solve(s, verts)
    out = capsys.readouterr().out
    want = _printed(out, "Init") + _printed(out, "final")
    st = s.stats
    assert len(want) == 2 and st["energy_refreshes"] in (1, 2)
    solvers = []
    for mesh in _meshes(world):
        r, _ = _build_on_surface(ALMGeometrySolver(device="cpu"), ref)
        r.shard(mesh)
        solvers.append(r)
    _in_threads([lambda r=r: _solve(r, verts) for r in solvers])
    out = capsys.readouterr().out
    for what, e in zip(("Init", "final"), want):
        got = _printed(out, what)
        assert len(got) == world
        np.testing.assert_allclose(got, e, rtol=1e-12)
    for r in solvers:
        for k in ("energy_refreshes", "cp_refreshes", "trials"):
            assert r.stats[k] == st[k], k


def test_pcg_collectives_per_iteration(thread_comm):
    """pcg_fused on row shards (the given entries' twins on the CPU)
    against the unsharded solve of an SPD ELL system with the two-level
    preconditioner: 3 collectives at the start and 4 per iteration (p's
    assembly, pAp, the coarse sum, the stacked {rz, rr})."""
    s, _ = _build(ALMGeometrySolver(device="cpu"), tc, "cg")
    system = s.system
    rhs = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (system.n_verts, 3)))
    x_ref, it_ref = tl.pcg_fused(system.ell.apply, rhs,
                                 system.precond_diag, tol=1e-10,
                                 max_iters=40, precond=system.mg.apply)
    shards = [pg.shard_geometry_system(system, m) for m in _meshes(3)]

    def run(sh):
        from aa_admm_tpu_torch.solver.geometry import _full, _own
        comm = sh.shard.comm
        c0 = comm.count
        x, it = tl.pcg_fused(
            lambda v: sh.ell.apply(_full(sh, v)), _own(sh, rhs),
            sh.precond_diag, tol=1e-10, max_iters=40,
            precond=lambda r: sh.mg.apply(r, comm.all_reduce),
            reduce=comm.all_reduce)
        return _full(sh, x), it, comm.count - c0
    outs = _in_threads([lambda sh=sh: run(sh) for sh in shards])
    for x, it, coll in outs:
        assert it == it_ref and 0 < it < 40
        np.testing.assert_allclose(x.numpy(), x_ref.numpy(), rtol=1e-9,
                                   atol=1e-11)
        assert coll == 3 + 4 * it + 1       # + the gather of x
        assert torch.equal(x, outs[0][0])


def test_given_twins_compose_to_b2_b3_twins():
    """On one rank the given entries' twins, fed their own dots, are B2's
    and B3's twins bit for bit; on a device with no kernel they raise."""
    g = np.random.default_rng(2)
    v = {k: torch.from_numpy(g.standard_normal((300, 3)))
         for k in ("x", "r", "p", "ap", "z")}
    rz = torch.from_numpy(g.random(3) + 0.5)
    rr_prev = torch.tensor([1.0, 1e-30, 1.0], dtype=torch.float64)
    thresh = torch.full((3,), 1e-20, dtype=torch.float64)
    x1, r1, p1 = v["x"].clone(), v["r"].clone(), v["p"].clone()
    rr1 = ck.cg_update1_plain(rz, v["p"], v["ap"], x1, r1, rr_prev, thresh)
    rz1 = ck.cg_update2_plain(rz, r1, v["z"], p1, rr_prev, thresh)
    x2, r2, p2 = v["x"].clone(), v["r"].clone(), v["p"].clone()
    rr2 = ck.cg_update1_given(ck.cg_dot(v["p"], v["ap"]), rz, v["p"],
                              v["ap"], x2, r2, rr_prev, thresh)
    rz2 = ck.cg_dot(r2, v["z"])
    ck.cg_update2_given(rz2, rz, v["z"], p2, rr_prev, thresh)
    for a, b in [(x1, x2), (r1, r2), (rr1, rr2), (p1, p2), (rz1, rz2)]:
        assert torch.equal(a, b)
    meta = torch.zeros((4, 3), device="meta")
    sm = torch.zeros(3, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ck.cg_dot(meta, meta)
    with pytest.raises(ValueError, match="no kernel for device"):
        ck.cg_update1_given(sm, sm, meta, meta, meta, meta, sm, sm)
    with pytest.raises(ValueError, match="no kernel for device"):
        ck.cg_update2_given(sm, sm, meta, meta, sm, sm)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_matrix_free_rows_aligned_at_ragged_split(dtype, thread_comm,
                                                  monkeypatch):
    """The sharded matrix-free operator (the CG path without its ELL
    matrix) on the 81-vertex grid split 41/40 over two ranks: rank 1's
    rows of the summed partials start at byte 41 * 3 * itemsize, off the
    16-byte boundary that the CG kernels' loads need. The operator hands
    the CG loop an aligned copy equal to that view; rank 0 keeps its view
    (no copy). Both ranks' rows together match the unsharded operator."""
    s, _ = _build(ALMGeometrySolver(device="cpu"), tc, "cg", nx=8,
                  dtype=dtype)
    system = dataclasses.replace(s.system, ell=None)
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    v = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (system.n_verts, 3))).to(tdt)
    shards = [pg.shard_geometry_system(system, m) for m in _meshes(2)]
    assert [(sh.shard.lo, sh.shard.hi) for sh in shards] == [(0, 41),
                                                             (41, 81)]
    fns = [lambda sh=sh: tg._matrix_free(sh, tg._own(sh, v))
           for sh in shards]
    with monkeypatch.context() as m:
        m.setattr(tg, "_aligned", lambda t: t)
        views = _in_threads(fns)
    outs = _in_threads(fns)
    assert views[0].data_ptr() % 16 == 0 and views[1].data_ptr() % 16 != 0
    for view, out in zip(views, outs):
        assert out.data_ptr() % 16 == 0 and out.is_contiguous()
        assert torch.equal(out, view)
    assert outs[0]._base is not None and outs[1]._base is None
    want = tg._matrix_free(system, v)
    # the same terms summed in another order (per rank, then over ranks)
    tol = 1e-5 if dtype == np.float32 else 1e-12
    torch.testing.assert_close(torch.cat(outs), want, rtol=tol,
                               atol=tol * float(want.abs().max()))


# ---------------------------------------------------------------------------
# The field-selection guard
# ---------------------------------------------------------------------------

def _sphere_tris(n_u, n_v):
    u = np.linspace(0, 2 * np.pi, n_u, endpoint=False)
    v = np.linspace(0.1, np.pi - 0.1, n_v)
    U, V = np.meshgrid(u, v, indexing="ij")
    verts = np.stack([np.cos(U) * np.sin(V), np.sin(U) * np.sin(V),
                      np.cos(V)], -1).reshape(-1, 3)
    faces = []
    for i in range(n_u):
        for j in range(n_v - 1):
            a, b = i * n_v + j, ((i + 1) % n_u) * n_v + j
            faces += [[a, b, a + 1], [b, b + 1, a + 1]]
    return verts, np.asarray(faces)


def test_field_selection_keeps_reference_whole(thread_comm):
    """A RefSurfaceBatch whose query count equals its triangle count (and
    one whose query count equals its group count) keeps the triangles and
    groups whole on every rank and cuts its queries only; a batch class
    that declares no ELEM_FIELDS is refused."""
    ref_v, ref_f = _sphere_tris(10, 6)               # 100 triangles
    T = len(ref_f)
    small = tc.RefSurfaceBatch.create(np.arange(T) % 50, 1.0, ref_v, ref_f)
    ref_v2, ref_f2 = _sphere_tris(100, 102)          # 20,200 triangles
    big = tc.RefSurfaceBatch.create(np.arange(4) % 50, 1.0, ref_v2, ref_f2)
    G = big.grp_gcenter.shape[0]
    big = tc.RefSurfaceBatch.create(np.arange(G) % 50, 1.0, ref_v2, ref_f2)
    assert small.idx.shape[0] == small.tri_verts.shape[0] == T
    assert big.grp_tris is not None and big.idx.shape[0] == G
    s = ALMGeometrySolver(device="cpu")
    s.add_hard_constraint(tc.EdgeLengthBatch.create(
        np.stack([np.arange(49), np.arange(1, 50)], 1), 1.0, 0.5))
    s.add_soft_constraint(small)
    s.add_soft_constraint(big)
    s.setup_ADMM(50, 10.0, linear_solver="cg")
    for mesh in _meshes(2):
        sh = pg.shard_geometry_system(s.system, mesh)
        for full, cut in zip(s.system.soft, sh.soft):
            lo, hi = tens._split(full.idx.shape[0], 2, mesh.r)
            assert torch.equal(cut.idx, full.idx[lo:hi])
            assert torch.equal(cut.w, full.w[lo:hi])
            for k in ("tri_verts", "grp_tris", "grp_cent", "grp_rad",
                      "grp_gcenter", "grp_gradius"):
                a, b = getattr(full, k), getattr(cut, k)
                assert (a is None and b is None) or torch.equal(a, b), k
            assert cut.inv_idx.shape[0] <= full.inv_idx.shape[0]

    @dataclasses.dataclass(frozen=True)
    class Undeclared:
        idx: torch.Tensor
        w: torch.Tensor
    sys2 = dataclasses.replace(s.system, soft=(Undeclared(
        torch.zeros(4, dtype=torch.int64), torch.ones(4)),))
    with pytest.raises(TypeError, match="ELEM_FIELDS"):
        pg.shard_geometry_system(sys2, _meshes(2)[0])


# ---------------------------------------------------------------------------
# Spawned gloo ranks
# ---------------------------------------------------------------------------

def _height_field(n=102, lo=-15.0, hi=21.0):
    """tests/test_torch_geometry.py's reference: 20,402 triangles (above
    the subgroup-cache threshold of 20,000)."""
    u = np.linspace(lo, hi, n)
    X, Y = np.meshgrid(u, u, indexing="ij")
    Z = 0.3 * np.sin(0.13 * X) * np.cos(0.09 * Y)
    verts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], 1)
    i, j = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    a = (i * n + j).ravel()
    b = a + n
    faces = np.concatenate([np.stack([a, b, a + 1], 1),
                            np.stack([b, b + 1, a + 1], 1)])
    return verts, faces


def test_wire_mesh_group_cache_sharded_on_gloo_ranks(tmp_path):
    """optimize_mesh on the CG path with the subgroup cache, over 2 spawned
    gloo ranks, against the unsharded solve: the bounds above, equal
    rejects and equal cache refreshes (the refresh test is taken over
    both ranks' queries)."""
    rng = np.random.default_rng(0)
    nx = ny = 4
    xs, ys = np.meshgrid(np.arange(nx + 1, dtype=float),
                         np.arange(ny + 1, dtype=float), indexing="ij")
    verts = np.stack([xs.ravel(), ys.ravel(),
                      0.15 * rng.normal(size=xs.size)], axis=1)
    faces = [[i * (ny + 1) + j, (i + 1) * (ny + 1) + j,
              (i + 1) * (ny + 1) + j + 1, i * (ny + 1) + j + 1]
             for i in range(nx) for j in range(ny)]
    mesh = PolyMesh(verts=verts, faces=faces)
    el = mesh.average_edge_length() * 0.5
    sub = subdivide_and_smooth(mesh)
    ref_v, ref_f = _height_field()
    ref = twm.optimize_mesh(sub, ref_v, ref_f, max_iter=20, anderson_m=5,
                            edge_length=el, result_dir=str(tmp_path),
                            device="cpu", dense_threshold=0)
    st = ref.stats
    assert 1 <= st["cp_refreshes"] < st["trials"]
    assert sum(ref.anderson_reset) > 0
    scene = dict(verts=sub.verts, faces=[list(f) for f in sub.faces],
                 ref_v=ref_v, ref_f=ref_f, edge_length=el)
    ranks = tens.run_ranks(2, pg.wire_mesh_case, scene,
                           dict(max_iter=20, dense_threshold=0),
                           device="cpu", timeout=300)
    fv_ref = np.asarray(ref.function_values)
    for r in ranks:
        assert r["fv"].shape == fv_ref.shape
        np.testing.assert_allclose(r["fv"], fv_ref, rtol=FV_RTOL)
        np.testing.assert_allclose(r["x"], ref.get_solution(), rtol=X_RTOL,
                                   atol=X_ATOL)
        assert r["rejects"] == ref.anderson_reset
        for k in ("trials", "cg_iters", "cp_refreshes"):
            assert r["stats"][k] == st[k], k
        assert r["launches"] == dict.fromkeys(r["launches"], 0)   # twins
        # one refresh test per trial on top of the CG path's count
        assert r["stats"]["collectives"] == (
            r["stats"]["trials"] * 9 + 4 * r["stats"]["cg_iters"] + 1)
    assert np.array_equal(ranks[0]["fv"], ranks[1]["fv"])
    assert np.array_equal(ranks[0]["x"], ranks[1]["x"])
    assert ranks[0]["rows"] == (0, 41) and ranks[1]["rows"] == (41, 81)


def test_dryrun_geometry_two_ranks(capsys):
    out = pg.dryrun_geometry(2, device="cpu", timeout=300)
    assert sorted(out) == ["collectives", "max_dfv_rel", "max_dx"]
    assert out["max_dx"] < 1e-9 and out["max_dfv_rel"] < 1e-8
    assert out["collectives"] > 0
    assert "dryrun[geometry]" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,c", [(115200, 3), (81, 3), (4099, 1), (0, 3)])
def test_given_entries_match_twins_on_card(n, c, dtype):
    """cg_dot, cg_update1_given and cg_update2_given against their twins
    (a frozen column, zero divisors) on the card, bit-equal on a repeat;
    each wrapper call counts one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(n + c)
    v = {k: torch.randn((n, c), generator=g, dtype=dtype).to(dev)
         for k in ("x", "r", "p", "ap", "z")}
    rz = torch.rand(c, generator=g, dtype=dtype).to(dev) + 0.5
    pap = torch.rand(c, generator=g, dtype=dtype).to(dev) + 0.5
    rr_prev = torch.ones(c, dtype=dtype, device=dev)
    rr_prev[0] = 1e-30                       # frozen column
    thresh = torch.full((c,), 1e-20, dtype=dtype, device=dev)
    pap[-1] = 0                              # zero divisors
    rz_old = rz.clone()
    rz_old[-1] = 0
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    before = ck.launch_counts()
    outs = []
    for _ in range(2):
        x, r, p = v["x"].clone(), v["r"].clone(), v["p"].clone()
        d = ck.cg_dot(v["p"], v["ap"])
        rr = ck.cg_update1_given(pap, rz, v["p"], v["ap"], x, r, rr_prev,
                                 thresh)
        ck.cg_update2_given(rz, rz_old, v["z"], p, rr_prev, thresh)
        outs.append((d, x, r, rr, p))
    after = ck.launch_counts()
    for k in ("cg_dot", "cg_update1_given", "cg_update2_given"):
        assert after[k] == before[k] + 2
    x, r, p = v["x"].clone(), v["r"].clone(), v["p"].clone()
    d = ck.cg_dot_plain(v["p"], v["ap"])
    rr = ck.cg_update1_given_plain(pap, rz, v["p"], v["ap"], x, r, rr_prev,
                                   thresh)
    ck.cg_update2_given_plain(rz, rz_old, v["z"], p, rr_prev, thresh)
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
    # x, r and p element-wise at atol = tol; the column sums d and rr (n
    # terms of size ~1) also at atol = tol * sqrt(n), a signed sum's size
    for i, (a, b) in enumerate(zip(outs[0], (d, x, r, rr, p))):
        atol = tol * (max(n, 1) ** 0.5 if i in (0, 3) else 1)
        torch.testing.assert_close(a, b, rtol=tol, atol=atol)
    assert torch.equal(outs[0][1][:, 0], v["x"][:, 0])   # frozen: unmoved


def matrix_free_case(rank, world, device, dtype_name):
    """One rank of test_matrix_free_ragged_split_solves_on_card: the
    81-vertex grid on the CG path with the matrix-free operator (the ELL
    matrix dropped) solved unsharded, then sharded over the world (rows
    41/40 over two ranks); both solves' (x, fv, rejects), the rank's rows
    and the sharded solve's kernel launches."""
    dtype = np.dtype(dtype_name)
    cg_tol = 1e-13 if dtype == np.float64 else 1e-4
    out = {}
    for sharded in (False, True):
        s, verts = _build(ALMGeometrySolver(device=device), tc, "cg", nx=8,
                          dtype=dtype)
        s.system = dataclasses.replace(s.system, ell=None)
        if sharded:
            s.shard(pg.make_vert_mesh(world))
        ck.reset_launch_counts()
        out[sharded] = _solve(s, verts, cg_tol)
    sh = s.system.shard
    return dict(rows=(sh.lo, sh.hi), unsharded=out[False], sharded=out[True],
                launches=ck.launch_counts())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_matrix_free_ragged_split_solves_on_card(dtype):
    """The ragged 41/40 split through the matrix-free operator on the card,
    two gloo ranks on one card: the rows of rank 1 start off a 16-byte
    boundary, and the given entries take them. float64 holds the unsharded
    card solve to this file's bounds with equal rejects; float32 is finite;
    the ranks are bit-equal and launch only the given entries of B2/B3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ranks = tens.run_ranks(2, matrix_free_case, np.dtype(dtype).name,
                           device="cuda", n_cards=1, timeout=600)
    assert [r["rows"] for r in ranks] == [(0, 41), (41, 81)]
    for r in ranks:
        x, fv, rej = r["sharded"]
        assert np.isfinite(x).all() and np.isfinite(fv).all()
        if dtype == np.float64:
            _assert_matches(x, fv, rej, [("unsharded",) + r["unsharded"]])
        launches = r["launches"]
        assert launches["cg_update1"] == launches["cg_update2"] == 0
        assert launches["cg_dot"] > 0 and launches["cg_update2_given"] > 0
    for a, b in zip(ranks[0]["sharded"], ranks[1]["sharded"]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
