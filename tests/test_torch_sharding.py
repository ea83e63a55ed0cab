"""Element-axis sharding of the port's physics step
(aa_admm_tpu_torch/parallel/ensemble.py: shard_system, make_mesh,
run_ranks, dryrun) at f64 on the CPU, on the 40-tet beam of
``build_tiny_scene``.

* World 2, every rank on the element axis, both orders, on the dense and
  the forced-CG global step (where the vertex scatter of every CG matvec
  is summed over the ranks, and every rank reads the CG loop's test from
  the replicated residual); and world 4, a
  dp 2 x elem 2 mesh stepping an xzu ensemble of four replicas, two per dp
  group: the ranks (spawned processes joined by gloo over a FileStore) write
  npz files, and each scene is held against the JAX package's unsharded
  step (its vmapped ``ensemble_step`` for the ensemble) to the bounds of
  tests/test_parallel.py:73-100: x rtol 1e-10 / atol 1e-12, prim rtol
  1e-9, equal reset counts. Against the port's own unsharded step these
  hold as they are; against the JAX package the residuals below 1e-11 of
  a trace's first are compared to that floor (tests/test_torch_zxu.py's
  PRIM_FLOOR), because there the JAX package's own single-scene and vmapped
  steps differ by up to 1.5e-9 relative on these replicas. The ranks of one
  element group must agree bit for bit (every value they branch on is
  all-reduced).
* The exact count of collectives per step: on the dense path, one for the
  setup's solve and seven per accelerated xzu iteration (the solve, the
  primal norm, the reject branch's solve and norm, the AA inner products,
  the diagnostic solve and its combined residual); four per zxu iteration
  and one more per reject branch run (zxu runs its reject branch only on
  a reject, through a host read). On the CG path each solve adds its
  initial residual's matvec and one per CG iteration, and xzu too runs
  its reject branch only on a reject. A stray collective fails these.
* Ragged shards in one process, the ranks as threads summing through a
  barrier: three ranks over a batch of two collision terms leave one rank
  with none, whose empty partials still join every sum.
"""

import dataclasses
import tempfile
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_admm_tpu.parallel import ensemble as jens
from aa_admm_tpu_torch.parallel import ensemble as tens

ITERS, M = 8, 3
PRIM_FLOOR = 1e-11


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene_pair(order, path):
    """The float64 tiny scene of the port and of the JAX package, on the
    scene's own global step ("auto": dense at this size) or the CG path."""
    solver, s = tens.build_tiny_scene(order, "float64", ITERS, M,
                                      device="cpu")
    js, jset = jens.build_tiny_scene(order, dtype="float64",
                                     admm_iters=ITERS, anderson_m=M)
    if path == "cg":
        s.linear_solver = jset.linear_solver = "cg"
        solver.initialize(s)
        js.initialize(jset)
    return solver, js


def _references(order, S, path="auto"):
    """The S tiny-scene replicas' unsharded steps, (x, prim, resets) each:
    the JAX package's (its vmapped ensemble_step) and the port's."""
    solver, js = _scene_pair(order, path)
    xs, vs, pps = tens.tiny_states(solver, S)
    jx, _, jtr = jens.ensemble_step(order)(
        js.system, *(jnp.asarray(a.numpy()) for a in (xs, vs, pps)))
    tx, _, ttr = tens.ensemble_step(order)(solver.system, xs, vs, pps)
    return ((np.asarray(jx), np.asarray(jtr.prim),
             np.asarray(jtr.reset_count), PRIM_FLOOR),
            (tx.numpy(), ttr.prim.numpy(), ttr.reset_count.numpy(), 0.0))


def _expected_collectives(order, branches, cg_iters=None):
    """Collectives of one step of ITERS iterations that ran the reject
    branch `branches` times: one vertex scatter per global solve (on the CG
    path, cg_iters not None, also each solve's initial residual and one
    matvec per CG iteration), and the norms and AA partials."""
    if order == "xzu":
        if cg_iters is None:
            branches = ITERS     # the dense path runs the branch every time
        solves = 1 + 2 * ITERS + branches
        other = 3 * ITERS + branches     # prim, AA, comb; the branch's prim
    else:
        solves = 1 + ITERS
        other = 3 * ITERS + branches     # prim, comb, AA; the branch's prim
    return solves + other + (0 if cg_iters is None else solves + cg_iters)


def _run(world, spec):
    out = tempfile.mkdtemp(prefix="shard_test_")
    tens.run_ranks(world, tens.sharded_case, spec, out, device="cpu",
                   timeout=300)
    return [dict(np.load(f"{out}/rank{r}.npz")) for r in range(world)]


def _assert_matches(rank_out, refs):
    for jx, jprim, jresets, floor in refs:
        for i, s in enumerate(rank_out["scenes"]):
            np.testing.assert_allclose(rank_out["x"][i], jx[s], rtol=1e-10,
                                       atol=1e-12)
            p, pj = rank_out["prim"][i], jprim[s]
            ok = ~np.isnan(pj)
            assert np.array_equal(np.isnan(p), ~ok)
            np.testing.assert_allclose(p[ok], pj[ok], rtol=1e-9,
                                       atol=floor * pj[0])
            assert int(rank_out["reset_count"][i]) == int(jresets[s])


def test_split_is_contiguous_and_ragged():
    for E, P in [(40, 2), (40, 3), (2, 3), (0, 2), (7, 7), (5, 8)]:
        parts = [tens._split(E, P, r) for r in range(P)]
        assert parts[0][0] == 0 and parts[-1][1] == E
        assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
        sizes = [hi - lo for lo, hi in parts]
        assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes)[::-1]


@pytest.mark.parametrize("path", ["auto", "cg"])
@pytest.mark.parametrize("order", ["xzu", "zxu"])
def test_elem_sharded_step_matches_jax(order, path):
    spec = dict(order=order, iters=ITERS, m=M, prefer_dp=1, scenes=1,
                solver=path)
    ranks = _run(2, spec)
    refs = _references(order, 1, path)
    for r in ranks:
        assert int(r["elem_rank"]) == int(r["rank"])
        _assert_matches(r, refs)
        assert np.array_equal(r["x"], ranks[0]["x"])
        assert np.array_equal(r["prim"], ranks[0]["prim"], equal_nan=True)
        # no eps-break here, so the reject branches run are the resets
        assert not np.isnan(r["prim"]).any()
        assert (int(r["cg_iters"]) > 0) == (path == "cg")
        cg = int(r["cg_iters"]) if path == "cg" else None
        assert int(r["collectives"]) == _expected_collectives(
            order, int(r["reset_count"][0]), cg)


def test_dp_elem_ensemble_matches_jax():
    """World 4 as dp 2 x elem 2: each dp group steps its two of the four
    xzu replicas as one tiled, element-sharded ensemble."""
    spec = dict(order="xzu", iters=ITERS, m=M, prefer_dp=2, scenes=4)
    ranks = _run(4, spec)
    refs = _references("xzu", 4)
    assert sorted(tuple(r["scenes"]) for r in ranks) == [(0, 1), (0, 1),
                                                         (2, 3), (2, 3)]
    for r in ranks:
        assert (int(r["dp_rank"]), int(r["elem_rank"])) == divmod(
            int(r["rank"]), 2)
        _assert_matches(r, refs)
        assert int(r["collectives"]) == _expected_collectives("xzu", 0)
    assert np.array_equal(ranks[0]["x"], ranks[1]["x"])
    assert np.array_equal(ranks[2]["x"], ranks[3]["x"])


def test_convert_refuses_a_jax_elem_sharding_and_names_shard_system():
    from aa_admm_tpu_torch import convert
    with pytest.raises(NotImplementedError, match="ensemble.shard_system"):
        convert.physics_system_from_numpy({"elem_sharding": object()})


def test_a_failing_rank_fails_the_call():
    with pytest.raises(RuntimeError, match="rank [01] failed"):
        tens.run_ranks(2, tens.sharded_case, dict(order="no-such-order"),
                       tempfile.mkdtemp(prefix="shard_test_"), device="cpu",
                       timeout=120)


def test_dryrun_two_ranks():
    summary = tens.dryrun(2, device="cpu", timeout=300)
    assert sorted(summary) == ["geometry", "xzu", "xzu_cg", "zxu", "zxu_cg"]
    for order in ("xzu", "xzu_cg", "zxu", "zxu_cg"):
        assert summary[order]["max_dx"] < 1e-10
        assert summary[order]["max_dprim"] < 1e-8
    geo = summary["geometry"]
    assert geo["max_dx"] < 1e-9 and geo["max_dfv_rel"] < 1e-8
    assert summary["xzu"]["collectives"] == 1 + 7 * 3
    assert summary["xzu_cg"]["collectives"] > 1 + 5 * 3


# ---------------------------------------------------------------------------
# Ragged shards with an empty rank, the ranks as threads
# ---------------------------------------------------------------------------

class _Mesh:
    """A mesh stand-in for shard_system: rank r of P on the element axis."""

    def __init__(self, P, r):
        self.P, self.r = P, r

    def __getitem__(self, name):
        return self

    def size(self):
        return self.P

    def get_local_rank(self):
        return self.r

    def get_group(self, name):
        return None


class _ThreadComm:
    """all_reduce of P threads: each deposits its partial and sums all of
    them in rank order after a barrier."""

    def __init__(self, slots, barrier, r):
        self.slots, self.barrier, self.r, self.count = slots, barrier, r, 0

    def all_reduce(self, t):
        self.slots[self.r] = t
        self.barrier.wait()
        out = sum(self.slots[1:], self.slots[0].clone())
        self.barrier.wait()
        self.count += 1
        return out


@pytest.mark.parametrize("order", ["xzu", "zxu"])
def test_ragged_shards_with_an_empty_rank(order):
    P = 3
    solver, s = tens.build_tiny_scene(order, "float64", ITERS, M,
                                      device="cpu")
    if order == "zxu":
        solver.set_collisions([0, 5])         # two terms over three ranks
        solver.initialize(s)
    system = solver.system
    xs, vs, pps = tens.tiny_states(solver, 2)
    x1, _, tr1 = tens.ensemble_step(order)(system, xs, vs, pps)
    slots, barrier = [None] * P, threading.Barrier(P, timeout=60)
    shards = [dataclasses.replace(tens.shard_system(system, _Mesh(P, r)),
                                  comm=_ThreadComm(slots, barrier, r))
              for r in range(P)]
    sizes = [[b.w.shape[0] for b in sh.batches] for sh in shards]
    assert [sum(col) for col in zip(*sizes)] == [b.w.shape[0]
                                                 for b in system.batches]
    if order == "zxu":
        assert [sz[1] for sz in sizes] == [1, 1, 0]
    results = [None] * P

    def run(r):
        results[r] = tens.ensemble_step(order)(shards[r], xs, vs, pps)
    threads = [threading.Thread(target=run, args=(r,)) for r in range(P)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    for r, (x, _, tr) in enumerate(results):
        np.testing.assert_allclose(x.numpy(), x1.numpy(), rtol=1e-10,
                                   atol=1e-12)
        assert torch.equal(tr.reset_count, tr1.reset_count)
        ok = ~torch.isnan(tr1.prim)
        np.testing.assert_allclose(tr.prim[ok].numpy(), tr1.prim[ok].numpy(),
                                   rtol=1e-9)
        # the reject branch runs when either scene rejects
        branches = int(((tr1.reject > 0).any(0)).sum())
        expect = 1 + (7 * ITERS if order == "xzu"
                      else 4 * ITERS + branches)
        assert shards[r].comm.count == expect


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_dryrun_on_card():
    """chip_smoke phase 12's sharding check: two ranks on the one card
    through gloo (which takes CUDA tensors) against the unsharded f64
    step, both orders, on the dense and the CG global step, and the
    geometry dryrun's solve."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    summary = tens.dryrun(2, n_cards=1, timeout=300)
    assert sorted(summary) == ["geometry", "xzu", "xzu_cg", "zxu", "zxu_cg"]
    for order in ("xzu", "xzu_cg", "zxu", "zxu_cg"):
        assert summary[order]["max_dx"] < 1e-10
        assert summary[order]["max_dprim"] < 1e-8
    geo = summary["geometry"]
    assert geo["max_dx"] < 1e-9 and geo["max_dfv_rel"] < 1e-8
