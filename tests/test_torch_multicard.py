"""The port's sharded paths with one rank per card
(aa_admm_tpu_torch/parallel/ensemble.py: rank_placement, run_ranks,
make_mesh, dryrun; parallel/geometry.py: make_vert_mesh).

On the CPU:

* ``rank_placement``'s rule over (world, device type, card count): the CPU
  always under gloo; CUDA with no more ranks than cards under NCCL, rank r
  on cuda:r; more ranks than cards under gloo, round-robin over the cards;
  the card count defaults to what torch sees (stubbed here).
* The meshes' device type follows the group's backend, on spawned gloo
  ranks on the CPU: "cpu" for both meshes, each rank on its rule's device.
* ``dryrun(2, device="cpu")``'s JSON line holds the geometry solve's parity
  ("geometry": max_dx, max_dfv_rel, collectives) inside the JAX dryrun's
  bounds, as the JAX dryrun's line does.

On two cards (``cuda``; skipped below two): every kernel entry (B1's plane
and indexed entries, B2, B3, ``cg_dot`` and the given entries) on cuda:1
tensors while card 0 is current equals the same call on cuda:0 bit for
bit; ``dryrun(2)`` and ``dryrun_geometry(2)`` under NCCL pass their bounds
with each rank on its own card.
"""

import json

import numpy as np
import pytest
import torch

from aa_admm_tpu_torch.ops import cuda_kernels as ck
from aa_admm_tpu_torch.parallel import ensemble as tens
from aa_admm_tpu_torch.parallel import geometry as pg


def _cards(*idx):
    return [torch.device("cuda", i) for i in idx]


@pytest.mark.parametrize("world,device_type,n_cards,seen,want", [
    (3, "cpu", None, 0, ("gloo", [torch.device("cpu")] * 3)),
    (4, "cuda", None, 4, ("nccl", _cards(0, 1, 2, 3))),
    (2, "cuda", None, 1, ("gloo", _cards(0, 0))),
    (4, "cuda", None, 2, ("gloo", _cards(0, 1, 0, 1))),
    (2, "cuda", 2, 4, ("nccl", _cards(0, 1))),
    (3, "cuda", 2, 4, ("gloo", _cards(0, 1, 0))),
    (2, "cuda", 1, 4, ("gloo", _cards(0, 0))),
], ids=["cpu", "cuda-4-of-4", "cuda-2-of-1", "cuda-4-of-2",
        "cuda-2-of-2-given", "cuda-3-of-2-given", "cuda-2-of-1-given"])
def test_rank_placement(world, device_type, n_cards, seen, want,
                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: seen)
    assert tens.rank_placement(world, device_type, n_cards) == want


def test_rank_placement_refuses_no_cards_and_other_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="at least one card"):
        tens.rank_placement(2, "cuda")
    with pytest.raises(ValueError, match="no rank placement"):
        tens.rank_placement(2, "mps", 1)


def _mesh_types(rank, world, device):
    return dict(ensemble=tens.make_mesh(world).device_type,
                geometry=pg.make_vert_mesh(world).device_type,
                **tens.rank_info(device))


def test_mesh_device_type_follows_backend_on_gloo_ranks():
    ranks = tens.run_ranks(2, _mesh_types, device="cpu", timeout=120)
    for r in ranks:
        assert r == dict(ensemble="cpu", geometry="cpu", backend="gloo",
                         device="cpu", current_device=None)
    tens.check_placement(ranks, 2, "cpu")


def test_dryrun_json_line_holds_geometry(capsys):
    tens.dryrun(2, device="cpu", timeout=300)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    line = json.loads(lines[-1])
    assert line["dryrun"] == "ok" and line["n_devices"] == 2
    assert line["backend"] == "gloo" and line["devices"] == ["cpu", "cpu"]
    geo = line["orders"]["geometry"]
    assert sorted(geo) == ["collectives", "max_dfv_rel", "max_dx"]
    assert geo["max_dx"] < 1e-9 and geo["max_dfv_rel"] < 1e-8
    assert geo["collectives"] > 0


# ---------------------------------------------------------------------------
# On two cards
# ---------------------------------------------------------------------------

def _two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")


def _kernel_call(entry, dtype, seed):
    """(fn, inputs) of one kernel entry at a small shape; fn(*inputs)
    returns its outputs, the inputs it updates in place included."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, dtype=dtype)

    n, c = 5000, 3
    if entry == "ericson":
        return ck.ericson_candidates_T, [rnd(3, 700), rnd(9, 48, 700)]
    if entry == "ericson_idx":
        idx = torch.randint(0, 50, (700, 6), generator=g)
        return (lambda p, t, i: ck.ericson_candidates_idx(p, t, i, 4),
                [rnd(700, 3), rnd(200, 3, 3), idx])
    scal = [torch.rand(c, generator=g, dtype=dtype) + 0.5 for _ in range(2)]
    thresh = torch.full((c,), 1e-20, dtype=dtype)
    if entry == "cg_update1":
        def fn(rz, p, ap, x, r, rr, th):
            return ck.cg_update1(rz, p, ap, x, r, rr, th), x, r
        return fn, [scal[0], rnd(n, c), rnd(n, c), rnd(n, c), rnd(n, c),
                    scal[1], thresh]
    if entry == "cg_update2":
        def fn(rz, r, z, p, rr, th):
            return ck.cg_update2(rz, r, z, p, rr, th), p
        return fn, [scal[0], rnd(n, c), rnd(n, c), rnd(n, c), scal[1],
                    thresh]
    if entry == "cg_dot":
        return ck.cg_dot, [rnd(n, c), rnd(n, c)]
    if entry == "cg_update1_given":
        def fn(pap, rz, p, ap, x, r, rr, th):
            return ck.cg_update1_given(pap, rz, p, ap, x, r, rr, th), x, r
        return fn, [scal[0], scal[1], rnd(n, c), rnd(n, c), rnd(n, c),
                    rnd(n, c), scal[1].clone(), thresh]
    assert entry == "cg_update2_given"

    def fn(rz, rz_old, z, p, rr, th):
        ck.cg_update2_given(rz, rz_old, z, p, rr, th)
        return (p,)
    return fn, [scal[0], scal[1], rnd(n, c), rnd(n, c), scal[1].clone(),
                thresh]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("entry", ["ericson", "ericson_idx", "cg_update1",
                                   "cg_update2", "cg_dot",
                                   "cg_update1_given", "cg_update2_given"])
def test_kernel_on_second_card_equals_first(entry, dtype):
    """Each entry on cuda:1 tensors while card 0 is current, against the
    same call on cuda:0: equal bits, and its launch counted."""
    _two_cards()
    fn, inputs = _kernel_call(entry, dtype, seed=7)
    outs = {}
    with torch.cuda.device(0):
        for i in (0, 1):
            args = [t.to(f"cuda:{i}") for t in inputs]
            before = ck.launch_counts()
            out = fn(*args)
            out = out if isinstance(out, tuple) else (out,)
            assert all(o.device == torch.device("cuda", i) for o in out)
            key = "ericson_idx" if entry == "ericson_idx" else entry
            assert ck.launch_counts()[key] == before[key] + 1
            torch.cuda.synchronize(i)
            outs[i] = [o.cpu() for o in out]
        assert torch.cuda.current_device() == 0
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_dryruns_under_nccl_one_rank_per_card(capsys):
    """dryrun(2) (both orders, both global steps, and the geometry solve)
    and dryrun_geometry(2) with n_cards 2: NCCL, each rank on its own card
    (both raise otherwise), within the JAX dryrun's bounds."""
    _two_cards()
    summary = tens.dryrun(2, n_cards=2, timeout=300)
    for order in ("xzu", "xzu_cg", "zxu", "zxu_cg"):
        assert summary[order]["max_dx"] < 1e-10
        assert summary[order]["max_dprim"] < 1e-8
    line = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                       if ln.startswith("{")][-1])
    assert line["backend"] == "nccl"
    assert line["devices"] == ["cuda:0", "cuda:1"]
    geo = pg.dryrun_geometry(2, n_cards=2, timeout=300)
    assert geo["max_dx"] < 1e-9 and geo["max_dfv_rel"] < 1e-8
    assert summary["geometry"]["max_dx"] < 1e-9
