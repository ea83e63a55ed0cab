"""The launch across hosts (aa_admm_tpu_torch/parallel/multihost.py) on the
CPU, gloo on 127.0.0.1, against the JAX package's tools/multihost_dryrun.py
case.

* Two torchrun hosts of two ranks (``launch(2, 2, "dryrun")``): the float64
  tiny xzu scene as an ensemble of two replicas per host on a (dp 2, elem 2)
  mesh whose dp axis spans the hosts. Each replica is held to the JAX
  package's single-process ``step_xzu`` at max|dx| < 1e-10 (the JAX tool's
  bound) and bit for bit to the same spec on ``run_ranks(4, ...)``, the
  one-host route; each rank's dp coordinate is its host; the geometry
  dryrun on the same ranks is within 1e-9 / 1e-8; rank 0's JSON has the
  JAX artifact's keys and goes to the run's directory.
* ``launch(2, 1, "wire")`` on a small wire mesh, bit for bit against
  ``run_ranks(2, wire_mesh_case, ...)`` (tests/test_torch_parallel_geometry.py
  holds that to the unsharded solve).
* ``host_env`` on monkeypatched variables: each missing or inconsistent
  variable raises and names itself; the host index is RANK //
  LOCAL_WORLD_SIZE. The card rule (``ensemble.card_backend``) on UUID
  lists, the host-aware placement check, the cards each simulated host
  sees, one rank joining by hand-set variables (no torchrun agent: rank 0
  hosts the store), and a rank that raises: the launch raises within its
  deadline with that rank's error and leaves no process behind.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_admm_tpu.parallel import ensemble as jens
from aa_admm_tpu.solver.physics import step_xzu as jax_step_xzu
from aa_admm_tpu_torch.core.polymesh import PolyMesh, subdivide_and_smooth
from aa_admm_tpu_torch.parallel import ensemble as tens
from aa_admm_tpu_torch.parallel import geometry as pg
from aa_admm_tpu_torch.parallel import multihost as mh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = dict(mh.DRYRUN_SPEC, prefer_dp=2, scenes=4)
ENV = dict(RANK="5", WORLD_SIZE="8", LOCAL_RANK="1", LOCAL_WORLD_SIZE="4",
           MASTER_ADDR="127.0.0.1", MASTER_PORT="29500")


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    """The dryrun on two torchrun hosts of two gloo ranks: (the ranks'
    results, their npz files, the run's directory)."""
    out = tmp_path_factory.mktemp("hosts")
    ranks = mh.launch(2, 2, "dryrun", device="cpu", timeout=240,
                      out=str(out))
    npz = [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]
    return ranks, npz, out


def test_dp_spans_the_hosts(dryrun):
    ranks, npz, _ = dryrun
    for r, (res, z) in enumerate(zip(ranks, npz)):
        assert res["rank"] == r and res["host"] == r // 2
        assert res["local_rank"] == r % 2
        assert res["dp_coord"] == res["dp_rank"] == res["host"]
        assert res["elem_rank"] == res["local_rank"]
        assert res["scenes"] == z["scenes"].tolist() == [2 * res["host"],
                                                         2 * res["host"] + 1]
    mh.check_host_placement(ranks)
    assert {r["backend"] for r in ranks} == {"gloo"}


def test_replicas_match_the_jax_single_process_step(dryrun):
    """The JAX tool's check: each host's replicas against the JAX package's
    unsharded step of the same replica, max|dx| < 1e-10."""
    ranks, npz, _ = dryrun
    solver, _ = tens.build_tiny_scene("xzu", "float64", SPEC["iters"],
                                      SPEC["m"], device="cpu")
    js, _ = jens.build_tiny_scene("xzu", dtype="float64",
                                  admm_iters=SPEC["iters"],
                                  anderson_m=SPEC["m"])
    xs, vs, pps = tens.tiny_states(solver, 4)
    step = jax.jit(jax_step_xzu)
    ref = [np.asarray(step(js.system, *(jnp.asarray(a[s].numpy())
                                        for a in (xs, vs, pps)))[0])
           for s in range(4)]
    for res, z in zip(ranks, npz):
        for i, s in enumerate(z["scenes"]):
            assert np.abs(z["x"][i] - ref[s]).max() < 1e-10
        assert res["max_dx"] < 1e-10        # against the port's own step


def test_replicas_bit_equal_to_one_host_ranks(dryrun, tmp_path):
    _, npz, _ = dryrun
    tens.run_ranks(4, tens.sharded_case, SPEC, str(tmp_path), device="cpu",
                   timeout=240)
    for r, z in enumerate(npz):
        one = np.load(tmp_path / f"rank{r}.npz")
        for k in ("scenes", "x", "v", "prim", "comb", "reject",
                  "collectives", "reset_count"):
            assert np.array_equal(z[k], one[k], equal_nan=True), (r, k)


def test_geometry_dryrun_on_the_same_ranks(dryrun):
    ranks, _, _ = dryrun
    for r in ranks:
        g = r["geometry"]
        assert g["max_dx"] < 1e-9 and g["max_dfv_rel"] < 1e-8
        assert g["collectives"] > 0 and g["backend"] == "gloo"
    geo = ranks[0]["summary"]["geometry"]
    assert geo["max_dx"] < 1e-9 and geo["max_dfv_rel"] < 1e-8


def test_json_has_the_jax_artifacts_keys(dryrun):
    ranks, _, out = dryrun
    with open(out / "multihost.json") as f:
        art = json.load(f)
    assert art == ranks[0]["summary"]
    assert art["multihost"] == "ok" and art["n_processes"] == 2
    assert art["devices_per_process"] == 2
    assert art["mesh"] == "dp 2 (across hosts) x elem 2"
    assert art["max_dx_vs_single_process"] == max(r["max_dx"] for r in ranks)
    assert art["max_dx_vs_single_process"] < 1e-10
    assert art["checked_shards_per_process"] == 4
    assert art["backend"] == "gloo"
    assert [(p["rank"], p["host"], p["local_rank"], p["device"], p["card"])
            for p in art["ranks"]] == [(r, r // 2, r % 2, "cpu", None)
                                       for r in range(4)]
    assert not os.path.exists(os.path.join(REPO, "multihost.json"))


def _wire_scene():
    """tests/test_torch_parallel_geometry.py's small wire mesh: a noisy
    4 x 4-face grid subdivided to 81 vertices against a height field of
    20,402 triangles (the subgroup cache)."""
    rng = np.random.default_rng(0)
    n = 4
    xs, ys = np.meshgrid(np.arange(n + 1, dtype=float),
                         np.arange(n + 1, dtype=float), indexing="ij")
    verts = np.stack([xs.ravel(), ys.ravel(),
                      0.15 * rng.normal(size=xs.size)], axis=1)
    faces = [[i * (n + 1) + j, (i + 1) * (n + 1) + j,
              (i + 1) * (n + 1) + j + 1, i * (n + 1) + j + 1]
             for i in range(n) for j in range(n)]
    mesh = PolyMesh(verts=verts, faces=faces)
    sub = subdivide_and_smooth(mesh)
    u = np.linspace(-15.0, 21.0, 102)
    X, Y = np.meshgrid(u, u, indexing="ij")
    ref_v = np.stack([X.ravel(), Y.ravel(),
                      (0.3 * np.sin(0.13 * X) * np.cos(0.09 * Y)).ravel()], 1)
    i, j = np.meshgrid(np.arange(101), np.arange(101), indexing="ij")
    a = (i * 102 + j).ravel()
    ref_f = np.concatenate([np.stack([a, a + 102, a + 1], 1),
                            np.stack([a + 102, a + 103, a + 1], 1)])
    return dict(verts=sub.verts, faces=[list(f) for f in sub.faces],
                ref_v=ref_v, ref_f=ref_f,
                edge_length=mesh.average_edge_length() * 0.5)


def test_scene_file_round_trip(tmp_path):
    scene = _wire_scene()
    pg.save_scene(str(tmp_path / "scene.npz"), scene)
    back = pg.load_scene(str(tmp_path / "scene.npz"))
    assert back["faces"] == [[int(v) for v in f] for f in scene["faces"]]
    for k in ("verts", "ref_v", "ref_f"):
        assert back[k].dtype == np.asarray(scene[k]).dtype
        assert np.array_equal(back[k], scene[k])
    assert back["edge_length"] == scene["edge_length"]


def test_wire_case_across_hosts_bit_equal_to_one_host(tmp_path):
    scene = _wire_scene()
    opts = dict(max_iter=5, dense_threshold=0)
    hosts = mh.launch(2, 1, "wire", device="cpu", timeout=240,
                      scene=scene, opts=opts)
    one = tens.run_ranks(2, pg.wire_mesh_case, scene, opts, device="cpu",
                         timeout=240)
    for h, o in zip(hosts, one):
        assert (h["rank"], h["host"], h["local_rank"]) == (o["rank"],
                                                          o["rank"], 0)
        assert h["rows"] == o["rows"] and h["rejects"] == o["rejects"]
        assert np.array_equal(h["x"], o["x"])
        assert np.array_equal(h["fv"], o["fv"])
        assert h["stats"]["trials"] == o["stats"]["trials"] > 0
        assert h["stats"]["collectives"] == o["stats"]["collectives"]
        assert h["launches"] == dict.fromkeys(h["launches"], 0)    # twins
    mh.check_host_placement(hosts)


# ---------------------------------------------------------------------------
# The rank's place
# ---------------------------------------------------------------------------

def _set_env(monkeypatch, **kw):
    for k, v in dict(ENV, **kw).items():
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)


@pytest.mark.parametrize("name", mh._VARS)
def test_host_env_names_a_missing_variable(monkeypatch, name):
    _set_env(monkeypatch, **{name: None})
    with pytest.raises(ValueError, match=f"^{name} is not set"):
        mh.host_env()


@pytest.mark.parametrize("kw,name", [
    (dict(RANK="8"), "RANK=8 is not below WORLD_SIZE"),
    (dict(WORLD_SIZE="6"), "WORLD_SIZE=6 is not a multiple of "
                           "LOCAL_WORLD_SIZE"),
    (dict(LOCAL_RANK="2"), "LOCAL_RANK=2 is not RANK % LOCAL_WORLD_SIZE"),
    (dict(RANK="x"), "RANK='x' is not an integer"),
    (dict(LOCAL_WORLD_SIZE="0"), "LOCAL_WORLD_SIZE=0 is out of range"),
    (dict(MASTER_PORT="70000"), "MASTER_PORT=70000 is out of range"),
], ids=["rank", "world", "local-rank", "not-int", "local-world", "port"])
def test_host_env_names_an_inconsistent_variable(monkeypatch, kw, name):
    _set_env(monkeypatch, **kw)
    with pytest.raises(ValueError, match=f"^{name}"):
        mh.host_env()


@pytest.mark.parametrize("rank,world,local_world,host,n_hosts", [
    (5, 8, 4, 1, 2), (0, 8, 4, 0, 2), (3, 4, 1, 3, 4), (2, 3, 3, 0, 1)])
def test_host_env_derives_the_host(monkeypatch, rank, world, local_world,
                                   host, n_hosts):
    _set_env(monkeypatch, RANK=str(rank), WORLD_SIZE=str(world),
             LOCAL_RANK=str(rank % local_world),
             LOCAL_WORLD_SIZE=str(local_world))
    env = mh.host_env()
    assert (env.rank, env.world, env.local_rank, env.local_world) == (
        rank, world, rank % local_world, local_world)
    assert (env.host, env.n_hosts) == (host, n_hosts)
    assert (env.master_addr, env.master_port) == ("127.0.0.1", 29500)


@pytest.mark.parametrize("cards,want", [
    (["GPU-a", "GPU-a"], "gloo"), (["GPU-a", "GPU-b"], "nccl"),
    ([None, None], "gloo"), ([None, "GPU-a"], "gloo"),
    (["GPU-a", "GPU-b", "GPU-a", "GPU-c"], "gloo"),
    (["GPU-a", "GPU-b", "GPU-c", "GPU-d"], "nccl"),
], ids=["shared", "distinct", "cpu", "mixed", "one-shared-of-four",
        "four-distinct"])
def test_card_rule(cards, want):
    assert tens.card_backend(cards) == want


def _info(rank, local_rank, card, backend, n_cards=2):
    dev = "cpu" if card is None else f"cuda:{local_rank % n_cards}"
    return dict(rank=rank, local_rank=local_rank, card=card, backend=backend,
                n_cards=0 if card is None else n_cards, device=dev,
                current_device=None if card is None else local_rank % n_cards)


@pytest.mark.parametrize("infos,error", [
    ([_info(0, 0, None, "gloo"), _info(1, 0, None, "gloo")], None),
    ([_info(r, r % 2, f"GPU-{r}", "nccl") for r in range(4)], None),
    ([_info(r, 0, "GPU-0", "gloo", 1) for r in range(2)], None),
    ([_info(r, 0, "GPU-0", "nccl", 1) for r in range(2)], "under gloo"),
    ([_info(0, 0, "GPU-0", "gloo"), _info(1, 1, "GPU-1", "gloo")],
     "under nccl"),
    ([dict(_info(0, 1, "GPU-0", "nccl"), device="cuda:0", current_device=0),
      _info(1, 1, "GPU-1", "nccl")], "not on cuda:1"),
    ([_info(1, 0, None, "gloo"), _info(0, 1, None, "gloo")], "placement 0"),
], ids=["cpu", "nccl-4", "gloo-shared", "nccl-shared", "gloo-distinct",
        "wrong-card", "order"])
def test_host_placement_check(infos, error):
    if error is None:
        mh.check_host_placement(infos)
    else:
        with pytest.raises(RuntimeError, match=error):
            mh.check_host_placement(infos)


@pytest.mark.parametrize("n_hosts,cards,want", [
    (2, [0, 1, 2, 3], ["0,1", "2,3"]), (2, [0], ["0", "0"]),
    (2, ["3", "5"], ["3", "5"]), (4, [0, 1], ["0,1"] * 4),
    (1, [0, 1], ["0,1"])])
def test_host_cards(n_hosts, cards, want):
    assert mh.host_cards(n_hosts, cards) == want


def test_one_rank_joins_by_hand_set_variables(monkeypatch):
    """Without torchrun's agent, rank 0 hosts the env:// store itself."""
    _set_env(monkeypatch, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
             LOCAL_WORLD_SIZE="1", MASTER_PORT=str(mh.free_port()))
    monkeypatch.delenv("TORCHELASTIC_USE_AGENT_STORE", raising=False)
    n = torch.get_num_threads()
    try:
        env, device = mh.init_host_rank("cpu")
        try:
            info = mh.host_rank_info(env, device)
        finally:
            torch.distributed.destroy_process_group()
    finally:
        torch.set_num_threads(n)
    assert (env.host, env.n_hosts, str(device)) == (0, 1, "cpu")
    assert info["backend"] == "gloo" and info["card"] is None
    mh.check_host_placement([info])


def _alive_with(token: str) -> list:
    """Processes (not zombies) whose arguments hold `token`."""
    alive = []
    for d in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                args = f.read()
            with open(f"/proc/{d}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if token.encode() in args and state != "Z":
            alive.append(int(d))
    return alive


def test_a_failing_rank_fails_the_launch(tmp_path):
    """Rank 1 cannot write its npz (a directory holds the name): the launch
    raises within its deadline with rank 1's error, and kills the ranks
    that wait for it in a collective."""
    (tmp_path / "rank1.npz").mkdir()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="failed") as e:
        mh.launch(2, 2, "dryrun", device="cpu", timeout=120, out=str(tmp_path))
    assert time.monotonic() - t0 < 120
    assert "rank1.err" in str(e.value)
    assert "IsADirectoryError" in str(e.value)
    assert _alive_with(str(tmp_path)) == []
