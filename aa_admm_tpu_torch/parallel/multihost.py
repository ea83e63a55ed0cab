"""The launch across hosts (counterpart of tools/multihost_dryrun.py): ranks
started by ``torchrun`` on every host, each reading its place from
torchrun's ``env://`` variables, one process group over TCP, and the dp axis
of the ``(dp, elem)`` mesh spanning the hosts.

On each host a user runs::

    torchrun --nnodes H --node-rank h --nproc-per-node L \\
        --master-addr HOST0 --master-port P \\
        -m aa_admm_tpu_torch.parallel.multihost --worker dryrun|wire ...

A worker reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` (``host_env``;
torchrun numbers the ranks host-major, so the host is ``RANK //
LOCAL_WORLD_SIZE``), takes card ``LOCAL_RANK % visible cards`` and joins the
group (``init_host_rank``). No host sees the others' cards, so the ranks
publish their cards' UUIDs through the store at ``MASTER_ADDR:MASTER_PORT``
(under torchrun the agent's) before the group starts, and every rank picks
the backend by ``ensemble.card_backend`` from the same list: NCCL where no
two ranks share a card, else gloo. Then it builds ``make_mesh(world,
prefer_dp=hosts)``, checks that its dp coordinate is its host, and runs one
case:

* ``dryrun``, the JAX tool's case: the float64 tiny xzu scene as an
  ensemble of two replicas per host through ``ensemble.sharded_case`` (each
  host builds only its own replicas), each replica held to the
  single-process unsharded ``step_xzu`` at max|dx| < 1e-10, the maximum
  over all ranks gathered; then the geometry dryrun's rank
  (``geometry._dryrun_rank``: max|dx| < 1e-9, max|dfv/fv| < 1e-8). Each
  rank writes ``rank{r}.npz``; rank 0 writes ``multihost.json`` with the
  JAX artifact's keys, the backend and each rank's placement.
* ``wire``: ``geometry.wire_mesh_case`` on the scene ``--scene`` names
  (written by ``geometry.save_scene``), with ``--opts`` (its opts as JSON,
  the dtype by name).

Every rank pickles its result to ``rank{r}.pkl`` in ``--out``.

``launch`` (and ``python -m aa_admm_tpu_torch.parallel.multihost --hosts H
--ranks-per-host L [--cpu]``, which runs the dryrun) starts H such torchrun
hosts on this machine, with one free port, and returns the ranks' results.
On the cards each host sees only its own share of them
(``CUDA_VISIBLE_DEVICES``), as H real nodes would; where the cards are
fewer than the hosts, every host sees them all and the ranks share cards
through gloo.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pickle
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from .ensemble import (build_tiny_scene, card_backend, check_ranks,
                       make_mesh, rank_info, sharded_case, tiny_states)
from ..solver.physics import step_xzu

_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
         "MASTER_ADDR", "MASTER_PORT")
# the JAX tool's scene: the float64 tiny xzu beam, its admm_iters and m
DRYRUN_SPEC = dict(order="xzu", iters=3, m=3)
REPLICAS_PER_HOST = 2
_MODULE = "aa_admm_tpu_torch.parallel.multihost"
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# ---------------------------------------------------------------------------
# A rank's place
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HostEnv:
    """A rank's place as torchrun's variables give it."""
    rank: int
    world: int
    local_rank: int
    local_world: int
    master_addr: str
    master_port: int

    @property
    def host(self) -> int:
        return self.rank // self.local_world

    @property
    def n_hosts(self) -> int:
        return self.world // self.local_world


def host_env() -> HostEnv:
    """This rank's HostEnv from RANK, WORLD_SIZE, LOCAL_RANK,
    LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT. Raises ValueError naming
    the variable that is missing, not an integer, or inconsistent with the
    others (torchrun numbers the ranks host-major, every host with
    LOCAL_WORLD_SIZE of them)."""
    raw = {}
    for name in _VARS:
        val = os.environ.get(name, "")
        if not val:
            raise ValueError(f"{name} is not set (the launch across hosts "
                             f"reads {', '.join(_VARS)}, as torchrun sets "
                             f"them)")
        raw[name] = val
    num = {}
    for name in _VARS:
        if name == "MASTER_ADDR":
            continue
        try:
            num[name] = int(raw[name])
        except ValueError:
            raise ValueError(f"{name}={raw[name]!r} is not an integer") \
                from None
        if num[name] < (1 if name in ("WORLD_SIZE", "LOCAL_WORLD_SIZE",
                                      "MASTER_PORT") else 0):
            raise ValueError(f"{name}={num[name]} is out of range")
    rank, world = num["RANK"], num["WORLD_SIZE"]
    local_rank, local_world = num["LOCAL_RANK"], num["LOCAL_WORLD_SIZE"]
    if rank >= world:
        raise ValueError(f"RANK={rank} is not below WORLD_SIZE={world}")
    if world % local_world:
        raise ValueError(f"WORLD_SIZE={world} is not a multiple of "
                         f"LOCAL_WORLD_SIZE={local_world}")
    if rank % local_world != local_rank:
        raise ValueError(f"LOCAL_RANK={local_rank} is not RANK % "
                         f"LOCAL_WORLD_SIZE = {rank} % {local_world} (ranks "
                         f"are numbered host-major)")
    if num["MASTER_PORT"] > 65535:
        raise ValueError(f"MASTER_PORT={num['MASTER_PORT']} is out of range")
    return HostEnv(rank, world, local_rank, local_world, raw["MASTER_ADDR"],
                   num["MASTER_PORT"])


def card_id(device):
    """The UUID of the card `device` names, None on the CPU: the identity
    that holds across hosts and CUDA_VISIBLE_DEVICES."""
    if device.type != "cuda":
        return None
    return str(torch.cuda.get_device_properties(device).uuid)


def init_host_rank(device_type: str = "cuda"):
    """Joins this rank to the group torchrun's variables describe and places
    it: on CUDA card LOCAL_RANK % visible cards, current before any CUDA
    work; on the CPU the CPU. The ranks exchange their cards' UUIDs through
    the env:// store, so all pick one backend by card_backend before the
    group starts (NCCL with device_id bound, or gloo). One torch thread.
    Returns (HostEnv, device)."""
    env = host_env()
    torch.set_num_threads(1)
    if device_type == "cuda":
        n = torch.cuda.device_count()
        if n < 1:
            raise RuntimeError("init_host_rank: CUDA ranks need a visible "
                               "card")
        device = torch.device("cuda", env.local_rank % n)
        torch.cuda.set_device(device)            # before any CUDA work
    elif device_type == "cpu":
        device = torch.device("cpu")
    else:
        raise ValueError(f"no rank placement for device type "
                         f"{device_type!r}")
    store, _, _ = next(dist.rendezvous("env://"))
    cards = dist.PrefixStore("aaadmm_cards", store)
    cards.set(str(env.rank), card_id(device) or "")
    backend = card_backend(cards.get(str(r)).decode() or None
                           for r in range(env.world))
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, store=dist.PrefixStore("default_pg",
                                                            store),
                            rank=env.rank, world_size=env.world, **kw)
    return env, device


def host_rank_info(env: HostEnv, device) -> dict:
    """rank_info with the rank, its host, its local rank, its card's UUID,
    the cards its host sees and CUDA_VISIBLE_DEVICES."""
    return dict(rank_info(device), rank=env.rank, host=env.host,
                local_rank=env.local_rank, card=card_id(device),
                n_cards=(torch.cuda.device_count() if device.type == "cuda"
                         else 0),
                visible=os.environ.get("CUDA_VISIBLE_DEVICES"))


def check_host_placement(infos):
    """Raises unless the ranks' host_rank_info (in rank order) show the
    placement init_host_rank gives: each rank on card local_rank % its
    host's cards (the CPU without one), current, and the backend
    card_backend gives for their UUIDs (under NCCL all distinct)."""
    for r, info in enumerate(infos):
        if info["rank"] != r:
            raise RuntimeError(f"placement {r} is rank {info['rank']}'s")
    devices = [torch.device("cpu") if i["card"] is None else
               torch.device("cuda", i["local_rank"] % i["n_cards"])
               for i in infos]
    check_ranks(infos, card_backend(i["card"] for i in infos), devices)


# ---------------------------------------------------------------------------
# The worker
# ---------------------------------------------------------------------------

def _dryrun_case(env: HostEnv, device, out: str) -> dict:
    """The JAX tool's case on this rank (module docstring)."""
    from .geometry import _dryrun_rank as geometry_rank
    from .geometry import _geometry_summary
    S = REPLICAS_PER_HOST * env.n_hosts
    spec = dict(DRYRUN_SPEC, prefer_dp=env.n_hosts, scenes=S)
    small = sharded_case(env.rank, env.world, device, spec, out)
    with np.load(os.path.join(out, f"rank{env.rank}.npz")) as z:
        scenes, xs_sh = z["scenes"], z["x"]
    mine = slice(int(scenes[0]), int(scenes[-1]) + 1)
    solver, _ = build_tiny_scene("xzu", "float64", spec["iters"], spec["m"],
                                 device=device)
    xs, vs, pps = tiny_states(solver, S, scenes=mine)
    max_dx = 0.0
    for i in range(len(scenes)):
        x, _, _ = step_xzu(solver.system, xs[i], vs[i], pps[i])
        max_dx = max(max_dx, float(np.abs(x.cpu().numpy() - xs_sh[i]).max()))
    if not max_dx < 1e-10:
        raise RuntimeError(f"rank {env.rank}: its replicas {scenes.tolist()} "
                           f"differ from the single-process step by "
                           f"max|dx| {max_dx:.3e}")
    geo = geometry_rank(env.rank, env.world, device)
    mine_info = dict(host_rank_info(env, device), dp_rank=small["dp_rank"],
                     elem_rank=small["elem_rank"], scenes=scenes.tolist(),
                     max_dx=max_dx, geometry=geo)
    ranks = [None] * env.world
    dist.all_gather_object(ranks, mine_info)
    out_d = dict(mine_info)
    if env.rank == 0:
        check_host_placement(ranks)
        summary = {
            "multihost": "ok", "n_processes": env.n_hosts,
            "devices_per_process": env.local_world,
            "mesh": f"dp {env.n_hosts} (across hosts) x elem "
                    f"{env.local_world}",
            "max_dx_vs_single_process": max(r["max_dx"] for r in ranks),
            "checked_shards_per_process": env.local_world *
            REPLICAS_PER_HOST,
            "geometry": _geometry_summary([r["geometry"] for r in ranks],
                                          env.world),
            "backend": ranks[0]["backend"],
            "ranks": [{k: r[k] for k in ("rank", "host", "local_rank",
                                         "device", "card", "visible",
                                         "backend")} for r in ranks]}
        with open(os.path.join(out, "multihost.json"), "w") as f:
            json.dump(summary, f, indent=1)
        print(json.dumps(summary), flush=True)
        out_d["summary"] = summary
    return out_d


def _wire_case(env: HostEnv, device, scene_path: str, opts: dict) -> dict:
    from .geometry import load_scene, wire_mesh_case
    opts = dict(opts)
    if "dtype" in opts:
        opts["dtype"] = np.dtype(opts["dtype"])
    out = wire_mesh_case(env.rank, env.world, device, load_scene(scene_path),
                         opts)
    return dict(out, **host_rank_info(env, device))


def worker(case: str, out: str, device_type: str = "cuda", scene=None,
           opts=None) -> dict:
    """One rank of `case` ("dryrun" or "wire") under torchrun's variables:
    joins the group (init_host_rank), checks that its dp coordinate on
    make_mesh(world, prefer_dp=hosts) is its host, runs the case and
    pickles its result to out/rank{r}.pkl (the traceback to
    out/rank{r}.err when it raises). Returns the result."""
    os.makedirs(out, exist_ok=True)
    rank = os.environ.get("RANK", "?")
    try:
        env, device = init_host_rank(device_type)
        try:
            t_case = time.time()
            mesh = make_mesh(env.world, prefer_dp=env.n_hosts)
            dpr = mesh["dp"].get_local_rank()
            if dpr != env.host:
                raise RuntimeError(f"rank {env.rank} of host {env.host} has "
                                   f"dp coordinate {dpr}: dp does not span "
                                   f"the hosts")
            if case == "dryrun":
                res = _dryrun_case(env, device, out)
            elif case == "wire":
                res = _wire_case(env, device, scene, opts or {})
            else:
                raise ValueError(f"no case {case!r}")
            res.update(dp_coord=dpr, case_start=t_case)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(out, f"rank{env.rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        return res
    except BaseException:
        with open(os.path.join(out, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def free_port() -> int:
    """A TCP port on 127.0.0.1 free when asked (bound to port 0)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def host_cards(n_hosts: int, cards) -> list:
    """CUDA_VISIBLE_DEVICES of each of n_hosts hosts on this machine's
    `cards` (their names as the caller sees them): contiguous equal shares
    when there are at least as many cards as hosts, as on real nodes; else
    every host sees them all."""
    cards = [str(c) for c in cards]
    per = len(cards) // n_hosts
    if per == 0:
        return [",".join(cards)] * n_hosts
    return [",".join(cards[h * per:(h + 1) * per]) for h in range(n_hosts)]


def _visible_cards() -> list:
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env:
        return env.split(",")
    return list(range(torch.cuda.device_count()))


def _launch_pids(out: str) -> list:
    """Live processes whose arguments name this launch's output directory
    (its torchrun agents and their workers)."""
    pids = []
    for d in os.listdir("/proc"):
        if not d.isdigit() or int(d) == os.getpid():
            continue
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                args = f.read().split(b"\0")
        except OSError:
            continue
        if _MODULE.encode() in args and out.encode() in args:
            pids.append(int(d))
    return pids


def _tail(path: str, n: int = 3000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return ""


def launch(n_hosts: int, ranks_per_host: int, case: str = "dryrun",
           device=None, timeout: float = 600.0, out=None,
           **case_args) -> list:
    """`case` on n_hosts simulated hosts of ranks_per_host ranks each: one
    ``python -m torch.distributed.run`` per host on 127.0.0.1 and a free
    port, each host's output in out/host{h}.log. `device` (default the
    card) names the device type; on CUDA each host sees its share of the
    cards (host_cards). case_args: "wire" takes scene (wire_mesh_case's
    dict, handed over as out/scene.npz) and opts. `out` (default a
    temporary directory, removed at the end) keeps the ranks' files.
    Returns the ranks' results in rank order. Raises, with each failed
    rank's traceback (the first to fail first), when a host fails or the
    hosts have not all ended within `timeout` seconds; every process of the
    launch is then killed."""
    dev_type = resolve_device(device).type
    keep = out is not None
    out = os.path.abspath(out if keep else
                          tempfile.mkdtemp(prefix="aaadmm_hosts_"))
    os.makedirs(out, exist_ok=True)
    for f in os.listdir(out):     # an earlier launch's results and errors
        if f.startswith("rank") and f.endswith((".pkl", ".err")):
            os.remove(os.path.join(out, f))
    args = ["--worker", case, "--out", out]
    if dev_type == "cpu":
        args.append("--cpu")
    if case == "wire":
        from .geometry import save_scene
        scene = os.path.join(out, "scene.npz")
        save_scene(scene, case_args.pop("scene"))
        opts = dict(case_args.pop("opts", {}))
        if "dtype" in opts:
            opts["dtype"] = np.dtype(opts["dtype"]).name
        args += ["--scene", scene, "--opts", json.dumps(opts)]
    if case_args:
        raise TypeError(f"launch: {case!r} takes no {sorted(case_args)}")
    port = free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO, env.get("PYTHONPATH")) if p)
    visible = host_cards(n_hosts, _visible_cards()) if dev_type == "cuda" \
        else [None] * n_hosts
    procs, logs = [], []
    deadline = time.monotonic() + timeout
    try:
        for h in range(n_hosts):
            host_env_h = dict(env)
            if visible[h] is not None:
                host_env_h["CUDA_VISIBLE_DEVICES"] = visible[h]
            log = open(os.path.join(out, f"host{h}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run",
                 "--nnodes", str(n_hosts), "--node-rank", str(h),
                 "--nproc-per-node", str(ranks_per_host),
                 "--master-addr", "127.0.0.1", "--master-port", str(port),
                 "-m", _MODULE, *args],
                env=host_env_h, cwd=_REPO, stdout=log,
                stderr=subprocess.STDOUT, start_new_session=True))
        while True:
            codes = [p.poll() for p in procs]
            failed = [h for h, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                errs = sorted((f for f in os.listdir(out)
                               if f.endswith(".err")),
                              key=lambda f: os.path.getmtime(
                                  os.path.join(out, f)))
                text = "\n".join(f"{f}:\n{_tail(os.path.join(out, f))}"
                                 for f in errs) or "\n".join(
                    f"host{h}.log:\n{_tail(os.path.join(out, f'host{h}.log'))}"
                    for h in failed)
                raise RuntimeError(f"launch: host(s) {failed} failed (exit "
                                   f"codes {[codes[h] for h in failed]}):\n"
                                   f"{text}")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"launch: {codes.count(None)} of "
                                   f"{n_hosts} hosts still running after "
                                   f"{timeout} s")
            time.sleep(0.2)
        results = []
        for r in range(n_hosts * ranks_per_host):
            with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for pid in _launch_pids(out):
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        for p in procs:
            p.wait()
        for log in logs:
            log.close()
        if not keep:
            shutil.rmtree(out, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m " + _MODULE,
        description="Without --worker: the dryrun on --hosts simulated hosts "
                    "of --ranks-per-host torchrun ranks on this machine. "
                    "With --worker: one rank, under torchrun.")
    ap.add_argument("--worker", choices=("dryrun", "wire"))
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--ranks-per-host", type=int, default=2)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=os.path.join("result", "multihost"))
    ap.add_argument("--scene", help="wire: the scene's .npz (save_scene)")
    ap.add_argument("--opts", default="{}",
                    help="wire: wire_mesh_case's opts as JSON")
    a = ap.parse_args(argv)
    dev = "cpu" if a.cpu else "cuda"
    if a.worker:
        worker(a.worker, os.path.abspath(a.out), dev, a.scene,
               json.loads(a.opts))
        return 0
    ranks = launch(a.hosts, a.ranks_per_host, "dryrun", device=dev,
                   out=a.out)
    print(json.dumps(ranks[0]["summary"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
