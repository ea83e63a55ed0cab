"""BENCHMARK.json against the benchmark's contract, and every name it holds
found as a file: configurations, mixes, checks, drivers, metric readers."""

import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_paths(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert all(PATH.match(p) and ".." not in p for p in bench["paths"])
    cmd = bench["command"]
    assert len(cmd) <= 32 and cmd[1].startswith("portbench/")
    assert os.path.isfile(os.path.join(ROOT, cmd[1]))
    assert isinstance(bench["run_seconds"], int) and \
        1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 seconds
    n = 24
    total = (2 + 14 * n) * (bench["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_lines(bench):
    entries = (bench["configs"] + bench["workloads"] + bench["end_to_end"]
               + bench["per_layer"])
    names = [e["name"] for e in entries if "unit" in e]
    assert len(names) == len(set(names))
    lines = [e[k] for e in entries for k in ("why", "layer") if k in e]
    lines += [c["source"] for c in bench["configs"]] + bench["command"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for line in lines:
        assert 1 <= len(line) <= 200 and "\n" not in line \
            and "\t" not in line, line
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert len(json.dumps(bench)) <= 64 * 1024


def test_cells(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        assert w["chips"] == 1
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert NAME.match(w["traffic"])
        c = configs[w["config"]]
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        cfg = run.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["reduced"] == c["reduced"]
        assert os.path.isfile(os.path.join(ROOT, "portbench", "drivers",
                                           cfg["driver"] + ".py"))
        for sub, name in (("mixes", w["traffic"]), ("checks", w["name"])):
            assert os.path.isfile(os.path.join(ROOT, "portbench", sub,
                                               name + ".json"))
    used = {w["config"] for w in bench["workloads"]}
    assert used == set(configs)


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert os.path.isfile(os.path.join(ROOT, "portbench", "metrics",
                                           m["name"] + ".py"))
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert m["moves"] in [x["name"] for x in
                                  run.metrics_for(bench, w, "end_to_end")]
    for w in bench["workloads"]:
        e = [m["name"] for m in run.metrics_for(bench, w["name"],
                                                "end_to_end")]
        assert "setup_s" in e and len(e) >= 2
        assert run.metrics_for(bench, w["name"], "per_layer")


def test_readers_load(bench):
    for m in bench["per_layer"]:
        assert callable(run.reader(ROOT, m["name"]))


def test_forbidden_modules_compares_whole_names():
    mods = {"jax": 1, "jax.numpy": 1, "jaxlib": 1, "flax.linen": 1,
            "aa_admm_tpu": 1, "aa_admm_tpu.ops": 1, "aa_admm_tpu_torch": 1,
            "aa_admm_tpu_torch.ops": 1, "jaxtyping": 1, "numpy": 1}
    assert run.forbidden_modules(mods) == sorted(
        ["jax", "jax.numpy", "jaxlib", "flax.linen", "aa_admm_tpu",
         "aa_admm_tpu.ops"])


def test_harness_and_program_load_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.run as r, portbench.calibrate, portbench.faults\n"
            "import portbench.drivers.geometry, portbench.drivers.physics\n"
            "import aa_admm_tpu_torch.apps.beams\n"
            "import aa_admm_tpu_torch.solver.geometry\n"
            "import aa_admm_tpu_torch.ops.constraints\n"
            "print(r.forbidden_modules())\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_chip_no_result(tmp_path):
    """Without a CUDA device (or without the program) a run exits non-zero
    and prints nothing on standard output."""
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", "wiremesh-maletorso-cold", "--seed", "3",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""
