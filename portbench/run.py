"""Run one cell of the port's benchmark once, on the GPU it is started on:

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Set-up (scene, solver, warm-up of every shape the cell uses) counts in
``setup_s``, from the start of this process to the first timed unit. Then
units (requests or frames) run back to back until ``--seconds`` have
passed; the window ends with the unit in flight. With ``--trace 1`` a fixed
number of units runs untraced and then as many again under torch.profiler
instead, and the result carries the cell's per-layer metrics. After the window the program's state is
freed and a sample of what it produced is replayed through the plain
reference: ``correct`` says whether every number compared lies within its
limit. The program's own prints go to standard error; the last line of
standard output is the result, one JSON object.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

PROGRAM = "aa_admm_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "aa_admm_tpu")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name, compared whole, is jax, jaxlib,
    flax or the JAX package."""
    modules = sys.modules if modules is None else modules
    return sorted(n for n in modules if n.split(".")[0] in FORBIDDEN)


def cache_env(root):
    """Every build and kernel cache inside the checkout, at fixed paths (the
    port builds its kernels into its own ``build/`` there)."""
    cache = os.path.join(root, ".portbench_cache")
    env = dict(TRITON_CACHE_DIR="triton", TORCH_EXTENSIONS_DIR="extensions",
               CUDA_CACHE_PATH="cuda")
    for key, sub in env.items():
        os.environ[key] = os.path.join(cache, sub)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell(bench, workload):
    """(the workload's entry, its configuration's entry)."""
    w = {x["name"]: x for x in bench["workloads"]}.get(workload)
    if w is None:
        raise SystemExit(f"unknown workload {workload!r}")
    c = {x["name"]: x for x in bench["configs"]}[w["config"]]
    return w, c


def metrics_for(bench, workload, kind):
    """The cell's end_to_end or per_layer entries: those that list it, and
    those without a list that it reports (per-layer: that move an
    end-to-end metric the cell reports)."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in names
                                 else [])]


def reader(root, name):
    """The per-layer metric's reader: ``metrics/<name>.py``'s read(ctx)."""
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Context:
    """What a per-layer reader reads: the driver's counters over the traced
    units, the trace's summary and the problem's sizes."""

    def __init__(self, counters, trace, problem):
        self.counters, self.trace, self.problem = counters, trace, problem


def card_line():
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def run_cell(bench, workload, seed, seconds, trace, device, overrides=None):
    """Set up, run the window, check. Returns (result dict, the compared
    numbers [(name, reading, limit)]). `overrides` may replace the loaded
    config, mix or check dicts (the tests' tiny cells)."""
    import torch

    from portbench import trace as tr

    w, c = cell(bench, workload)
    o = overrides or {}
    cfg = o.get("config") or load_json(os.path.join(ROOT, c["file"]))
    mix = o.get("mix") or load_json(
        os.path.join(ROOT, "portbench", "mixes", w["traffic"] + ".json"))
    chk = o.get("check") or load_json(
        os.path.join(ROOT, "portbench", "checks", workload + ".json"))
    drv = importlib.import_module("portbench.drivers." + cfg["driver"])
    driver = drv.Driver(cfg, mix, chk, seed, device)
    on_gpu = torch.device(device).type == "cuda"

    def sync():
        if on_gpu:
            torch.cuda.synchronize()

    t_imports = time.perf_counter() - T_START
    driver.setup()
    sync()
    if on_gpu:
        torch.cuda.reset_peak_memory_stats()
    summary = None
    t0 = time.perf_counter()
    setup_s = t0 - T_START
    print(f"portbench: setup {setup_s:.3f} s, of it imports and files "
          f"{t_imports:.3f} s", file=sys.stderr)
    if trace:
        # the same number of units untraced, then traced: the profiler
        # slows the host, which sets the pace of these cells, so the idle
        # share is read against the untraced units' wall time; only the
        # device's activity is traced
        from torch.profiler import ProfilerActivity, profile
        n_units = int(mix["trace_units"])
        t1 = time.perf_counter()
        for _ in range(n_units):
            driver.unit()
        sync()
        untraced_s = time.perf_counter() - t1
        acts = [ProfilerActivity.CUDA if on_gpu else ProfilerActivity.CPU]
        before = dict(driver.counters)
        with profile(activities=acts) as prof:
            t1 = time.perf_counter()
            for _ in range(n_units):
                driver.unit()
            sync()
            traced_s = time.perf_counter() - t1
        summary = tr.summarize(tr.from_profiler(prof), traced_s, untraced_s)
        # the per-layer readers read the traced units' counts alone
        traced_counts = {k: v - before[k] for k, v in driver.counters.items()}
    else:
        while True:
            driver.unit()
            if time.perf_counter() - t0 >= seconds:
                break
    sync()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_gpu else 0
    attempted = len(driver.latencies)
    values = driver.end_to_end(wall)
    values["setup_s"] = setup_s
    counters = traced_counts if trace else dict(driver.counters)
    problem = dict(driver.problem)
    driver.release()
    gc.collect()
    if on_gpu:
        torch.cuda.empty_cache()

    checks, failed = driver.check()
    checks = [(n, float(v), float(lim)) for n, v, lim in checks]
    correct = bool(checks) and all(v <= lim for _, v, lim in checks)

    metrics = {}
    if trace:
        ctx = Context(counters, summary, problem)
        for m in metrics_for(bench, workload, "per_layer"):
            v = reader(ROOT, m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
    else:
        for m in metrics_for(bench, workload, "end_to_end"):
            if m["name"] in values:
                metrics[m["name"]] = dict(value=values[m["name"]],
                                          unit=m["unit"])
    dev = dict(platform="gpu" if on_gpu else device,
               kind=torch.cuda.get_device_name(0) if on_gpu else device,
               count=int(w["chips"]), memory_peak_bytes=int(peak))
    result = dict(correct=correct, attempted=attempted, failed=failed,
                  metrics=metrics, device=dev)
    if summary is not None:
        dev["busy_s"], dev["window_s"] = summary.busy_s, summary.window_s
        result["breakdown"] = dict(device_ops=summary.device_ops,
                                   idle_gaps=summary.idle_gaps)
    return result, checks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the result goes to the real standard output; everything else,
    # the program's prints included, to standard error
    out = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    sys.stdout = sys.stderr

    cache_env(ROOT)
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    w, _ = cell(bench, args.workload)
    if importlib.util.find_spec(PROGRAM) is None:
        print(f"portbench: the program {PROGRAM} is not in this checkout",
              file=sys.stderr)
        return 4
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(w["chips"]):
        print(f"portbench: the cell needs {w['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result, checks = run_cell(bench, args.workload, args.seed, args.seconds,
                              args.trace, "cuda")
    print(f"portbench: {card_line()}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package are loaded: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 5
    result["checks"] = {n: dict(value=v, limit=lim) for n, v, lim in checks}
    for n, v, lim in checks:
        print(f"check {n} {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    out.write(json.dumps(result) + "\n")
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
