"""The port's program spans laid on a torch.profiler trace, and one cell's
traced passes with the spans recorded:

    python3 portbench/spans.py --workload NAME --seed N [--units K]

The port records spans while ``aa_admm_tpu_torch.core.timers.recording()``
is open: (name, start, end, parent, request), on the host's clock, moved
onto the profiler's (Unix-epoch) clock by the recording's anchor pair. Here
the profiler's device events are assigned to spans through their
correlation ids: a kernel (or copy) belongs to the innermost span that holds
the start of the runtime call that launched it (``cudaLaunchKernel``,
``cudaGraphLaunch``, ``cudaMemcpyAsync``, ...: every kernel of a graph
shares its launch's id), and each idle gap of the device to the innermost
span that holds its middle. ``trace.summarize`` and the readers of the
benchmark's other per-layer metrics are left as they are.

The command sets the cell up with spans recorded, runs ``--units`` units
(the mix's ``trace_units`` by default) untraced, the mix's ``trace_units``
under torch.profiler (the device alone, as ``run.py --trace 1`` traces it)
with spans recorded, then ``--units`` with spans recorded and no profiler:
the host's times are read there, as the profiler slows the host. It prints
one JSON line: the span readers' values (``metrics/<name>.py`` of
``READERS``, each given a context whose ``spans`` is a ``SpanSummary``),
the device time that no span holds, whether each unit's ``sync`` spans
equal the host reads its solver counted, and what recording costs: the
third pass's wall per unit of work (trial or frame) over the untraced
pass's, and over ``--units`` further pairs of units, one recorded and one
not, in turns. It replays nothing through the reference: ``run.py``
decides ``correct``.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import importlib
import json
import os
import sys
import time
from collections import Counter
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import run, trace  # noqa: E402

# The per-layer metrics that read program spans (files in metrics/).
READERS = ("alm.solve_work_ms", "alm.energy_device_ms",
           "alm.host_issue_ms_per_trial", "local.device_ms_per_trial",
           "global.device_ms_per_trial", "device.idle.alm_solve_work",
           "physics.local_device_ms_per_iter", "physics.comb_device_share",
           "physics.host_issue_ms_per_iter", "setup.program_s")


def from_profiler(prof):
    """(name, on_device, start_s, end_s, correlation id) of every event of a
    finished profile; as ``trace.from_profiler``, the device-side copies of
    host annotations are left out."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = str(e.device_type()).endswith("CUDA")
        if dev and e.is_user_annotation():
            continue
        start = e.start_ns() * 1e-9
        out.append((e.name(), dev, start, start + e.duration_ns() * 1e-9,
                    e.correlation_id()))
    return out


def in_seconds(spans):
    """Spans of ``SpanRecorder.profiler_spans()`` with times in seconds."""
    return [(n, s * 1e-9, e * 1e-9, p, r) for n, s, e, p, r in spans]


def innermost(spans, starts, t):
    """Index of the innermost span that holds time t, or None. Spans nest
    and are in the order they opened (starts ascending): the innermost
    holder is the latest-opened span before t or one of its ancestors."""
    i = bisect.bisect_right(starts, t) - 1
    while i is not None and i >= 0:
        if spans[i][2] >= t:
            return i
        i = spans[i][3]
    return None


@dataclasses.dataclass
class Assignment:
    """A profiled pass's device time and idle time per span. ``device_s``
    and ``idle_s`` are inclusive (a span's own and its descendants'), one
    entry per span; the totals are over the whole pass."""
    spans: list
    device_s: list
    idle_s: list
    device_total_s: float
    unassigned_device_s: float
    idle_total_s: float
    unassigned: dict          # kernel name -> device seconds held by no span
    early: int = 0            # device events that start before their launch
    lead_s: float = 0.0       # the most by which one does: the gaps' shift

    def total(self, name, what="device_s"):
        """Inclusive device (or idle) seconds of the spans named `name`,
        each counted once (a span inside another of its name adds
        nothing)."""
        vals = getattr(self, what)
        return sum(vals[i] for i in topmost(self.spans, name))

    def count(self, name):
        return count(self.spans, name)


def topmost(spans, name):
    """Indices of the spans named `name` with no ancestor of that name."""
    out = []
    for i, s in enumerate(spans):
        if s[0] != name:
            continue
        p = s[3]
        while p is not None and spans[p][0] != name:
            p = spans[p][3]
        if p is None:
            out.append(i)
    return out


def _roll_up(spans, own):
    """Inclusive sums from per-span own sums (children follow parents)."""
    inc = list(own)
    for i in range(len(spans) - 1, -1, -1):
        p = spans[i][3]
        if p is not None:
            inc[p] += inc[i]
    return inc


def assign(events, spans, lo, hi):
    """Assign a profiled pass's device events and idle gaps to its spans
    (both on the profiler's clock, in seconds; [lo, hi] the pass's window).
    A device event goes to the innermost span that holds the start of the
    host call with its correlation id; with no such call or span it is
    unassigned. An idle gap (between the device events' union, inside
    [lo, hi]) goes to the innermost span that holds its middle. Where the
    trace puts device events before the calls that launched them (the
    device's timestamps are converted onto the host's clock, and the H100
    has read up to 4.2 ms early), the device's times are moved later by the
    largest such lead before the gaps are taken: the least shift that
    starts every event after its launch."""
    starts = [s[1] for s in spans]
    launch = {}
    for name, dev, s, _, corr in events:
        if not dev and corr and name.startswith("cu"):
            launch.setdefault(corr, s)
    dev_events = [(n, s, e, c) for n, d, s, e, c in events if d]
    leads = [launch[c] - s for _, s, _, c in dev_events if c in launch]
    early = sum(1 for x in leads if x > 0)
    lead = max([0.0] + leads)
    where = {}
    own_dev = [0.0] * len(spans)
    unassigned, total, loose = Counter(), 0.0, 0.0
    intervals = []
    for name, s, e, corr in dev_events:
        intervals.append((s + lead, e + lead))
        total += e - s
        if corr not in where:
            t = launch.get(corr)
            where[corr] = None if t is None else innermost(spans, starts, t)
        i = where[corr]
        if i is None:
            loose += e - s
            unassigned[name] += e - s
        else:
            own_dev[i] += e - s
    own_idle = [0.0] * len(spans)
    idle = 0.0
    for a, b in trace.gaps(intervals, lo, hi):
        idle += b - a
        i = innermost(spans, starts, 0.5 * (a + b))
        if i is not None:
            own_idle[i] += b - a
    return Assignment(spans=spans, device_s=_roll_up(spans, own_dev),
                      idle_s=_roll_up(spans, own_idle),
                      device_total_s=total, unassigned_device_s=loose,
                      idle_total_s=idle, unassigned=dict(unassigned),
                      early=early, lead_s=lead)


def outside(spans, name, inner):
    """For each span named `name`: its duration less that of its
    descendants named `inner` (the outermost of them), in the spans'
    unit of time."""
    covered = [0.0] * len(spans)
    for i in topmost(spans, inner):
        p = spans[i][3]
        d = spans[i][2] - spans[i][1]
        while p is not None:
            covered[p] += d
            p = spans[p][3]
    return [spans[i][2] - spans[i][1] - covered[i]
            for i in range(len(spans)) if spans[i][0] == name]


def count(spans, name):
    return sum(1 for s in spans if s[0] == name)


@dataclasses.dataclass
class SpanSummary:
    """What the span readers read: the set-up's spans, the third (host)
    pass's spans, and the profiled pass's Assignment (None without device
    events: on the CPU). Host spans are on the host's clock, in ns."""
    setup: list
    host: list
    profiled: Assignment = None


def sync_matches(spans, root, reads):
    """Per unit, (sync spans under its root, host reads its solver
    counted): the units' roots are the root spans named `root`, in order;
    `reads` the per-unit counts."""
    out = []
    idx = [i for i, s in enumerate(spans) if s[3] is None and s[0] == root]
    for k, r in zip(idx, reads):
        req = spans[k][4]
        n = sum(1 for s in spans if s[0] == "sync" and s[4] == req)
        out.append((n, r))
    return out


def run_spans(bench, workload, seed, device, units=None, overrides=None):
    """Set up the cell and run its three passes (see the module's
    docstring); returns the result dict."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from aa_admm_tpu_torch.core import timers

    w, c = run.cell(bench, workload)
    o = overrides or {}
    cfg = o.get("config") or run.load_json(os.path.join(ROOT, c["file"]))
    mix = o.get("mix") or run.load_json(
        os.path.join(ROOT, "portbench", "mixes", w["traffic"] + ".json"))
    chk = o.get("check") or run.load_json(
        os.path.join(ROOT, "portbench", "checks", workload + ".json"))
    drv = importlib.import_module("portbench.drivers." + cfg["driver"])
    driver = drv.Driver(cfg, mix, chk, seed, device)
    on_gpu = torch.device(device).type == "cuda"

    def sync():
        if on_gpu:
            torch.cuda.synchronize()

    n_prof = int(mix["trace_units"])
    n = int(units or n_prof)

    # a unit's work: its trials (a solve's vary with the request), or one
    # frame
    work_key = "trials" if "trials" in driver.counters else "frames"

    def units_pass(n):
        """(wall s, work, per-unit host reads) of n units."""
        reads, w0 = [], driver.counters[work_key]
        t0 = time.perf_counter()
        for _ in range(n):
            r0 = driver.counters["host_reads"]
            driver.unit()
            reads.append(driver.counters["host_reads"] - r0)
        sync()
        return (time.perf_counter() - t0, driver.counters[work_key] - w0,
                reads)

    def cost_pairs(n):
        """Recording's cost: n pairs of units, one recorded and one not,
        in turns; the recorded units' wall per unit of work over the
        others', less 1."""
        wall, work = [0.0, 0.0], [0, 0]
        for k in range(n):
            for on in ((False, True) if k % 2 == 0 else (True, False)):
                if on:
                    with timers.recording():
                        t, w, _ = units_pass(1)
                else:
                    t, w, _ = units_pass(1)
                wall[on] += t
                work[on] += w
        return (wall[1] / work[1]) / (wall[0] / work[0]) - 1.0

    with timers.recording() as rec:
        driver.setup()
        sync()
    setup = rec.spans
    untraced_s, untraced_work, _ = units_pass(n)
    acts = [ProfilerActivity.CUDA if on_gpu else ProfilerActivity.CPU]
    with timers.recording() as rec_p:
        with profile(activities=acts) as prof:
            lo = time.perf_counter_ns()
            _, _, reads_p = units_pass(n_prof)
            hi = time.perf_counter_ns()
    with timers.recording() as rec_h:
        host_s, host_work, reads_h = units_pass(n)
    cost = cost_pairs(n)
    driver.release()

    shift = rec_p.anchor_ns[1] - rec_p.anchor_ns[0]
    events = from_profiler(prof)
    spans_p = in_seconds(rec_p.profiler_spans())
    profiled = None
    if any(d for _, d, _, _, _ in events):
        profiled = assign(events, spans_p, (lo + shift) * 1e-9,
                          (hi + shift) * 1e-9)
    summary = SpanSummary(setup=setup, host=rec_h.spans, profiled=profiled)
    ctx = SimpleNamespace(spans=summary, counters={}, trace=None,
                          problem=dict(getattr(driver, "problem", {})))
    metrics = {}
    for name in READERS:
        v = run.reader(ROOT, name)(ctx)
        if v is not None:
            metrics[name] = v
    root = "step" if cfg["driver"] == "physics" else "solve"
    matches = (sync_matches(rec_p.spans, root, reads_p)
               + sync_matches(rec_h.spans, root, reads_h))
    out = dict(workload=workload, seed=seed, units=n, profiled_units=n_prof,
               metrics=metrics,
               untraced_s=untraced_s, recorded_s=host_s,
               third_pass_over_untraced=(host_s / host_work)
               / (untraced_s / untraced_work) - 1.0,
               recording_cost=cost,
               sync_vs_host_reads=matches,
               sync_equals_host_reads=bool(matches) and all(
                   a == b for a, b in matches))
    if profiled is not None:
        busy = trace.union_length(
            [(s, e) for _, d, s, e, _ in events if d], -1e30, 1e30)
        top = sorted(profiled.unassigned.items(), key=lambda kv: -kv[1])
        out.update(device_s=profiled.device_total_s, busy_s=busy,
                   unassigned_device_s=profiled.unassigned_device_s,
                   device_before_launch=profiled.early,
                   device_shift_s=profiled.lead_s,
                   unassigned_top=[[k, v] for k, v in top[:10]])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--units", type=int, default=None)
    args = ap.parse_args(argv)
    out = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    run.cache_env(ROOT)
    bench = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    import torch
    if not torch.cuda.is_available():
        print("portbench: spans.py needs a CUDA device", file=sys.stderr)
        return 3
    res = run_spans(bench, args.workload, args.seed, "cuda", args.units)
    res["card"] = run.card_line()
    out.write(json.dumps(res) + "\n")
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
