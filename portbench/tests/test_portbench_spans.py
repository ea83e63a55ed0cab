"""The span reduction on synthetic traces (device events assigned through
their correlation ids to the innermost program span, a graph's kernels
through one launch, idle gaps by their middle, events outside every span),
each span reader's value and its silence where it finds nothing, and a
tiny CPU run of each cell's traced passes with spans recorded."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from portbench import run, spans  # noqa: E402
from test_portbench_runs import BENCH, WIRE, tiny  # noqa: E402


def solve_spans():
    """One solve: (name, start_s, end_s, parent, request)."""
    return [
        ("solve", 0.0, 10.0, None, 0),           # 0
        ("solve.energy", 0.4, 1.5, 0, 0),        # 1
        ("alm.loop", 2.0, 8.0, 0, 0),            # 2
        ("local", 2.1, 3.0, 2, 0),               # 3
        ("sync", 2.5, 2.9, 3, 0),                # 4
        ("global", 3.0, 5.0, 2, 0),              # 5
        ("sync", 4.5, 4.9, 5, 0),                # 6
        ("solve.energy", 8.5, 9.5, 0, 0),        # 7
    ]


def solve_events():
    """(name, on_device, start_s, end_s, correlation id)."""
    return [
        ("cudaLaunchKernel", False, 0.6, 0.61, 1),
        ("topk", True, 1.0, 1.4, 1),                  # solve.energy
        ("cudaLaunchKernel", False, 2.2, 2.21, 2),
        ("b1", True, 2.3, 2.6, 2),                    # local
        ("cudaMemcpyAsync", False, 2.6, 2.7, 3),
        ("Memcpy DtoH", True, 2.6, 2.7, 3),           # sync in local
        ("cudaGraphLaunch", False, 3.1, 3.11, 4),
        ("k1", True, 3.2, 3.6, 4),                    # one graph: global
        ("k2", True, 3.6, 4.0, 4),
        ("cudaLaunchKernel", False, 9.8, 9.81, 5),
        ("tail", True, 9.8, 9.9, 5),                  # solve itself
        ("cudaLaunchKernel", False, 10.5, 10.51, 6),
        ("late", True, 10.5, 10.6, 6),                # launched outside
        ("orphan", True, 10.7, 10.8, 7),              # no launch seen
    ]


def test_innermost_and_topmost():
    s = solve_spans()
    starts = [x[1] for x in s]
    assert spans.innermost(s, starts, 2.6) == 4
    assert spans.innermost(s, starts, 2.95) == 3
    assert spans.innermost(s, starts, 6.0) == 2      # past local and global
    assert spans.innermost(s, starts, 9.7) == 0
    assert spans.innermost(s, starts, 10.2) is None
    assert spans.innermost(s, starts, -1.0) is None
    nested = [("a", 0, 9, None, 0), ("a", 1, 2, 0, 0), ("a", 10, 11, None, 1)]
    assert spans.topmost(nested, "a") == [0, 2]


def test_device_events_go_to_the_innermost_launching_span():
    a = spans.assign(solve_events(), solve_spans(), 0.0, 11.0)
    assert a.device_total_s == pytest.approx(1.9)
    assert a.total("solve.energy") == pytest.approx(0.4)
    assert a.total("sync") == pytest.approx(0.1)
    assert a.total("local") == pytest.approx(0.4)    # with its sync's copy
    # both kernels of the graph follow its one cudaGraphLaunch
    assert a.total("global") == pytest.approx(0.8)
    assert a.total("alm.loop") == pytest.approx(1.2)
    assert a.total("solve") == pytest.approx(1.7)
    # launched after every span, or with no launch in the trace
    assert a.unassigned_device_s == pytest.approx(0.2)
    assert set(a.unassigned) == {"late", "orphan"}
    assert a.count("solve") == 1 and a.count("sync") == 2
    assert a.early == 0 and a.lead_s == 0.0    # every kernel after launch


def test_idle_gaps_go_to_the_span_at_their_middle():
    a = spans.assign(solve_events(), solve_spans(), 0.0, 11.0)
    # gaps: 0-1.0 (energy), 1.4-2.3 (solve), 2.7-3.2 (local), 4.0-9.8
    # (alm.loop), 9.9-10.5, 10.6-10.7, 10.8-11 (no span)
    assert a.idle_total_s == pytest.approx(9.1)
    assert a.total("solve.energy", "idle_s") == pytest.approx(1.0)
    assert a.total("local", "idle_s") == pytest.approx(0.5)
    assert a.total("alm.loop", "idle_s") == pytest.approx(6.3)
    assert a.total("solve", "idle_s") == pytest.approx(8.2)


def test_gaps_follow_a_device_clock_that_reads_early():
    """A kernel stamped 0.3 s before its launch moves the device's times
    (and so its gaps) 0.3 s later; device seconds and their spans stay."""
    ev = [e if e[0] != "b1" else ("b1", True, 1.9, 2.2, 2)
          for e in solve_events()]
    a = spans.assign(ev, solve_spans(), 0.0, 11.2)
    assert a.early == 1 and a.lead_s == pytest.approx(0.3)
    assert a.total("local") == pytest.approx(0.4)
    # the energy's kernel now ends at 1.7: the gap 1.7-2.2 is the solve's
    assert a.total("solve.energy", "idle_s") == pytest.approx(1.3)


def test_outside_and_sync_matches():
    s = solve_spans()
    assert spans.outside(s, "alm.loop", "sync") == [pytest.approx(5.2)]
    assert spans.outside(s, "solve", "alm.loop") == [pytest.approx(4.0)]
    two = s + [("solve", 11.0, 12.0, None, 1), ("sync", 11.1, 11.2, 8, 1)]
    assert spans.sync_matches(two, "solve", [2, 3]) == [(2, 2), (1, 3)]


def step_spans():
    return [
        ("step", 0.0, 10.0, None, 0),            # 0
        ("step.local", 1.0, 2.0, 0, 0),          # 1
        ("step.global", 2.0, 5.0, 0, 0),         # 2
        ("sync", 4.0, 4.5, 2, 0),                # 3
        ("step.local", 5.0, 6.0, 0, 0),          # 4
        ("sync", 6.5, 7.0, 0, 0),                # 5
        ("step.comb", 7.0, 9.0, 0, 0),           # 6
    ]


def step_events():
    return [
        ("cudaGraphLaunch", False, 1.1, 1.11, 1),
        ("svd", True, 1.2, 1.4, 1),
        ("newton", True, 1.4, 1.6, 1),
        ("cudaLaunchKernel", False, 2.1, 2.11, 2),
        ("gemm", True, 2.2, 2.5, 2),
        ("cudaGraphLaunch", False, 7.1, 7.11, 3),
        ("prox", True, 7.2, 7.7, 3),
    ]


def ns(sp):
    return [(n, int(s * 1e9), int(e * 1e9), p, r) for n, s, e, p, r in sp]


def setup_spans():
    return ns([("setup.build", 0.0, 2.0, None, 0),
               ("step", 3.0, 6.0, None, 1),
               ("setup.capture", 3.5, 4.5, 1, 1),
               ("setup.build", 7.0, 8.0, None, 2),
               ("setup.capture", 7.2, 7.5, 3, 2)])


def values(summary):
    from types import SimpleNamespace
    ctx = SimpleNamespace(spans=summary, counters={}, trace=None, problem={})
    return {n: run.reader(ROOT, n)(ctx) for n in spans.READERS}


def test_wire_readers():
    prof = spans.assign(solve_events(), solve_spans(), 0.0, 11.0)
    v = values(spans.SpanSummary(setup=setup_spans(), host=ns(solve_spans()),
                                 profiled=prof))
    assert v["alm.solve_work_ms"] == pytest.approx(4000.0)
    assert v["alm.energy_device_ms"] == pytest.approx(400.0)
    assert v["alm.host_issue_ms_per_trial"] == pytest.approx(5200.0)
    assert v["local.device_ms_per_trial"] == pytest.approx(400.0)
    assert v["global.device_ms_per_trial"] == pytest.approx(800.0)
    assert v["device.idle.alm_solve_work"] == pytest.approx(
        100.0 * 1.9 / 9.1)
    assert v["setup.program_s"] == pytest.approx(4.0)
    for n in ("physics.local_device_ms_per_iter",
              "physics.comb_device_share", "physics.host_issue_ms_per_iter"):
        assert v[n] is None


def test_physics_readers():
    prof = spans.assign(step_events(), step_spans(), 0.0, 10.0)
    v = values(spans.SpanSummary(setup=[], host=ns(step_spans()),
                                 profiled=prof))
    assert v["physics.local_device_ms_per_iter"] == pytest.approx(400.0)
    assert v["physics.comb_device_share"] == pytest.approx(
        100.0 * 0.5 / 1.2)
    assert v["physics.host_issue_ms_per_iter"] == pytest.approx(9000.0)
    for n in ("alm.solve_work_ms", "alm.energy_device_ms",
              "alm.host_issue_ms_per_trial", "local.device_ms_per_trial",
              "global.device_ms_per_trial", "device.idle.alm_solve_work",
              "setup.program_s"):
        assert v[n] is None


def test_readers_silent_without_spans():
    empty = values(spans.SpanSummary(setup=[], host=[], profiled=None))
    assert all(v is None for v in empty.values())
    # the benchmark's own context, which carries no spans
    ctx = run.Context({}, None, {})
    for n in spans.READERS:
        assert run.reader(ROOT, n)(ctx) is None


@pytest.mark.parametrize("workload", WIRE + ("beams-published",))
def test_tiny_cell_reports_host_spans(workload):
    out = spans.run_spans(BENCH, workload, 2**31 + 7, "cpu",
                          overrides=tiny(workload))
    host = ("setup.program_s",) + (
        ("alm.solve_work_ms", "alm.host_issue_ms_per_trial")
        if workload in WIRE else ("physics.host_issue_ms_per_iter",))
    assert set(out["metrics"]) == set(host)
    assert all(v > 0 for v in out["metrics"].values())
    assert out["sync_equals_host_reads"]
    assert len(out["sync_vs_host_reads"]) == (out["units"]
                                              + out["profiled_units"])
    assert "unassigned_device_s" not in out      # no device on the CPU
