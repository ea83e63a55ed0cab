"""The metric arithmetic on synthetic traces and counters: the union of
busy intervals, the idle gaps and what the host ran in them, the 90th
percentile, the roofline share and each reader's silence where it finds
nothing."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import roofline, run, trace  # noqa: E402
from portbench.drivers.geometry import Driver  # noqa: E402


def events():
    """A 10 s window: two overlapping kernels, a copy, a runtime call
    around the longest gap, another that covers no gap."""
    return [
        ("cudaLaunchKernel", False, 0.5, 0.6),
        ("cudaMemcpyAsync", False, 5.0, 8.0),
        ("cg1_fused<float, 3, 2>", True, 1.0, 3.0),
        ("cg2_fused<float, 3, 2>", True, 2.0, 4.0),
        ("Memcpy DtoH", True, 4.5, 5.0),
        ("cg1_fused<float, 3, 2>", True, 8.0, 9.0),
    ]


def test_union_and_gaps():
    assert trace.union_length([(1, 3), (2, 4), (4.5, 5)], 0, 10) == 3.5
    assert trace.union_length([(-2, 1), (9, 12)], 0, 10) == 2.0
    assert trace.gaps([(1, 3), (2, 4), (8, 9)], 0, 10) == [
        (0, 1), (4, 8), (9, 10)]


def test_summary():
    s = trace.summarize(events(), 10.0, 8.0)
    assert s.window_s == 10.0 and s.untraced_s == 8.0
    assert s.busy_s == pytest.approx(4.5)         # 1-4, 4.5-5, 8-9
    assert s.kernels["cg1_fused<float, 3, 2>"] == [2, 3.0]
    assert s.matching("cg1_fused", "cg2_fused") == (3, 5.0)
    assert s.device_ops[0] == ["cg1_fused<float, 3, 2>", 3.0]
    # the longest gap, 5 - 8, lies inside the host's read; the gaps lie
    # between the first and the last device event
    assert s.idle_gaps == [["cudaMemcpyAsync", 3.0], ["host", 0.5]]
    assert len(s.device_ops) <= 10 and len(s.idle_gaps) <= 10


def test_summary_without_device_events():
    s = trace.summarize([("cudaLaunchKernel", False, 0.0, 1.0)], 2.0)
    assert s.window_s == 2.0 and s.busy_s == 0.0
    assert s.kernels == {} and s.idle_gaps == []


def test_p90_by_nearest_rank():
    d = Driver.__new__(Driver)
    d.latencies = [i / 1000 for i in range(1, 101)]
    d.counters = dict(accepted=500)
    out = d.end_to_end(10.0)
    assert out["resolve_p90_ms"] == pytest.approx(90.0)
    assert out["alm_iter_ms"] == pytest.approx(20.0)


def test_readers():
    s = trace.summarize(events(), 12.0, 10.0)
    ctx = run.Context(dict(trials=20, accepted=10, cg_iters=300,
                           host_reads=360, cp_refreshes=5, frames=2),
                      s, dict(cg_rows=1000, cg_cols=3, word=4))
    val = {n: run.reader(ROOT, n)(ctx) for n in (
        "alm.trials_per_iter", "alm.host_reads_per_trial",
        "local.cp_refresh_share", "global.cg_iters_per_trial",
        "device.idle.alm", "device.idle.frame", "kernels.cg_roofline",
        "physics.host_reads_per_frame", "device.kernels_per_frame")}
    assert val["alm.trials_per_iter"] == 2.0
    assert val["alm.host_reads_per_trial"] == 18.0
    assert val["local.cp_refresh_share"] == 25.0
    assert val["global.cg_iters_per_trial"] == 15.0
    assert val["device.idle.alm"] == pytest.approx(55.0)
    assert val["device.idle.frame"] == pytest.approx(55.0)
    assert val["physics.host_reads_per_frame"] == 180.0
    assert val["device.kernels_per_frame"] == 1.5     # copies left out
    least = (2 * roofline.bound_s(*roofline.cg_update1(1000, 3, 4), 4)
             + roofline.bound_s(*roofline.cg_update2(1000, 3, 4), 4))
    assert val["kernels.cg_roofline"] == pytest.approx(100 * least / 5.0)


def test_readers_silent_without_data():
    ctx = run.Context(dict(trials=0, accepted=0, frames=0), None, {})
    for n in ("alm.trials_per_iter", "alm.host_reads_per_trial",
              "local.cp_refresh_share", "global.cg_iters_per_trial",
              "device.idle.alm", "kernels.cg_roofline",
              "physics.host_reads_per_frame", "device.kernels_per_frame"):
        assert run.reader(ROOT, n)(ctx) is None
    # a trace without the port's CG kernels or any device time
    empty = trace.summarize([("cudaLaunchKernel", False, 0.0, 1.0)], 1.0)
    ctx = run.Context({}, empty, dict(cg_rows=10, cg_cols=3, word=4))
    assert run.reader(ROOT, "kernels.cg_roofline")(ctx) is None
    assert run.reader(ROOT, "device.idle.alm")(ctx) is None


def test_cg_bytes():
    assert roofline.cg_update1(58081, 3, 4) == (6 * 58081 * 3 * 4,
                                                8 * 58081 * 3)
    assert roofline.cg_update2(58081, 3, 4) == (4 * 58081 * 3 * 4,
                                                4 * 58081 * 3)
    b, f = roofline.cg_update1(58081, 3, 4)
    assert roofline.bound_s(b, f, 4) == b / roofline.H100_BYTES_PER_S
