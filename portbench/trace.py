"""The reduction of a torch.profiler trace to what the per-layer metrics
read: the device's busy time as the union of its operations' intervals
(overlapping kernels count once), per-kernel counts and device seconds,
and the breakdown the result line carries. The wall times come from the
host's clock: around the traced units, and around as many units run just
before them untraced (the profiler slows the host, so the idle shares are
read against the latter).

Events are (name, on_device, start_s, end_s) tuples; ``from_profiler``
makes them from a finished ``torch.profiler.profile``, so the arithmetic
below runs on synthetic lists as well.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

def from_profiler(prof):
    """(name, on_device, start_s, end_s) of every event of a finished
    profile, read from the raw kineto events (no per-event objects). The
    device-side copies of host annotations, which the trace lays on the
    device's timeline, are not device work and are left out."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = str(e.device_type()).endswith("CUDA")
        if dev and e.is_user_annotation():
            continue
        start = e.start_ns() * 1e-9
        out.append((e.name(), dev, start, start + e.duration_ns() * 1e-9))
    return out


def union_length(intervals, lo, hi):
    """Length of the union of the intervals clipped to [lo, hi]."""
    total, end = 0.0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def gaps(intervals, lo, hi):
    """The idle gaps (start, end) between the union's pieces in [lo, hi]."""
    out, end = [], lo
    for s, e in sorted(intervals):
        if s > end and s <= hi:
            out.append((end, min(s, hi)))
        end = max(end, e)
    if end < hi:
        out.append((end, hi))
    return out


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: dict          # name -> [launches, device seconds]
    device_ops: list       # [[name, seconds]] the top 10 by device time
    idle_gaps: list        # [[what the host ran, seconds]] the 10 longest
    untraced_s: float = 0.0  # wall time of as many units run untraced

    def matching(self, *parts):
        """(launches, device seconds) summed over kernels whose name holds
        any of `parts`."""
        n, t = 0, 0.0
        for name, (c, s) in self.kernels.items():
            if any(p in name for p in parts):
                n, t = n + c, t + s
        return n, t


def summarize(events, window_s, untraced_s=0.0, top=10):
    """Reduce the events of one traced window of `window_s` seconds (the
    host's clock around the traced units, which synchronize before and
    after, so every device event lies inside it; `untraced_s` the same
    number of units' wall time untraced): the busy time is the
    union of the device events; idle gaps are taken between the first and
    the last of them and named by the host event (a CUDA runtime call)
    that covers each one's middle."""
    dev = [(n, s, e) for n, d, s, e in events if d]
    spans = [(s, e) for _, s, e in dev]
    lo = min((s for s, _ in spans), default=0.0)
    hi = max((e for _, e in spans), default=0.0)
    busy = union_length(spans, lo, hi)
    kernels = defaultdict(lambda: [0, 0.0])
    for n, s, e in dev:
        kernels[n][0] += 1
        kernels[n][1] += e - s
    ops = sorted(([n, t] for n, (_, t) in kernels.items()),
                 key=lambda r: -r[1])[:top]
    idle = sorted(gaps(spans, lo, hi), key=lambda g: g[0] - g[1])[:top]
    host = sorted(((s, e, n) for n, d, s, e in events if not d),
                  key=lambda r: r[0])
    starts = [s for s, _, _ in host]
    named = [[host_at(host, starts, (a + b) / 2), b - a] for a, b in idle]
    return TraceSummary(window_s=float(window_s), busy_s=busy,
                        kernels=dict(kernels), device_ops=ops,
                        idle_gaps=named, untraced_s=float(untraced_s))


def host_at(host, starts, t):
    """The innermost host event (latest start) of `host` ((start, end, name)
    sorted by start; `starts` their starts) that covers time t, or 'host'
    where none does."""
    i = bisect.bisect_right(starts, t)
    best = None
    for s, e, n in reversed(host[max(0, i - 2000):i]):
        if e >= t:
            best = n
            break
    return best or "host"
