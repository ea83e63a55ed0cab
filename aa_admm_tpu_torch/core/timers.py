"""Phase timers and runtime reporting (counterpart of
aa_admm_tpu/core/timers.py): mcl::MicroTimer (MicroTimer.hpp:46-70) and
admm::Solver::RuntimeData (Solver.hpp:70-79, print at Solver.cpp:551-564),
the per-phase accumulation of global / local / acceleration /
initialization milliseconds plus the per-iteration cumulative step time.
On the card the instrumented steps synchronize the device at the end of
each phase, so the buckets hold device time, not enqueue time. The
program's spans (``span``, ``recording``) time the fused path itself, on
the host's clock, for the benchmark's traced runs. ``host_read`` is the
one way the program waits for the device to decide something: each read
is a ``sync`` span and one more in ``host_reads()``."""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time
from typing import List


class MicroTimer:
    def __init__(self):
        self._t0 = time.perf_counter()

    def reset(self):
        self._t0 = time.perf_counter()

    def elapsed_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3

    def elapsed_s(self) -> float:
        return time.perf_counter() - self._t0


@dataclasses.dataclass
class RuntimeData:
    global_ms: float = 0.0
    local_ms: float = 0.0
    acceleration_ms: float = 0.0
    initialization_ms: float = 0.0
    inner_iters: int = 0
    step_time: List[float] = dataclasses.field(default_factory=list)

    def print(self, settings) -> None:
        it = max(1, settings.admm_iters)
        print(f"\nTotal global step: {self.global_ms}ms")
        print(f"Total local step: {self.local_ms}ms")
        print(f"Total acceleration step: {self.acceleration_ms}ms")
        print(f"Total Initialization time: {self.initialization_ms}ms")
        print(f"Avg global step: {self.global_ms / it}ms")
        print(f"Avg local step: {self.local_ms / it}ms")
        print(f"Avg acceleration step: {self.acceleration_ms / it}ms")
        print(f"Avg Initialization step: {self.initialization_ms / it}ms")
        print(f"ADMM Iters: {settings.admm_iters}")
        print(f"Avg Inner Iters: {self.inner_iters / float(it)}")
        print(f"Anderson M: {settings.anderson_m}")


# ---- program spans ----
#
# A span names one stretch of the host's time inside the program: a solve or
# a step (a root, one per request), its phases, each host read that waits
# for the device (``sync``, opened by ``host_read`` alone), the set-up's
# builds and the CUDA graphs' capture. Spans are kept
# only while a ``recording()`` is open; otherwise ``span`` hands back one
# shared do-nothing context, which reads no clock and keeps nothing. Spans
# go around the calls into a CUDA graph's capture, never inside the captured
# function (there they would run once, while it is captured).


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_active = None          # the open recording's SpanRecorder, or None


class SpanRecorder:
    """The spans of one recording, in the order they were opened. Each is
    (name, start_ns, end_ns, parent, request): ``time.perf_counter_ns``
    times, the index of the enclosing span (None for a root) and the root's
    sequence number within the recording (its solve or step). One thread
    records. ``anchor_ns`` pairs a ``perf_counter_ns`` reading with a
    ``time_ns`` one taken together when the recording began; torch.profiler
    stamps its events on the latter (Unix-epoch) clock."""

    def __init__(self):
        self.anchor_ns = (time.perf_counter_ns(), time.time_ns())
        self._spans = []
        self._open = []
        self._roots = 0

    @property
    def spans(self) -> List[tuple]:
        return [tuple(s) for s in self._spans]

    def profiler_spans(self) -> List[tuple]:
        """The spans with their times moved onto the profiler's clock
        (Unix-epoch nanoseconds)."""
        shift = self.anchor_ns[1] - self.anchor_ns[0]
        return [(n, s + shift, e + shift, p, r)
                for n, s, e, p, r in self._spans]

    def _enter(self, name) -> int:
        if self._open:
            parent = self._open[-1]
            request = self._spans[parent][4]
        else:
            parent, request = None, self._roots
            self._roots += 1
        i = len(self._spans)
        self._spans.append([name, time.perf_counter_ns(), None, parent,
                            request])
        self._open.append(i)
        return i

    def _exit(self, i):
        self._spans[i][2] = time.perf_counter_ns()
        self._open.pop()


class _Span:
    __slots__ = ("_rec", "_name", "_i")

    def __init__(self, rec, name):
        self._rec, self._name = rec, name

    def __enter__(self):
        self._i = self._rec._enter(self._name)

    def __exit__(self, *exc):
        self._rec._exit(self._i)
        return False


def span(name: str):
    """A context that records the span `name` while a recording is open."""
    rec = _active
    return _NO_SPAN if rec is None else _Span(rec, name)


def spanned(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def recording():
    """Record the program's spans while the context is open; yields the
    SpanRecorder. Recordings do not nest."""
    global _active
    if _active is not None:
        raise RuntimeError("a recording is already open")
    _active = rec = SpanRecorder()
    try:
        yield rec
    finally:
        _active = None


# ---- host reads ----

_reads = threading.local()


def host_read(t):
    """t's host copy, the program's one wait for the device to decide
    something: a ``sync`` span, and one more in this thread's host_reads()."""
    with span("sync"):
        _reads.n = host_reads() + 1
        return t.cpu()


def host_reads() -> int:
    """The host reads this thread has made (count work by a difference)."""
    return getattr(_reads, "n", 0)
