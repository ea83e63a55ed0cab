"""Phase timers and runtime reporting (counterpart of
aa_admm_tpu/core/timers.py): mcl::MicroTimer (MicroTimer.hpp:46-70) and
admm::Solver::RuntimeData (Solver.hpp:70-79, print at Solver.cpp:551-564),
the per-phase accumulation of global / local / acceleration /
initialization milliseconds plus the per-iteration cumulative step time.
On the card the instrumented steps synchronize the device at the end of
each phase, so the buckets hold device time, not enqueue time."""

from __future__ import annotations

import dataclasses
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
