"""Phase timer (counterpart of aa_admm_tpu/core/timers.py MicroTimer, the
equivalent of mcl::MicroTimer, MicroTimer.hpp:46-70)."""

from __future__ import annotations

import time


class MicroTimer:
    def __init__(self):
        self._t0 = time.perf_counter()

    def reset(self):
        self._t0 = time.perf_counter()

    def elapsed_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3

    def elapsed_s(self) -> float:
        return time.perf_counter() - self._t0
