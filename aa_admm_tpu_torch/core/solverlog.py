"""Convergence-vs-ground-truth logger (counterpart of
aa_admm_tpu/core/solverlog.py; admm SolverLog, SolverLog.hpp:28-71).

Tracks the normalized error ||x* - x|| / ||x* - x0|| per iteration against a
precomputed exact solution x_star: run once to convergence, then run again
logging the error trajectory. Host NumPy.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .timers import MicroTimer


class SolverLog:
    def __init__(self):
        self.x_star: Optional[np.ndarray] = None
        self.errors: List[float] = []
        self.runtimes: List[float] = []
        self.final_r: float = 0.0
        self._x0: Optional[np.ndarray] = None
        self._t = MicroTimer()

    def reset(self):
        self.errors.clear()
        self.runtimes.clear()
        self._t.reset()

    def _skip(self, x) -> bool:
        return self.x_star is None or self.x_star.shape != np.shape(x)

    def add(self, x):
        if self._skip(x):
            return
        x = np.asarray(x)
        if not self.errors:
            self.runtimes.append(0.0)
            self._t.reset()
            self._x0 = x.copy()
        else:
            self.runtimes.append(self._t.elapsed_ms())
        numer = np.linalg.norm(self.x_star - x)
        denom = np.linalg.norm(self.x_star - self._x0)
        self.errors.append(numer / max(denom, 1e-300))

    def finalize(self, apply_A, x, b):
        """Final ||A x - b|| with a matrix-free operator."""
        if self._skip(x):
            return
        self.final_r = float(np.linalg.norm(np.asarray(apply_A(x)) - b))
