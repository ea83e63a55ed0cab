"""Configuration surfaces (counterpart of aa_admm_tpu/core/config.py).

* ``Settings`` — physics CLI flags (``-dt -v -it -g -ck -a -am -ab -ap``),
  defaults matching ``admm_anderson_*/src/Solver.hpp:46-67``.
* ``Parameters`` — geometry option files (whitespace ``key value`` lines,
  ``#`` comments), keys per ``Geometry/Parameters.h:59-90,232-238``.
* ``Lame`` — physics material parameters.

The port reads no environment switch: ``Settings.dtype`` defaults to float64
and a caller sets it explicitly.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class AccelType(enum.IntEnum):
    NOACC = 0
    ANDERSON = 1


@dataclasses.dataclass
class Settings:
    """Physics solver settings (reference admm::Solver::Settings).

    Defaults per admm_anderson_hard_zxu/src/Solver.hpp:63-66: dt=1/30,
    verbose=1, admm_iters=500, gravity=-9.8, m=2, penalty=1.0, NOACC.
    """

    timestep_s: float = 1.0 / 30.0       # -dt
    verbose: int = 1                     # -v
    admm_iters: int = 500                # -it
    gravity: float = -9.8                # -g
    constraint_w: float = -1.0           # -ck (vestigial, as in the reference)
    anderson_m: int = 2                  # -am (setting it turns acceleration on)
    beta: float = 1.0                    # -ab (xzu only; vestigial in reference)
    penalty: float = 1.0                 # -ap (zxu only)
    acceleration_type: AccelType = AccelType.NOACC  # -a {0,1}
    dtype: np.dtype = dataclasses.field(
        default_factory=lambda: np.dtype(np.float64))
    collect_comb_residual: bool = True
    linear_solver: str = "auto"          # auto | dense | cg
    cg_tol: float = 1e-12
    cg_max_iters: int = 400
    trace_chunk: int = 0

    def parse_args(self, argv) -> bool:
        """Parse reference-style flags. Returns True if help was requested
        (mirrors Solver::Settings::parse_args, Solver.cpp:510-534). A
        non-numeric value raises ValueError naming the flag."""
        args = list(argv)
        i = 0
        while i < len(args):
            arg = args[i]
            if arg in ("-help", "--help", "-h"):
                print(self.help())
                return True
            nxt = args[i + 1] if i + 1 < len(args) else None
            if nxt is not None and arg in ("-dt", "-v", "-it", "-g", "-ck",
                                           "-a", "-am", "-ab", "-ap"):
                try:
                    float(nxt)
                except ValueError:
                    raise ValueError(
                        f"invalid value for {arg}: '{nxt}' (expected a number)"
                    ) from None
            if arg == "-dt" and nxt:
                self.timestep_s = float(nxt); i += 1
            elif arg == "-v" and nxt:
                self.verbose = int(nxt); i += 1
            elif arg == "-it" and nxt:
                self.admm_iters = int(nxt); i += 1
            elif arg == "-g" and nxt:
                self.gravity = float(nxt); i += 1
            elif arg == "-ck" and nxt:
                self.constraint_w = float(nxt); i += 1
            elif arg == "-a" and nxt:
                self.acceleration_type = (
                    AccelType.NOACC if int(nxt) == 0 else AccelType.ANDERSON
                ); i += 1
            elif arg == "-am" and nxt:
                self.anderson_m = int(nxt)
                self.acceleration_type = AccelType.ANDERSON
                i += 1
            elif arg == "-ab" and nxt:
                self.beta = float(nxt); i += 1
            elif arg == "-ap" and nxt:
                self.penalty = float(nxt); i += 1
            i += 1
        return False

    @staticmethod
    def help() -> str:
        return (
            "\n==========================================\nArgs:\n"
            "\t-dt: time step (s)\n"
            "\t-v: verbosity (higher -> show more)\n"
            "\t-it: # admm iters\n"
            "\t-g: gravity (m/s^2)\n"
            "\t-ck: constraint weights (-1 = auto)\n"
            "\t-a: acceleration type (0=NoAcc, 1=Anderson)\n"
            "\t-am: anderson window size (>0, int)\n"
            "\t-ap: admm penalty parameter (zxu)\n"
            "==========================================\n"
        )

    @property
    def accelerated(self) -> bool:
        return self.acceleration_type == AccelType.ANDERSON and self.anderson_m > 0


@dataclasses.dataclass
class Parameters:
    """Geometry option file (reference Geometry/Parameters.h:36-254).

    Defaults: iter=1, anderson_m=5 (Parameters.h:39-45)."""

    iterations: int = 1
    anderson_m: int = 5
    square_elasticity: bool = False
    time_step: float = 0.0

    _KEYS = {
        "iterations": ("iterations", int),
        "andersonm": ("anderson_m", int),
        "squareelasticity": ("square_elasticity", lambda v: bool(int(v))),
        "timestep": ("time_step", float),
    }

    @classmethod
    def load(cls, path: str) -> "Parameters":
        p = cls()
        with open(path, "r") as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                parts = line.split()
                if len(parts) < 2:
                    continue
                key = parts[0].lower()
                if key in cls._KEYS:
                    attr, conv = cls._KEYS[key]
                    setattr(p, attr, conv(parts[1]))
        return p

    def valid(self) -> bool:
        return self.iterations > 0 and self.anderson_m >= 0 and self.time_step >= 0

    def output(self) -> str:
        return (
            f"Iterations {self.iterations}\n"
            f"AndersonM {self.anderson_m}\n"
            f"SquareElasticity {int(self.square_elasticity)}\n"
            f"TimeStep {self.time_step}\n"
        )


@dataclasses.dataclass
class Lame:
    """Material parameters (reference admm_anderson_xzu/src/EnergyTerm.hpp:35-61;
    JAX core/config.py:180-218).

    mu = k/(2(1+v)), lambda = k*v/((1+v)(1-2v)) from Young's modulus k and
    Poisson ratio v; bulk modulus = lambda + (2/3) mu.
    """

    mu: float
    lam: float
    limit_min: float = -100.0
    limit_max: float = 100.0

    @classmethod
    def from_young_poisson(cls, k: float, v: float,
                           limit_min: float = -100.0,
                           limit_max: float = 100.0) -> "Lame":
        return cls(mu=k / (2.0 * (1.0 + v)),
                   lam=k * v / ((1.0 + v) * (1.0 - 2.0 * v)),
                   limit_min=limit_min, limit_max=limit_max)

    @classmethod
    def rubber(cls) -> "Lame":
        return cls.from_young_poisson(10000000, 0.499)

    @classmethod
    def soft_rubber(cls) -> "Lame":
        return cls.from_young_poisson(10000000, 0.399)

    @classmethod
    def very_soft_rubber(cls) -> "Lame":
        return cls.from_young_poisson(1000000, 0.299)

    @property
    def bulk_modulus(self) -> float:
        return self.lam + (2.0 / 3.0) * self.mu
