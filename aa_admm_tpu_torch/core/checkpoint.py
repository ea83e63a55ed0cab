"""Checkpoint and state persistence (counterpart of
aa_admm_tpu/core/checkpoint.py; the two packages read each other's files).

* Reference-format 16-digit text dumps of mid-step ADMM state
  (admm::Solver::load, Solver.hpp:153-215: file 1 = ``n`` then rows
  ``z u last_z``; file 2 = ``n`` then rows of ``x``).
* NumPy .npz checkpoints of solver state for resume.
"""

from __future__ import annotations

import numpy as np


def save_admm_state_text(file_zu: str, file_x: str, z, u, last_z, x) -> None:
    z = np.asarray(z).ravel()
    u = np.asarray(u).ravel()
    last_z = np.asarray(last_z).ravel()
    x = np.asarray(x).ravel()
    if not z.shape == u.shape == last_z.shape:
        raise ValueError("z, u and last_z must have one length")
    with open(file_zu, "w") as f:
        f.write(f"{len(z)}\n")
        for a, b, c in zip(z, u, last_z):
            f.write("%.16g %.16g %.16g\n" % (a, b, c))
    with open(file_x, "w") as f:
        f.write(f"{len(x)}\n")
        for v in x:
            f.write("%.16g\n" % v)


def load_admm_state_text(file_zu: str, file_x: str):
    """Returns (z, u, last_z, x) flat float64 arrays; raises ValueError on
    malformed input (the reference's error paths)."""
    with open(file_zu, "r") as f:
        n = int(f.readline().split()[0])
        if n <= 0:
            raise ValueError("Error: invalid number or values")
        rows = np.loadtxt(f, max_rows=n)
    if rows.shape != (n, 3):
        raise ValueError("Error parsing distance values")
    with open(file_x, "r") as f:
        m = int(f.readline().split()[0])
        if m <= 0:
            raise ValueError("Error: invalid number or values from file 2")
        x = np.loadtxt(f, max_rows=m)
    if x.size != m:
        raise ValueError("Error parsing x values")
    return rows[:, 0], rows[:, 1], rows[:, 2], x.ravel()


def save_solver_npz(path: str, **arrays) -> None:
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in arrays.items()})


def load_solver_npz(path: str) -> dict:
    with np.load(path) as d:
        return {k: d[k] for k in d.files}
