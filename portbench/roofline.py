"""Peaks of one NVIDIA H100 (SXM data sheet, dense, at its 700 W limit) and
the bytes and operations of the port's kernels, computed from their shapes
(frozen from chip_smoke.py's ``bound_ms`` and its B2/B3 arithmetic).

A kernel's roofline share is the least time the chip could take for the
work, the larger of bytes over peak bandwidth and operations over peak
rate, summed over its launches, divided by its measured device time.
"""

from __future__ import annotations

H100_BYTES_PER_S = 3.35e12     # HBM3
H100_F32_FLOPS = 67e12         # float32 outside the tensor cores
H100_F64_FLOPS = 34e12         # float64 outside the tensor cores


def bound_s(n_bytes, n_flops, word):
    """Least seconds for n_bytes moved and n_flops done at the word size
    (4: float32, 8: float64)."""
    peak = H100_F32_FLOPS if word == 4 else H100_F64_FLOPS
    return max(n_bytes / H100_BYTES_PER_S, n_flops / peak)


def cg_update1(n, c, word):
    """B2 (``cg1_fused``): reads p, Ap, x, r and writes x, r, (n, c) each;
    two multiply-adds and a squared sum a row: (bytes, operations)."""
    return 6 * n * c * word, 8 * n * c


def cg_update2(n, c, word):
    """B3 (``cg2_fused``): reads r, z, p and writes p, (n, c) each; a dot
    and an update a row: (bytes, operations)."""
    return 4 * n * c * word, 4 * n * c
