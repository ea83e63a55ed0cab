"""Shared helpers for the frozen struct-of-arrays constraint and element
batches (counterpart of aa_admm_tpu/ops/_batchutil.py).

Host mirrors: setup-time assembly and the delta-form anchors read f64 NumPy
copies attached at creation, never the (possibly device-resident, possibly
cast) tensors. ``cast_floats`` moves a batch to the solve dtype and device
and carries the f64 mirrors over unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_TORCH_FLOAT = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}


def torch_dtype(dtype) -> torch.dtype:
    """numpy float dtype (or torch dtype) -> torch float dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_FLOAT[np.dtype(dtype)]


def _t(a, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))


def _scatter_rows(contrib, idx, n_verts):
    """segment_sum of (R, 3) rows into n_verts bins."""
    out = torch.zeros((n_verts, contrib.shape[-1]), dtype=contrib.dtype,
                      device=contrib.device)
    return out.index_add_(0, idx, contrib)


def _host_mirror(obj, **arrays):
    """Attach host-side NumPy mirrors to a frozen batch (not dataclass
    fields)."""
    object.__setattr__(obj, "_host",
                       {k: np.asarray(v) for k, v in arrays.items()})
    return obj


def hostarr(b, name):
    h = getattr(b, "_host", None)
    if h is not None and name in h:
        return h[name]
    return getattr(b, name).detach().cpu().numpy()


def _cast(v, tdt, device):
    if isinstance(v, torch.Tensor):
        dt = tdt if (tdt is not None and v.is_floating_point()) else v.dtype
        if v.dtype != dt or (device is not None
                             and v.device != torch.device(device)):
            return v.to(device=device, dtype=dt)
        return v
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return cast_floats(v, tdt, device)
    if isinstance(v, tuple):
        out = tuple(_cast(a, tdt, device) for a in v)
        return v if all(a is b for a, b in zip(out, v)) else out
    return v


def cast_floats(batch, dtype, device=None):
    """Copy of a frozen batch with every floating tensor field cast to
    `dtype` (None keeps each field's) and every tensor field moved to
    `device` (None keeps it), through nested frozen dataclasses and tuples
    of them (a collision batch's scene and mesh obstacles). The f64 `_host`
    mirrors are carried over unchanged."""
    tdt = None if dtype is None else torch_dtype(dtype)
    kw = {}
    for f in dataclasses.fields(batch):
        v = getattr(batch, f.name)
        c = _cast(v, tdt, device)
        if c is not v:
            kw[f.name] = c
    if not kw:
        return batch
    out = dataclasses.replace(batch, **kw)
    h = getattr(batch, "_host", None)
    if h is not None:
        object.__setattr__(out, "_host", h)
    return out
