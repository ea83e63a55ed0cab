"""Shared helpers for the frozen struct-of-arrays constraint and element
batches (counterpart of aa_admm_tpu/ops/_batchutil.py).

Host mirrors: setup-time assembly and the delta-form anchors read f64 NumPy
copies attached at creation, never the (possibly device-resident, possibly
cast) tensors. ``cast_floats`` moves a batch to the solve dtype and device
and carries the f64 mirrors over unchanged.

Scatters: every scatter-add of the port (a batch's adjoint ``scatter``, the
wind's jacobi kick, the regularization rows, the coarse restriction) runs
in gather form: ``sum_k contrib[inv_idx[v, k]] * inv_mask[v, k]`` over an
inverse table built once on the host when its batch is made
(``build_inverse_table``), its slots summed by a scan in ascending order.
That gives the same bits on every run of one device; ``index_add_`` on
CUDA sums with float atomics in an order that changes from run to run.
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


def build_inverse_table(idx_flat, n_verts, dtype):
    """Inverse adjacency of a scatter (JAX _batchutil.py:64-88): for each
    destination vertex, the positions in the FLATTENED contribution array
    that sum into it, in ascending order, padded to the largest valence.
    Turns ``segment_sum(contrib, idx)`` into
    ``sum_k contrib[inv_idx[v, k]] * inv_mask[v, k]``.

    Returns (inv_idx (n_verts, K) int32, inv_mask (n_verts, K) dtype)."""
    idx_flat = np.asarray(idx_flat).reshape(-1).astype(np.int64)
    counts = np.bincount(idx_flat, minlength=n_verts)
    K = max(int(counts.max()), 1)
    starts = np.zeros(n_verts + 1, np.int64)
    starts[1:] = np.cumsum(counts)
    order = np.argsort(idx_flat, kind="stable")
    sorted_v = idx_flat[order]
    pos_in_v = np.arange(len(idx_flat)) - starts[sorted_v]
    inv_idx = np.zeros((n_verts, K), np.int32)
    inv_mask = np.zeros((n_verts, K), dtype)
    inv_idx[sorted_v, pos_in_v] = order.astype(np.int32)
    inv_mask[sorted_v, pos_in_v] = 1
    return inv_idx, inv_mask


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def inverse_table(idx, dtype, valid=None):
    """The gather-form table of a scatter over ``idx`` (a tensor or array,
    flattened in the contribution rows' order) as tensors on idx's device:
    (inv_idx (n, K) int64, inv_mask (n, K) of torch dtype `dtype`), with
    n = max(idx) + 1 over the slots that enter it. Only the slots where
    `valid` holds enter the table (padded slots contribute zeros, and
    aliasing them all to vertex 0 would make that vertex's row as long as
    their count)."""
    dev = idx.device if isinstance(idx, torch.Tensor) else torch.device("cpu")
    flat = _np(idx).reshape(-1).astype(np.int64)
    pos = (np.arange(flat.size) if valid is None
           else np.flatnonzero(_np(valid).reshape(-1)))
    tdt = torch_dtype(dtype)
    if pos.size == 0:
        return (torch.zeros((0, 0), dtype=torch.int64, device=dev),
                torch.zeros((0, 0), dtype=tdt, device=dev))
    inv_idx, inv_mask = build_inverse_table(
        flat[pos], int(flat[pos].max()) + 1, np.float64)
    return (torch.from_numpy(pos[inv_idx]).to(dev),
            torch.from_numpy(inv_mask).to(device=dev, dtype=tdt))


def _gather_scatter(contrib, inv_idx, inv_mask, n_rows):
    """The scatter-add of contribution rows contrib (R, c, ...) into n_rows
    rows, in gather form (JAX constraints.py:47-50): a padded gather, then
    a sum over the slot axis, then zero rows from the table's last row to
    n_rows. The sum is the last element of a scan over the slots: one pass
    in ascending slot order, so each vertex sums its rows in ascending
    position, with the same bits on every run (on CUDA a scan over an axis
    that is not the innermost runs each column in one thread, without
    atomics). On the CPU in float64 that is segment_sum's order, bit for
    bit; in float32 the CPU's scan carries its running sum in double, so
    it rounds once where segment_sum rounds at every add."""
    n, K = inv_idx.shape
    tail = (n_rows - n,) + tuple(contrib.shape[1:])
    if K == 0:
        return contrib.new_zeros((n_rows,) + tuple(contrib.shape[1:]))
    g = contrib.index_select(0, inv_idx.reshape(-1)).reshape(
        (n, K) + tuple(contrib.shape[1:]))               # (n, K, c, ...)
    m = inv_mask.reshape((n, K) + (1,) * (contrib.dim() - 1))
    out = (g * m).cumsum(1)[:, -1]
    return torch.cat([out, out.new_zeros(tail)]) if n < n_rows else out


class GatherAdjoint:
    """Mixin of a frozen dataclass whose adjoint is a scatter-add over a
    fixed index. The class declares ``inv_idx`` and ``inv_mask`` fields
    (default None) and ``_adjoint_index()``; a table left None is built on
    the host when the object is made, over max(index) + 1 rows, so every
    scatter it runs is a gather, padded to the caller's row count."""

    def _adjoint_index(self):
        """(index whose flattening addresses the contribution rows, valid
        slots or None, dtype of the mask)."""
        return self.idx, None, self.w.dtype

    def __post_init__(self):
        if self.inv_idx is None:
            idx, valid, dt = self._adjoint_index()
            inv_idx, inv_mask = inverse_table(idx, dt, valid=valid)
            object.__setattr__(self, "inv_idx", inv_idx)
            object.__setattr__(self, "inv_mask", inv_mask)

    def _scatter(self, contrib, n_rows):
        return _gather_scatter(contrib, self.inv_idx, self.inv_mask, n_rows)


def with_gather_adjoint(batch, n_verts):
    """The JAX package's step that arms a batch's gather-form adjoint for
    n_verts rows (JAX constraints.py:53-72). A port batch builds its table
    when it is made, in its own float dtype (the device dtype after
    cast_floats, which casts the mask with the other floats, never the f64
    host mirror's), and its scatter pads to the row count it is given; so
    this returns the batch itself once its table fits n_verts rows."""
    if batch.inv_idx.shape[0] > n_verts:
        raise ValueError(f"the batch addresses {batch.inv_idx.shape[0]} "
                         f"rows, more than {n_verts}")
    return batch


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
