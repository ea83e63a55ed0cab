"""Carry state across from the JAX package, given as NumPy arrays.

With these a test can run one ``solve_alm_chunk`` (geometry) or one
``step_xzu``/``step_zxu`` (physics) in both packages from the same state.
Inputs are plain NumPy arrays (for example ``jax.device_get`` of the JAX
objects; a nested object — a collision batch's scene and mesh obstacles, the
wind — may be given as such an object or as a dict of its fields); nothing
here imports JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops import closest_point as cp
from .ops import constraints, elements
from .ops._batchutil import _host_mirror, torch_dtype
from .ops.collider import TetMeshSdf
from .ops.sdf import SdfScene
from .solver import anderson
from .solver.linear import DenseInverseSolver
from .solver.multigrid import TwoLevelPrecond
from .solver.physics import PhysicsSystem, WindForce


_TABLES = ("inv_idx", "inv_mask")


def _get(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _has(obj, name):
    return name in obj if isinstance(obj, dict) else hasattr(obj, name)


def _tensor(a, device, dtype=None):
    a = np.array(a)             # a writable copy (device_get arrays are not)
    t = torch.from_numpy(a)
    if a.dtype.kind in "iu":
        t = t.to(torch.int64)
    return t.to(device=device, dtype=dtype)


def _nested(cls, obj, device):
    """A port dataclass of tensors (and scalars) from an object or dict
    holding its fields. The gather-form tables (`inv_idx`, `inv_mask`),
    which the JAX object may lack or hold as None, then keep their default
    (the port object builds its own); any other field it lacks raises."""
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in _TABLES and (not _has(obj, f.name)
                                  or _get(obj, f.name) is None):
            continue
        v = _get(obj, f.name)
        kw[f.name] = (v if isinstance(v, (int, float, str))
                      else _tensor(v, device))
    return cls(**kw)


def _batch(cls, fields: dict, device):
    names = {f for f in cls.__dataclass_fields__}
    kw = {}
    for name, v in fields.items():
        if name not in names or v is None:
            continue
        if name == "scene":
            kw[name] = _nested(SdfScene, v, device)
        elif name == "mesh_sdfs":
            kw[name] = tuple(_nested(TetMeshSdf, m, device) for m in v)
        else:
            kw[name] = (v if isinstance(v, (int, float, str))
                        else _tensor(v, device))
    out = cls(**kw)
    host = fields.get("_host")
    if host is not None:
        _host_mirror(out, **{k: (np.asarray(v, np.int64)
                                 if k in ("idx", "tets", "tris") else v)
                             for k, v in host.items()})
    return out


def batch_from_numpy(kind, fields: dict, device="cpu"):
    """A port constraint batch from a JAX batch's fields. `kind` is the class
    name ("PlaneBatch", "AngleBatch", "EdgeLengthBatch", "ClosenessBatch",
    "RefSurfaceBatch") or the port class; `fields` maps field names to NumPy
    arrays (or Python scalars and strings for the static fields) and may
    hold "_host", the batch's host-mirror dict. Integer arrays become int64;
    fields the port does not have are dropped. The gather-form adjoint
    tables (`inv_idx`, `inv_mask`) are carried across where the JAX batch
    has them; where it holds None, the port batch builds its own."""
    cls = getattr(constraints, kind) if isinstance(kind, str) else kind
    return _batch(cls, fields, device)


def element_batch_from_numpy(kind, fields: dict, device="cpu"):
    """A port physics element batch ("TetBatch", "TriBatch", "PinBatch",
    "CollisionBatch" or "SelfCollisionBatch", or the port class) from a JAX
    batch's fields, converted as in batch_from_numpy; a TetBatch's `kind`
    and `svd_method` and a TriBatch's `variant` are strings, a
    CollisionBatch's `scene` an SdfScene's fields and its `mesh_sdfs` a
    sequence of TetMeshSdf fields (objects or dicts)."""
    cls = getattr(elements, kind) if isinstance(kind, str) else kind
    return _batch(cls, fields, device)


def physics_system_from_numpy(fields: dict, device="cpu") -> PhysicsSystem:
    """The port's PhysicsSystem from a JAX PhysicsSystem's arrays: `masses`,
    `free_mask`, `free_idx`, `batches` (a sequence of (kind, fields) pairs,
    as element_batch_from_numpy takes them), `Ainv` (the dense path) or
    `precond_diag` (the CG path), and the static settings (`n_verts`,
    `n_free`, `order`, `dt`, `gravity`, `dt2p`, `admm_iters`, `anderson_m`,
    `accel`, `collect_comb`, `cg_tol`, `cg_max_iters`) and `wind` (None, or
    a WindForce's fields: `faces`, `direction`, `alpha_n`, `mode`). The JAX
    system's element sharding (a jax.sharding placement) must be None: carry
    the unsharded system across and shard it with
    aa_admm_tpu_torch.parallel.ensemble.shard_system."""
    if fields.get("elem_sharding") is not None:
        raise NotImplementedError(
            "a JAX elem_sharding does not carry across; convert the "
            "unsharded system and shard it with "
            "aa_admm_tpu_torch.parallel.ensemble.shard_system")
    wind = fields.get("wind")
    statics = {k: fields[k] for k in (
        "n_verts", "n_free", "order", "dt", "gravity", "dt2p", "admm_iters",
        "anderson_m", "accel", "collect_comb", "cg_tol", "cg_max_iters")
        if k in fields}
    Ainv, diag = fields.get("Ainv"), fields.get("precond_diag")
    return PhysicsSystem(
        masses=_tensor(fields["masses"], device),
        free_mask=_tensor(fields["free_mask"], device),
        free_idx=_tensor(fields["free_idx"], device),
        batches=tuple(element_batch_from_numpy(k, f, device)
                      for k, f in fields["batches"]),
        solver=None if Ainv is None else DenseInverseSolver(
            Ainv=_tensor(Ainv, device)),
        precond_diag=None if diag is None else _tensor(diag, device),
        wind=None if wind is None else _nested(WindForce, wind, device),
        **statics)


def two_level_from_numpy(agg, Ac_inv, inv_diag, device="cpu",
                         dtype=None) -> TwoLevelPrecond:
    """The port's two-level preconditioner from its three arrays (its
    restriction's table is built from agg)."""
    dt = torch_dtype(dtype) if dtype is not None else None
    return TwoLevelPrecond(agg=_tensor(agg, device),
                           Ac_inv=_tensor(Ac_inv, device, dt),
                           inv_diag=_tensor(inv_diag, device, dt))


def _cp_cache(c, device):
    if c is None:
        return None
    if hasattr(c, "gidx") or (isinstance(c, dict) and "gidx" in c):
        return cp.CPCacheGroup(gidx=_tensor(_get(c, "gidx"), device),
                               p0=_tensor(_get(c, "p0"), device),
                               slack=_tensor(_get(c, "slack"), device))
    candT = _get(c, "candT") if not isinstance(c, dict) else c.get("candT")
    return cp.CPCache(idx=_tensor(_get(c, "idx"), device),
                      p0=_tensor(_get(c, "p0"), device),
                      slack=_tensor(_get(c, "slack"), device),
                      candT=None if candT is None else _tensor(candT, device))


def alm_state_from_numpy(state: dict, device="cpu") -> dict:
    """The port's ALM loop state from the JAX loop-state dict
    (aa_admm_tpu/solver/geometry.py _alm_init_state): x, u, dx, du, the cp
    caches, prev, reset, the AA state and the counters. The JAX counters
    ``trial``, ``limit``, ``max_trials`` and ``cgit`` become host ints."""
    def t(a):
        return _tensor(a, device)

    aa = _get(state, "aa")
    return dict(
        x=t(state["x"]), u=tuple(t(a) for a in state["u"]),
        dx=t(state["dx"]), du=tuple(t(a) for a in state["du"]),
        cp=tuple(_cp_cache(c, device) for c in state["cp"]),
        prev=t(state["prev"]), reset=t(state["reset"]),
        aa=anderson.AAState(**{name: t(_get(aa, name)) for name in
                               ("current_u", "dF", "dG", "dF_scale", "M",
                                "iter", "col_idx")}),
        it=t(state["it"]), trial=int(state["trial"]), fv=t(state["fv"]),
        rj=t(state["rj"]), rejects=t(state["rejects"]),
        limit=int(state["limit"]), max_trials=int(state["max_trials"]),
        cgit=int(state["cgit"]), reads=0, cp_refreshes=0)
