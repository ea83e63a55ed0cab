"""ctypes bindings for the native host library (counterpart of
aa_admm_tpu/native/__init__.py): a median-split AABB tree for batched
closest-point queries and fast OBJ and TetGen .ele/.node parsers, from the
C++ source ``native/aaadmm_native.cpp`` at the repository's root.

Build: at first use ``g++`` compiles that source with the flags of
``native/Makefile`` into ``aa_admm_tpu_torch/build/`` (git-ignored; named
by the source's hash, so an edited source rebuilds); nothing is written
into ``native/``. Without a compiler or the source, ``available()`` is
False, the parsers return None (core/meshio.py then parses in NumPy) and
``host_closest_points`` uses the port's brute-force ``closest_point_on_mesh``
on CPU tensors. These are host parsers and host queries, not a device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "aaadmm_native.cpp"
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ["-O3", "-fopenmp", "-std=c++14", "-fPIC", "-shared"]

_LIB = None
_TRIED = False


def lib_path() -> Path:
    tag = hashlib.sha1(SOURCE.read_bytes()
                       + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libaaadmm_native-{tag}.so"


def build() -> Path:
    """Compile the library unless it is built already; returns its path.
    Raises when the source or g++ is missing or the compile fails."""
    out = lib_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native library is compiled "
                           "at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"      # concurrent builds don't collide
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    lib.aabb_build.restype = ctypes.c_void_p
    lib.aabb_build.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_void_p, ctypes.c_int64]
    lib.aabb_free.restype = None
    lib.aabb_free.argtypes = [ctypes.c_void_p]
    lib.aabb_closest_points.restype = None
    lib.aabb_closest_points.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int64, ctypes.c_void_p,
                                        ctypes.c_void_p]
    lib.obj_parse.restype = ctypes.c_int
    lib.obj_parse.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_int64)]
    lib.elenode_parse.restype = ctypes.c_int
    lib.elenode_parse.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int64)]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _rows3(a, dtype, name):
    """a as a C-contiguous (n, 3) array of dtype; raises otherwise."""
    out = np.ascontiguousarray(a, dtype)
    if out.ndim != 2 or out.shape[1] != 3:
        raise ValueError(f"{name} must have shape (n, 3), not {out.shape}")
    return out


class AabbTree:
    """Median-split AABB tree over a triangle soup; batched closest-point
    queries in f64 on the host (the equivalent of igl::AABB / TriMeshAABB)."""

    def __init__(self, verts: np.ndarray, tris: np.ndarray):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._verts = _rows3(verts, np.float64, "verts")
        self._tris = _rows3(tris, np.int32, "tris")
        if self._tris.size and (self._tris.min() < 0
                                or self._tris.max() >= len(self._verts)):
            raise ValueError("tris index a vertex that does not exist")
        self._handle = lib.aabb_build(_ptr(self._verts), len(self._verts),
                                      _ptr(self._tris), len(self._tris))

    def closest_points(self, queries: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """(points (Q, 3), squared distances (Q,))."""
        q = _rows3(queries, np.float64, "queries")
        out = np.empty_like(q)
        sqd = np.empty(len(q))
        self._lib.aabb_closest_points(ctypes.c_void_p(self._handle), _ptr(q),
                                      len(q), _ptr(out), _ptr(sqd))
        return out, sqd

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.aabb_free(ctypes.c_void_p(handle))
            self._handle = None


def host_closest_points(ref_verts, ref_tris, queries):
    """Closest surface points on the host: the native tree when the library
    is available, else the port's brute-force sweep on CPU tensors."""
    if available():
        pts, _ = AabbTree(np.asarray(ref_verts),
                          np.asarray(ref_tris)).closest_points(queries)
        return pts
    import torch
    from ..ops.closest_point import closest_point_on_mesh
    tri = np.asarray(ref_verts, np.float64)[np.asarray(ref_tris)]
    return closest_point_on_mesh(
        torch.from_numpy(np.ascontiguousarray(queries, np.float64)),
        torch.from_numpy(tri)).numpy()


def load_obj_native(path: str):
    """(verts (V, 3) f64, tris (F, 3) int32, polygons fan-split), or None
    when the library is unavailable or the file cannot be opened."""
    lib = _load()
    if lib is None:
        return None
    nv, nt = ctypes.c_int64(), ctypes.c_int64()
    if lib.obj_parse(path.encode(), None, ctypes.byref(nv), None,
                     ctypes.byref(nt)) != 0:
        return None
    verts = np.empty((nv.value, 3))
    tris = np.empty((nt.value, 3), np.int32)
    lib.obj_parse(path.encode(), _ptr(verts), ctypes.byref(nv), _ptr(tris),
                  ctypes.byref(nt))
    return verts, tris


def load_elenode_native(basename: str):
    """(verts (V, 3) f64, tets (T, 4) int32, indices from 0), or None."""
    lib = _load()
    if lib is None:
        return None
    nv, nt = ctypes.c_int64(), ctypes.c_int64()
    ele, node = (basename + ".ele").encode(), (basename + ".node").encode()
    if lib.elenode_parse(ele, node, None, ctypes.byref(nv), None,
                         ctypes.byref(nt)) != 0:
        return None
    verts = np.empty((nv.value, 3))
    tets = np.empty((nt.value, 4), np.int32)
    lib.elenode_parse(ele, node, _ptr(verts), ctypes.byref(nv), _ptr(tets),
                      ctypes.byref(nt))
    return verts, tets
