"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``, ``sm_90a``) that
replace the JAX package's three Pallas kernels
(aa_admm_tpu/ops/pallas_kernels.py), each with its plain torch twin:

* B1 ``ericson_candidates_T`` / ``ericson_candidates`` — exact closest point
  over per-query candidate triangles (replaces ``_ericson_kernel``).
* B2 ``cg_update1`` — the post-matvec half of a CG iteration
  (replaces ``_cg_k1``).
* B3 ``cg_update2`` — the post-preconditioner half (replaces ``_cg_k2``).

Dispatch is by the tensors' device alone: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the twin. Nothing falls back.

Build: at first use each source is compiled by ``nvcc`` into a shared
library with a plain C interface under ``aa_admm_tpu_torch/build/`` (named by
the source's hash, so an edited source rebuilds) and loaded with ctypes.
``build_all()`` starts one ``nvcc`` per source, all at once. Every C entry
point launches on the caller's stream, allocates nothing, does not
synchronize, and returns ``cudaGetLastError()``.

Launch counters (``ericson_launches``, ``cg_update1_launches``,
``cg_update2_launches``) count one per wrapper call that launched its kernel,
however many CUDA launches that call takes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = {"ericson": "ericson.cu", "cg_update": "cg_update.cu"}
# -fmad=false: no fused multiply-adds, so each kernel rounds op by op like
# its twin (the Ericson sweep's candidate choice then matches the twin's on
# near-ties; both kernels are bound by bytes, not by arithmetic).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

ericson_launches = 0
cg_update1_launches = 0
cg_update2_launches = 0

_LIBS: dict = {}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_P = ctypes.c_void_p
_ARGTYPES = {
    "ericson_candidates": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P],
    "cg_update1": [_P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, _P],
    "cg_update2": [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, _P],
}
_LIB_OF = {"ericson_candidates": "ericson", "cg_update1": "cg_update",
           "cg_update2": "cg_update"}
# CG reductions: per-block partial sums over a fixed grid, reduced in a fixed
# order (deterministic; no float atomics).
CG_THREADS = 256
CG_MAX_BLOCKS = 528          # 4 blocks on each of the H100's 132 SMs
CG_MAX_COLS = 4


def reset_launch_counts():
    global ericson_launches, cg_update1_launches, cg_update2_launches
    ericson_launches = cg_update1_launches = cg_update2_launches = 0


def launch_counts() -> dict:
    return {"ericson": ericson_launches, "cg_update1": cg_update1_launches,
            "cg_update2": cg_update2_launches}


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are compiled at "
                           "first use and need the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / SOURCES[name]).read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_all(names=None, verbose: bool = False) -> dict:
    """Compile every (or the named) kernel library that is not built yet,
    one nvcc process per source, all started together. Returns
    {name: compiler output}; raises if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = f"{out}.{os.getpid()}.tmp"      # concurrent builds don't collide
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, str(CSRC_DIR / SOURCES[name])]
        procs[name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (out, tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def _fn(entry: str, dtype: torch.dtype):
    name = _LIB_OF[entry]
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        for e, lname in _LIB_OF.items():
            if lname != name:
                continue
            for suf in _SUFFIX.values():
                f = getattr(lib, f"{e}_{suf}")
                f.argtypes = _ARGTYPES[e]
                f.restype = ctypes.c_int
        _LIBS[name] = lib
    return getattr(lib, f"{entry}_{_SUFFIX[dtype]}")


def _check(rc: int, entry: str):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {entry} failed to launch: "
                           f"cudaError {rc}")


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def _on_cuda(tensors, entry: str) -> bool:
    """True for CUDA inputs (launch), False for CPU inputs (twin); raises on
    mixed devices, other devices or unsupported dtypes."""
    dev = tensors[0].device
    dt = tensors[0].dtype
    for t in tensors:
        _require(t.device == dev, f"{entry}: all inputs must be on one device")
        _require(t.dtype == dt, f"{entry}: all inputs must share one dtype")
    _require(dt in _SUFFIX, f"{entry}: dtype {dt} not supported "
                            f"(float32 or float64)")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{entry}: no kernel for device {dev}")
    for t in tensors:
        _require(t.is_contiguous(), f"{entry}: inputs must be contiguous")
    return True


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# ---------------------------------------------------------------------------
# B1: Ericson candidate closest point
# ---------------------------------------------------------------------------

def ericson_candidates_T_plain(pT, candT):
    """Twin of B1: pT (3, Q), candT (9, K, Q) -> (qv (3, Q), dv (1, Q)),
    the closest point and squared distance of the FIRST minimum over K."""
    from .closest_point import _closest_point_candidates_all
    K, Q = candT.shape[1], candT.shape[2]
    cand = candT.permute(2, 1, 0).reshape(Q, K, 3, 3)
    q, sqd = _closest_point_candidates_all(pT.T, cand)
    i = torch.argmin(sqd, dim=1)          # first minimum, like the kernel
    qb = torch.gather(q, 1, i[:, None, None].expand(Q, 1, 3))[:, 0]
    d = torch.gather(sqd, 1, i[:, None])[:, 0]
    return qb.T.contiguous(), d[None, :]


def ericson_candidates_T(pT, candT):
    """B1 on kernel-layout inputs: pT (3, Q), candT (9, K, Q) coordinate
    planes [ax ay az bx by bz cx cy cz], queries contiguous. Returns
    (qv (3, Q), dv (1, Q)). Counterpart of pallas_kernels.ericson_candidates_T
    (no query padding: the TPU tile width is not carried over)."""
    global ericson_launches
    _require(pT.dim() == 2 and pT.shape[0] == 3, "ericson: pT must be (3, Q)")
    _require(candT.dim() == 3 and candT.shape[0] == 9
             and candT.shape[2] == pT.shape[1],
             "ericson: candT must be (9, K, Q) with pT's Q")
    _require(candT.shape[1] >= 1, "ericson: needs K >= 1 candidates")
    if not _on_cuda([pT, candT], "ericson_candidates"):
        return ericson_candidates_T_plain(pT, candT)
    K, Q = candT.shape[1], candT.shape[2]
    qv = torch.empty((3, Q), dtype=pT.dtype, device=pT.device)
    dv = torch.empty((1, Q), dtype=pT.dtype, device=pT.device)
    if Q == 0:
        return qv, dv
    f = _fn("ericson_candidates", pT.dtype)
    _check(f(pT.data_ptr(), candT.data_ptr(), qv.data_ptr(), dv.data_ptr(),
             K, Q, _stream(pT.device)), "ericson_candidates")
    ericson_launches += 1
    return qv, dv


def ericson_candidates(p, cand):
    """B1 on (Q, 3) points and (Q, K, 3, 3) candidates -> (points (Q, 3),
    sqdist (Q,)); relays the candidates into the (9, K, Q) kernel layout."""
    Q, K = cand.shape[0], cand.shape[1]
    candT = cand.reshape(Q, K, 9).permute(2, 1, 0).contiguous()
    qv, dv = ericson_candidates_T(p.T.contiguous(), candT)
    return qv.T, dv[0]


# ---------------------------------------------------------------------------
# B2 / B3: fused CG vector updates on (n, c) vectors
# ---------------------------------------------------------------------------

def cg_update1_plain(rz, p, ap, x, r, rr_prev, thresh):
    """Twin of B2: pAp = p.Ap per column; alpha = rz / pAp (pAp = 0 divides
    by 1), 0 for frozen columns (rr_prev <= thresh); x += alpha p and
    r -= alpha Ap in place; returns rr = r.r per column."""
    pAp = (p * ap).sum(0)
    a = rz / torch.where(pAp == 0, torch.ones_like(pAp), pAp)
    alpha = torch.where(rr_prev > thresh, a, torch.zeros_like(a))
    x.add_(alpha[None, :] * p)
    r.sub_(alpha[None, :] * ap)
    return (r * r).sum(0)


def cg_update2_plain(rz_old, r, z, p, rr_prev, thresh):
    """Twin of B3: rz = r.z per column; beta = rz / rz_old (rz_old = 0
    divides by 1), 0 for frozen columns; p = z + beta p in place; returns
    rz."""
    rz = (r * z).sum(0)
    b = rz / torch.where(rz_old == 0, torch.ones_like(rz_old), rz_old)
    beta = torch.where(rr_prev > thresh, b, torch.zeros_like(b))
    p.copy_(z + beta[None, :] * p)
    return rz


def cg_blocks(n: int) -> int:
    """Grid size of the CG kernels for n rows (fixed per n, so the partial
    sums and hence the reduction order are fixed)."""
    return max(1, min(CG_MAX_BLOCKS, -(-n // CG_THREADS)))


def _check_cg(entry, vecs, scalars):
    n_c = vecs[0].shape
    _require(vecs[0].dim() == 2, f"{entry}: vectors must be (n, c)")
    for v in vecs:
        _require(v.shape == n_c, f"{entry}: vectors must share shape (n, c)")
    for s in scalars:
        _require(s.shape == (n_c[1],), f"{entry}: scalars must be (c,)")
    return n_c


def cg_update1(rz, p, ap, x, r, rr_prev, thresh):
    """B2: the post-matvec half of a CG iteration on (n, c) vectors
    (counterpart of pallas_kernels.cg_update1 without the band layout).
    Updates x and r in place; returns rr (c,). rz, rr_prev, thresh: (c,)."""
    global cg_update1_launches
    n, c = _check_cg("cg_update1", [p, ap, x, r], [rz, rr_prev, thresh])
    if not _on_cuda([rz, p, ap, x, r, rr_prev, thresh], "cg_update1"):
        return cg_update1_plain(rz, p, ap, x, r, rr_prev, thresh)
    _require(1 <= c <= CG_MAX_COLS, f"cg_update1: c must be in 1..{CG_MAX_COLS}")
    nb = cg_blocks(n)
    partials = torch.empty((2, nb, c), dtype=x.dtype, device=x.device)
    rr = torch.empty((c,), dtype=x.dtype, device=x.device)
    f = _fn("cg_update1", x.dtype)
    _check(f(rz.data_ptr(), rr_prev.data_ptr(), thresh.data_ptr(),
             p.data_ptr(), ap.data_ptr(), x.data_ptr(), r.data_ptr(),
             rr.data_ptr(), partials.data_ptr(), n, c, nb,
             _stream(x.device)), "cg_update1")
    cg_update1_launches += 1
    return rr


def cg_update2(rz_old, r, z, p, rr_prev, thresh):
    """B3: the post-preconditioner half of a CG iteration on (n, c) vectors
    (counterpart of pallas_kernels.cg_update2). Updates p in place; returns
    rz (c,)."""
    global cg_update2_launches
    n, c = _check_cg("cg_update2", [r, z, p], [rz_old, rr_prev, thresh])
    if not _on_cuda([rz_old, r, z, p, rr_prev, thresh], "cg_update2"):
        return cg_update2_plain(rz_old, r, z, p, rr_prev, thresh)
    _require(1 <= c <= CG_MAX_COLS, f"cg_update2: c must be in 1..{CG_MAX_COLS}")
    nb = cg_blocks(n)
    partials = torch.empty((nb, c), dtype=p.dtype, device=p.device)
    rz = torch.empty((c,), dtype=p.dtype, device=p.device)
    f = _fn("cg_update2", p.dtype)
    _check(f(rz_old.data_ptr(), rr_prev.data_ptr(), thresh.data_ptr(),
             r.data_ptr(), z.data_ptr(), p.data_ptr(), rz.data_ptr(),
             partials.data_ptr(), n, c, nb, _stream(p.device)), "cg_update2")
    cg_update2_launches += 1
    return rz
