"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``, ``sm_90a``) that
replace the JAX package's three Pallas kernels
(aa_admm_tpu/ops/pallas_kernels.py), each with its plain torch twin:

* B1 ``ericson_candidates_idx`` / ``ericson_candidates_T`` /
  ``ericson_candidates`` — exact closest point over per-query candidate
  triangles (replaces ``_ericson_kernel``). The indexed entry gathers its
  candidates from a static triangle table inside the kernel; the plane
  entry takes the candT cache's (9, K, Q) layout.
* B2 ``cg_update1`` — the post-matvec half of a CG iteration, one launch
  (replaces ``_cg_k1``).
* B3 ``cg_update2`` — the post-preconditioner half, one launch (replaces
  ``_cg_k2``).
* The given entries of B2 and B3, for a CG whose rows are split over ranks
  (the sharded geometry solve): ``cg_dot`` (this rank's column dots, in a
  fixed order), ``cg_update1_given`` (B2's update from an all-rank pAp; it
  returns this rank's r.r) and ``cg_update2_given`` (B3's update from an
  all-rank rz), one launch each. None waits on a grid-wide barrier.
  ``cg_dot`` and ``cg_update1_given`` take an optional ``out`` (c,) tensor
  (a row of a larger buffer, say) for their result.
* ``tet_prox`` / ``tet_grad`` — the physics local step of a tet batch, the
  prox and the energy gradient of one material (linear, NeoHookean or
  StVK) on a plane-form (9, E) block, one thread an element (replaces no
  TPU kernel: the JAX package leaves this step to XLA). Their twins are
  the batched torch math of ops/prox.py and ops/svd3.py (Jacobi SVD).

Dispatch is by the tensors' device alone: a CUDA tensor launches the kernel
(or raises), a CPU tensor runs the twin. Nothing falls back.

Build: at first use each source is compiled by ``nvcc`` into a shared
library with a plain C interface under ``aa_admm_tpu_torch/build/`` (named by
the source's hash, so an edited source rebuilds) and loaded with ctypes.
``build_all()`` starts one ``nvcc`` per source, all at once. Every C entry
point launches on the caller's stream, allocates nothing, does not
synchronize, and returns ``cudaGetLastError()``. The runtime launches on
its current card, so each wrapper makes its tensors' card current for the
launch (``_launch``): a ``cuda:1`` tensor runs on card 1 whichever card the
caller has current.

Launch counters (``ericson_launches`` for the plane entry,
``ericson_idx_launches`` for the indexed entry, ``cg_update1_launches``,
``cg_update2_launches``, ``cg_dot_launches``, ``cg_update1_given_launches``,
``cg_update2_given_launches``, ``tet_prox_launches``, ``tet_grad_launches``)
count one per wrapper call that launched its kernel (one CUDA launch each).

Cached state, per process: B1's padded copy of each triangle table (a few
tables, rebuilt when the table changes in place; made on the table's card)
and the grid limits and scratch of B2, B3, ``cg_dot`` and
``cg_update1_given`` (partial sums and counters, one set per entry, card,
dtype, c and grid size; calls that share a set must be ordered on one
stream, as the solver's are). The scratch is made on a set's first call,
which must not be under CUDA-graph capture. Every CG entry moves 16-byte
words and raises on vectors that do not start on a 16-byte boundary.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from . import prox as proxops

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = {"ericson": "ericson.cu", "cg_update": "cg_update.cu",
           "tet_prox": "tet_prox.cu"}
TET_KINDS = ("linear", "neohookean", "stvk")
# -fmad=false: no fused multiply-adds, so each kernel rounds op by op like
# its twin (the Ericson sweep's candidate choice then matches the twin's on
# near-ties; both kernels are bound by bytes, not by arithmetic).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

ericson_launches = 0
ericson_idx_launches = 0
cg_update1_launches = 0
cg_update2_launches = 0
cg_dot_launches = 0
cg_update1_given_launches = 0
cg_update2_given_launches = 0
tet_prox_launches = 0
tet_grad_launches = 0

_LIBS: dict = {}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ARGTYPES = {
    "ericson_candidates": [_P, _P, _P, _P, _I, _I, _LL, _P],
    "ericson_candidates_idx": [_P, _P, _P, _P, _P, _I, _I, _I, _LL, _LL, _P],
    "cg_update1": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _P],
    "cg_update1_max_blocks": [_I, _I, _P],
    "cg_update2": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _P],
    "cg_update2_max_blocks": [_I, _I, _P],
    "cg_dot": [_P, _P, _P, _P, _P, _LL, _I, _I, _P],
    "cg_update1_given": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I,
                         _I, _P],
    "cg_given_max_blocks": [_I, _I, _P],
    "cg_update2_given": [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _P],
    "cg_update2_given_max_blocks": [_I, _I, _P],
    **{f"tet_prox_{kind}": [_P, _P, _P, _P, _P, _LL, _P]
       for kind in TET_KINDS},
    **{f"tet_grad_{kind}": [_P, _P, _P, _P, _P, _P, _LL, _P]
       for kind in TET_KINDS},
}
_LIB_OF = {"ericson_candidates": "ericson", "ericson_candidates_idx": "ericson",
           "cg_update1": "cg_update", "cg_update1_max_blocks": "cg_update",
           "cg_update2": "cg_update", "cg_update2_max_blocks": "cg_update",
           "cg_dot": "cg_update",
           "cg_update1_given": "cg_update", "cg_update2_given": "cg_update",
           "cg_given_max_blocks": "cg_update",
           "cg_update2_given_max_blocks": "cg_update",
           **{e: "tet_prox" for e in _ARGTYPES if e.startswith("tet_")}}
# B1: lanes per query are raised (powers of two up to 32) until about this
# many threads are in flight: four 256-thread blocks on each of 132 SMs.
ERICSON_TARGET_THREADS = 131072
ERICSON_ROW_WORDS = 12       # padded table row: kRowWords in ericson.cu
_TABLES: list = []           # [(table, its version, padded copy)], newest last
_MAX_TABLES = 4
# CG reductions: per-block partial sums over a fixed grid, reduced in a fixed
# order (deterministic; no float atomics).
CG_MAX_COLS = 4
# The grids of B2, B3 and the given entries: blocks of 4 rows a thread
# (the 4-row chunks of cg_update.cu), no more than the card holds at once;
# threads a block: B2, cg_dot and cg_update1_given (kThreads1, kThreadsG),
# B3 (kThreads2), cg_update2_given (kThreadsG2).
CG1_THREADS = 256
CG2_THREADS = 512
CG2_GIVEN_THREADS = 128
CG1_ROWS = 4
_MAX_BLOCKS: dict = {}       # (entry, card index, dtype, c) -> blocks
_SCRATCH: dict = {}          # (entry, card index, dtype, c, blocks) -> tensors


def reset_launch_counts():
    global ericson_launches, ericson_idx_launches
    global cg_update1_launches, cg_update2_launches
    global cg_dot_launches, cg_update1_given_launches
    global cg_update2_given_launches, tet_prox_launches, tet_grad_launches
    ericson_launches = ericson_idx_launches = 0
    cg_update1_launches = cg_update2_launches = 0
    cg_dot_launches = cg_update1_given_launches = 0
    cg_update2_given_launches = tet_prox_launches = tet_grad_launches = 0


def launch_counts() -> dict:
    return {"ericson": ericson_launches, "ericson_idx": ericson_idx_launches,
            "cg_update1": cg_update1_launches,
            "cg_update2": cg_update2_launches, "cg_dot": cg_dot_launches,
            "cg_update1_given": cg_update1_given_launches,
            "cg_update2_given": cg_update2_given_launches,
            "tet_prox": tet_prox_launches, "tet_grad": tet_grad_launches}


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
                f.restype = _I
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
    mixed devices, other devices or unsupported dtypes. (The checks build
    their messages only to raise: this runs on every call of a host-paced
    loop.)"""
    dev = tensors[0].device
    dt = tensors[0].dtype
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{entry}: all inputs must be on one device")
        if t.dtype != dt:
            raise ValueError(f"{entry}: all inputs must share one dtype")
    if dt not in _SUFFIX:
        raise ValueError(f"{entry}: dtype {dt} not supported (float32 or "
                         f"float64)")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{entry}: no kernel for device {dev}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{entry}: inputs must be contiguous")
    return True


def _launch(entry: str, dtype, dev, *args):
    """Calls C entry point `entry` with args and dev's current stream, with
    dev's card current (the runtime launches on its current card)."""
    with torch.cuda.device(dev):
        _check(_fn(entry, dtype)(*args,
                                 torch.cuda.current_stream(dev).cuda_stream),
               entry)


# ---------------------------------------------------------------------------
# B1: Ericson candidate closest point
# ---------------------------------------------------------------------------

def _first_min(p, cand):
    """Plain B1 on materialised candidates: p (Q, 3), cand (Q, K, 3, 3) ->
    (point (Q, 3), sqdist (Q,)) of the FIRST minimum over K (argmin)."""
    from .closest_point import _closest_point_candidates_all
    Q = cand.shape[0]
    q, sqd = _closest_point_candidates_all(p, cand)
    i = torch.argmin(sqd, dim=1)
    qb = torch.gather(q, 1, i[:, None, None].expand(Q, 1, 3))[:, 0]
    return qb, torch.gather(sqd, 1, i[:, None])[:, 0]


def ericson_lanes(Q: int, K: int) -> int:
    """Lanes per query of both B1 kernels: doubled from 1 while fewer than
    ERICSON_TARGET_THREADS threads would run, up to 32 and to the first
    power of two >= K."""
    lanes = 1
    while lanes < 32 and lanes < K and Q * lanes < ERICSON_TARGET_THREADS:
        lanes *= 2
    return lanes


def ericson_candidates_T_plain(pT, candT):
    """Twin of B1: pT (3, Q), candT (9, K, Q) -> (qv (3, Q), dv (1, Q)),
    the closest point and squared distance of the FIRST minimum over K."""
    K, Q = candT.shape[1], candT.shape[2]
    q, d = _first_min(pT.T, candT.permute(2, 1, 0).reshape(Q, K, 3, 3))
    return q.T.contiguous(), d[None, :]


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
    _launch("ericson_candidates", pT.dtype, pT.device, pT.data_ptr(),
            candT.data_ptr(), qv.data_ptr(), dv.data_ptr(), K,
            ericson_lanes(Q, K), Q)
    ericson_launches += 1
    return qv, dv


def _row_table(tris):
    """The (T, 12) padded copy of a (T, 3, 3) triangle table that the
    indexed kernel reads (three 16-byte loads a row at f32). Built once per
    table and kept while the table is unchanged: the cache holds the table
    itself, so its memory cannot be reused by another tensor, and compares
    its version counter, which every in-place torch op on it bumps."""
    for i, (src, version, tab) in enumerate(_TABLES):
        if (src.data_ptr() == tris.data_ptr() and src.shape == tris.shape
                and src.stride() == tris.stride() and src.dtype == tris.dtype
                and src.device == tris.device):
            if version == tris._version:
                return tab
            del _TABLES[i]
            break
    T = tris.shape[0]
    tab = torch.zeros((T, ERICSON_ROW_WORDS), dtype=tris.dtype,
                      device=tris.device)
    tab[:, :9] = tris.reshape(T, 9)
    _TABLES.append((tris, tris._version, tab))
    del _TABLES[:-_MAX_TABLES]
    return tab


def ericson_candidates_idx_plain(p, tris, idx, sub: int = 1):
    """Twin of the indexed B1 entry: gathers the (Q, G * sub, 3, 3)
    candidates tris[idx[i, k // sub] * sub + k % sub] and sweeps them."""
    Q, G = idx.shape
    rows = (idx[:, :, None] * sub
            + torch.arange(sub, device=idx.device)).reshape(Q, G * sub)
    return _first_min(p, tris[rows])


def ericson_candidates_idx(p, tris, idx, sub: int = 1):
    """B1 on indexed candidates: p (Q, 3) points, tris (T, 3, 3) a static
    triangle table, idx (Q, G) int64; candidate k of query i is table row
    idx[i, k // sub] * sub + k % sub (sub = 1: idx names triangles; sub > 1:
    idx names runs of sub contiguous triangles). Returns (point (Q, 3),
    sqdist (Q,)) of the first minimum over the G * sub candidates. Rows
    must lie in the table: the kernel stops the device on one that does
    not, as torch indexing does."""
    global ericson_idx_launches
    _require(p.dim() == 2 and p.shape[1] == 3, "ericson_idx: p must be (Q, 3)")
    _require(tris.dim() == 3 and tris.shape[1:] == (3, 3),
             "ericson_idx: tris must be (T, 3, 3)")
    _require(idx.dim() == 2 and idx.shape[0] == p.shape[0]
             and idx.dtype == torch.int64,
             "ericson_idx: idx must be (Q, G) int64 with p's Q")
    _require(sub >= 1 and idx.shape[1] * sub >= 1,
             "ericson_idx: needs G * sub >= 1 candidates")
    _require(idx.device == p.device, "ericson_idx: all inputs must be on one device")
    if not _on_cuda([p, tris], "ericson_candidates_idx"):
        return ericson_candidates_idx_plain(p, tris, idx, sub)
    _require(idx.is_contiguous(), "ericson_idx: inputs must be contiguous")
    (Q, G), T = idx.shape, tris.shape[0]
    q = torch.empty((Q, 3), dtype=p.dtype, device=p.device)
    d = torch.empty((Q,), dtype=p.dtype, device=p.device)
    if Q == 0:
        return q, d
    tab = _row_table(tris)
    _launch("ericson_candidates_idx", p.dtype, p.device, p.data_ptr(),
            tab.data_ptr(), idx.data_ptr(), q.data_ptr(), d.data_ptr(), G,
            sub, ericson_lanes(Q, G * sub), Q, T)
    ericson_idx_launches += 1
    return q, d


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


def _check_cg(entry, vecs, scalars):
    n_c = vecs[0].shape
    if len(n_c) != 2:
        raise ValueError(f"{entry}: vectors must be (n, c)")
    for v in vecs:
        if v.shape != n_c:
            raise ValueError(f"{entry}: vectors must share shape (n, c)")
    for s in scalars:
        if s.shape != n_c[1:]:
            raise ValueError(f"{entry}: scalars must be (c,)")
    return n_c


def _resident_blocks(entry: str, c: int, dtype, device) -> int:
    """Blocks of the kernels behind `entry` that the card holds at once
    (the occupancy API times the SMs), asked of the card once per device,
    dtype and c."""
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    key = (entry, device.index, dtype, c)
    most = _MAX_BLOCKS.get(key)
    if most is None:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):       # the occupancy API's card
            _check(_fn(entry, dtype)(c, device.index, ctypes.addressof(out)),
                   entry)
        most = _MAX_BLOCKS[key] = out.value
    return most


def one_wave_blocks(n: int, most: int, threads: int = CG1_THREADS) -> int:
    """A grid for n rows of 4-row chunks, `threads` chunks a block: enough
    blocks for a chunk per thread, but no more than `most` (what the card
    holds at once), and at least one."""
    return max(1, min(most, -(-n // (CG1_ROWS * threads))))


def cg1_blocks(n: int, c: int, dtype, device) -> int:
    """B2's grid for n rows: one block per 1,024 rows, but no more than the
    card holds at once. Fixed for a card and n, so the reduction order is
    fixed."""
    return one_wave_blocks(
        n, _resident_blocks("cg_update1_max_blocks", c, dtype, device))


def cg2_blocks(n: int, c: int, dtype, device) -> int:
    """B3's grid for n rows: B2's rule over B3's blocks and occupancy."""
    return one_wave_blocks(
        n, _resident_blocks("cg_update2_max_blocks", c, dtype, device),
        CG2_THREADS)


def cg_given_blocks(n: int, c: int, dtype, device) -> int:
    """The grid of cg_dot and cg_update1_given for n rows: one wave, as
    B2's, of their own kernels. Fixed for a card, dtype, c and n, so the
    reduction order is fixed."""
    return one_wave_blocks(
        n, _resident_blocks("cg_given_max_blocks", c, dtype, device))


def cg2_given_blocks(n: int, c: int, dtype, device) -> int:
    """cg_update2_given's grid for n rows: one wave of its own blocks."""
    return one_wave_blocks(
        n, _resident_blocks("cg_update2_given_max_blocks", c, dtype, device),
        CG2_GIVEN_THREADS)


def _scratch(entry: str, dtype, device, c: int, nb: int):
    """The partial sums (2, nb, c) and two integer counters of the one-launch
    reductions of `entry` (B2: both; B3 and the given entries: the first of
    each), kept per (entry, device, dtype, c, nb). The counters only grow,
    by nb per launch each, so they stay valid across calls, CUDA-graph
    replays and solves that alternate on one stream. Made outside any stream
    capture, so that the counters start from zero on the device."""
    key = (entry, device.index, dtype, c, nb)
    s = _SCRATCH.get(key)
    if s is None:
        _require(not torch.cuda.is_current_stream_capturing(),
                 f"{entry}: call it once before capturing it in a CUDA "
                 f"graph (its scratch is made on that first call)")
        s = _SCRATCH[key] = (
            torch.empty((2, nb, c), dtype=dtype, device=device),
            torch.zeros((2,), dtype=torch.int64, device=device))
    return s


def _aligned(entry, vecs):
    """Raises unless every vector starts on a 16-byte boundary (the
    kernels' 16-byte loads and stores)."""
    if any(t.data_ptr() % 16 for t in vecs):
        raise ValueError(f"{entry}: vectors must be 16-byte aligned "
                         f"(16-byte loads)")


def cg_update1(rz, p, ap, x, r, rr_prev, thresh):
    """B2: the post-matvec half of a CG iteration on (n, c) vectors
    (counterpart of pallas_kernels.cg_update1 without the band layout), in
    one launch. Updates x and r in place; returns rr (c,). rz, rr_prev,
    thresh: (c,)."""
    global cg_update1_launches
    n, c = _check_cg("cg_update1", [p, ap, x, r], [rz, rr_prev, thresh])
    if not _on_cuda([rz, p, ap, x, r, rr_prev, thresh], "cg_update1"):
        return cg_update1_plain(rz, p, ap, x, r, rr_prev, thresh)
    _require(1 <= c <= CG_MAX_COLS, f"cg_update1: c must be in 1..{CG_MAX_COLS}")
    _aligned("cg_update1", (p, ap, x, r))
    nb = cg1_blocks(n, c, x.dtype, x.device)
    partials, counters = _scratch("cg_update1", x.dtype, x.device, c, nb)
    rr = torch.empty((c,), dtype=x.dtype, device=x.device)
    _launch("cg_update1", x.dtype, x.device, rz.data_ptr(),
            rr_prev.data_ptr(), thresh.data_ptr(), p.data_ptr(),
            ap.data_ptr(), x.data_ptr(), r.data_ptr(), rr.data_ptr(),
            partials.data_ptr(), counters.data_ptr(), n, c, nb)
    cg_update1_launches += 1
    return rr


def cg_update2(rz_old, r, z, p, rr_prev, thresh):
    """B3: the post-preconditioner half of a CG iteration on (n, c) vectors
    (counterpart of pallas_kernels.cg_update2), in one launch. Updates p in
    place; returns rz (c,)."""
    global cg_update2_launches
    n, c = _check_cg("cg_update2", [r, z, p], [rz_old, rr_prev, thresh])
    if not _on_cuda([rz_old, r, z, p, rr_prev, thresh], "cg_update2"):
        return cg_update2_plain(rz_old, r, z, p, rr_prev, thresh)
    _require(1 <= c <= CG_MAX_COLS, f"cg_update2: c must be in 1..{CG_MAX_COLS}")
    _aligned("cg_update2", (r, z, p))
    nb = cg2_blocks(n, c, p.dtype, p.device)
    partials, counters = _scratch("cg_update2", p.dtype, p.device, c, nb)
    rz = torch.empty((c,), dtype=p.dtype, device=p.device)
    _launch("cg_update2", p.dtype, p.device, rz_old.data_ptr(),
            rr_prev.data_ptr(), thresh.data_ptr(), r.data_ptr(),
            z.data_ptr(), p.data_ptr(), rz.data_ptr(), partials.data_ptr(),
            counters.data_ptr(), n, c, nb)
    cg_update2_launches += 1
    return rz


# ---------------------------------------------------------------------------
# The given entries: B2 and B3 on a rank's rows, from all-rank dots
# ---------------------------------------------------------------------------

def _into(out, value):
    return value if out is None else out.copy_(value)


def cg_dot_plain(a, b, out=None):
    """Twin of cg_dot: the column dots a.b of (n, c) vectors (into out when
    given)."""
    return _into(out, (a * b).sum(0))


def cg_update1_given_plain(pap, rz, p, ap, x, r, rr_prev, thresh, out=None):
    """Twin of cg_update1_given: alpha = rz / pAp (pAp = 0 divides by 1) from
    the given pAp, 0 for frozen columns; x += alpha p and r -= alpha Ap in
    place; returns r.r of these rows per column (into out when given)."""
    a = rz / torch.where(pap == 0, torch.ones_like(pap), pap)
    alpha = torch.where(rr_prev > thresh, a, torch.zeros_like(a))
    x.add_(alpha[None, :] * p)
    r.sub_(alpha[None, :] * ap)
    return _into(out, (r * r).sum(0))


def cg_update2_given_plain(rz, rz_old, z, p, rr_prev, thresh):
    """Twin of cg_update2_given: beta = rz / rz_old (rz_old = 0 divides by
    1) from the given rz, 0 for frozen columns; p = z + beta p in place."""
    b = rz / torch.where(rz_old == 0, torch.ones_like(rz_old), rz_old)
    beta = torch.where(rr_prev > thresh, b, torch.zeros_like(b))
    p.copy_(z + beta[None, :] * p)


def _cg_cols(entry, c):
    _require(1 <= c <= CG_MAX_COLS, f"{entry}: c must be in 1..{CG_MAX_COLS}")


def _check_out(entry, out, like, c):
    if out is not None and not (out.shape == (c,) and out.dtype == like.dtype
                                and out.device == like.device
                                and out.is_contiguous()):
        raise ValueError(f"{entry}: out must be a contiguous ({c},) tensor "
                         f"of the inputs' dtype and device")


def _given_launch(entry, vecs, *ptrs_and_n):
    """Launches `entry` (cg_dot or cg_update1_given) on vecs' card over its
    one-wave grid, with its kept scratch; ptrs_and_n: the C entry's
    arguments before the scratch, then n."""
    v = vecs[0]
    n, c = v.shape
    _cg_cols(entry, c)
    _aligned(entry, vecs)
    nb = cg_given_blocks(n, c, v.dtype, v.device)
    partials, ticket = _scratch(entry, v.dtype, v.device, c, nb)
    _launch(entry, v.dtype, v.device, *ptrs_and_n[:-1], partials.data_ptr(),
            ticket.data_ptr(), ptrs_and_n[-1], c, nb)


def cg_dot(a, b, out=None):
    """This rank's column dots a.b (c,) of (n, c) vectors, in one launch: a
    one-wave grid of 16-byte loads whose last block sums the blocks'
    partials in a fixed order. The partials that the given entries are
    handed, summed over the ranks. Into out ((c,), a row of a buffer say)
    when given, else a new tensor."""
    global cg_dot_launches
    n, c = _check_cg("cg_dot", [a, b], [])
    _check_out("cg_dot", out, a, c)
    if not _on_cuda([a, b], "cg_dot"):
        return cg_dot_plain(a, b, out)
    if out is None:
        out = torch.empty((c,), dtype=a.dtype, device=a.device)
    _given_launch("cg_dot", [a, b], a.data_ptr(), b.data_ptr(),
                  out.data_ptr(), n)
    cg_dot_launches += 1
    return out


def cg_update1_given(pap, rz, p, ap, x, r, rr_prev, thresh, out=None):
    """B2 on this rank's rows with pAp given (summed over the ranks), in one
    launch: x and r updated in place; returns this rank's r.r (c,), to be
    summed over the ranks, into out when given. cg_dot's grid, loads and
    fixed-order sum."""
    global cg_update1_given_launches
    n, c = _check_cg("cg_update1_given", [p, ap, x, r],
                     [pap, rz, rr_prev, thresh])
    _check_out("cg_update1_given", out, x, c)
    if not _on_cuda([pap, rz, p, ap, x, r, rr_prev, thresh],
                    "cg_update1_given"):
        return cg_update1_given_plain(pap, rz, p, ap, x, r, rr_prev, thresh,
                                      out)
    if out is None:
        out = torch.empty((c,), dtype=x.dtype, device=x.device)
    _given_launch("cg_update1_given", [p, ap, x, r], pap.data_ptr(),
                  rz.data_ptr(), rr_prev.data_ptr(), thresh.data_ptr(),
                  p.data_ptr(), ap.data_ptr(), x.data_ptr(), r.data_ptr(),
                  out.data_ptr(), n)
    cg_update1_given_launches += 1
    return out


def cg_update2_given(rz, rz_old, z, p, rr_prev, thresh):
    """B3 on this rank's rows with rz_new given (summed over the ranks):
    p = z + beta p in place, one launch over a one-wave grid (no
    reduction, so no scratch)."""
    global cg_update2_given_launches
    n, c = _check_cg("cg_update2_given", [z, p], [rz, rz_old, rr_prev, thresh])
    if not _on_cuda([rz, rz_old, z, p, rr_prev, thresh], "cg_update2_given"):
        return cg_update2_given_plain(rz, rz_old, z, p, rr_prev, thresh)
    _cg_cols("cg_update2_given", c)
    _aligned("cg_update2_given", (z, p))
    _launch("cg_update2_given", p.dtype, p.device, rz.data_ptr(),
            rz_old.data_ptr(), rr_prev.data_ptr(), thresh.data_ptr(),
            z.data_ptr(), p.data_ptr(), n, c,
            cg2_given_blocks(n, c, p.dtype, p.device))
    cg_update2_given_launches += 1


# ---------------------------------------------------------------------------
# The tet batches' local step: prox and gradient, one launch a call
# ---------------------------------------------------------------------------

_TET_PROX = {"linear": proxops.prox_tet_linear,
             "neohookean": proxops.prox_tet_neohookean,
             "stvk": proxops.prox_tet_stvk}
_TET_GRAD = {"linear": proxops.grad_tet_linear,
             "neohookean": proxops.grad_tet_neohookean,
             "stvk": proxops.grad_tet_stvk}


def _tet_twin(fn, block, *args):
    """fn of ops/prox.py on a plane-form (9, E) block's (E, 3, 3) view,
    back in plane form (as TetBatch's CPU path calls it)."""
    E = block.shape[1]
    return fn(block.T.reshape(E, 3, 3), *args).reshape(E, 9).T


def tet_prox_plain(v, mu, lam, k, kind):
    """Twin of tet_prox: the material's prox of ops/prox.py (Jacobi SVD)."""
    return _tet_twin(_TET_PROX[kind], v, mu, lam, k)


def tet_grad_plain(z, mu, lam, k, vol, kind):
    """Twin of tet_grad: the material's gradient of ops/prox.py."""
    return _tet_twin(_TET_GRAD[kind], z, mu, lam, k, vol)


def _check_tet(entry, block, params, kind) -> bool:
    """Checks a call of tet_prox or tet_grad on any device; True where it
    launches (CUDA), False where the twin runs (CPU)."""
    _require(kind in TET_KINDS, f"{entry}: kind must be one of {TET_KINDS}")
    _require(block.dim() == 2 and block.shape[0] == 9,
             f"{entry}: the block must be (9, E) in plane form")
    E = block.shape[1]
    for p in params:
        _require(p.shape == (E,), f"{entry}: per-element parameters must be "
                                  f"(E,) with the block's E")
    _require(block.is_contiguous(), f"{entry}: the block must be contiguous")
    return _on_cuda([block, *params], entry)


def tet_prox(v, mu, lam, k, kind):
    """The prox of one tet material on a plane-form (9, E) block v (a
    contiguous (9, E) tensor) with per-element mu, lam, k (E,): on CUDA one
    launch of csrc/tet_prox.cu, which returns a new contiguous block; on
    the CPU the twin (ops/prox.py). kind: linear | neohookean | stvk."""
    global tet_prox_launches
    if not _check_tet("tet_prox", v, (mu, lam, k), kind):
        return tet_prox_plain(v, mu, lam, k, kind)
    out = torch.empty_like(v)
    if v.shape[1]:
        _launch(f"tet_prox_{kind}", v.dtype, v.device, v.data_ptr(),
                mu.data_ptr(), lam.data_ptr(), k.data_ptr(), out.data_ptr(),
                v.shape[1])
        tet_prox_launches += 1
    return out


def tet_grad(z, mu, lam, k, vol, kind):
    """dU/dF * vol of one tet material at a plane-form (9, E) block z, as
    tet_prox: one launch on CUDA, the twin on the CPU."""
    global tet_grad_launches
    if not _check_tet("tet_grad", z, (mu, lam, k, vol), kind):
        return tet_grad_plain(z, mu, lam, k, vol, kind)
    out = torch.empty_like(z)
    if z.shape[1]:
        _launch(f"tet_grad_{kind}", z.dtype, z.device, z.data_ptr(),
                mu.data_ptr(), lam.data_ptr(), k.data_ptr(), vol.data_ptr(),
                out.data_ptr(), z.shape[1])
        tet_grad_launches += 1
    return out
