"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line with its seconds; any failed check exits
non-zero before the final result line):
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from aa_admm_tpu_torch/csrc (one nvcc each, in
     parallel);
  3. each kernel against its plain torch twin on the card, float32 and
     float64, at the CPU tests' shapes and at the main path's shapes; device
     times of kernel and twin (CUDA-graph replays between CUDA events)
     beside the kernel's bound; B1's indexed entry also against the chain
     it replaced (gather, relayout, plane entry); B2 called twice must give
     equal bits;
  4. a small float64 wire-mesh solve on the CG path (group closest-point
     cache, reference > 20,000 triangles) on the GPU and on the CPU through
     the port: function values and solution must agree; then the same on
     the flat cache with cached (9, K, Q) candidates (reference of 6,962
     triangles), the path of B1's plane entry;
  5. the main path at full width: a synthetic wire mesh at MaleTorso scale
     (about 231k vertices after subdivision, a 40k-triangle reference)
     through ``optimize_mesh`` in float32, with every kernel's launches
     counted and bench.py's wire-mesh bounds reported beside its errors;
  6. a torch.profiler breakdown of the first five iterations of the
     full-width solve (per-kernel device time, device idle share, and the
     port's kernels' device time per launch on the solve's own data; the
     table goes to result/profile_full.txt);
  7. planarity at costa2k scale: a noisy 48 x 48-face quad grid against the
     clean height field triangulated to 9,800 triangles through the
     planarity app's ``optimize_mesh`` (the flat closest-point cache: B1's
     plane entry on the cached candidates, its indexed entry in the 2-stage
     queries of the first and last energy): 100 float32
     iterations on the GPU (the max planarity error must fall), then 20
     float64 iterations on the GPU and the CPU (function values and reject
     sequences must agree);
  8. physics, float64: one non-accelerated step of the published beams
     scene on the GPU and the CPU (residuals must agree, and the head must
     match the C++ golden of tests/golden/), ten Anderson-accelerated frames
     on the GPU (the pins must move with the stretch), a torch.profiler
     breakdown of ten accelerated iterations, and one
     accelerated step of the beams built from 48 x 12 x 12 cubes, which
     takes the CG path;
  9. physics in the zxu order, float64, through the apps' build_scene on
     synthetic mesh files: plinkohit and plinkopony on a 12 x 7 x 8-cube
     block (936 vertices, the horse's size), 30 frames of -a 1 -am 5 -it 13
     each, with GPU against CPU over the first contact frame; windyflag on
     a 64 x 64 grid (GPU against CPU, ten accelerated frames, a profile in
     result/profile_zxu.txt, sequential wind on 16 x 16); the two-block
     self-collision scene (30 frames, and the hash collider forced to
     overflow against the dense one); three accelerated frames of three
     48 x 12 x 12-cube blocks over the plinkohit pit (24,843 vertices),
     which take the CG path;
 10. instrumentation and state, float64 unless noted: the instrumented step
     (beams with -a 1 -am 5 and without; windyflag 64 x 64 in zxu, -a 1
     -am 5) against the fused step on the GPU and against itself on the
     CPU, with its per-phase RuntimeData split; chunked residual tracing
     (trace_chunk 10 and 1) bit-equal to the fused steps; save_admm_state
     at iteration 50 and the replays (the .npz sidecar's accelerated tail
     bit-equal, the text alone within 1e-11, the GPU's dump on the CPU) on
     plinkohit's first frame and beams; beams --log-x-star and the AA sweep
     (test_anderson_admm, 7 settings x 2 frames); the plain geometry solver
     on the planarity scene (f32 quality, f64 GPU vs CPU, B1's launches on
     its path); the native library built and held against the NumPy
     parsers and the f64 CPU closest-point sweep. The bit-for-bit
     comparisons run without deterministic algorithms (every scatter of
     the port sums in a fixed order);
 11. the fixed-order scatter: without deterministic algorithms, each run
     twice from one state and held bit for bit: two accelerated beams
     steps, two windyflag-synthetic steps, plinkohit's first contact
     frame, five float32 trials of phase 5's wire mesh (its solver when
     phase 5 ran, else a new 20-iteration solve of its scene).

``--phases 1,2,7`` runs only the listed phases (phase 1 always runs); the
result lines need every phase.

The last two lines are the kernels' JSON record and the run's result JSON.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12         # float32 outside the tensor cores
H100_F64_FLOPS = 34e12         # float64 outside the tensor cores
ERICSON_FLOPS_PER_PAIR = 120   # Ericson test + select + distance, rounded up
MAIN_Q = 65536                 # the group fast path's query tile
# B1's tiles on the main path, all through the indexed entry:
# (queries, index columns G, sub); candidates K = G * sub
ERICSON_SHAPES = {"group fast path": (MAIN_Q, 6, 16),
                  "group refresh": (8192, 48, 1), "2-stage": (4096, 48, 1)}
MAIN_T = 39808                 # the main path's triangle table (Morton-padded)
MAIN_N = 230400                # CG vector rows at MaleTorso scale
# the kernels of the subgroup-cache path (phases 4 and 5), and of the flat
# cache with cached (9, K, Q) candidates (phase 4, second solve)
MAIN_PATH_KERNELS = ("ericson_idx", "cg_update1", "cg_update2")
CANDT_PATH_KERNELS = ("ericson", "ericson_idx", "cg_update1", "cg_update2")
SMALL_N_REF, CANDT_N_REF = 102, 60     # 20,402 and 6,962 triangles
# phase 7: B1's shapes on the planarity scene (2,401 queries, 48 candidates
# from a 9,800-triangle table); phase 8: the beams' C++ golden
PLAN_Q, PLAN_K, PLAN_T = 2401, 48, 9800
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "golden", "beams_step1_residual_no_cpp.txt")

T0 = time.perf_counter()


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(name, t0):
    print(f"[phase] {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean milliseconds per eager call of fn() (CUDA events around a loop
    of calls): the host's Python and launch cost included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, reps=5):
    """Mean device milliseconds of one fn() call: `iters` calls captured
    into a CUDA graph, replayed `reps` times between CUDA events, so the
    host's per-call cost is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def time_pair(kernel, twin, iters=20):
    """(kernel device ms, twin device ms, kernel eager ms, twin eager ms)."""
    return (device_ms(kernel, iters), device_ms(twin, iters),
            cuda_ms(kernel, iters), cuda_ms(twin, iters))


def bound_ms(n_bytes, n_flops, dtype):
    peak = H100_F32_FLOPS if dtype == torch.float32 else H100_F64_FLOPS
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, n_flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Synthetic scenes
# ---------------------------------------------------------------------------

def quad_grid(nx, ny, noise, field=None, seed=0):
    """Noisy (nx x ny)-face quad grid, unit spacing, z = field(x, y) + noise."""
    from aa_admm_tpu_torch.core.polymesh import PolyMesh
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.arange(nx + 1, dtype=float),
                         np.arange(ny + 1, dtype=float), indexing="ij")
    z = field(xs, ys) if field is not None else np.zeros_like(xs)
    verts = np.stack([xs.ravel(), ys.ravel(),
                      (z + noise * rng.normal(size=xs.shape)).ravel()], 1)
    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    a = (i * (ny + 1) + j).ravel()
    faces = np.stack([a, a + ny + 1, a + ny + 2, a + 1], 1).tolist()
    return PolyMesh(verts=verts, faces=faces)


def height_field_tris(n, lo, hi, field):
    """The height field z = field(x, y) over [lo, hi]^2, triangulated on an
    n x n vertex grid: 2 (n-1)^2 triangles."""
    u = np.linspace(lo, hi, n)
    X, Y = np.meshgrid(u, u, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel(), field(X, Y).ravel()], 1)
    i, j = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    a = (i * n + j).ravel()
    b = a + n
    faces = np.concatenate([np.stack([a, b, a + 1], 1),
                            np.stack([b, b + 1, a + 1], 1)])
    return verts, faces


def small_scene(n_ref=102):
    """The CPU tests' CG-path scene: a 4x4 noisy grid (81 vertices after
    subdivision) over a bumpy reference of 2 (n_ref - 1)^2 triangles:
    20,402 (subgroup cache) by default, 6,962 at n_ref = 60 (flat cache
    with cached (9, K, Q) candidates)."""
    from aa_admm_tpu_torch.core.polymesh import subdivide_and_smooth

    def field(x, y):
        return 0.3 * np.sin(0.13 * x) * np.cos(0.09 * y)

    mesh = quad_grid(4, 4, 0.15)
    el = mesh.average_edge_length()
    ref_v, ref_f = height_field_tris(n_ref, -15.0, 21.0, field)
    return subdivide_and_smooth(mesh), el * 0.5, ref_v, ref_f


def full_scene(n_faces=240, n_ref=142):
    """MaleTorso scale: a noisy 240 x 240-face quad grid on a bumpy height
    field, subdivided and smoothed to 231,361 vertices; the reference is
    the same field triangulated to 2 * 141^2 = 39,762 triangles."""
    from aa_admm_tpu_torch.core.polymesh import subdivide_and_smooth

    def field(x, y):
        return 3.0 * np.sin(2 * np.pi * x / 80.0) * np.cos(2 * np.pi * y / 60.0)

    mesh = quad_grid(n_faces, n_faces, 0.05, field=field, seed=1)
    el = mesh.average_edge_length()
    ref_v, ref_f = height_field_tris(n_ref, -2.0, n_faces + 2.0, field)
    return subdivide_and_smooth(mesh), el * 0.5, ref_v, ref_f


def planarity_scene(n_faces=48, n_ref=71):
    """costa2k scale: a noisy 48 x 48-face quad grid (2,401 vertices, 2,304
    quads; z noise sigma 0.05 of the unit edge) on the height field
    z = 2 sin(2 pi x / 40) cos(2 pi y / 30), against the clean field
    triangulated to 2 * 70^2 = 9,800 triangles (flat cache with cached
    candidates: above 4,096 and at most 20,000 triangles, Q * K <= 1M)."""
    def field(x, y):
        return 2.0 * np.sin(2 * np.pi * x / 40.0) * np.cos(2 * np.pi * y / 30.0)

    mesh = quad_grid(n_faces, n_faces, 0.05, field=field, seed=2)
    ref_v, ref_f = height_field_tris(n_ref, -2.0, n_faces + 2.0, field)
    return mesh, ref_v, ref_f


# ---------------------------------------------------------------------------
# Phase 3: kernels against their twins
# ---------------------------------------------------------------------------

def ericson_inputs(Q, K, dtype, device, seed):
    g = np.random.default_rng(seed)
    p = torch.from_numpy(g.standard_normal((Q, 3))).to(device, dtype)
    cand = torch.from_numpy(g.standard_normal((Q, K, 3, 3))).to(device, dtype)
    return p, cand


def ericson_idx_inputs(Q, G, sub, dtype, device, seed, n_rows=None):
    """Random points, a random table of n_rows triangles (a multiple of sub;
    default 4 G + 5 runs) and random run indices."""
    g = np.random.default_rng(seed)
    n_runs = (n_rows // sub) if n_rows else 4 * G + 5
    p = torch.from_numpy(g.standard_normal((Q, 3))).to(device, dtype)
    tris = torch.from_numpy(g.standard_normal((n_runs * sub, 3, 3))).to(
        device, dtype)
    idx = torch.from_numpy(g.integers(0, n_runs, size=(Q, G))).to(device)
    return p, tris, idx


def ericson_tie_inputs(sub, dtype, device):
    """Queries at the origin over a triangle A (nearest at its vertex
    (0, 0, 1)) and its mirror -A (nearest at (0, 0, -1)), both at squared
    distance exactly 1, at many positions k; all other rows are far
    triangles or 1e15 dummies, one index run duplicated. Returns
    (p, tris, idx, expected points): the lowest k of A and -A wins."""
    n_runs, G = (64, 48) if sub == 1 else (8, 6)
    g = np.random.default_rng(3)
    T = n_runs * sub
    tris = g.standard_normal((T, 3, 3)) + 50.0
    tris[T - sub // 2 - 1:] = 1e15
    tri_a = np.asarray([[0.0, 0, 1], [1, 0, 2], [0, 1, 2]])
    rows_a, rows_b = [sub + sub // 2, 2 * sub], [6 * sub - 1, 3 * sub]
    tris[rows_a], tris[rows_b] = tri_a, -tri_a
    idx, want = [], []
    for seed in range(200):
        runs = np.random.default_rng(seed).permutation(n_runs)[:G]
        k = {r: int(np.where(runs == r // sub)[0][0]) * sub + r % sub
             for r in rows_a + rows_b if r // sub in runs}
        if k.keys() & set(rows_a) and k.keys() & set(rows_b):
            idx.append(runs)
            want.append([0, 0, 1.0 if min(k, key=k.get) in rows_a else -1.0])
    dup = np.full(G, n_runs - 1)
    dup[[1, G - 2]] = rows_a[0] // sub
    idx.append(dup)
    want.append([0, 0, 1.0])

    def t(a, dt=dtype):
        return torch.as_tensor(np.asarray(a)).to(device, dt)
    return (torch.zeros((len(idx), 3), dtype=dtype, device=device), t(tris),
            t(idx, torch.int64), t(want))


def ericson_idx_bound(Q, G, sub, T, dtype):
    """Bytes: idx, points and the table read once, point and distance
    written once; operations: about 120 per (query, candidate)."""
    w = 4 if dtype == torch.float32 else 8
    n_bytes = 8 * Q * G + w * (3 * Q + 9 * T + 4 * Q)
    return bound_ms(n_bytes, ERICSON_FLOPS_PER_PAIR * G * sub * Q, dtype)


def check_ericson(ck, device, record, cand_q):
    """B1's plane entry vs twin at the test shapes, degenerate triangles,
    the main path's tile shapes with K = 48 or 96 candidates and its own
    paths' shapes (cand_q queries x 48 in phase 4, PLAN_Q x PLAN_K in phase
    7); records each of its own paths' shapes with the f32 error measured
    there."""
    from aa_admm_tpu_torch.ops.closest_point import (
        _closest_point_candidates_all)
    tol = {torch.float64: (1e-12, 1e-12), torch.float32: (2e-6, 1e-5)}
    err_at = {}       # f32 max abs error (points, distances) by (Q, K)
    for dtype in (torch.float32, torch.float64):
        dtol, qtol = tol[dtype]
        for Q, K in [(300, 7), (128, 48), (1000, 16), (cand_q, 48),
                     (PLAN_Q, PLAN_K), (MAIN_Q, 48), (MAIN_Q, 96)]:
            p, cand = ericson_inputs(Q, K, dtype, device, Q + K)
            q_k, d_k = ck.ericson_candidates(p, cand)
            candT = cand.reshape(Q, K, 9).permute(2, 1, 0).contiguous()
            qv, dv = ck.ericson_candidates_T_plain(p.T.contiguous(), candT)
            torch.cuda.synchronize()
            # Points are compared where the minimum is not a near-tie: on a
            # near-tie the kernel and the twin may round to different
            # winners (both exact to the tolerance).
            _, sqd = _closest_point_candidates_all(p, cand)
            two = torch.topk(sqd, min(2, K), dim=1, largest=False).values
            gap = two[:, -1] - two[:, 0]
            clear = (gap > 5 * dtol * torch.clamp_min(two[:, 0], 1.0)) | (K == 1)
            ed = float((d_k - dv[0]).abs().max())
            eq = float((q_k - qv.T)[clear].abs().max())
            check(torch.allclose(d_k, dv[0], rtol=dtol, atol=dtol),
                  f"ericson Q={Q} K={K} {dtype}: sqdist err {ed}")
            check(torch.allclose(q_k[clear], qv.T[clear], rtol=qtol, atol=qtol),
                  f"ericson Q={Q} K={K} {dtype}: point err {eq}")
            check(float(clear.float().mean()) > 0.99,
                  f"ericson Q={Q} K={K} {dtype}: too many near-ties")
            if dtype == torch.float32:
                err_at[Q, K] = max(ed, eq)
        # zero-area triangles and on-surface queries must not NaN
        p = torch.tensor([[0.0, 0.0, 0.0], [1.0, 2.0, 3.0]], dtype=dtype,
                         device=device)
        tri = torch.tensor([[[0, 0, 0], [0, 0, 0], [0, 0, 0]],
                            [[1, 2, 3], [1, 2, 3], [4, 5, 6]]], dtype=dtype,
                           device=device)
        cand = torch.stack([tri, tri])
        q_k, d_k = ck.ericson_candidates(p, cand)
        qv, dv = ck.ericson_candidates_T_plain(
            p.T.contiguous(), cand.reshape(2, 2, 9).permute(2, 1, 0).contiguous())
        check(bool(torch.isfinite(q_k).all()), "ericson degenerate: NaN")
        check(torch.allclose(q_k, qv.T, atol=1e-6)
              and torch.allclose(d_k, dv[0], atol=1e-6),
              "ericson degenerate: mismatch")
    # timing at its own path's shape and at the main path's three tiles
    for where, (Q, K) in {"candT cache": (cand_q, 48),
                          "planarity candT": (PLAN_Q, PLAN_K),
                          "group refresh tile": (8192, 48),
                          "2-stage tile": (4096, 48),
                          "group fast path tile": (MAIN_Q, 96)}.items():
        p, cand = ericson_inputs(Q, K, torch.float32, device, 5)
        candT = cand.reshape(Q, K, 9).permute(2, 1, 0).contiguous()
        pT = p.T.contiguous()
        ms, plain, ms_e, plain_e = time_pair(
            lambda: ck.ericson_candidates_T(pT, candT),
            lambda: ck.ericson_candidates_T_plain(pT, candT), iters=10)
        n_bytes = 4 * (9 * K * Q + 3 * Q + 4 * Q)
        b, by = bound_ms(n_bytes, ERICSON_FLOPS_PER_PAIR * K * Q,
                         torch.float32)
        err = f", max abs err vs twin {err_at[Q, K]:.3e}" if (
            Q, K) in err_at else ""
        print(f"  B1 ericson (planes) f32 {where} Q={Q} K={K} lanes "
              f"{ck.ericson_lanes(Q, K)}: kernel {ms:.4f} ms, twin "
              f"{plain:.4f} ms (device, CUDA graph); per eager call "
              f"{ms_e:.4f} / {plain_e:.4f} ms; bound {b:.4f} ms ({by}, "
              f"{n_bytes / 1e9:.3f} GB){err}")
        if where in ("candT cache", "planarity candT"):
            record["ericson" if where == "candT cache"
                   else "ericson_planarity"] = dict(
                ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
                max_abs_err=err_at[Q, K])


def check_ericson_idx(ck, device, record):
    """B1's indexed entry vs its twin, bit for bit at f32, at the CPU
    tests' shapes, the main path's three tiles (over a 39,808-row table),
    the planarity scene's 2-stage shape (over a 9,800-row table), exact ties
    and dummy rows; then its time at each of those path shapes beside the
    twin's and, at the refresh tile, beside the chain it replaced. Each
    shape is recorded with the f32 error measured there."""
    worst = {torch.float32: 0.0, torch.float64: 0.0}
    err_at = {}       # f32 max abs error by (Q, G, sub, T)
    cases = [(300, 7, 1, None), (128, 48, 1, None), (200, 6, 16, None)]
    cases += [(Q, G, sub, MAIN_T) for Q, G, sub in ERICSON_SHAPES.values()]
    cases += [(PLAN_Q, PLAN_K, 1, PLAN_T)]
    for dtype in (torch.float32, torch.float64):
        for Q, G, sub, T in cases:
            p, tris, idx = ericson_idx_inputs(Q, G, sub, dtype, device,
                                              Q + G + sub, T)
            q_k, d_k = ck.ericson_candidates_idx(p, tris, idx, sub)
            q_t, d_t = ck.ericson_candidates_idx_plain(p, tris, idx, sub)
            err = max(float((q_k - q_t).abs().max()),
                      float((d_k - d_t).abs().max()))
            worst[dtype] = max(worst[dtype], err)
            if dtype == torch.float32:
                err_at[Q, G, sub, T] = err
            check(err <= (0.0 if dtype == torch.float32 else 1e-12),
                  f"ericson_idx Q={Q} G={G} sub={sub} {dtype}: err {err}")
        for sub in (1, 16):
            p, tris, idx, want = ericson_tie_inputs(sub, dtype, device)
            q_k, d_k = ck.ericson_candidates_idx(p, tris, idx, sub)
            q_t, d_t = ck.ericson_candidates_idx_plain(p, tris, idx, sub)
            check(torch.equal(q_k, want) and torch.equal(q_t, want)
                  and bool((d_k == 1).all()),
                  f"ericson_idx ties sub={sub} {dtype}: not the first minimum")
    print(f"  B1 ericson_idx vs twin: max abs err f32 "
          f"{worst[torch.float32]:.3e}, f64 {worst[torch.float64]:.3e}; "
          f"exact ties, duplicates and 1e15 dummies resolved as argmin")
    record["ericson_idx"] = {}
    shapes = dict(ERICSON_SHAPES, **{"planarity 2-stage": (PLAN_Q, PLAN_K, 1)})
    for where, (Q, G, sub) in shapes.items():
        T = PLAN_T if where == "planarity 2-stage" else MAIN_T
        p, tris, idx = ericson_idx_inputs(Q, G, sub, torch.float32, device, 5,
                                          T)
        ms, plain, ms_e, plain_e = time_pair(
            lambda: ck.ericson_candidates_idx(p, tris, idx, sub),
            lambda: ck.ericson_candidates_idx_plain(p, tris, idx, sub),
            iters=10)
        b, by = ericson_idx_bound(Q, G, sub, T, torch.float32)
        print(f"  B1 ericson_idx f32 {where} Q={Q} G={G} sub={sub} lanes "
              f"{ck.ericson_lanes(Q, G * sub)}: kernel {ms:.4f} ms, twin "
              f"{plain:.4f} ms (device, CUDA graph); per eager call "
              f"{ms_e:.4f} / {plain_e:.4f} ms; bound {b:.4f} ms ({by}); max "
              f"abs err vs twin {err_at[Q, G, sub, T]:.3e}")
        record["ericson_idx"][where] = dict(
            ms=ms, plain_ms=plain, bound_ms=b, bound_by=by,
            max_abs_err=err_at[Q, G, sub, T])
        if where != "group refresh":
            continue
        # the chain the indexed entry replaced: gather, relayout, planes
        pT = p.T.contiguous()
        K = G * sub

        def chain():
            candT = tris[idx].reshape(Q, K, 9).permute(2, 1, 0).contiguous()
            return ck.ericson_candidates_T(pT, candT)
        candT = tris[idx].reshape(Q, K, 9).permute(2, 1, 0).contiguous()
        ms_chain = device_ms(chain, iters=10)
        ms_planes = device_ms(lambda: ck.ericson_candidates_T(pT, candT),
                              iters=10)
        qc, dc = chain()
        q_k, d_k = ck.ericson_candidates_idx(p, tris, idx, sub)
        check(torch.equal(qc.T, q_k) and torch.equal(dc[0], d_k),
              "ericson_idx: differs from the gather-relayout-planes chain")
        print(f"  B1 at the refresh tile, same inputs and bound {b:.4f} ms: "
              f"indexed entry {ms:.4f} ms; old chain (tris[idx], relayout, "
              f"plane entry) {ms_chain:.4f} ms, of which the plane entry "
              f"{ms_planes:.4f} ms")


def ericson_launch_split(stats, n_queries):
    """B1 (indexed entry) launches of the main path by tile shape, from the
    solve's counters: each cache refresh sweeps 8,192-query tiles, each
    fast-path trial 65,536-query tiles, and the init/final energies
    4,096-query 2-stage tiles."""
    def tiles(shape):
        return -(-n_queries // ERICSON_SHAPES[shape][0])

    refreshes = stats["cp_refreshes"]
    return {"group fast path": (stats["trials"] - refreshes)
            * tiles("group fast path"),
            "group refresh": refreshes * tiles("group refresh"),
            "2-stage": 2 * tiles("2-stage")}


def cg_inputs(n, c, dtype, device, seed):
    g = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a).to(device, dtype)

    v = {k: t(g.standard_normal((n, c))) for k in ("x", "r", "p", "ap", "z")}
    rz = t(g.random(c) + 0.5)
    # column 1 frozen (rr_prev <= thresh); the last column has a zero
    # divisor (p and r zero there, so pAp = 0 and r.z = 0 next).
    rr_prev = t(np.array([1.0, 1e-30, 1.0, 1.0][:c]))
    thresh = t(np.full(c, 1e-20))
    if c >= 3:
        v["p"][:, c - 1] = 0
    rz_old = rz.clone()
    rz_old[0] = 0
    return v, rz, rz_old, rr_prev, thresh


def check_cg(ck, device, record, n_small):
    """B2/B3 vs twins with a frozen column and zero divisors (pAp = 0,
    rz_old = 0): at n=230,400, c=3 and, for B2, at c = 1..4 on the small
    scene's n, an n that is no multiple of the block size, n=230,400 (p
    and Ap kept in registers) and n=300,001 (too many rows for that: read
    again); B2 called twice on the same inputs must give equal bits. Then
    both timed at n=230,400, c=3."""
    n, c = MAIN_N, 3
    rtol = {torch.float64: 1e-12, torch.float32: 1e-3}
    worst1 = worst2 = 0.0
    for dtype in (torch.float32, torch.float64):
        v, rz, rz_old, rr_prev, thresh = cg_inputs(n, c, dtype, device, 7)
        xk, rk = v["x"].clone(), v["r"].clone()
        xt, rt = v["x"].clone(), v["r"].clone()
        rr_k = ck.cg_update1(rz, v["p"], v["ap"], xk, rk, rr_prev, thresh)
        rr_t = ck.cg_update1_plain(rz, v["p"], v["ap"], xt, rt, rr_prev,
                                   thresh)
        pk, pt = v["p"].clone(), v["p"].clone()
        rz_k = ck.cg_update2(rz_old, rk, v["z"], pk, rr_prev, thresh)
        rz_t = ck.cg_update2_plain(rz_old, rt, v["z"], pt, rr_prev, thresh)
        torch.cuda.synchronize()
        tol = rtol[dtype]
        for name, a, b in [("x", xk, xt), ("r", rk, rt), ("rr", rr_k, rr_t),
                           ("p", pk, pt), ("rz", rz_k, rz_t)]:
            err = float((a - b).abs().max())
            check(torch.allclose(a, b, rtol=tol, atol=tol),
                  f"cg {name} {dtype}: max abs err {err}")
            if dtype == torch.float32:
                if name in ("x", "r", "rr"):
                    worst1 = max(worst1, err)
                else:
                    worst2 = max(worst2, err)
        check(bool(torch.equal(xk[:, 1], v["x"][:, 1])),
              "cg frozen column moved")
        for nc in (n_small, 70001, MAIN_N, 300001):
            for cc in (1, 2, 3, 4):
                v, rz, _, rr_prev, thresh = cg_inputs(nc, cc, dtype, device,
                                                      nc + cc)
                outs = []
                for _ in range(2):
                    x, r = v["x"].clone(), v["r"].clone()
                    rr = ck.cg_update1(rz, v["p"], v["ap"], x, r, rr_prev,
                                       thresh)
                    outs.append((x, r, rr))
                x, r = v["x"].clone(), v["r"].clone()
                rr = ck.cg_update1_plain(rz, v["p"], v["ap"], x, r, rr_prev,
                                         thresh)
                check(all(torch.equal(a, b) for a, b in zip(*outs)),
                      f"cg_update1 n={nc} c={cc} {dtype}: two calls differ")
                for name, a, b in zip(("x", "r", "rr"), outs[0], (x, r, rr)):
                    err = float((a - b).abs().max())
                    check(torch.allclose(a, b, rtol=tol, atol=tol),
                          f"cg_update1 n={nc} c={cc} {dtype}: {name} err {err}")
                    if dtype == torch.float32:
                        worst1 = max(worst1, err)
    v, rz, _, rr_prev, thresh = cg_inputs(n, c, torch.float32, device, 8)
    x, r, p = v["x"], v["r"], v["p"]
    print(f"  B2 cg_update1: c = 1..4, n = {n_small}, 70001, {MAIN_N}, 300001: "
          f"matches the twin (f32 max abs err {worst1:.3e}) and repeats "
          f"bit for bit; grid {ck.cg1_blocks(n, c, x.dtype, x.device)} "
          f"blocks of {ck.CG1_THREADS} at n={n}, c={c}")
    rz_old = (r * v["z"]).sum(0)     # beta ~ 1: repeated calls stay finite
    ms1, pl1, ms1_e, pl1_e = time_pair(
        lambda: ck.cg_update1(rz, p, v["ap"], x, r, rr_prev, thresh),
        lambda: ck.cg_update1_plain(rz, p, v["ap"], x, r, rr_prev, thresh))
    ms2, pl2, ms2_e, pl2_e = time_pair(
        lambda: ck.cg_update2(rz_old, r, v["z"], p, rr_prev, thresh),
        lambda: ck.cg_update2_plain(rz_old, r, v["z"], p, rr_prev, thresh))
    b1, by1 = bound_ms(6 * n * c * 4, 8 * n * c, torch.float32)
    b2, by2 = bound_ms(4 * n * c * 4, 4 * n * c, torch.float32)
    print(f"  B2 cg_update1 f32 n={n} c={c}: kernel {ms1:.4f} ms, twin "
          f"{pl1:.4f} ms (device, CUDA graph); per eager call {ms1_e:.4f} / "
          f"{pl1_e:.4f} ms; bound {b1:.4f} ms ({by1})")
    print(f"  B3 cg_update2 f32 n={n} c={c}: kernel {ms2:.4f} ms, twin "
          f"{pl2:.4f} ms (device, CUDA graph); per eager call {ms2_e:.4f} / "
          f"{pl2_e:.4f} ms; bound {b2:.4f} ms ({by2})")
    record["cg_update1"] = dict(ms=ms1, plain_ms=pl1, bound_ms=b1,
                                bound_by=by1, max_abs_err=worst1)
    record["cg_update2"] = dict(ms=ms2, plain_ms=pl2, bound_ms=b2,
                                bound_by=by2, max_abs_err=worst2)


# ---------------------------------------------------------------------------
# Phases 4 and 5: the solve
# ---------------------------------------------------------------------------

def run_small_solve(device, n_ref, max_iter=20):
    import functools
    from aa_admm_tpu_torch.apps import wire_mesh_opt as wm
    from aa_admm_tpu_torch.solver.geometry import ALMGeometrySolver

    sub, el, ref_v, ref_f = small_scene(n_ref)
    saved = wm.ALMGeometrySolver
    wm.ALMGeometrySolver = functools.partial(ALMGeometrySolver,
                                             dense_threshold=0)
    try:
        return wm.optimize_mesh(sub, ref_v, ref_f, max_iter=max_iter,
                                anderson_m=5, edge_length=el,
                                result_dir="result/smoke_small",
                                device=device)
    finally:
        wm.ALMGeometrySolver = saved


def phase_f64_solve(ck, n_ref, path, device="cuda"):
    """The small f64 solve on the GPU and the CPU; every kernel of `path`
    must have launched. Returns the GPU run's launch counts."""
    ck.reset_launch_counts()
    s_gpu = run_small_solve(device, n_ref)
    counts = ck.launch_counts()
    s_cpu = run_small_solve("cpu", n_ref)
    fg, fc = np.asarray(s_gpu.function_values), np.asarray(s_cpu.function_values)
    check(len(fg) == len(fc) and len(fg) > 0, "f64 solve: iteration counts differ")
    rel = float(np.max(np.abs(fg - fc) / np.abs(fc)))
    dx = float(np.abs(s_gpu.get_solution() - s_cpu.get_solution()).max())
    st = s_gpu.stats
    print(f"  f64 GPU vs CPU, {2 * (n_ref - 1) ** 2}-triangle reference: "
          f"{len(fg)} iterations, {st['trials']} trials, "
          f"{st['cp_refreshes']} cache refreshes, max rel fv diff {rel:.3e}, "
          f"max |x diff| {dx:.3e}, rejects gpu {sum(s_gpu.anderson_reset)} "
          f"cpu {sum(s_cpu.anderson_reset)}, launches {counts}")
    check(rel <= 1e-8, f"f64 solve: function values differ by {rel}")
    check(dx <= 1e-8, f"f64 solve: solutions differ by {dx}")
    check(s_gpu.anderson_reset == s_cpu.anderson_reset,
          "f64 solve: reject sequences differ")
    check(all(counts[k] > 0 for k in path),
          f"f64 solve: a kernel of {path} was not launched: {counts}")
    check(st["cp_refreshes"] < st["trials"],
          "f64 solve: the cache's fast path never ran")
    return counts


# bench.py:42-48: a wire-mesh run whose max edge or angle error exceeds 3x
# the C++'s after-optimization error on MaleTorso may not post a speedup
QUALITY_LOOSE, WIREMESH_EDGE_MAX, WIREMESH_ANGLE_MAX = 3.0, 0.00212871, 0.142833


def phase_full_solve(ck, device="cuda", scene=full_scene, max_iter=20):
    from aa_admm_tpu_torch.apps.wire_mesh_opt import (check_wiremesh_error,
                                                      optimize_mesh)
    t0 = time.perf_counter()
    sub, el, ref_v, ref_f = scene()
    t_scene = time.perf_counter() - t0
    print(f"  scene: {sub.n_verts()} vertices, {len(sub.faces)} faces, "
          f"reference {len(ref_f)} triangles, target edge {el:.4f} "
          f"({t_scene:.1f} s)", flush=True)
    min_a, max_a = np.pi * 0.25, np.pi * 0.75
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    solver = optimize_mesh(sub, ref_v, ref_f, max_iter=max_iter, anderson_m=5,
                           edge_length=el, min_angle_radian=min_a,
                           max_angle_radian=max_a, dtype=np.float32,
                           result_dir="result/smoke_full", device=device)
    torch.cuda.synchronize()
    counts = ck.launch_counts()
    t_total = time.perf_counter() - t0
    st = solver.stats
    out = solver.get_solution()
    n_it = len(solver.function_values)
    print(f"  optimize_mesh {t_total:.2f} s: setup_ADMM {solver.setup_s:.2f} s, "
          f"solve {st['solve_s']:.3f} s, "
          f"{st['solve_s'] / max(n_it, 1) * 1e3:.1f} ms/iteration, "
          f"{n_it} accepted of {st['trials']} trials, "
          f"{st['cg_iters']} CG iterations, {st['cp_refreshes']} cp-cache "
          f"refreshes, {st['host_reads'] / max(st['trials'], 1):.1f} host "
          f"reads/trial, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  kernel launches on the main path: {counts}")
    e_b, a_b, _ = check_wiremesh_error(sub, sub.verts, el, min_a, max_a)
    e_a, a_a, _ = check_wiremesh_error(sub, out, el, min_a, max_a)
    from aa_admm_tpu_torch.apps.wire_mesh_opt import check_ref_surface_distance
    r_b = check_ref_surface_distance(sub.verts, sub, ref_v, ref_f,
                                     device=device)
    r_a = check_ref_surface_distance(out, sub, ref_v, ref_f, device=device)
    print(f"  edge err mean {e_b.mean():.4e} -> {e_a.mean():.4e}, max "
          f"{e_b.max():.4e} -> {e_a.max():.4e}; angle err max {a_b.max():.4e}"
          f" -> {a_a.max():.4e}; ref dist max {r_b.max():.4e} -> "
          f"{r_a.max():.4e}")
    print(f"  bench.py's wire-mesh bounds (100 iterations on MaleTorso; "
          f"reported, not gated, beside {max_iter} iterations here): max "
          f"edge error {e_a.max():.4e} against "
          f"{QUALITY_LOOSE * WIREMESH_EDGE_MAX:.4e}, max angle error "
          f"{a_a.max():.4e} against {QUALITY_LOOSE * WIREMESH_ANGLE_MAX:.4e}")
    check(np.isfinite(out).all() and out.shape == sub.verts.shape,
          "full solve: non-finite or misshapen solution")
    check(np.isfinite(solver.function_values).all(),
          "full solve: non-finite function values")
    check(e_a.mean() < e_b.mean(), "full solve: mean edge error did not fall")
    check(all(counts[k] > 0 for k in MAIN_PATH_KERNELS),
          f"full solve: a kernel was not launched: {counts}")
    check(st["cp_refreshes"] >= 1 and st["cg_iters"] > 0,
          "full solve: no cp-cache refresh or no CG iteration")
    split = ericson_launch_split(st, sub.n_verts())
    print(f"  B1 (indexed entry) launches by tile shape: {split}")
    check(sum(split.values()) == counts["ericson_idx"],
          f"full solve: B1 launches {counts['ericson_idx']} != {split}")
    check(counts["ericson"] == 0,
          "full solve: materialised candidates on the subgroup-cache path")
    return counts, solver, split


def profile_trials(solver, init_x, n_iter=5, out="result/profile_full.txt"):
    """Device-time breakdown of the first `n_iter` accepted iterations of
    the solve just run (same system; the cache starts cold, so the first
    trial refreshes): torch.profiler's per-kernel self device time, the
    device's busy share of the wall time, host reads per trial."""
    import os
    from torch.profiler import ProfilerActivity, profile
    from aa_admm_tpu_torch.solver import geometry as g
    x0 = torch.as_tensor(np.asarray(init_x, np.float32), device=solver.device)
    state = g._alm_init_state(solver.system, x0)
    state["limit"] = n_iter = min(n_iter, solver.system.max_iter)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = g.solve_alm_chunk(solver.system, state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device events only (kernels, copies): an operator's row repeats the
    # device time of the kernels it launched
    busy_ms = sum(dev_us(e) for e in ka
                  if str(e.device_type).endswith("CUDA")) / 1e3
    trials = state["trial"]
    table = ka.table(sort_by="self_cuda_time_total", row_limit=25)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        f.write(table)
    print(f"  profile: {n_iter} iterations, {trials} trials, wall "
          f"{wall_ms:.1f} ms ({wall_ms / trials:.2f} ms/trial), device busy "
          f"{busy_ms:.1f} ms ({busy_ms / trials:.2f} ms/trial), device idle "
          f"share {1 - busy_ms / wall_ms:.3f}, host reads "
          f"{state['reads'] / trials:.1f}/trial, CG iterations "
          f"{state['cgit'] / trials:.1f}/trial")
    rows = sorted((e for e in ka if str(e.device_type).endswith("CUDA")),
                  key=dev_us, reverse=True)[:15]
    for e in rows:
        print(f"    {dev_us(e) / 1e3 / trials:9.3f} ms/trial  x{e.count:<6d} "
              f"{e.key[:90]}")
    # the port's own kernels on the solve's real data
    for e in ka:
        if str(e.device_type).endswith("CUDA") and any(
                k in e.key for k in ("ericson_", "cg1_fused", "cg2_update",
                                     "col_dot_partial")):
            print(f"    port kernel x{e.count:<5d} "
                  f"{dev_us(e) / max(e.count, 1) / 1e3:.4f} ms per launch "
                  f"in the solve: {e.key[:70]}")


# ---------------------------------------------------------------------------
# Phase 7: planarity at costa2k scale
# ---------------------------------------------------------------------------

def run_planarity(ck, device, dtype, max_iter):
    """optimize_mesh of the planarity app with its defaults (penalty 1e5,
    closeness 1, relative Laplacian 0.1) and AndersonM 5; returns (solver,
    launch counts, seconds)."""
    from aa_admm_tpu_torch.apps import planarity_opt as po
    mesh, ref_v, ref_f = planarity_scene()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    solver = po.optimize_mesh(mesh, ref_v, ref_f, max_iter, 5, dtype=dtype,
                              device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return solver, ck.launch_counts(), time.perf_counter() - t0


def phase_planarity(ck):
    """The f32 run on the GPU (quality), then f64 on the GPU against the
    CPU (parity). Returns the f32 run's launch counts."""
    from aa_admm_tpu_torch.apps.planarity_opt import check_planarity_error
    mesh, ref_v, ref_f = planarity_scene()
    print(f"  scene: {mesh.n_verts()} vertices, {len(mesh.faces)} quads, "
          f"reference {len(ref_f)} triangles", flush=True)
    solver, counts, secs = run_planarity(ck, "cuda", np.float32, 100)
    st = solver.stats
    n_it = len(solver.function_values)
    out = solver.get_solution()
    pl_b, _ = check_planarity_error(mesh)
    pl_a, _ = check_planarity_error(mesh, out)
    print(f"  f32 GPU, 100 iterations: {secs:.2f} s, setup_ADMM "
          f"{solver.setup_s:.2f} s, solve {st['solve_s']:.3f} s, "
          f"{st['solve_s'] / max(n_it, 1) * 1e3:.2f} ms/iteration, {n_it} "
          f"accepted of {st['trials']} trials, {sum(solver.anderson_reset)} "
          f"rejects, {st['cp_refreshes']} cp-cache refreshes, "
          f"{st['host_reads'] / max(n_it, 1):.2f} host reads/iteration, "
          f"launches {counts}")
    print(f"  planarity error max {pl_b.max():.4e} -> {pl_a.max():.4e}, mean "
          f"{pl_b.mean():.4e} -> {pl_a.mean():.4e}")
    check(np.isfinite(out).all() and out.shape == mesh.verts.shape,
          "planarity f32: non-finite or misshapen solution")
    check(np.isfinite(solver.function_values).all(),
          "planarity f32: non-finite function values")
    check(np.isfinite(pl_a).all() and pl_a.max() < pl_b.max(),
          "planarity f32: the max planarity error did not fall")
    check(counts["ericson"] > 0 and counts["ericson_idx"] > 0,
          f"planarity f32: a B1 entry was not launched: {counts}")

    s_gpu, c64, secs_g = run_planarity(ck, "cuda", np.float64, 20)
    s_cpu, _, secs_c = run_planarity(ck, "cpu", np.float64, 20)
    fg = np.asarray(s_gpu.function_values)
    fc = np.asarray(s_cpu.function_values)
    check(len(fg) == len(fc) and len(fg) > 0,
          "planarity f64: iteration counts differ")
    rel = float(np.max(np.abs(fg - fc) / np.abs(fc)))
    dx = float(np.abs(s_gpu.get_solution() - s_cpu.get_solution()).max())
    print(f"  f64 GPU vs CPU, 20 iterations: GPU {secs_g:.2f} s "
          f"({s_gpu.stats['solve_s'] / len(fg) * 1e3:.2f} ms/iteration), CPU "
          f"{secs_c:.2f} s; max rel fv diff {rel:.3e}, max |x diff| "
          f"{dx:.3e}, rejects gpu {sum(s_gpu.anderson_reset)} cpu "
          f"{sum(s_cpu.anderson_reset)}, GPU launches {c64}")
    check(rel <= 1e-8, f"planarity f64: function values differ by {rel}")
    check(s_gpu.anderson_reset == s_cpu.anderson_reset,
          "planarity f64: reject sequences differ")
    check(c64["ericson"] > 0 and c64["ericson_idx"] > 0,
          f"planarity f64: a B1 entry was not launched: {c64}")
    return counts


# ---------------------------------------------------------------------------
# Phase 8: physics (xzu, Anderson on z)
# ---------------------------------------------------------------------------

def beams_settings(accel, iters=100):
    from aa_admm_tpu_torch.core.config import AccelType, Settings
    s = Settings()
    s.admm_iters = iters
    s.verbose = 0
    if accel:
        s.acceleration_type = AccelType.ANDERSON
        s.anderson_m = 5
    return s


def beams_noacc_step(device):
    from aa_admm_tpu_torch.apps import beams
    s = beams_settings(False)
    solver, stretch = beams.build_scene(s, device=device)
    stretch(s.timestep_s)
    t0 = time.perf_counter()
    tr = solver.step()
    secs = time.perf_counter() - t0
    return (tr.prim.cpu().numpy(), tr.comb.cpu().numpy(),
            tr.reject.cpu().numpy(), solver.x, secs)


def profile_beams(solver, n_iter=10, out="result/profile_beams.txt"):
    """torch.profiler over one accelerated beams step cut to n_iter ADMM
    iterations (the same system): device busy and idle share, and the
    launches per iteration."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    from aa_admm_tpu_torch.solver import physics as ph
    system = dataclasses.replace(solver.system, admm_iters=n_iter)
    x, v, pp = solver._x_dev, solver._v_dev, solver._pin_pos_dev()
    ph.step_xzu(system, x, v, pp)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ph.step_xzu(system, x, v, pp)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    dev = [e for e in ka if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(dev_us(e) for e in dev) / 1e3
    launches = sum(e.count for e in dev)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        f.write(ka.table(sort_by="self_cuda_time_total", row_limit=25))
    print(f"  profile, {n_iter} accelerated iterations (setup included): "
          f"wall {wall_ms:.1f} ms (profiler on), device busy {busy_ms:.2f} "
          f"ms, device idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{launches / n_iter:.0f} device launches per iteration")


def phase_physics(ck):
    from aa_admm_tpu_torch.apps import beams
    ck.reset_launch_counts()
    # the published scene, one non-accelerated step: GPU against CPU, and
    # the head against the C++ golden
    pg, cg, rg, xg, sg = beams_noacc_step("cuda")
    pc, cc, rc, xc, sc = beams_noacc_step("cpu")
    cpp = np.loadtxt(GOLDEN)
    head = float(max(np.max(np.abs(pg[:25] - cpp[:25, 1]) / cpp[:25, 1]),
                     np.max(np.abs(cg[:25] - cpp[:25, 2]) / cpp[:25, 2])))
    dprim = float(np.max(np.abs(pg - pc) / np.abs(pc)))
    dcomb = float(np.max(np.abs(cg - cc) / np.abs(cc)))
    print(f"  beams (624 vertices, 1,620 tets, dense path), one "
          f"non-accelerated step of 100 iterations: GPU {sg * 1e3:.1f} ms, "
          f"CPU {sc * 1e3:.1f} ms; GPU vs CPU max rel prim {dprim:.3e}, comb "
          f"{dcomb:.3e}, max |x diff| {np.abs(xg - xc).max():.3e}; first 25 "
          f"iterations vs the C++ golden max rel {head:.3e}")
    check(np.isfinite(pg).all() and np.isfinite(cg).all(),
          "beams: non-finite residuals")
    check(np.allclose(pg, pc, rtol=1e-8, atol=1e-9)
          and np.allclose(cg, cc, rtol=1e-8, atol=1e-9),
          f"beams: GPU and CPU residuals differ (prim {dprim}, comb {dcomb})")
    check(np.array_equal(rg, rc), "beams: reject sequences differ")
    check(np.allclose(xg, xc, rtol=1e-8, atol=1e-9),
          "beams: GPU and CPU positions differ")
    check(head < 1e-5, f"beams: the head differs from the C++ golden by {head}")

    # ten Anderson-accelerated frames on the GPU
    frames = 10
    s = beams_settings(True)
    solver, stretch = beams.build_scene(s, device="cuda")
    x_orig = np.concatenate(solver.verts)
    pins = sorted(solver.pins)
    for _ in range(frames):
        stretch(s.timestep_s)
        solver.step()
    solver.flush_traces()
    ms = np.asarray(solver.step_ms)
    n_it = len(solver.step_prim)
    moved = (solver.x[pins, 0] - x_orig[pins, 0]) * np.sign(x_orig[pins, 0])
    print(f"  beams -a 1 -am 5, {frames} frames on the GPU: "
          f"{ms.mean():.1f} ms/step (first {ms[0]:.1f}, median "
          f"{np.median(ms):.1f}), {ms.sum() / n_it:.2f} ms per ADMM iteration "
          f"({n_it} recorded), {sum(solver.step_reject) / frames:.1f} "
          f"rejects/step, {solver.stats['host_reads'] / frames:.0f} host "
          f"reads/step")
    check(np.isfinite(solver.x).all(), "beams AA: non-finite positions")
    # build_scene places the pins once, then each frame moves them by dt
    want = (frames + 1) * s.timestep_s
    check(np.allclose(moved, want, rtol=1e-9, atol=1e-12),
          f"beams AA: pins moved {moved.min()}..{moved.max()}, not {want}")
    profile_beams(solver)

    # the same beams from 48 x 12 x 12 cubes: the CG path
    s = beams_settings(True)
    t0 = time.perf_counter()
    big, stretch = beams.build_scene(s, device="cuda", cubes=(48, 12, 12))
    setup = time.perf_counter() - t0
    sysm = big.system
    check(sysm.solver is None and sysm.precond_diag is not None,
          "beams CG size: initialize did not take the CG path")
    stretch(s.timestep_s)
    tr = big.step()
    prim = tr.prim.cpu().numpy()
    valid = prim[~np.isnan(prim)]
    n_tets = sum(int(b.tets.shape[0]) for b in sysm.batches)
    print(f"  beams 48x12x12 ({sysm.n_verts} vertices, {n_tets} tets, "
          f"{sysm.n_free} free, CG path): setup {setup:.2f} s, one "
          f"accelerated step {big.step_ms[-1]:.1f} ms ({len(valid)} "
          f"iterations, {big.step_ms[-1] / max(len(valid), 1):.1f} "
          f"ms/iteration), {big.stats['cg_iters']} CG iterations, "
          f"{big.stats['host_reads']} host reads, "
          f"{int(tr.reject.sum())} rejects, prim {valid[0]:.4e} -> "
          f"{valid[-1]:.4e}")
    check(np.isfinite(valid).all() and len(valid) > 0,
          "beams CG size: non-finite residuals")
    check(valid[-1] < valid[0], "beams CG size: the primal residual did "
          "not fall within the step")
    check(np.isfinite(big.x).all(), "beams CG size: non-finite positions")
    counts = ck.launch_counts()
    print(f"  kernel launches in phase 8: {counts} (the physics path runs "
          f"none of the port's kernels)")


# ---------------------------------------------------------------------------
# Phase 9: physics in the zxu order (collisions, self-collision, wind)
# ---------------------------------------------------------------------------

APP_SCALE = 13.0   # the plinko apps' transform: 13 x file + shift


def zxu_settings(accel, iters):
    from aa_admm_tpu_torch.core.config import AccelType, Settings
    s = Settings()
    s.admm_iters = iters
    s.verbose = 0
    if accel:
        s.acceleration_type = AccelType.ANDERSON
        s.anderson_m = 5
    return s


def block_file(d, name, cubes, scale, x_mid, y_low, shift, z_mids=(0.0,)):
    """make_tet_blocks(*cubes) scaled by `scale`, one copy centred at each z
    of z_mids, written to d/name.ele/.node so that the plinko apps'
    transform (13 x + shift) puts the blocks' x centre at x_mid and lowest
    face at y_low. Returns the basename."""
    from aa_admm_tpu_torch.core.factory import TetMeshData, make_tet_blocks
    from aa_admm_tpu_torch.core.meshio import save_elenode
    mesh = make_tet_blocks(*cubes)
    v = mesh.verts * scale
    lo, hi = v.min(0), v.max(0)
    v = v - [0.5 * (lo[0] + hi[0]), lo[1], 0.5 * (lo[2] + hi[2])]
    n = len(v)
    out = TetMeshData(
        verts=np.concatenate([v + [x_mid, y_low, z] for z in z_mids]),
        tets=np.concatenate([mesh.tets + i * n for i in range(len(z_mids))]))
    out.verts = (out.verts - np.asarray(shift)) / APP_SCALE
    base = os.path.join(d, name)
    save_elenode(base, out)
    return base


def scene_sd(solver, x):
    """Signed distance of every vertex to the solver's analytic obstacles."""
    from aa_admm_tpu_torch.ops.elements import CollisionBatch
    b = [b for b in solver.system.batches if isinstance(b, CollisionBatch)][0]
    d, _ = b.scene.signed_distance(torch.as_tensor(x).to(
        b.scene.floor_y.device, b.scene.floor_y.dtype))
    return d.cpu().numpy()


def run_frames_report(solver, frames, name):
    """`frames` steps; per frame the count of vertices inside an obstacle
    (d < 0) and the state before the first frame that ends with some.
    Returns (first contact frame, state before it, max count, min y)."""
    first, state, most, ymin = None, None, 0, np.inf
    for f in range(frames):
        before = (solver.x.copy(), solver.v.copy())
        solver.step()
        d = scene_sd(solver, solver._x_dev)
        n = int((d < 0).sum())
        if n and first is None:
            first, state = f + 1, before
        most = max(most, n)
        ymin = min(ymin, float(solver.x[:, 1].min()))
    solver.flush_traces()
    ms = np.asarray(solver.step_ms)
    n_it = len(solver.step_prim)
    print(f"  {name} -a 1 -am 5 -it {solver.settings.admm_iters}, {frames} "
          f"frames on the GPU ({solver.n_verts} vertices): "
          f"{ms.mean():.1f} ms/step (first {ms[0]:.1f}, median "
          f"{np.median(ms):.1f}), {ms.sum() / max(n_it, 1):.2f} ms/iteration, "
          f"{sum(solver.step_reject) / frames:.2f} rejects/step, "
          f"{solver.stats['host_reads'] / frames:.1f} host reads/step; "
          f"first penetration at frame {first}, most vertices inside an "
          f"obstacle at a frame end {most}, lowest y {ymin:.4f}")
    return first, state, most, ymin


def compare_frame(app, base, state, accel, iters, sd_solver):
    """One frame from `state` on the GPU and on the CPU; returns (agree,
    line): residuals at rtol 1e-8 (above 1e-12 of the first) with equal
    rejects, positions at 1e-8; plus the vertices whose side of the
    obstacles differs between the two ends of the frame, and their |d|."""
    out = {}
    for dev in ("cuda", "cpu"):
        sv = app.build_scene(zxu_settings(accel, iters), mesh_path=base,
                             device=dev)
        sv.x, sv.v = state
        tr = sv.step()
        out[dev] = (tr.prim.cpu().numpy(), tr.comb.cpu().numpy(),
                    tr.reject.cpu().numpy(), sv.x)
    (pg, cg, rg, xg), (pc, cc, rc, xc) = out["cuda"], out["cpu"]
    ok = ~np.isnan(pc) & ~np.isnan(pg)
    dp = float(np.max(np.abs(pg - pc)[ok] / pc[ok]))
    dc = float(np.max(np.abs(cg - cc)[ok] / cc[ok]))
    dx = float(np.abs(xg - xc).max())
    agree = (np.array_equal(rg, rc) and np.array_equal(np.isnan(pg), np.isnan(pc))
             and np.allclose(pg[ok], pc[ok], rtol=1e-8, atol=1e-12 * pc[0])
             and np.allclose(cg[ok], cc[ok], rtol=1e-8, atol=1e-12 * cc[0])
             and np.allclose(xg, xc, rtol=1e-8, atol=1e-10))
    sg, sc = scene_sd(sd_solver, xg), scene_sd(sd_solver, xc)
    side = (sg < 0) != (sc < 0)
    near = (np.abs(sg) < 1e-8) | (np.abs(sc) < 1e-8)
    line = (f"{'Anderson m=5' if accel else 'no acceleration'}: max rel prim "
            f"{dp:.3e}, comb {dc:.3e}, max |x diff| {dx:.3e}, rejects gpu "
            f"{int(rg.sum())} cpu {int(rc.sum())} "
            f"({'equal' if np.array_equal(rg, rc) else 'differ'}); "
            f"{int(side.sum())} vertices changed side"
            + (f" (|d| <= {np.abs(np.concatenate([sg[side], sc[side]])).max():.3e})"
               if side.any() else "")
            + f", {int(near.sum())} within 1e-8 of a surface")
    return agree, bool(side.any() or near.any()), line


def phase_plinko(app, name, base, frames, floor_ok):
    solver = app.build_scene(zxu_settings(True, 13), mesh_path=base,
                             device="cuda")
    first, state, most, ymin = run_frames_report(solver, frames, name)
    check(np.isfinite(solver.x).all(), f"{name}: non-finite positions")
    check(first is not None, f"{name}: no vertex ever penetrated")
    check(floor_ok(solver), f"{name}: the block fell through (lowest y "
          f"{ymin})")
    # GPU against CPU over the first contact frame, from the same state. A
    # contact's hard snap is discontinuous: where the two runs part, the
    # vertices on either side of an obstacle's surface are reported.
    for accel in (False, True):
        agree, explained, line = compare_frame(app, base, state, accel, 13,
                                               solver)
        print(f"  {name} GPU vs CPU, contact frame {first}, {line}")
        check(agree or explained, f"{name}: GPU and CPU differ over the "
              "contact frame, and no vertex changed side or lies near a "
              "surface")


def cloth_file(d, n):
    """An n x n-cell cloth of 1.9 units (about cloth.obj's extent) written to
    d/cloth{n}.obj. Returns (path, vertices, triangles)."""
    from aa_admm_tpu_torch.core.factory import make_plane_grid
    from aa_admm_tpu_torch.core.meshio import save_obj
    grid = make_plane_grid(n, n, size=1.9)
    path = os.path.join(d, f"cloth{n}.obj")
    save_obj(path, grid.verts, grid.faces)
    return path, len(grid.verts), len(grid.faces)


def phase_windyflag(tmp):
    import dataclasses
    from aa_admm_tpu_torch.apps import windyflag as wf
    from aa_admm_tpu_torch.solver import physics as ph

    def cloth(n):
        return cloth_file(tmp, n)

    path, nv, nf = cloth(64)
    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        sv = wf.build_scene(zxu_settings(False, 100), mesh_path=path,
                            device=dev)
        setup = time.perf_counter() - t0
        tr = sv.step()
        out[dev] = (tr.prim.cpu().numpy(), tr.comb.cpu().numpy(), sv.x,
                    sv.step_ms[-1], setup)
    (pg, cg, xg, mg, sg), (pc, cc, xc, mc, sc) = out["cuda"], out["cpu"]
    dp = float(np.max(np.abs(pg - pc) / pc))
    dc = float(np.max(np.abs(cg - cc) / cc))
    print(f"  windyflag 64x64 ({nv} vertices, {nf} triangles, dense path), "
          f"one non-accelerated step of 100 iterations: GPU {mg:.1f} ms, CPU "
          f"{mc:.1f} ms (setup {sg:.1f} / {sc:.1f} s); GPU vs CPU max rel "
          f"prim {dp:.3e}, comb {dc:.3e}, max |x diff| "
          f"{np.abs(xg - xc).max():.3e}")
    check(np.allclose(pg, pc, rtol=1e-8, atol=1e-12 * pc[0])
          and np.allclose(cg, cc, rtol=1e-8, atol=1e-12 * cc[0])
          and np.allclose(xg, xc, rtol=1e-8, atol=1e-10),
          f"windyflag: GPU and CPU differ (prim {dp}, comb {dc})")

    frames = 10
    sv = wf.build_scene(zxu_settings(True, 100), mesh_path=path,
                        device="cuda")
    x0 = np.concatenate(sv.verts)
    pins = sorted(sv.pins)
    for _ in range(frames):
        sv.step()
    sv.flush_traces()
    ms = np.asarray(sv.step_ms)
    n_it = len(sv.step_prim)
    dz = float(sv.x[:, 2].mean() - x0[:, 2].mean())
    print(f"  windyflag -a 1 -am 5, {frames} frames on the GPU: "
          f"{ms.mean():.1f} ms/step (first {ms[0]:.1f}, median "
          f"{np.median(ms):.1f}), {ms.sum() / n_it:.2f} ms/iteration ({n_it} "
          f"recorded), {sum(sv.step_reject) / frames:.1f} rejects/step, "
          f"{sv.stats['host_reads'] / frames:.0f} host reads/step; mean z "
          f"moved {dz:+.4f}")
    check(np.isfinite(sv.x).all(), "windyflag AA: non-finite positions")
    check(np.allclose(sv.x[pins], x0[pins], atol=1e-12),
          "windyflag AA: the pins moved")
    check(dz > 0, f"windyflag AA: the cloth did not move in +z ({dz})")
    profile_step(sv, ph.step_zxu, "windyflag", out="result/profile_zxu.txt")

    path, nv, nf = cloth(16)
    out = {}
    for dev in ("cuda", "cpu"):
        s2 = wf.build_scene(zxu_settings(False, 100), mesh_path=path,
                            device=dev, wind_mode="sequential")
        tr = s2.step()
        out[dev] = (tr.prim.cpu().numpy(), s2.x, s2.step_ms[-1])
        if dev == "cuda":
            # the kick alone, in both modes, from the state after the step
            system = s2.system
            kick = {m: cuda_ms(lambda w=dataclasses.replace(system.wind, mode=m):
                               w.apply(system.dt, s2._x_dev, s2._v_dev,
                                       system.n_verts), iters=5, warmup=1)
                    for m in ("sequential", "jacobi")}
    (pg, xg, mg), (pc, xc, mc) = out["cuda"], out["cpu"]
    dp = float(np.max(np.abs(pg - pc) / pc))
    print(f"  windyflag 16x16 ({nv} vertices, {nf} triangles), sequential "
          f"wind, one non-accelerated step: GPU {mg:.1f} ms, CPU {mc:.1f} ms; "
          f"GPU vs CPU max rel prim {dp:.3e}, max |x diff| "
          f"{np.abs(xg - xc).max():.3e}; the kick alone on the GPU: "
          f"sequential {kick['sequential']:.2f} ms, jacobi "
          f"{kick['jacobi']:.3f} ms")
    check(np.allclose(pg, pc, rtol=1e-8, atol=1e-12 * pc[0])
          and np.allclose(xg, xc, rtol=1e-8, atol=1e-10),
          f"windyflag sequential wind: GPU and CPU differ ({dp})")


def profile_step(solver, step_fn, name, n_iter=10, out="result/profile.txt"):
    """torch.profiler over one step of `solver`'s system cut to n_iter ADMM
    iterations (setup included): device busy and idle share, launches per
    iteration; the table goes to `out`."""
    import dataclasses
    from torch.profiler import ProfilerActivity, profile
    system = dataclasses.replace(solver.system, admm_iters=n_iter)
    x, v, pp = solver._x_dev, solver._v_dev, solver._pin_pos_dev()
    step_fn(system, x, v, pp)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(system, x, v, pp)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    dev = [e for e in ka if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(dev_us(e) for e in dev) / 1e3
    launches = sum(e.count for e in dev)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        f.write(ka.table(sort_by="self_cuda_time_total", row_limit=25))
    print(f"  profile, {name}, {n_iter} accelerated iterations (setup "
          f"included): wall {wall_ms:.1f} ms (profiler on), device busy "
          f"{busy_ms:.2f} ms, device idle share {1 - busy_ms / wall_ms:.3f}, "
          f"{launches / n_iter:.0f} device launches per iteration")
    for e in sorted(dev, key=dev_us, reverse=True)[:8]:
        print(f"    {dev_us(e) / 1e3 / n_iter:8.3f} ms/iteration  "
              f"x{e.count:<6d} {e.key[:80]}")


def phase_selfcollision():
    from aa_admm_tpu_torch.core.config import Lame
    from aa_admm_tpu_torch.core.factory import make_tet_blocks
    from aa_admm_tpu_torch.ops.collider import (DynamicTetCollider,
                                                HashGridTetCollider)
    from aa_admm_tpu_torch.solver.physics import PhysicsSolver
    bottom, top = make_tet_blocks(2, 1, 2), make_tet_blocks(1, 1, 1)

    def scene(top_y, colliders):
        sv = PhysicsSolver(order="zxu", device="cuda")
        o0 = sv.add_tetmesh(bottom.verts, bottom.tets, Lame.rubber(),
                            self_collision=colliders == "mesh")
        sv.add_tetmesh(top.verts + [0.5, top_y, 0.5], top.tets, Lame.rubber(),
                       self_collision=colliders == "mesh")
        sv.set_pins(list(range(o0, o0 + len(bottom.verts))))
        nb = len(bottom.verts)
        if colliders == "overflow":
            sv.add_dynamic_collider(bottom.verts, bottom.tets, 0,
                                    n_buckets=1, cap=1)
            sv.add_dynamic_collider(top.verts + [0.5, top_y, 0.5], top.tets,
                                    nb, n_buckets=1, cap=1)
        elif colliders == "dense":
            sv.dynamic_colliders = [
                DynamicTetCollider.create(bottom.verts, bottom.tets, 0),
                DynamicTetCollider.create(top.verts + [0.5, top_y, 0.5],
                                          top.tets, nb)]
        sv.initialize(zxu_settings(False, 10))
        return sv

    frames = 30
    sv = scene(2.0, "mesh")
    nb = len(bottom.verts)
    contacts, ymin = [], np.inf
    for _ in range(frames):
        sv.step()
        b = sv.system.batches[sv._selfcol_index]
        contacts.append(int(b.active.sum()))
        ymin = min(ymin, float(sv.x[nb:, 1].min()))
    ms = np.asarray(sv.step_ms)
    print(f"  self-collision, two blocks, {frames} frames on the GPU: "
          f"{ms.mean():.1f} ms/step (median {np.median(ms):.1f}), "
          f"{sv.stats['host_reads'] / frames:.1f} host reads/step; contacts "
          f"in {sum(c > 0 for c in contacts)} frames (most {max(contacts)}), "
          f"lowest y of the top block {ymin:.4f}")
    check(np.isfinite(sv.x).all(), "self-collision: non-finite positions")
    check(max(contacts) > 0, "self-collision: no contact ever fired")
    check(0.5 < ymin < 1.4, f"self-collision: top block lowest y {ymin}")

    ref, ov = scene(0.95, "dense"), scene(0.95, "overflow")
    ref._refresh_self_contacts()
    ov._refresh_self_contacts()
    br = ref.system.batches[ref._selfcol_index]
    bo = ov.system.batches[ov._selfcol_index]
    kinds = [type(c).__name__ for c in ov.dynamic_colliders]
    dt = float((br.target - bo.target).abs().max())
    print(f"  hash collider forced to overflow (1 bucket, cap 1): escalated "
          f"to {kinds}, {int(bo.active.sum())} contacts, the dense "
          f"collider's {int(br.active.sum())}, max |target diff| {dt:.3e}")
    check(bool(br.active.any()), "self-collision overflow: no contact")
    check(torch.equal(br.active, bo.active) and dt <= 1e-12,
          "self-collision overflow: contact set differs from the dense one")
    check(not any(isinstance(c, HashGridTetCollider)
                  for c in ov.dynamic_colliders),
          "self-collision overflow: did not escalate")


def phase_zxu(ck):
    import tempfile
    from aa_admm_tpu_torch.apps import plinkohit, plinkopony
    ck.reset_launch_counts()
    tmp = tempfile.mkdtemp(prefix="smoke_zxu_")
    try:
        t0 = time.perf_counter()
        hit = block_file(tmp, "hit", (12, 7, 8), 0.15, 0.25, -1.0,
                         (0.25, 2.5, 0.0))
        phase_plinko(plinkohit, "plinkohit-synthetic", hit, 30,
                     lambda s: s.x[:, 1].min() > -4.3)
        print(f"  ({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        pony = block_file(tmp, "pony", (12, 7, 8), 0.15, 0.25, 4.0,
                          (0.25, 5.0, 0.0))
        slide_n = np.array([0.5, np.sqrt(3.0) / 2.0, 0.0])
        phase_plinko(plinkopony, "plinkopony-synthetic", pony, 30,
                     lambda s: ((s.x - [0.0, -6.5, 0.0]) @ slide_n).min()
                     > -0.3)
        print(f"  ({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        phase_windyflag(tmp)
        print(f"  ({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        phase_selfcollision()
        print(f"  ({time.perf_counter() - t0:.1f} s)")

        # zxu at CG size: three 48 x 12 x 12-cube blocks side by side
        # (24,843 vertices, 103,680 tets, as beams-cg-103k), over the pit
        t0 = time.perf_counter()
        big = block_file(tmp, "big", (48, 12, 12), 0.1, 0.0, -2.99,
                         (0.25, 2.5, 0.0), z_mids=(-1.5, 0.0, 1.5))
        sv = plinkohit.build_scene(zxu_settings(True, 13), mesh_path=big,
                                   device="cuda")
        setup = time.perf_counter() - t0
        check(sv.system.solver is None and sv.system.precond_diag is not None,
              "zxu CG size: initialize did not take the CG path")
        first = None
        for f in range(3):
            tr = sv.step()
            prim = tr.prim.cpu().numpy()
            valid = prim[~np.isnan(prim)]
            n_in = int((scene_sd(sv, sv._x_dev) < 0).sum())
            if n_in and first is None:
                first = f + 1
            print(f"  zxu CG size frame {f + 1}: {sv.step_ms[-1]:.1f} ms, "
                  f"prim {valid[0]:.4e} -> {valid[-1]:.4e}, "
                  f"{int(tr.reject.sum())} rejects, {n_in} vertices inside "
                  f"the obstacle")
            check(np.isfinite(valid).all() and valid[-1] < valid[0],
                  f"zxu CG size: the primal residual did not fall in frame "
                  f"{f + 1}")
        n_tets = sum(int(b.tets.shape[0]) for b in sv.system.batches
                     if hasattr(b, "tets"))
        print(f"  zxu CG size ({sv.system.n_verts} vertices, {n_tets} tets, "
              f"CG path): setup {setup:.2f} s, {np.mean(sv.step_ms):.1f} "
              f"ms/step, {sv.stats['cg_iters']} CG iterations, "
              f"{sv.stats['host_reads']} host reads in 3 frames")
        check(np.isfinite(sv.x).all(), "zxu CG size: non-finite positions")
        check(first is not None and first <= 3,
              "zxu CG size: no vertex penetrated by frame 3")
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
    counts = ck.launch_counts()
    print(f"  kernel launches in phase 9: {counts} (the physics path runs "
          f"none of the port's kernels)")


# ---------------------------------------------------------------------------
# Phase 10: instrumentation and state, the plain geometry solver, native
# ---------------------------------------------------------------------------

def valid(a):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a[~np.isnan(a)]


def beams_solver(dev, accel, iters=100):
    """The published beams scene with its pins moved once more, as before
    a step (phase 8)."""
    from aa_admm_tpu_torch.apps import beams
    s = beams_settings(accel, iters)
    solver, stretch = beams.build_scene(s, device=dev)
    stretch(s.timestep_s)
    return solver


def phase10_makers(tmp):
    """Solver factories (device, accel, iters) of the three scenes phase 10
    reuses: beams-published, windyflag 64 x 64, plinkohit-synthetic."""
    from aa_admm_tpu_torch.apps import plinkohit
    from aa_admm_tpu_torch.apps import windyflag as wf
    cloth, _, _ = cloth_file(tmp, 64)
    hit = block_file(tmp, "hit", (12, 7, 8), 0.15, 0.25, -1.0,
                     (0.25, 2.5, 0.0))
    return {
        "beams-published": beams_solver,
        "windyflag-synthetic": lambda dev, accel, iters=100: wf.build_scene(
            zxu_settings(accel, iters), mesh_path=cloth, device=dev),
        "plinkohit-synthetic": lambda dev, accel, iters=100:
            plinkohit.build_scene(zxu_settings(accel, iters), mesh_path=hit,
                                  device=dev)}


def first_parting(a, b, rtol=1e-8, atol=1e-9):
    """The first iteration at which two residual sequences differ beyond
    the tolerance (or the shorter length when one stops early), None when
    they agree throughout."""
    n = min(len(a), len(b))
    bad = ~np.isclose(a[:n], b[:n], rtol=rtol, atol=atol)
    if bad.any():
        return int(np.argmax(bad))
    return None if len(a) == len(b) else n


def check_instrumented(name, make, accel):
    """The instrumented step on the GPU against the fused step on the GPU
    (tests/test_instrumented.py's tolerances) and against the instrumented
    step on the CPU (rtol 1e-8, atol 1e-9, phase 8's bound, and equal
    resets). With Anderson acceleration a reject test that compares two
    residuals at roundoff's level can go either way, and the runs part
    from there: that is accepted after a common head of 40 iterations, and
    the parting iteration is printed with its residual. Prints the
    RuntimeData split per iteration."""
    fused, inst = make("cuda", accel), make("cuda", accel)
    tr = fused.step()
    t0 = time.perf_counter()
    prims_i, combs_i = inst.step_instrumented()
    secs = time.perf_counter() - t0
    pf = valid(tr.prim)
    n = min(len(pf), len(prims_i))
    check(n > 0 and np.allclose(pf[:n], prims_i[:n], rtol=1e-9),
          f"{name}: instrumented prims differ from the fused step's")
    check(np.allclose(fused.x, inst.x, rtol=1e-9, atol=1e-12),
          f"{name}: instrumented x differs from the fused step's")
    check(int(tr.reset_count) == inst.reset_num,
          f"{name}: instrumented resets {inst.reset_num} != fused "
          f"{int(tr.reset_count)}")
    cpu = make("cpu", accel)
    t0 = time.perf_counter()
    prims_c, combs_c = cpu.step_instrumented()
    secs_c = time.perf_counter() - t0
    part = [first_parting(prims_i, prims_c), first_parting(combs_i, combs_c)]
    part = min([k for k in part if k is not None], default=None)
    m = min(len(prims_c), len(prims_i)) if part is None else part
    dp = float(np.max(np.abs(prims_i[:m] - prims_c[:m]) / prims_c[:m]))
    dc = float(np.max(np.abs(combs_i[:m] - combs_c[:m]) / combs_c[:m]))
    agree = part is None and inst.reset_num == cpu.reset_num
    rt = inst.runtime
    it = max(rt.inner_iters, 1)
    print(f"  {name} {'-a 1 -am 5' if accel else 'no acceleration'}, "
          f"instrumented step, {len(prims_i)} iterations: GPU "
          f"{secs * 1e3:.1f} ms ({secs * 1e3 / it:.2f} ms/iteration), CPU "
          f"{secs_c * 1e3:.1f} ms; fused GPU {fused.step_ms[-1]:.1f} ms; "
          f"vs fused max |x diff| {np.abs(fused.x - inst.x).max():.3e}; GPU "
          f"vs CPU max rel prim {dp:.3e}, comb {dc:.3e}"
          + ("" if part is None else
             f" over the first {part} iterations (they part at iteration "
             f"{part}, prim {prims_c[min(part, len(prims_c) - 1)] / prims_c[0]:.3e} "
             f"of the first)") + f", resets {inst.reset_num} / {cpu.reset_num}")
    print(f"  {name} RuntimeData per iteration (GPU, device synchronized "
          f"at each phase's end): global {rt.global_ms / it:.3f} ms, local "
          f"{rt.local_ms / it:.3f} ms, acceleration "
          f"{rt.acceleration_ms / it:.3f} ms, initialization "
          f"{rt.initialization_ms:.3f} ms once; {inst.stats['host_reads']} "
          f"host reads")
    check(agree or (accel and part is not None and part >= 40),
          f"{name}: instrumented GPU and CPU differ (prim {dp}, comb {dc}, "
          f"from iteration {part}, resets {inst.reset_num} / "
          f"{cpu.reset_num})")
    return rt


def check_chunked(name, make):
    """Two accelerated steps with trace_chunk 10 and 1 (set after
    initialize) against the fused steps, bit for bit; time rows strictly
    increasing; ms per step of the second step (the first captures the
    graphs)."""
    out = {}
    for chunk in (0, 10, 1):
        s = make("cuda", True)
        s.settings.trace_chunk = chunk
        s.step()
        s.step()
        s.flush_traces()
        out[chunk] = s
    ref = out[0]
    for chunk in (10, 1):
        s = out[chunk]
        t = s.step_times
        check(np.array_equal(s.x, ref.x) and s.step_prim == ref.step_prim
              and s.step_comb == ref.step_comb
              and s.step_reject == ref.step_reject,
              f"{name}: trace_chunk {chunk} differs from the fused step")
        check(all(a < b for a, b in zip(t, t[1:])),
              f"{name}: trace_chunk {chunk} time rows not increasing")
    print(f"  {name} chunked tracing, 2 accelerated steps, bit-equal to "
          f"fused: ms per step (second step) fused "
          f"{ref.step_ms[-1]:.1f}, chunk 10 {out[10].step_ms[-1]:.1f}, "
          f"chunk 1 {out[1].step_ms[-1]:.1f}")


def check_state(name, make, tmp):
    """save_admm_state at iteration 50 of 100 and replays: the accelerated
    tail from the sidecar bit for bit, the non-accelerated tail from the
    text alone within 1e-11; then the GPU's text dump replayed on the CPU
    within phase 8's bound."""
    f = {k: os.path.join(tmp, f"{name}-{k}") for k in
         ("zu", "x", "aa.npz", "zu0", "x0")}
    a = make("cuda", True)
    a.save_admm_state(f["zu"], f["x"], at_iteration=50, aa_file=f["aa.npz"])
    ref = make("cuda", True)
    ref.step()
    tail = make("cuda", True, 50)
    tail.load_admm_state(f["zu"], f["x"], aa_file=f["aa.npz"])
    tail.step()
    b = make("cuda", False)
    b.save_admm_state(f["zu0"], f["x0"], at_iteration=50)
    text = make("cuda", False, 50)
    text.load_admm_state(f["zu0"], f["x0"])
    text.step()
    for s in (a, tail):
        s.flush_traces()
    check(np.array_equal(a.x, ref.x),
          f"{name}: the dumping step does not commit like step()")
    check(np.array_equal(tail.x, a.x),
          f"{name}: the sidecar replay differs from the uninterrupted step "
          f"(max {np.abs(tail.x - a.x).max()})")
    d_text = float(np.abs(text.x - b.x).max())
    check(d_text <= 1e-11, f"{name}: the text replay differs by {d_text}")
    cpu = make("cpu", False, 50)
    cpu.load_admm_state(f["zu0"], f["x0"])
    cpu.step()
    d_cpu = float(np.abs(cpu.x - b.x).max())
    check(np.allclose(cpu.x, b.x, rtol=1e-8, atol=1e-9),
          f"{name}: the GPU dump replayed on the CPU differs by {d_cpu}")
    print(f"  {name} state at iteration 50 of 100: sidecar replay of the "
          f"accelerated tail bit-equal ({a.reset_num} resets in the step), "
          f"text replay without acceleration max |x diff| "
          f"{d_text:.3e}, the GPU's dump replayed on the CPU {d_cpu:.3e}")


def check_sweep(tmp):
    """beams --log-x-star at full width (a 2,000-iteration star step, then
    the accelerated step instrumented), and the AA sweep over its seven
    settings at two frames each."""
    from aa_admm_tpu_torch.apps import beams, test_anderson_admm
    d = os.path.join(tmp, "log")
    t0 = time.perf_counter()
    beams.main(["-a", "1", "-am", "5", "-v", "0", "--log-x-star"],
               n_frames=1, result_dir=d, device="cuda")
    secs = time.perf_counter() - t0
    log = np.loadtxt(os.path.join(d, "solverlog-5.txt"))
    print(f"  beams --log-x-star -a 1 -am 5 (2,000-iteration star step, one "
          f"instrumented step, one frame): {secs:.1f} s; {len(log)} rows, "
          f"error {log[0, 1]:.4g} -> {log[-1, 1]:.4e} in {log[-1, 0]:.1f} ms")
    # one row per recorded iteration: 100 unless the eps-break fired
    check(log.ndim == 2 and 0 < len(log) <= 100 and log.shape[1] == 2
          and np.isfinite(log).all(), f"log-x-star: solverlog shape {log.shape}")
    check(log[0, 1] == 1.0 and log[-1, 1] < 0.05,
          f"log-x-star: errors {log[0, 1]} -> {log[-1, 1]} (want 1 -> < 0.05)")
    d = os.path.join(tmp, "sweep")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        test_anderson_admm.main(["2", d])
    secs = time.perf_counter() - t0
    names = sorted(os.listdir(d))
    rows = {n: np.loadtxt(os.path.join(d, n)) for n in names}
    print(f"  test_anderson_admm, 7 settings x 2 frames: {secs:.1f} s; rows "
          f"{ {n: len(r) for n, r in rows.items()} }")
    check(names == [f"residual-{m}.txt" for m in range(1, 7)]
          + ["residual-no.txt"], f"sweep: files {names}")
    check(all(100 < len(r) <= 200 and r.shape[1] == 3
              and np.isfinite(r).all() for r in rows.values())
          and len(rows["residual-no.txt"]) == 200,
          "sweep: a residual file is malformed")


def run_plain(ck, device, dtype, iters):
    """The plain AA-ADMM solver on the planarity scene: PlaneBatch hard, a
    RefSurfaceBatch of weight 10 over the 9,800-triangle reference soft
    (2-stage projection: B1's indexed entry), penalty 1, Anderson m = 5.
    Its residual does not converge on this scene, in the JAX package
    either; the planarity error falls. Returns (solver, launch counts,
    seconds)."""
    from aa_admm_tpu_torch.ops.constraints import PlaneBatch, RefSurfaceBatch
    from aa_admm_tpu_torch.solver.geometry_plain import GeometrySolver
    mesh, ref_v, ref_f = planarity_scene()
    n = mesh.n_verts()
    s = GeometrySolver(device=device)
    s.dtype = dtype
    s.add_hard_constraint(PlaneBatch.create(mesh.faces, weight=1.0))
    s.add_soft_constraint(RefSurfaceBatch.create(list(range(n)), 10.0, ref_v,
                                                 ref_f))
    s.setup_ADMM(n, penalty_param=1.0)
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    s.solve_ADMM(mesh.verts, 1e-10, iters, 5)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return s, ck.launch_counts(), time.perf_counter() - t0


def phase_plain(ck):
    """f32 for 100 iterations on the GPU (the max planarity error must fall),
    then f64 for 20 on the GPU and the CPU (function values within 1e-8,
    equal resets). Returns the f32 run's launch counts."""
    from aa_admm_tpu_torch.apps.planarity_opt import check_planarity_error
    mesh = planarity_scene()[0]
    s, counts, secs = run_plain(ck, "cuda", np.float32, 100)
    out = s.get_solution()
    fv = np.asarray(s.function_values)
    with contextlib.redirect_stdout(io.StringIO()):
        pl_b, _ = check_planarity_error(mesh)
        pl_a, _ = check_planarity_error(mesh, out)
    st = s.stats
    print(f"  plain solver f32 GPU, 100 iterations ({mesh.n_verts()} "
          f"vertices, 9,800 reference triangles): {secs:.2f} s, "
          f"{st['solve_s'] / st['iters'] * 1e3:.2f} ms/iteration, "
          f"{st['resets']} resets, {st['host_reads'] / st['iters']:.2f} host "
          f"reads/iteration, B1 launches {counts['ericson_idx']} "
          f"({counts['ericson_idx'] / st['iters']:.2f}/iteration), launches "
          f"{counts}; residual {fv[0]:.4e} -> {fv[-1]:.4e} (least "
          f"{fv.min():.4e}); planarity error max {pl_b.max():.4e} -> "
          f"{pl_a.max():.4e}, mean {pl_b.mean():.4e} -> {pl_a.mean():.4e}")
    check(np.isfinite(out).all() and np.isfinite(fv).all(),
          "plain f32: non-finite values")
    check(pl_a.max() < pl_b.max(),
          "plain f32: the max planarity error did not fall")
    check(counts["ericson_idx"] > 0,
          f"plain f32: B1 was not launched on the plain path: {counts}")
    g, c64, secs_g = run_plain(ck, "cuda", np.float64, 20)
    c, _, secs_c = run_plain(ck, "cpu", np.float64, 20)
    fg, fc = np.asarray(g.function_values), np.asarray(c.function_values)
    rel = float(np.max(np.abs(fg - fc) / np.abs(fc)))
    print(f"  plain solver f64, 20 iterations: GPU {secs_g:.2f} s, CPU "
          f"{secs_c:.2f} s; max rel fv diff {rel:.3e}, resets GPU "
          f"{g.stats['resets']} CPU {c.stats['resets']}, GPU launches {c64}")
    check(len(fg) == len(fc) == 20 and rel <= 1e-8,
          f"plain f64: GPU and CPU function values differ by {rel}")
    check(g.stats["resets"] == c.stats["resets"],
          "plain f64: reset counts differ")
    check(c64["ericson_idx"] > 0, f"plain f64: B1 was not launched: {c64}")
    return counts


def phase_native(tmp):
    """Build the native library here; its parsers against the NumPy parsers
    on phase 9's mesh files, its AABB tree against the port's f64 CPU
    brute-force sweep."""
    from aa_admm_tpu_torch import native
    from aa_admm_tpu_torch.core import meshio
    from aa_admm_tpu_torch.ops.closest_point import closest_point_on_mesh
    built_before = native.lib_path().exists()
    t0 = time.perf_counter()
    path = native.build()
    t_build = time.perf_counter() - t0
    check(native.available(), "native: the library did not load")
    cloth, _, _ = cloth_file(tmp, 64)
    hit = block_file(tmp, "hit", (12, 7, 8), 0.15, 0.25, -1.0,
                     (0.25, 2.5, 0.0))
    nv, nt = native.load_obj_native(cloth)
    py = meshio.load_obj_numpy(cloth)
    check(np.array_equal(nv, py.verts) and np.array_equal(nt, py.faces),
          "native: OBJ parse differs from the NumPy parser")
    ev, et = native.load_elenode_native(hit)
    py = meshio.load_elenode_numpy(hit)
    check(np.array_equal(ev, py.verts) and np.array_equal(et, py.tets),
          "native: .ele/.node parse differs from the NumPy parser")
    _, ref_v, ref_f = planarity_scene()
    g = np.random.default_rng(4)
    lo, hi = ref_v.min(0), ref_v.max(0)
    q = g.uniform(lo - 1.0, hi + 1.0, size=(10000, 3))
    t0 = time.perf_counter()
    pts, sqd = native.AabbTree(ref_v, ref_f).closest_points(q)
    t_tree = time.perf_counter() - t0
    t0 = time.perf_counter()
    twin = closest_point_on_mesh(torch.from_numpy(q),
                                 torch.from_numpy(ref_v[ref_f])).numpy()
    t_twin = time.perf_counter() - t0
    dq = float(np.abs(pts - twin).max())
    dd = float(np.abs(sqd - ((q - twin) ** 2).sum(1)).max())
    how = ("built before this phase, at the run's first mesh load"
           if built_before else f"built in {t_build:.1f} s")
    print(f"  native: {os.path.basename(str(path))} {how}; "
          f"OBJ ({len(nv)} vertices) and .ele/.node ({len(ev)} vertices, "
          f"{len(et)} tets) equal to the NumPy parsers; AabbTree 10,000 "
          f"queries x {len(ref_f)} triangles {t_tree * 1e3:.1f} ms against "
          f"the f64 CPU sweep {t_twin:.1f} s: max |point diff| {dq:.3e}, "
          f"max |sqdist diff| {dd:.3e}")
    check(dq <= 1e-12 and dd <= 1e-12,
          f"native: AabbTree differs from the CPU sweep ({dq}, {dd})")


def phase_state(ck):
    """Phase 10: instrumented steps, chunked tracing, ADMM state, SolverLog
    and the AA sweep, the plain geometry solver, the native library.
    Returns the plain solver's f32 launch counts."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="smoke_state_")
    try:
        makers = phase10_makers(tmp)
        beams_m, wind_m = makers["beams-published"], makers["windyflag-synthetic"]
        t0 = time.perf_counter()
        check_instrumented("beams-published", beams_m, True)
        check_instrumented("beams-published", beams_m, False)
        check_instrumented("windyflag-synthetic", wind_m, True)
        print(f"  ({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        for name in ("windyflag-synthetic", "beams-published"):
            check_chunked(name, makers[name])
        print(f"  ({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        for name in ("plinkohit-synthetic", "beams-published"):
            check_state(name, makers[name], tmp)
        print(f"  ({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        check_sweep(tmp)
        print(f"  ({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        counts = phase_plain(ck)
        print(f"  ({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        phase_native(tmp)
        print(f"  ({time.perf_counter() - t0:.1f} s)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return counts


# ---------------------------------------------------------------------------
# Phase 11: the fixed-order scatter, bit-equal repeats
# ---------------------------------------------------------------------------

def trials_twice(system, n_trials=5):
    """n_trials ALM trials from the solve's start, twice: bit-equal?"""
    from aa_admm_tpu_torch.solver import geometry as g
    outs = []
    for _ in range(2):
        st = g._alm_init_state(system, system.x0.clone())
        st["max_trials"] = n_trials
        st = g.solve_alm_chunk(system, st)
        outs.append((st["dx"], st["fv"], st["u"]))
    (xa, fa, ua), (xb, fb, ub) = outs
    return (torch.equal(xa, xb) and torch.equal(fa.nan_to_num(), fb.nan_to_num())
            and all(torch.equal(a, b) for a, b in zip(ua, ub)))


def steps_twice(make, n_steps, state=None):
    """n_steps steps of two solvers made by `make` (from `state` when
    given): (bit-equal, max |x diff|, ms per step of the first run)."""
    runs = []
    for _ in range(2):
        s = make()
        if state is not None:
            s.x, s.v = (a.copy() for a in state)
        for _ in range(n_steps):
            s.step()
        s.flush_traces()
        runs.append(s)
    a, b = runs
    same = (np.array_equal(a.x, b.x) and a.step_prim == b.step_prim
            and a.step_comb == b.step_comb and a.step_reject == b.step_reject)
    return same, float(np.abs(a.x - b.x).max()), list(a.step_ms)


def phase_bits(ck, wire_solver=None):
    """Phase 11: runs repeated from one state without deterministic
    algorithms must give equal bits. `wire_solver` is phase 5's solver;
    without it the wire mesh is solved here first."""
    import shutil
    import tempfile
    from aa_admm_tpu_torch.apps import plinkohit
    from aa_admm_tpu_torch.apps import windyflag as wf
    check(not torch.are_deterministic_algorithms_enabled(),
          "phase 11: deterministic algorithms are on")
    if wire_solver is None:
        with contextlib.redirect_stdout(io.StringIO()):
            _, wire_solver, _ = phase_full_solve(ck)
    tmp = tempfile.mkdtemp(prefix="smoke_bits_")
    try:
        cloth, _, _ = cloth_file(tmp, 64)
        hit = block_file(tmp, "hit", (12, 7, 8), 0.15, 0.25, -1.0,
                         (0.25, 2.5, 0.0))
        rows = []
        for name, make, k in (
                ("beams-published -a 1 -am 5, two steps",
                 lambda: beams_solver("cuda", True), 2),
                ("windyflag-synthetic -a 1 -am 5, two steps",
                 lambda: wf.build_scene(zxu_settings(True, 100),
                                        mesh_path=cloth, device="cuda"), 2)):
            same, dx, ms = steps_twice(make, k)
            rows.append(same)
            print(f"  {name}, twice: bit-equal {same} (max |x diff| "
                  f"{dx:.3e}); ms per step {', '.join(f'{m:.1f}' for m in ms)}")
        hit_make = lambda: plinkohit.build_scene(zxu_settings(True, 13),
                                                 mesh_path=hit, device="cuda")
        s = hit_make()
        state, frame = None, 0
        while state is None and frame < 30:
            before = (s.x.copy(), s.v.copy())
            s.step()
            frame += 1
            if (scene_sd(s, s._x_dev) < 0).any():
                state = before
        check(state is not None, "plinkohit: no contact in 30 frames")
        same, dx, ms = steps_twice(hit_make, 1, state)
        rows.append(same)
        print(f"  plinkohit-synthetic first contact frame ({frame}), twice: "
              f"bit-equal {same} (max |x diff| {dx:.3e}); {ms[0]:.1f} ms")
        same = trials_twice(wire_solver.system)
        rows.append(same)
        print(f"  five f32 wire-mesh trials (phase 5's system), twice: "
              f"bit-equal {same}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(all(rows), "phase 11: a run repeated from one state differs")


def main(argv):
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from aa_admm_tpu_torch.ops import cuda_kernels as ck
    want = set(range(1, 12))
    if argv[:1] == ["--phases"] and len(argv) == 2:
        want = {1} | {int(a) for a in argv[1].split(",")}
    elif argv:
        print("usage: python3 chip_smoke.py [--phases 2,3,...]",
              file=sys.stderr)
        return 1

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi: no output"
    print(card)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    phase("1 card", t0)

    if 2 in want:
        t0 = time.perf_counter()
        logs = ck.build_all(verbose=True)
        for name, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line or "error" in line:
                    print(f"  nvcc {name}: {line.strip()}")
        phase("2 build", t0)

    record = {}
    dev = torch.device("cuda")
    n_small = small_scene()[0].n_verts()
    if 3 in want:
        t0 = time.perf_counter()
        check_ericson(ck, dev, record, n_small)
        check_ericson_idx(ck, dev, record)
        check_cg(ck, dev, record, n_small)
        phase("3 kernels vs twins", t0)

    if 4 in want:
        t0 = time.perf_counter()
        phase_f64_solve(ck, SMALL_N_REF, MAIN_PATH_KERNELS)
        candT_counts = phase_f64_solve(ck, CANDT_N_REF, CANDT_PATH_KERNELS)
        phase("4 f64 solves GPU vs CPU (subgroup cache; flat cache + candT)",
              t0)

    if 5 in want:
        t0 = time.perf_counter()
        counts, solver, split = phase_full_solve(ck)
        phase("5 full-width f32 solve", t0)
    if 6 in want and 5 in want:
        t0 = time.perf_counter()
        profile_trials(solver, solver.system.x0.cpu().numpy())
        phase("6 profile of five full-width iterations", t0)

    if 7 in want:
        t0 = time.perf_counter()
        plan_counts = phase_planarity(ck)
        phase("7 planarity at costa2k scale (f32; f64 GPU vs CPU)", t0)

    if 8 in want:
        t0 = time.perf_counter()
        phase_physics(ck)
        phase("8 physics: beams (GPU vs CPU, golden, AA frames, CG size)",
              t0)

    if 9 in want:
        t0 = time.perf_counter()
        phase_zxu(ck)
        phase("9 physics, zxu: plinkohit, plinkopony, windyflag, "
              "self-collision, CG size", t0)

    if 10 in want:
        t0 = time.perf_counter()
        plain_counts = phase_state(ck)
        print(f"  B1 (indexed entry) launches on the plain solver's path, "
              f"f32, 100 iterations: {plain_counts['ericson_idx']}")
        phase("10 instrumentation and state, plain geometry, native", t0)

    if 11 in want:
        t0 = time.perf_counter()
        phase_bits(ck, solver if 5 in want else None)
        phase("11 fixed-order scatter: bit-equal repeats", t0)

    if want != set(range(1, 12)):
        print(f"  total {time.perf_counter() - T0:.1f} s; phases "
              f"{sorted(want)} only, so no result lines")
        return 3

    # Each B1 entry is reported at the shape its path launched most: the
    # indexed entry at the full-width solve's (phase 5) tile unless phase 7
    # launched it more often; the plane entry at the planarity scene's
    # shape (phase 7) when that launched it more than phase 4's candT solve.
    main_shape = max(split, key=split.get)
    if plan_counts["ericson_idx"] > split[main_shape]:
        idx_at, idx_launches = "planarity 2-stage", plan_counts["ericson_idx"]
    else:
        idx_at, idx_launches = main_shape, counts["ericson_idx"]
    record["ericson_idx"] = record["ericson_idx"][idx_at]
    if plan_counts["ericson"] > candT_counts["ericson"]:
        record["ericson"] = record["ericson_planarity"]
        pl_at, pl_launches = f"{PLAN_Q} x {PLAN_K} (phase 7)", \
            plan_counts["ericson"]
    else:
        pl_at, pl_launches = f"{n_small} x 48 (phase 4)", \
            candT_counts["ericson"]
    counts = dict(counts, ericson=pl_launches, ericson_idx=idx_launches)
    print(f"  B1 ericson_idx reported at its {idx_at} shape "
          f"({idx_launches} launches); ericson (planes) at {pl_at} "
          f"({pl_launches} launches)")

    meta = {
        "ericson": ("aa_admm_tpu_torch/csrc/ericson.cu",
                    "aa_admm_tpu/ops/pallas_kernels.py:47"),
        "ericson_idx": ("aa_admm_tpu_torch/csrc/ericson.cu",
                        "aa_admm_tpu/ops/pallas_kernels.py:47"),
        "cg_update1": ("aa_admm_tpu_torch/csrc/cg_update.cu",
                       "aa_admm_tpu/ops/pallas_kernels.py:207"),
        "cg_update2": ("aa_admm_tpu_torch/csrc/cg_update.cu",
                       "aa_admm_tpu/ops/pallas_kernels.py:230"),
    }
    kernels = []
    for name, (src, repl) in meta.items():
        r = record[name]
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=repl, launches=counts[name],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=None))
    print(f"  total {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main(sys.argv[1:])
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        rc = 2
    sys.exit(rc)
