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
     counted;
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
     takes the CG path.

``--phases 1,2,7`` runs only the listed phases (phase 1 always runs); the
result lines need every phase.

The last two lines are the kernels' JSON record and the run's result JSON.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

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


def main(argv):
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from aa_admm_tpu_torch.ops import cuda_kernels as ck
    want = set(range(1, 9))
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

    if want != set(range(1, 9)):
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
