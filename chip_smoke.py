"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line with its seconds; any failed check exits
non-zero before the final result line):
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from aa_admm_tpu_torch/csrc (one nvcc each, in
     parallel), and beside them the kernels that B3 and cg_update2_given
     replaced with the floor kernels (tools/port_cg_given_variants.cu);
  3. each kernel against its plain torch twin on the card, float32 and
     float64, at the CPU tests' shapes and at the main path's shapes; device
     times of kernel and twin (CUDA-graph replays between CUDA events)
     beside the kernel's bound; B1's indexed entry also against the chain
     it replaced (gather, relayout, plane entry); B2 and B3 at c = 1..4 and
     four n, equal bits on a repeat and under CUDA-graph replay; the given
     entries of B2 and B3 and their dot pass (cg_dot) at a rank's share of
     the main path's rows over two and four ranks and at ragged n, c =
     1..4, equal bits on a repeat and under CUDA-graph replay; both shares
     timed; B3 and cg_update2_given also in turns against the kernels they
     replaced and beside the floor (an empty kernel over the same grid, one
     pass over the same bytes);
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
     phase 5 ran, else a new 20-iteration solve of its scene);
 12. scene ensembles and element sharding (aa_admm_tpu_torch/parallel):
     bench.py's ensemble bench in float32 on beams-published (-a 1 -am 5,
     100 iterations, the stretch pin velocity) and plinkohit-synthetic
     (phase 9's block, 13 iterations): 8 replicas x 10 frames as one tiled
     ensemble against the single-scene rollout of the same 10 frames
     (iterations/s of both, bench.py's consistency bound 1e-4 * max(1,
     max|x1|), each replica's bits, the residual check, host reads per
     batched step); plinkohit-synthetic at 1, 8, 32 and 128 scenes
     (iterations/s, device ms per batched iteration); float64 ensemble
     steps against single-scene steps (both orders, dense and CG paths,
     replicas whose velocities differ; rtol 1e-10, atol 1e-12, equal
     resets); the sharding dryrun on two ranks on the one card through
     gloo (n_cards=1 on any machine), each holding half of every element
     batch: both orders, on the dense and the CG global step, against the
     unsharded float64 step (max|dx| < 1e-10, max|dprim| < 1e-8), with
     iterations/s and collectives per step, and the geometry dryrun's
     solve on the same ranks;
 13. the geometry solve sharded over vertex rows and constraint elements
     (aa_admm_tpu_torch/parallel/geometry.py), two gloo ranks on the one
     card (n_cards=1 on any machine): the float64 dryrun (max|dx| < 1e-9,
     max|dfv/fv| < 1e-8); phase
     4's small scene in float64 on the CG path with the subgroup cache
     against the unsharded solve on the card (rtol 1e-8, equal rejects and
     refreshes); and the main path of this phase, wiremesh-synthetic-231k
     in float32 for 5 ALM iterations through ``optimize_mesh`` sharded
     over the two ranks: the mean edge error must fall, bench.py's bounds
     beside the errors, ms per trial beside phase 5's, collectives and
     bytes per trial, each rank's launches (B1 and the given entries; the
     unsharded B2 and B3 must not launch) and the ranks' bit-equality;
     then each rank runs its first two iterations again, timed and under
     torch.profiler (device ms per trial);
 14. the sharded paths over cards, one rank per card under NCCL, on
     world = min(4, cards) cards when the machine has two or more (with
     one card it prints that it needs two and does nothing else): the
     physics dryrun (xzu as a dp x elem ensemble, zxu, the dense and the
     CG global step, f64, max|dx| < 1e-10, max|dprim| < 1e-8) and, on the
     same ranks, the geometry dryrun (max|dx| < 1e-9, max|dfv/fv| <
     1e-8); phase 4's small f64 scene on the cards against the unsharded
     card solve (as in phase 13); and wiremesh-synthetic-231k, f32, 5 ALM
     iterations on the cards: ms per trial beside phases 5 and 13 (and of
     the first two iterations repeated), collectives, MB summed, host ms
     inside the calls and the nccl kernels' device ms per trial
     (torch.profiler), each rank's device, current card, backend and
     launches; the ranks must be bit-equal, the mean edge error must fall
     and each rank must hold its own card under NCCL;
 15. the launch across hosts (aa_admm_tpu_torch/parallel/multihost.py):
     ranks started by torchrun, one per simulated host, each reading its
     place from torchrun's env:// variables, the dp axis spanning the
     hosts. Two hosts of one rank on the first card (both see it, so the
     card rule must give gloo): the JAX multihost dryrun's case (the
     float64 tiny xzu ensemble, two replicas per host, each against the
     single-process step, max|dx| < 1e-10, and the geometry dryrun on the
     same ranks) and the main path, wiremesh-synthetic-231k, f32, 5 ALM
     iterations, which must be bit-equal to phase 13's two ranks (ms per
     trial beside phase 13's, seconds from the launch to the first trial,
     each rank's placement and launches: B1 and the given entries, never
     the unsharded B2 or B3). With four or more cards, also two hosts of
     two ranks under NCCL, each host seeing two cards: the same two cases,
     the main path against phase 14's four ranks (bit-equal, or the
     difference and NCCL's connections printed and the quality checks
     held);
 16. the JAX package's on-chip f32 contract (tests_tpu/), with its bounds:
     one f32 beams step of 100 plain iterations against the C++ golden
     (relative error below 1e-2 while the C++ residual is above 1e-2 of
     its first value, the 1e-2 milestone within 3 iterations of the C++
     one) and Anderson m = 5 at f32 reaching 1e-2 within 15 iterations;
     closest points at f32 on the main path's reference surface (39,762
     triangles): 2,000 near-surface queries through the 2-stage sweep, the
     group cache's refresh, a small move and its fast path, each within
     rtol 2e-5, atol 1e-4 of the plain torch brute force on the card, and
     2,000 far-field queries through the 2-stage sweep (at most 2% off, at
     most 6% relative); the ms of each beside the brute force, and B1's
     launches (the ``phase16_launches`` of the kernels' record).

``--phases 1,2,7`` runs only the listed phases (phase 1 always runs); the
result lines need every phase. ``--seed N`` seeds phase 16's queries (11,
the JAX test's, by default).

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
# B1's tiles on the main path (and the uncached 2-stage sweep's), all
# through the indexed entry:
# (queries, index columns G, sub); candidates K = G * sub
ERICSON_SHAPES = {"group fast path": (MAIN_Q, 6, 16),
                  "group refresh": (8192, 48, 1), "2-stage": (4096, 48, 1)}
MAIN_T = 39808                 # the main path's triangle table (Morton-padded)
MAIN_N = 230400                # CG vector rows at MaleTorso scale
SHARD_N = MAIN_N // 2          # one of two ranks' rows (phase 13)
QUARTER_N = MAIN_N // 4        # one of four ranks' rows (phase 14)
# the kernels of the subgroup-cache path (phases 4 and 5), and of the flat
# cache with cached (9, K, Q) candidates (phase 4, second solve: its fast
# path is the plane entry and its refresh launches no kernel; the solve's
# energies project through the cache, so the indexed entry does not run)
MAIN_PATH_KERNELS = ("ericson_idx", "cg_update1", "cg_update2")
CANDT_PATH_KERNELS = ("ericson", "cg_update1", "cg_update2")
SMALL_N_REF, CANDT_N_REF = 102, 60     # 20,402 and 6,962 triangles
# phase 7: B1's shapes on the planarity scene (2,401 queries, 48 candidates
# from a 9,800-triangle table); phase 8: the beams' C++ golden
PLAN_Q, PLAN_K, PLAN_T = 2401, 48, 9800
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                      "golden", "beams_step1_residual_no_cpp.txt")
# the kernels that B3 and cg_update2_given replaced and the floor kernels
# (phase 3 times them beside the package's), appended to cg_update.cu
VARIANTS_CU = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tools", "port_cg_given_variants.cu")
OLD_MAX_BLOCKS = 528           # the replaced kernels' grid: 4 blocks an SM

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


def old_blocks(n):
    """The grid of the replaced CG kernels for n rows: a row a thread, 256
    a block, at most OLD_MAX_BLOCKS."""
    return max(1, min(OLD_MAX_BLOCKS, -(-n // 256)))


def start_variants_build(ck, name="variants", text=None):
    """Starts nvcc (the package's flags and -Xptxas -v) on `text`, by
    default aa_admm_tpu_torch/csrc/cg_update.cu with VARIANTS_CU appended,
    into the build directory's variants/; returns a function that waits for
    it and returns (CDLL, nvcc's output), or raises if nvcc failed."""
    import ctypes
    out_dir = ck.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    if text is None:
        text = ((ck.CSRC_DIR / "cg_update.cu").read_text() + "\n"
                + open(VARIANTS_CU).read())
    cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    cu.write_text(text)
    proc = subprocess.Popen(
        [ck._nvcc(), *ck.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so),
         str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)

    def finish():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        if not hasattr(lib, "floor_empty_f32"):      # an edited package
            return lib, log
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for entry, types in {
                "old_cg_update2_f32": [P] * 8 + [LL, I, P],
                "old_cg_update2_given_f32": [P] * 6 + [LL, I, P],
                "floor_empty_f32": [I, I, P],
                "floor_pass_f32": [P, P, P, LL, I, I, P]}.items():
            f = getattr(lib, entry)
            f.argtypes, f.restype = types, I
        return lib, log
    return finish


def variants_calls(ck, lib, n, c, v, rz_old, rr_prev, thresh, grid,
                   threads):
    """Calls on one set of f32, c = 3 inputs (v: r, z and p; p updated in
    place): the replaced B3 (two launches) and cg_update2_given, an empty
    kernel over `grid` blocks, and one pass of 16-byte chunks over r, z
    and p (B3's bytes) and over z and p (cg_update2_given's), a thread per
    chunk; `threads` a block in these three."""
    rz = torch.empty(c, device=v["p"].device)
    part = torch.empty((OLD_MAX_BLOCKS, c), device=v["p"].device)
    nb_old, nb_pass = old_blocks(n), max(1, -(-n // (4 * threads)))
    r, z, p = (v[k].data_ptr() for k in ("r", "z", "p"))

    def go(entry, *args):
        ck._check(getattr(lib, entry)(
            *args, torch.cuda.current_stream().cuda_stream), entry)
    return {
        "old cg_update2": lambda: go(
            "old_cg_update2_f32", rz_old.data_ptr(), rr_prev.data_ptr(),
            thresh.data_ptr(), r, z, p, rz.data_ptr(), part.data_ptr(), n,
            nb_old),
        "old cg_update2_given": lambda: go(
            "old_cg_update2_given_f32", rz_old.data_ptr(), rz_old.data_ptr(),
            rr_prev.data_ptr(), thresh.data_ptr(), z, p, n, nb_old),
        "empty kernel": lambda: go("floor_empty_f32", grid, threads),
        "pass over r, z, p": lambda: go("floor_pass_f32", r, z, p, n,
                                         nb_pass, threads),
        "pass over z, p": lambda: go("floor_pass_f32", None, z, p, n,
                                      nb_pass, threads)}


def in_turns(calls, order, iters=20, reps=10):
    """{name: [device ms, ...]} of calls timed by device_ms in `order`
    (names may repeat: old, new, new, old)."""
    out = {}
    for name in order:
        out.setdefault(name, []).append(
            device_ms(calls[name], iters=iters, reps=reps))
    return out


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


def full_field(x, y):
    return 3.0 * np.sin(2 * np.pi * x / 80.0) * np.cos(2 * np.pi * y / 60.0)


def full_reference(n_faces=240, n_ref=142):
    """The main path's reference surface: full_field triangulated to
    2 * 141^2 = 39,762 triangles (MaleTorso_target's size)."""
    return height_field_tris(n_ref, -2.0, n_faces + 2.0, full_field)


def full_scene(n_faces=240, n_ref=142):
    """MaleTorso scale: a noisy 240 x 240-face quad grid on a bumpy height
    field, subdivided and smoothed to 231,361 vertices; the reference is
    the same field triangulated to 2 * 141^2 = 39,762 triangles."""
    from aa_admm_tpu_torch.core.polymesh import subdivide_and_smooth

    mesh = quad_grid(n_faces, n_faces, 0.05, field=full_field, seed=1)
    el = mesh.average_edge_length()
    ref_v, ref_f = full_reference(n_faces, n_ref)
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
    solve's counters: the trials and the init/final energies each project
    through the subgroup cache once; a refresh (the loop's and the
    energies') sweeps 8,192-query tiles, the fast path 65,536-query
    tiles."""
    def tiles(shape):
        return -(-n_queries // ERICSON_SHAPES[shape][0])

    refreshes = stats["cp_refreshes"] + stats["energy_refreshes"]
    return {"group fast path": (stats["trials"] + 2 - refreshes)
            * tiles("group fast path"),
            "group refresh": refreshes * tiles("group refresh")}


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


def cg_case_bits(ck, nc, cc, dtype, device, tol):
    """B2 and B3 at n = nc, c = cc: twice on the same inputs (equal bits),
    once captured in a CUDA graph and replayed twice (the eager bits), and
    against their twins. Returns the f32 max abs errors (B2's, B3's)."""
    v, rz, rz_old, rr_prev, thresh = cg_inputs(nc, cc, dtype, device,
                                               nc + cc)

    def calls(x, r, p):
        rr = ck.cg_update1(rz, v["p"], v["ap"], x, r, rr_prev, thresh)
        rzn = ck.cg_update2(rz_old, v["r"], v["z"], p, rr_prev, thresh)
        return x, r, rr, p, rzn
    outs = [calls(v["x"].clone(), v["r"].clone(), v["p"].clone())
            for _ in range(2)]
    check(all(torch.equal(a, b) for a, b in zip(*outs)),
          f"cg_update1/2 n={nc} c={cc} {dtype}: two calls differ")
    gx, gr, gp = v["x"].clone(), v["r"].clone(), v["p"].clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gx.copy_(v["x"])
        gr.copy_(v["r"])
        gp.copy_(v["p"])
        got = calls(gx, gr, gp)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, outs[0])),
              f"cg_update1/2 n={nc} c={cc} {dtype}: a CUDA graph's replay "
              f"differs from the eager call")
    del graph
    x, r, p = v["x"].clone(), v["r"].clone(), v["p"].clone()
    rr = ck.cg_update1_plain(rz, v["p"], v["ap"], x, r, rr_prev, thresh)
    rzn = ck.cg_update2_plain(rz_old, v["r"], v["z"], p, rr_prev, thresh)
    errs = [0.0, 0.0]
    for i, (name, a, b) in enumerate(zip(("x", "r", "rr", "p", "rz"),
                                         outs[0], (x, r, rr, p, rzn))):
        err = float((a - b).abs().max())
        # rz, a signed sum of nc terms of size ~1, also at an atol of
        # tol * sqrt(nc), the size of such a sum
        atol = tol * (nc ** 0.5 if name == "rz" else 1)
        check(torch.allclose(a, b, rtol=tol, atol=atol),
              f"cg n={nc} c={cc} {dtype}: {name} err {err}")
        errs[i >= 3] = max(errs[i >= 3], err)
    return errs


def check_cg(ck, device, record, n_small, variants):
    """B2/B3 vs twins with a frozen column and zero divisors (pAp = 0,
    rz_old = 0): at n=230,400, c=3 and at c = 1..4 on the small scene's n,
    an n that is no multiple of the block size, n=230,400 (B2 keeps p and
    Ap in registers; B3 has a chunk a thread), n=300,001 (B2 reads them
    again) and n past one and past two chunks a thread of B3's grid (two
    chunks unrolled, then its grid-stride loops); each called twice on the same inputs must give equal bits, and
    replayed from a CUDA graph the eager call's. Then both timed at
    n=230,400, c=3, B3 in turns against the two launches it replaced and
    beside the floor: an empty kernel over its grid and one pass over r, z
    and p (`variants`, the CDLL of start_variants_build)."""
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
        for cc in (1, 2, 3, 4):
            # past one and past two chunks a thread of B3's grid: its
            # unrolled two chunks, its grid-stride loops
            wave = (ck.cg2_blocks(1 << 40, cc, dtype, device)
                    * ck.CG2_THREADS * ck.CG1_ROWS)
            for nc in (n_small, 70001, MAIN_N, 300001, wave + 5,
                       2 * wave + 5):
                e1, e2 = cg_case_bits(ck, nc, cc, dtype, device, tol)
                if dtype == torch.float32:
                    worst1, worst2 = max(worst1, e1), max(worst2, e2)
    v, rz, _, rr_prev, thresh = cg_inputs(n, c, torch.float32, device, 8)
    x, r, p = v["x"], v["r"], v["p"]
    nb1 = ck.cg1_blocks(n, c, x.dtype, x.device)
    nb2 = ck.cg2_blocks(n, c, x.dtype, x.device)
    print(f"  B2 cg_update1, B3 cg_update2: c = 1..4, n = {n_small}, 70001, "
          f"{MAIN_N}, 300001 and past one and two chunks a thread of B3's "
          f"grid, f32 and f64: match the twins (f32 max abs err "
          f"{worst1:.3e}, {worst2:.3e}), repeat bit for bit, eager and as "
          f"CUDA-graph replays; grids at n={n}, c={c}: {nb1} blocks of "
          f"{ck.CG1_THREADS} and {nb2} of {ck.CG2_THREADS}")
    rz_old = (r * v["z"]).sum(0)     # beta ~ 1: repeated calls stay finite
    ms1, pl1, ms1_e, pl1_e = time_pair(
        lambda: ck.cg_update1(rz, p, v["ap"], x, r, rr_prev, thresh),
        lambda: ck.cg_update1_plain(rz, p, v["ap"], x, r, rr_prev, thresh))
    _, pl2, ms2_e, pl2_e = time_pair(
        lambda: ck.cg_update2(rz_old, r, v["z"], p, rr_prev, thresh),
        lambda: ck.cg_update2_plain(rz_old, r, v["z"], p, rr_prev, thresh))
    calls = variants_calls(ck, variants, n, c, v, rz_old, rr_prev, thresh,
                           nb2, ck.CG2_THREADS)
    calls["cg_update2"] = lambda: ck.cg_update2(rz_old, r, v["z"], p,
                                                rr_prev, thresh)
    t = in_turns(calls, ("old cg_update2", "cg_update2", "cg_update2",
                         "old cg_update2", "empty kernel",
                         "pass over r, z, p"))
    ms2 = sum(t["cg_update2"]) / 2
    b1, by1 = bound_ms(6 * n * c * 4, 8 * n * c, torch.float32)
    b2, by2 = bound_ms(4 * n * c * 4, 4 * n * c, torch.float32)
    print(f"  B2 cg_update1 f32 n={n} c={c}: kernel {ms1:.4f} ms, twin "
          f"{pl1:.4f} ms (device, CUDA graph); per eager call {ms1_e:.4f} / "
          f"{pl1_e:.4f} ms; bound {b1:.4f} ms ({by1})")
    print(f"  B3 cg_update2 f32 n={n} c={c} ({nb2} blocks): kernel "
          f"{ms2:.4f} ms (in turns with the two launches it replaced, "
          f"{old_blocks(n)} blocks: old/new/new/old "
          + " / ".join(f"{m:.4f}" for m in (t["old cg_update2"][0],
                                           *t["cg_update2"],
                                           t["old cg_update2"][1]))
          + f" ms), twin {pl2:.4f} ms (device, CUDA graph); per eager call "
          f"{ms2_e:.4f} / {pl2_e:.4f} ms; bound {b2:.4f} ms ({by2}, "
          f"{b2 / ms2:.0%} of it); floor: an empty kernel over its grid "
          f"{t['empty kernel'][0]:.4f} ms, one pass of 16-byte chunks over "
          f"r, z, p {t['pass over r, z, p'][0]:.4f} ms")
    record["cg_update1"] = dict(ms=ms1, plain_ms=pl1, bound_ms=b1,
                                bound_by=by1, max_abs_err=worst1)
    record["cg_update2"] = dict(ms=ms2, plain_ms=pl2, bound_ms=b2,
                                bound_by=by2, max_abs_err=worst2)


def given_cases(ck, device):
    """(n, c, dtype) of the given entries' checks: a rank's share of the
    main path's rows over two and four ranks, ragged n (0, 1, 3, 81, 4,099,
    70,001: partial last chunks) and, for each grid (cg_dot's and
    cg_update1_given's; cg_update2_given's), an n with more 4-row chunks
    than the card holds its threads (the kernels' grid-stride loop), c =
    1..4, float32 and float64."""
    out = []
    for dtype in (torch.float32, torch.float64):
        for cc in (1, 2, 3, 4):
            loops = [ck.cg_given_blocks(1 << 40, cc, dtype, device)
                     * ck.CG1_THREADS * ck.CG1_ROWS + 5,
                     ck.cg2_given_blocks(1 << 40, cc, dtype, device)
                     * ck.CG2_GIVEN_THREADS * ck.CG1_ROWS + 5]
            out += [(nc, cc, dtype) for nc in
                    (SHARD_N, QUARTER_N, 0, 1, 3, 81, 4099, 70001, *loops)]
    return out


def check_cg_given(ck, device, record, variants):
    """The given entries of B2 and B3 and their dot pass (cg_dot) against
    their twins, with a frozen column and zero divisors, at given_cases'
    shapes; each called twice must give equal bits, and all three,
    captured in a CUDA graph after those eager calls and replayed twice,
    the eager call's bits. Then timed in f32, c = 3, at a rank's share over
    two ranks (reported) and over four, beside each bound (and cg_dot
    beside torch.linalg.vecdot, the one PyTorch call that computes it);
    cg_update2_given in turns against the kernel it replaced and beside
    the floor (an empty kernel over its grid, one pass over z and p)."""
    rtol = {torch.float64: 1e-12, torch.float32: 1e-3}
    worst = dict(cg_dot=0.0, cg_update1_given=0.0, cg_update2_given=0.0)
    cases = given_cases(ck, device)
    for nc, cc, dtype in cases:
        v, rz, rz_old, rr_prev, thresh = cg_inputs(nc, cc, dtype, device,
                                                   nc + cc + 11)
        pap = (v["p"] * v["ap"]).sum(0)
        outs = []
        for _ in range(2):
            x, r, p = v["x"].clone(), v["r"].clone(), v["p"].clone()
            d = ck.cg_dot(v["p"], v["ap"])
            rr = ck.cg_update1_given(pap, rz, v["p"], v["ap"], x, r,
                                     rr_prev, thresh)
            ck.cg_update2_given(rz, rz_old, v["z"], p, rr_prev, thresh)
            outs.append(dict(cg_dot=(d,), cg_update1_given=(x, r, rr),
                             cg_update2_given=(p,)))
        x, r, p = v["x"].clone(), v["r"].clone(), v["p"].clone()
        plain = dict(
            cg_dot=(ck.cg_dot_plain(v["p"], v["ap"]),),
            cg_update1_given=(x, r, ck.cg_update1_given_plain(
                pap, rz, v["p"], v["ap"], x, r, rr_prev, thresh)),
            cg_update2_given=(p,))
        ck.cg_update2_given_plain(rz, rz_old, v["z"], p, rr_prev, thresh)
        gx, gr, gp = v["x"].clone(), v["r"].clone(), v["p"].clone()
        gd, grr = rz.clone(), rz.clone()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            gx.copy_(v["x"])
            gr.copy_(v["r"])
            gp.copy_(v["p"])
            ck.cg_dot(v["p"], v["ap"], out=gd)
            ck.cg_update1_given(pap, rz, v["p"], v["ap"], gx, gr, rr_prev,
                                thresh, out=grr)
            ck.cg_update2_given(rz, rz_old, v["z"], gp, rr_prev, thresh)
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in
                      zip((gd, gx, gr, grr, gp),
                          (outs[0]["cg_dot"][0],
                           *outs[0]["cg_update1_given"],
                           outs[0]["cg_update2_given"][0]))),
                  f"given entries n={nc} c={cc} {dtype}: a CUDA graph's "
                  f"replay differs from the eager call")
        del graph
        for name in worst:
            check(all(torch.equal(a, b) for a, b in
                      zip(outs[0][name], outs[1][name])),
                  f"{name} n={nc} c={cc} {dtype}: two calls differ")
            for i, (a, b) in enumerate(zip(outs[0][name], plain[name])):
                err = float((a - b).abs().max()) if a.numel() else 0.0
                # x, r and p element-wise at atol = rtol; the column
                # sums (cg_dot, rr) of nc terms of size ~1 also at an
                # atol of rtol * sqrt(nc), the size of a signed sum
                summed = (name, i) in (("cg_dot", 0),
                                       ("cg_update1_given", 2))
                atol = rtol[dtype] * (max(nc, 1) ** 0.5 if summed else 1)
                check(torch.allclose(a, b, rtol=rtol[dtype], atol=atol),
                      f"{name} n={nc} c={cc} {dtype}: max abs err {err}")
                if dtype == torch.float32:
                    worst[name] = max(worst[name], err)
        if cc > 1:
            check(bool(torch.equal(outs[0]["cg_update1_given"][0][:, 1],
                                   v["x"][:, 1])),
                  "cg_update1_given: frozen column moved")
    ns = sorted({nc for nc, _, _ in cases})
    print(f"  cg_dot, cg_update1_given, cg_update2_given vs twins: "
          f"{len(cases)} cases, c = 1..4, f32 and f64, n = "
          f"{', '.join(map(str, ns))}: each repeats bit for bit, eager and "
          f"as CUDA-graph replays")
    c, w = 3, 4
    for n in (SHARD_N, QUARTER_N):
        v, rz, rz_old, rr_prev, thresh = cg_inputs(n, c, torch.float32,
                                                   device, 9)
        x, r, p, ap, z = v["x"], v["r"], v["p"], v["ap"], v["z"]
        pap = (p * ap).sum(0)
        rz_old = (r * z).sum(0)       # beta ~ 1: repeated calls stay finite
        timed = {
            "cg_dot": (lambda: ck.cg_dot(p, ap),
                       lambda: ck.cg_dot_plain(p, ap),
                       2 * n * c * w + c * w, 2 * n * c,
                       lambda: torch.linalg.vecdot(p, ap, dim=0)),
            "cg_update1_given": (
                lambda: ck.cg_update1_given(pap, rz, p, ap, x, r, rr_prev,
                                            thresh),
                lambda: ck.cg_update1_given_plain(pap, rz, p, ap, x, r,
                                                  rr_prev, thresh),
                6 * n * c * w + 5 * c * w, 6 * n * c, None),
            "cg_update2_given": (
                lambda: ck.cg_update2_given(rz_old, rz_old, z, p, rr_prev,
                                            thresh),
                lambda: ck.cg_update2_given_plain(rz_old, rz_old, z, p,
                                                  rr_prev, thresh),
                3 * n * c * w + 4 * c * w, 2 * n * c, None)}
        grids = {"cg_dot": ck.cg_given_blocks(n, c, x.dtype, x.device)}
        grids["cg_update1_given"] = grids["cg_dot"]
        grids["cg_update2_given"] = ck.cg2_given_blocks(n, c, x.dtype,
                                                        x.device)
        calls = variants_calls(ck, variants, n, c, v, rz_old, rr_prev,
                               thresh, grids["cg_update2_given"],
                               ck.CG2_GIVEN_THREADS)
        calls["cg_update2_given"] = timed["cg_update2_given"][0]
        t = in_turns(calls, ("old cg_update2_given", "cg_update2_given",
                             "cg_update2_given", "old cg_update2_given",
                             "empty kernel", "pass over z, p"))
        for name, (kern, twin, n_bytes, n_flops, lib) in timed.items():
            ms, pl, ms_e, pl_e = time_pair(kern, twin)
            turns = ""
            if name == "cg_update2_given":
                ms = sum(t[name]) / 2
                turns = (f" (in turns with the kernel it replaced, "
                         f"{old_blocks(n)} blocks: old/new/new/old "
                         + " / ".join(f"{m:.4f}" for m in (
                             t["old " + name][0], *t[name],
                             t["old " + name][1]))
                         + f" ms; floor: an empty kernel over the grid "
                         f"{t['empty kernel'][0]:.4f} ms, one pass of "
                         f"16-byte chunks over z, p "
                         f"{t['pass over z, p'][0]:.4f} ms)")
            lib_ms = device_ms(lib) if lib is not None else None
            b, by = bound_ms(n_bytes, n_flops, torch.float32)
            print(f"  {name} f32 n={n} c={c} ({grids[name]} blocks): "
                  f"kernel {ms:.4f} ms{turns}, twin {pl:.4f} ms (device, CUDA "
                  f"graph); per eager call {ms_e:.4f} / {pl_e:.4f} ms; bound "
                  f"{b:.4f} ms ({by}, {b / ms:.0%} of it)"
                  + (f"; torch.linalg.vecdot {lib_ms:.4f} ms" if lib else "")
                  + f"; f32 max abs err vs twin {worst[name]:.3e}")
            if n == SHARD_N:
                record[name] = dict(ms=ms, plain_ms=pl, bound_ms=b,
                                    bound_by=by, max_abs_err=worst[name],
                                    library_ms=lib_ms)


# ---------------------------------------------------------------------------
# Phases 4 and 5: the solve
# ---------------------------------------------------------------------------

def run_small_solve(device, n_ref, max_iter=20):
    from aa_admm_tpu_torch.apps import wire_mesh_opt as wm

    sub, el, ref_v, ref_f = small_scene(n_ref)
    return wm.optimize_mesh(sub, ref_v, ref_f, max_iter=max_iter,
                            anderson_m=5, edge_length=el,
                            result_dir="result/smoke_small", device=device,
                            dense_threshold=0)


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
    return counts, solver, split, (sub, el, ref_v, ref_f)


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
                k in e.key for k in ("ericson_", "cg1_fused", "cg2_fused")):
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
    # every projection, the energies' too, goes through the candT cache:
    # the plane entry on the fast path, no kernel in a refresh
    check(counts["ericson"] > 0 and counts["ericson_idx"] == 0,
          f"planarity f32: B1's plane entry not launched, or its indexed "
          f"entry launched: {counts}")

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
    check(c64["ericson"] > 0 and c64["ericson_idx"] == 0,
          f"planarity f64: B1's plane entry not launched, or its indexed "
          f"entry launched: {c64}")
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


# ---------------------------------------------------------------------------
# Phase 12: scene ensembles on one card, element-axis sharding
# ---------------------------------------------------------------------------

def prim_ok(prim):
    """bench.py's _prim_ok: every frame's first iterate finite, no inf
    anywhere (NaN marks the iterations an eps-break skipped)."""
    prim = prim.double().cpu().numpy()
    return bool(np.isfinite(prim[..., 0]).all()
                and not np.isinf(prim).any())


def replicas(solver, n):
    """n copies of the solver's (x, v, pin_pos), (n, verts, 3) each."""
    return tuple(t.expand(n, *t.shape).clone() for t in
                 (solver._x_dev, solver._v_dev, solver._pin_pos_dev()))


def ensemble_bench(name, solver, pin_vel, n_rep=8, n_frames=10):
    """bench.py's _ensemble_bench (bench.py:128-170) through the port:
    n_rep replicas x n_frames as one tiled ensemble against the
    single-scene run_frames of the same frames, each warmed by one frame
    first (the CUDA graphs' capture)."""
    from aa_admm_tpu_torch.parallel.ensemble import ensemble_run_frames
    from aa_admm_tpu_torch.solver.physics import _counts, run_frames
    system, iters = solver.system, solver.system.admm_iters
    x, v, pp = solver._x_dev, solver._v_dev, solver._pin_pos_dev()
    pv = None if pin_vel is None else torch.as_tensor(
        pin_vel, dtype=x.dtype, device=x.device)
    xs, vs, pps = replicas(solver, n_rep)
    run_frames(system, x, v, pp, 1, pv)
    ensemble_run_frames(system, xs, vs, pps, 1, pv)
    torch.cuda.synchronize()
    single = _counts()
    t0 = time.perf_counter()
    x1, _, _, tr1 = run_frames(system, x, v, pp, n_frames, pv, single)
    torch.cuda.synchronize()
    t_single = time.perf_counter() - t0
    counts = _counts()
    t0 = time.perf_counter()
    xe, _, _, tre = ensemble_run_frames(system, xs, vs, pps, n_frames, pv,
                                        counts)
    torch.cuda.synchronize()
    t_ens = time.perf_counter() - t0
    rate = n_rep * n_frames * iters / t_ens
    rate1 = n_frames * iters / t_single
    err = float((xe - x1[None]).abs().max())
    bound = 1e-4 * max(1.0, float(x1.abs().max()))
    bits = sum(bool(torch.equal(xe[r], x1)) for r in range(n_rep))
    ok = prim_ok(tre.prim) and prim_ok(tr1.prim)
    print(f"  {name}, {solver.n_verts} vertices, {iters} iterations/frame, "
          f"f32: ensemble {n_rep} x {n_frames} frames {t_ens:.3f} s, "
          f"ensemble_iters_per_s {rate:.3f}; single-scene run_frames "
          f"{t_single:.3f} s, {rate1:.3f} iterations/s (ratio "
          f"{rate / rate1:.2f}); consistency err {err:.3e} (bound "
          f"{bound:.3e}); {bits} of {n_rep} replicas bit-equal to the "
          f"single rollout; _prim_ok {ok}; resets per replica "
          f"{tre.reset_count.sum(1).tolist()} (single "
          f"{int(tr1.reset_count.sum())}); host reads per batched step "
          f"{counts['host_reads'] / n_frames:.1f} (single "
          f"{single['host_reads'] / n_frames:.1f})")
    check(err < bound, f"{name} ensemble: consistency err {err} >= {bound}")
    check(ok, f"{name} ensemble: non-finite residuals")


def busy_ms(fn):
    """(wall ms, device busy ms, device launches) of one fn() call under
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA")]
    busy = sum(getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
               for e in dev) / 1e3
    return wall, busy, sum(e.count for e in dev)


def ensemble_scaling(solver, sizes=(1, 8, 32, 128), n_frames=3):
    """plinkohit-synthetic's ensemble at each size: iterations/s over
    n_frames frames (after one warm frame), device ms per batched
    iteration from a profiled frame."""
    from aa_admm_tpu_torch.parallel.ensemble import ensemble_step
    step = ensemble_step(solver.system.order)
    iters = solver.system.admm_iters
    for S in sizes:
        xs, vs, pps = replicas(solver, S)

        def frames(k, xs=xs, vs=vs):
            for _ in range(k):
                xs, vs, tr = step(solver.system, xs, vs, pps)
            return xs, tr
        frames(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xe, tr = frames(n_frames)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        wall, busy, launches = busy_ms(lambda: frames(1))
        print(f"  plinkohit-synthetic ensemble of {S}: "
              f"{S * n_frames * iters / secs:.1f} iterations/s "
              f"({secs / n_frames * 1e3:.1f} ms/frame); profiled frame: "
              f"wall {wall:.1f} ms, device {busy / iters:.3f} ms per batched "
              f"iteration, idle share {1 - busy / wall:.3f}, "
              f"{launches / iters:.0f} launches per iteration")
        check(bool(torch.isfinite(xe).all()) and prim_ok(tr.prim),
              f"plinkohit-synthetic ensemble of {S}: non-finite result")


def tiny_parity(order, path, n=4):
    """float64 ensemble step of the tiny scene on the card against
    single-scene steps (replicas whose velocities differ): max |dx|, max
    relative prim difference, resets equal."""
    from aa_admm_tpu_torch.parallel import ensemble as ens
    from aa_admm_tpu_torch.solver import physics as ph
    iters, m = (30, 2) if order == "xzu" else (20, 3)
    solver, s = ens.build_tiny_scene(order, "float64", iters, m,
                                     device="cuda")
    if path == "cg":
        s.linear_solver = "cg"
        solver.initialize(s)
    xs, vs, pps = ens.tiny_states(solver, n, spread=1.0)
    if order == "xzu":      # velocities that make the fastest replica reject
        g = np.random.default_rng(0).normal(size=tuple(vs.shape))
        vs = torch.from_numpy(20.0 * np.linspace(0.0, 1.0, n)[:, None, None]
                              * g).to(vs)
    xe, _, tre = ens.ensemble_step(order)(solver.system, xs, vs, pps)
    fn = ph.step_xzu if order == "xzu" else ph.step_zxu
    dx, dp, same = 0.0, 0.0, True
    for r in range(n):
        x1, _, tr1 = fn(solver.system, xs[r], vs[r], pps[r])
        close = torch.allclose(xe[r], x1, rtol=1e-10, atol=1e-12)
        p, p1 = tre.prim[r], tr1.prim
        ok = ~torch.isnan(p1)
        same &= (close and torch.equal(torch.isnan(p), ~ok)
                 and torch.allclose(p[ok], p1[ok], rtol=1e-10, atol=1e-12)
                 and int(tre.reset_count[r]) == int(tr1.reset_count))
        dx = max(dx, float((xe[r] - x1).abs().max()))
        dp = max(dp, float((p[ok] - p1[ok]).abs().max() / p1[0]))
    print(f"  f64 ensemble of {n} against single-scene steps, {order} "
          f"{path}: max|dx| {dx:.3e}, max|dprim| / first prim {dp:.3e}, "
          f"resets {tre.reset_count.tolist()}")
    check(same, f"f64 ensemble {order} {path}: differs from single-scene "
          "steps beyond rtol 1e-10 / atol 1e-12 or in its resets")


def phase_ensembles(ck):
    import shutil
    import tempfile
    from aa_admm_tpu_torch.apps import beams, plinkohit
    from aa_admm_tpu_torch.parallel.ensemble import dryrun
    ck.reset_launch_counts()
    tmp = tempfile.mkdtemp(prefix="smoke_ens_")
    try:
        t0 = time.perf_counter()
        s = beams_settings(True, 100)
        s.dtype = np.dtype(np.float32)
        solver, stretch = beams.build_scene(s, device="cuda")
        ensemble_bench("beams-published -a 1 -am 5", solver,
                       stretch.pin_velocity)
        print(f"  ({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        hit = block_file(tmp, "hit", (12, 7, 8), 0.15, 0.25, -1.0,
                         (0.25, 2.5, 0.0))
        s = zxu_settings(True, 13)
        s.dtype = np.dtype(np.float32)
        solver = plinkohit.build_scene(s, mesh_path=hit, device="cuda")
        ensemble_bench("plinkohit-synthetic -a 1 -am 5", solver, None)
        ensemble_scaling(solver)
        print(f"  ({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        for order in ("xzu", "zxu"):
            for path in ("dense", "cg"):
                tiny_parity(order, path)
        print(f"  ({time.perf_counter() - t0:.1f} s)")
        # Two ranks on the one card through gloo (NCCL takes one rank per
        # card; n_cards=1 keeps this on one card on any machine), each with
        # half of every element batch; both orders on the dense and the CG
        # global step, then the geometry dryrun's solve.
        t0 = time.perf_counter()
        check_dryrun(dryrun(2, n_cards=1, timeout=300))
        print(f"  ({time.perf_counter() - t0:.1f} s with the ranks' start)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = ck.launch_counts()
    print(f"  kernel launches in phase 12: {counts} (the physics path runs "
          f"none of the port's kernels)")


# ---------------------------------------------------------------------------
# Phase 13: the geometry solve sharded over vertex rows and elements
# ---------------------------------------------------------------------------

SHARD_PATH_KERNELS = ("ericson_idx", "cg_dot", "cg_update1_given",
                      "cg_update2_given")
# the sharded main path's options (phases 13-15): 5 float32 ALM iterations
SHARD_WIRE_OPTS = dict(max_iter=5, dtype=np.float32)


def scene_dict(sub, el, ref_v, ref_f):
    """A wire-mesh scene as the plain arrays a spawned rank is handed."""
    return dict(verts=np.asarray(sub.verts), faces=[list(f) for f in sub.faces],
                ref_v=np.asarray(ref_v), ref_f=np.asarray(ref_f),
                edge_length=el)


def check_dryrun(summary):
    """The physics dryrun's bounds (both orders, both global steps) and the
    geometry dryrun's, on the summary dryrun() returns."""
    for key in ("xzu", "zxu", "xzu_cg", "zxu_cg"):
        o = summary[key]
        check(o["max_dx"] < 1e-10 and o["max_dprim"] < 1e-8,
              f"element-sharded {key}: {o}")
    g = summary["geometry"]
    check(g["max_dx"] < 1e-9 and g["max_dfv_rel"] < 1e-8,
          f"geometry dryrun: {g}")


def placement_text(ranks):
    return ", ".join(f"rank {r['rank']} {r['device']} (current "
                     f"{r['current_device']}, {r['backend']})" for r in ranks)


def sharded_f64_small(ck, world=2, n_cards=1):
    """Phase 4's small scene (20,402-triangle reference: the subgroup
    cache), f64, on the CG path: `world` ranks placed by rank_placement on
    n_cards cards (2 gloo ranks on one card in phase 13) against the
    unsharded solve on the card (rtol 1e-8, equal rejects and refreshes,
    the ranks bit-equal)."""
    from aa_admm_tpu_torch.apps import wire_mesh_opt as wm
    from aa_admm_tpu_torch.parallel import ensemble as ens
    from aa_admm_tpu_torch.parallel import geometry as pgeo
    sub, el, ref_v, ref_f = small_scene(SMALL_N_REF)
    ref = wm.optimize_mesh(sub, ref_v, ref_f, max_iter=20, anderson_m=5,
                           edge_length=el, result_dir="result/smoke_small",
                           device="cuda", dense_threshold=0)
    ranks = ens.run_ranks(world, pgeo.wire_mesh_case,
                          scene_dict(sub, el, ref_v, ref_f),
                          dict(max_iter=20, dense_threshold=0),
                          n_cards=n_cards, timeout=240)
    ens.check_placement(ranks, world, "cuda", n_cards)
    fv = np.asarray(ref.function_values)
    st = ref.stats
    rel = max(float(np.max(np.abs(r["fv"] / fv - 1))) if r["fv"].shape ==
              fv.shape else np.inf for r in ranks)
    dx = max(float(np.abs(r["x"] - ref.get_solution()).max()) for r in ranks)
    same = all(r["rejects"] == ref.anderson_reset and all(
        r["stats"][k] == st[k] for k in ("trials", "cp_refreshes"))
        for r in ranks)
    bits = all(np.array_equal(ranks[0]["fv"], r["fv"])
               and r["rejects"] == ranks[0]["rejects"]
               and np.array_equal(ranks[0]["x"], r["x"]) for r in ranks)
    r0 = ranks[0]["stats"]
    print(f"  f64 small scene, {world} ranks ({placement_text(ranks)}) vs "
          f"unsharded on the card: "
          f"{len(fv)} iterations, {st['trials']} trials, "
          f"{st['cp_refreshes']} refreshes (ranks {[r['stats']['cp_refreshes'] for r in ranks]}), "
          f"max rel fv diff {rel:.3e}, max |x diff| {dx:.3e}, rejects equal "
          f"{same}, ranks bit-equal {bits}; collectives {r0['collectives']} "
          f"({r0['collectives'] / r0['trials']:.1f}/trial), launches rank 0 "
          f"{ranks[0]['launches']}")
    check(rel <= 1e-8, f"sharded f64 solve: function values differ by {rel}")
    check(dx <= 1e-8, f"sharded f64 solve: solutions differ by {dx}")
    check(same, "sharded f64 solve: rejects, trials or refreshes differ")
    check(bits, "sharded f64 solve: the ranks' values differ")
    for r in ranks:
        check(all(r["launches"][k] > 0 for k in SHARD_PATH_KERNELS)
              and r["launches"]["cg_update1"] == 0
              and r["launches"]["cg_update2"] == 0,
              f"sharded f64 solve: kernels of rank {r['rank']}: "
              f"{r['launches']}")


def sharded_full(ck, scene, refs, world=2, n_cards=1):
    """wiremesh-synthetic-231k, f32, 5 ALM iterations on `world` ranks
    placed by rank_placement on n_cards cards (the main path of phase 13:
    2 gloo ranks on one card; of phase 14: one rank per card under NCCL):
    quality, ms per trial beside `refs` ({label: ms per trial or None}),
    collectives, bytes and host ms inside them per trial, the first two
    iterations repeated (ms per trial warm, and under torch.profiler the
    device ms per trial of the compute and of the nccl kernels), each
    rank's placement and launches, and whether the ranks' replicated
    values are bit-equal. Returns the ranks' results."""
    from aa_admm_tpu_torch.parallel import ensemble as ens
    from aa_admm_tpu_torch.parallel import geometry as pgeo
    sub, el, ref_v, ref_f = scene
    t0 = time.perf_counter()
    ranks = ens.run_ranks(world, pgeo.wire_mesh_case,
                          scene_dict(sub, el, ref_v, ref_f),
                          dict(SHARD_WIRE_OPTS, repeat_iters=2),
                          n_cards=n_cards, timeout=300)
    wall = time.perf_counter() - t0
    ens.check_placement(ranks, world, "cuda", n_cards)
    out = ranks[0]["x"]
    for r in ranks:
        st = r["stats"]
        tr = st["trials"]
        rp = r["repeat"]
        n_rp = rp["trials"]
        print(f"  rank {r['rank']} on {r['device']} (current card "
              f"{r['current_device']}, {r['backend']}) rows {r['rows']}: "
              f"setup_ADMM "
              f"{r['setup_s']:.2f} s, solve {st['solve_s']:.3f} s, "
              f"{st['solve_s'] / tr * 1e3:.1f} ms/trial over {tr} trials "
              f"({len(r['fv'])} accepted), {st['cg_iters']} CG iterations, "
              f"{st['cp_refreshes']} refreshes, {st['collectives']} "
              f"collectives ({st['collectives'] / tr:.1f}/trial, "
              f"{(st['collectives'] - 1) / tr:.1f} without the gather), "
              f"{st['comm_bytes'] / tr / 1e6:.2f} MB summed/trial, "
              f"{st['comm_s'] / tr * 1e3:.1f} ms/trial inside them, "
              f"launches {r['launches']}; its first 2 iterations again "
              f"({n_rp} trials): {rp['ms'] / n_rp:.1f} ms/trial, under the "
              f"profiler {rp['profiled_ms'] / n_rp:.1f} ms/trial with "
              f"{(rp['device_ms'] - rp['nccl_ms']) / n_rp:.2f} device "
              f"ms/trial in the compute kernels and "
              f"{rp['nccl_ms'] / n_rp:.2f} in {rp['nccl_kernels']} nccl "
              f"kernels (their wait for the other ranks included)")
        split = ericson_launch_split(st, r["rows"][1] - r["rows"][0])
        check(sum(split.values()) == r["launches"]["ericson_idx"],
              f"sharded full: rank {r['rank']} B1 launches "
              f"{r['launches']['ericson_idx']} != {split}")
    st = ranks[0]["stats"]
    ms_trial = st["solve_s"] / st["trials"] * 1e3
    ref_txt = "; ".join(f"{ms:.1f} {label}" if ms else f"{label}: not run"
                        for label, ms in refs.items())
    bits = all(np.array_equal(r["fv"], ranks[0]["fv"])
               and r["rejects"] == ranks[0]["rejects"]
               and np.array_equal(r["x"], out) for r in ranks)
    print(f"  {world} ranks ({ranks[0]['backend']}): {ms_trial:.1f} "
          f"ms/trial against {ref_txt}; "
          f"{wall:.1f} s with the ranks' start, scene hand-over and set-up; "
          f"replicated values bit-equal across ranks: {bits}")
    wire_quality(scene, ranks, "sharded full")
    check(bits, "sharded full: the ranks' replicated values differ")
    return ranks


def wire_quality(scene, ranks, what):
    """The sharded wire mesh's checks: prints the edge and angle errors
    before and after and bench.py's wire-mesh bounds beside them (reported,
    not gated); fails unless the solution is finite and of the scene's
    shape, the function values finite, the mean edge error fell and every
    rank launched B1 and the given entries, never the unsharded B2 or
    B3."""
    from aa_admm_tpu_torch.apps.wire_mesh_opt import check_wiremesh_error
    sub, el, _, _ = scene
    out = ranks[0]["x"]
    min_a, max_a = np.pi * 0.25, np.pi * 0.75
    with contextlib.redirect_stdout(io.StringIO()):
        e_b, a_b, _ = check_wiremesh_error(sub, sub.verts, el, min_a, max_a)
        e_a, a_a, _ = check_wiremesh_error(sub, out, el, min_a, max_a)
    print(f"  edge err mean {e_b.mean():.4e} -> {e_a.mean():.4e}, max "
          f"{e_b.max():.4e} -> {e_a.max():.4e}; angle err max "
          f"{a_b.max():.4e} -> {a_a.max():.4e}")
    print(f"  bench.py's wire-mesh bounds (100 iterations on MaleTorso; "
          f"reported, not gated, beside {SHARD_WIRE_OPTS['max_iter']} "
          f"iterations here): max edge "
          f"error {e_a.max():.4e} against "
          f"{QUALITY_LOOSE * WIREMESH_EDGE_MAX:.4e}, max angle error "
          f"{a_a.max():.4e} against {QUALITY_LOOSE * WIREMESH_ANGLE_MAX:.4e}")
    check(np.isfinite(out).all() and out.shape == sub.verts.shape,
          f"{what}: non-finite or misshapen solution")
    check(all(np.isfinite(r["fv"]).all() and len(r["fv"]) > 0
              for r in ranks), f"{what}: non-finite function values")
    check(e_a.mean() < e_b.mean(), f"{what}: mean edge error did not fall")
    for r in ranks:
        check(all(r["launches"][k] > 0 for k in SHARD_PATH_KERNELS)
              and r["launches"]["cg_update1"] == 0
              and r["launches"]["cg_update2"] == 0,
              f"{what}: kernels of rank {r['rank']}: {r['launches']}")


def phase_sharded_geometry(ck, scene, unsharded_ms):
    """The f64 dryrun on 2 ranks on one card (n_cards=1: gloo on any
    machine), the f64 small-scene parity and the full-width f32 main path;
    returns the full-width ranks' results."""
    from aa_admm_tpu_torch.parallel.geometry import dryrun_geometry
    t0 = time.perf_counter()
    out = dryrun_geometry(2, n_cards=1, timeout=180)
    check(out["max_dx"] < 1e-9 and out["max_dfv_rel"] < 1e-8,
          f"geometry dryrun: {out}")
    print(f"  ({time.perf_counter() - t0:.1f} s with the ranks' start)")
    t0 = time.perf_counter()
    sharded_f64_small(ck)
    print(f"  ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    ranks = sharded_full(ck, scene, {"ms/trial unsharded (phase 5)":
                                     unsharded_ms})
    print(f"  ({time.perf_counter() - t0:.1f} s)")
    return ranks


# ---------------------------------------------------------------------------
# Phase 14: the sharded paths over cards, one rank per card under NCCL
# ---------------------------------------------------------------------------

def phase_multicard(ck, scene, unsharded_ms, gloo_ms):
    """Phase 14 on world = min(4, cards) cards: the physics and geometry
    dryruns, the f64 small scene and the full-width main path, one rank per
    card under NCCL. Prints one line and does nothing with fewer than two
    cards. Returns the number of cards it ran on (0 when it did not) and
    the full-width ranks' results (None when it did not run)."""
    from aa_admm_tpu_torch.parallel import ensemble as ens
    n = torch.cuda.device_count()
    if n < 2:
        print(f"  phase 14 needs two cards and found {n}: not run")
        return 0, None
    world = min(4, n)
    print(f"  {world} ranks on {world} of {n} cards, one per card under "
          f"NCCL (each run below checks its ranks' placement)")
    t0 = time.perf_counter()
    check_dryrun(ens.dryrun(world, n_cards=world, timeout=300))
    print(f"  ({time.perf_counter() - t0:.1f} s with the ranks' start)")
    t0 = time.perf_counter()
    sharded_f64_small(ck, world, n_cards=world)
    print(f"  ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    ranks = sharded_full(ck, scene, {"ms/trial unsharded (phase 5)":
                                     unsharded_ms,
                                     "ms/trial on 2 gloo ranks on one card "
                                     "(phase 13)": gloo_ms},
                         world, n_cards=world)
    print(f"  ({time.perf_counter() - t0:.1f} s)")
    return world, ranks


# ---------------------------------------------------------------------------
# Phase 15: the launch across hosts
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def env_set(**kw):
    """os.environ with `kw` set, for the processes started inside."""
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def hosts_placement_text(r):
    return (f"rank {r['rank']}: host {r['host']}, local rank "
            f"{r['local_rank']}, {r['device']} (current "
            f"{r['current_device']}, CUDA_VISIBLE_DEVICES={r['visible']}), "
            f"card {r['card']}, {r['backend']}")


def ms_per_trial(ranks):
    st = ranks[0]["stats"]
    return st["solve_s"] / st["trials"] * 1e3


def hosts_dryrun(n_hosts, per_host, backend):
    """The JAX tool's case on n_hosts torchrun hosts of per_host ranks
    (parallel/multihost.py): the float64 tiny xzu ensemble, two replicas
    per host, dp across the hosts, each replica against the single-process
    step (max|dx| < 1e-10), then the geometry dryrun on the same ranks
    (1e-9 / 1e-8); the group's backend must be `backend`."""
    from aa_admm_tpu_torch.parallel import multihost as mh
    t0 = time.perf_counter()
    ranks = mh.launch(n_hosts, per_host, "dryrun", timeout=300,
                      out=f"result/phase15_dryrun_{n_hosts}x{per_host}")
    s, g = ranks[0]["summary"], ranks[0]["summary"]["geometry"]
    print(f"  dryrun on {n_hosts} hosts x {per_host} ({s['mesh']}): "
          f"max|dx| against the single-process step "
          f"{s['max_dx_vs_single_process']:.3e} "
          f"({s['checked_shards_per_process']} replica checks per host); "
          f"geometry max|dx| {g['max_dx']:.3e}, max|dfv/fv| "
          f"{g['max_dfv_rel']:.3e}; {time.perf_counter() - t0:.1f} s with "
          f"the hosts' start")
    for r in ranks:
        print(f"    {hosts_placement_text(r)}; dp coordinate {r['dp_coord']}")
    mh.check_host_placement(ranks)
    check(all(r["dp_coord"] == r["host"] for r in ranks),
          "phase 15 dryrun: dp does not span the hosts")
    check(all(r["backend"] == backend for r in ranks),
          f"phase 15 dryrun: backend {s['backend']}, the card rule gives "
          f"{backend}")
    check(s["max_dx_vs_single_process"] < 1e-10 and g["max_dx"] < 1e-9
          and g["max_dfv_rel"] < 1e-8, f"phase 15 dryrun: {s}")


def nccl_transports(out):
    """NCCL's connections as its INFO lines in the hosts' logs name them
    ("via P2P/...", "via SHM/...", "via NET/..."), counted."""
    import collections
    import re
    seen = collections.Counter()
    for name in sorted(os.listdir(out)):
        if name.startswith("host") and name.endswith(".log"):
            with open(os.path.join(out, name), errors="replace") as f:
                seen.update(re.findall(r"\bvia (\S+)", f.read()))
    return dict(seen)


def hosts_wire(scene, n_hosts, per_host, backend, ref, refs_ms, out):
    """wiremesh-synthetic-231k, f32, 5 ALM iterations (phases 13-14's
    scene and options) on n_hosts torchrun hosts of per_host ranks: each
    rank's placement, ms per trial beside `refs_ms` ({label: ms or None}),
    seconds from the launch to its first trial, launches; wire_quality's
    checks, the ranks bit-equal, the group's backend `backend`. Returns
    whether the solution, function values and rejects are bit-equal to
    `ref` (the same world's ranks started by run_ranks) and the largest
    difference of the solution."""
    from aa_admm_tpu_torch.parallel import multihost as mh
    sub, el, ref_v, ref_f = scene
    t_launch = time.time()
    ranks = mh.launch(n_hosts, per_host, "wire", timeout=400, out=out,
                      scene=scene_dict(sub, el, ref_v, ref_f),
                      opts=SHARD_WIRE_OPTS)
    wall = time.time() - t_launch
    mh.check_host_placement(ranks)
    for r in ranks:
        st = r["stats"]
        first = r["case_start"] - t_launch + r["wall_s"] - st["solve_s"]
        print(f"    {hosts_placement_text(r)}; rows {r['rows']}: "
              f"{st['solve_s'] / st['trials'] * 1e3:.1f} ms/trial over "
              f"{st['trials']} trials, {first:.1f} s from the launch to its "
              f"first trial, launches {r['launches']}")
    ref_txt = "; ".join(f"{ms:.1f} {label}" if ms else f"{label}: not run"
                        for label, ms in refs_ms.items())
    x0 = ref[0]["x"]
    bits = all(np.array_equal(r["x"], x0)
               and np.array_equal(r["fv"], ref[0]["fv"])
               and r["rejects"] == ref[0]["rejects"] for r in ranks)
    dx = max(float(np.abs(r["x"] - x0).max()) for r in ranks)
    print(f"  {len(ranks)} ranks on {n_hosts} hosts ({ranks[0]['backend']}): "
          f"{ms_per_trial(ranks):.1f} ms/trial against {ref_txt}; {wall:.1f} "
          f"s with the hosts' start, scene hand-over and set-up; bit-equal "
          f"to the same ranks started by run_ranks: {bits} (max |dx| "
          f"{dx:.3e})")
    wire_quality(scene, ranks, "phase 15 wire mesh")
    check(all(r["backend"] == backend for r in ranks),
          f"phase 15 wire mesh: backend {ranks[0]['backend']}, the card "
          f"rule gives {backend}")
    check(all(np.array_equal(r["x"], ranks[0]["x"])
              and np.array_equal(r["fv"], ranks[0]["fv"]) for r in ranks),
          "phase 15 wire mesh: the ranks' replicated values differ")
    return bits, dx


def wire_reference(scene, world, n_cards):
    """The sharded main path on `world` ranks started by run_ranks on
    n_cards cards, without the repeat: phase 15's reference when phase 13
    or 14 did not run."""
    from aa_admm_tpu_torch.parallel import ensemble as ens
    from aa_admm_tpu_torch.parallel import geometry as pgeo
    sub, el, ref_v, ref_f = scene
    return ens.run_ranks(world, pgeo.wire_mesh_case,
                         scene_dict(sub, el, ref_v, ref_f), SHARD_WIRE_OPTS,
                         n_cards=n_cards, timeout=300)


def phase_multihost(ck, scene, gloo_ref, nccl_ref, unsharded_ms):
    """Phase 15: two torchrun hosts of one rank each on the first card
    (both see it, so the card rule gives gloo), and with four or more cards
    two hosts of two ranks each under NCCL, each host seeing two cards: the
    dryrun and the full-width main path, bit-equal to phase 13's (gloo) and
    phase 14's (NCCL) solution or, where NCCL's four ranks from two hosts
    sum otherwise, the difference and NCCL's transports printed and the
    quality checks held. gloo_ref, nccl_ref: phases 13's and 14's ranks
    (None: solved here first)."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = (visible.split(",") if visible else
             [str(i) for i in range(torch.cuda.device_count())])
    t0 = time.perf_counter()
    if gloo_ref is None:
        gloo_ref = wire_reference(scene, 2, 1)
        print(f"  phase 13's main path on 2 gloo ranks (run_ranks), the "
              f"reference: {ms_per_trial(gloo_ref):.1f} ms/trial "
              f"({time.perf_counter() - t0:.1f} s)")
    with env_set(CUDA_VISIBLE_DEVICES=cards[0]):
        hosts_dryrun(2, 1, "gloo")
        t0 = time.perf_counter()
        bits, _ = hosts_wire(scene, 2, 1, "gloo", gloo_ref,
                             {"ms/trial unsharded (phase 5)": unsharded_ms,
                              "on 2 gloo ranks by run_ranks (phase 13)":
                              ms_per_trial(gloo_ref)},
                             "result/phase15_wire_2x1")
        print(f"  ({time.perf_counter() - t0:.1f} s)")
    check(bits, "phase 15: the wire mesh on two hosts of one rank differs "
                "from phase 13's")
    if len(cards) < 4:
        print(f"  two hosts of two NCCL ranks need four cards, found "
              f"{len(cards)}: not run")
        return
    t0 = time.perf_counter()
    if nccl_ref is None or len(nccl_ref) != 4:
        nccl_ref = wire_reference(scene, 4, 4)
        print(f"  phase 14's main path on 4 NCCL ranks (run_ranks), the "
              f"reference: {ms_per_trial(nccl_ref):.1f} ms/trial "
              f"({time.perf_counter() - t0:.1f} s)")
    with env_set(CUDA_VISIBLE_DEVICES=",".join(cards[:4])):
        hosts_dryrun(2, 2, "nccl")
        t0 = time.perf_counter()
        out = "result/phase15_wire_2x2"
        with env_set(NCCL_DEBUG="INFO"):
            bits, dx = hosts_wire(
                scene, 2, 2, "nccl", nccl_ref,
                {"ms/trial unsharded (phase 5)": unsharded_ms,
                 "on 4 NCCL ranks by run_ranks (phase 14)":
                 ms_per_trial(nccl_ref)}, out)
        print(f"  NCCL's connections (NCCL_DEBUG=INFO, the hosts' logs in "
              f"{out}): {nccl_transports(out)}")
        print(f"  ({time.perf_counter() - t0:.1f} s)")
    if bits:
        print("  two hosts of two NCCL ranks: bit-equal to phase 14's four "
              "ranks")
    else:
        print(f"  two hosts of two NCCL ranks: NOT bit-equal to phase 14's "
              f"four ranks (max |dx| {dx:.3e}); held to phase 14's quality "
              f"checks above instead")


# ---------------------------------------------------------------------------
# Phase 16: the JAX package's on-chip f32 contract (tests_tpu/)
# ---------------------------------------------------------------------------

# tests_tpu's bounds, unchanged (tests/test_torch_chip_f32.py and
# tests/test_torch_chip_closest_point.py hold the same on the CPU and card)
EARLY_REL, MILESTONE_SLACK, AA_HIT_MAX = 1e-2, 3, 15
NEAR_TOL = dict(rtol=2e-5, atol=1e-4)
FAR_FRAC_OFF, FAR_REL_MAX = 0.02, 0.06
CP_QUERIES = 2000
CP_SEED = 11                   # tests_tpu's queries' seed


def beams_f32_step(accel):
    """One f32 beams step of 100 iterations on the card (tests_tpu's
    _settings): (prim as f64, the step's ms)."""
    from aa_admm_tpu_torch.apps import beams
    s = beams_settings(accel)
    s.dtype = np.dtype("float32")
    solver, stretch = beams.build_scene(s, device="cuda")
    stretch(s.timestep_s)
    tr = solver.step()
    check(tr.prim.dtype == torch.float32, "phase 16: beams did not run f32")
    return tr.prim.cpu().numpy().astype(np.float64), solver.step_ms[-1]


def early_phase(prim, cpp):
    """tests_tpu's _early_phase_check as numbers: (max relative error while
    the C++ prim is above 1e-2 of its first value, the iterations that
    covers, our 1e-2 milestone, the C++ one)."""
    n = min(len(prim), len(cpp))
    prim, ref = prim[:n], cpp[:n, 1]
    mask = ref > 1e-2 * ref[0]
    rel = np.abs(prim[mask] - ref[mask]) / ref[mask]
    return (float(rel.max()), int(mask.sum()),
            int(np.argmax(prim < 1e-2 * prim[0])),
            int(np.argmax(ref < 1e-2 * ref[0])))


def cp_dist(q, pts):
    return np.linalg.norm(q - pts.cpu().numpy(), axis=1)


def near_regime(tri, args, q, edge):
    """tests_tpu's near-surface check on the card: the 2-stage sweep, a
    group-cache refresh and the cache after a small motion against brute
    force, then the cache's fast path on the queries with a positive slack
    (moved by 0.4 of the least). Returns the fast path's queries and cache."""
    from aa_admm_tpu_torch.ops import closest_point as tcp

    def against_brute(what, qn, out):
        want = cp_dist(qn, tcp.closest_point_on_mesh(torch.from_numpy(qn)
                                                     .cuda(), tri))
        got = cp_dist(qn, out)
        err = np.abs(got - want) / (NEAR_TOL["atol"]
                                    + NEAR_TOL["rtol"] * np.abs(want))
        print(f"    near, {what}: {len(qn)} queries, max |d - d_brute| "
              f"{np.abs(got - want).max():.3e} ({err.max():.3f} of the "
              f"bound)")
        check(err.max() <= 1.0, f"phase 16: near-surface {what} differs "
              f"from brute force beyond rtol 2e-5, atol 1e-4")

    qt = torch.from_numpy(q).cuda()
    against_brute("2-stage", q,
                  tcp.closest_point_on_mesh_2stage(qt, tri, k=48))
    cache = tcp.cp_cache_group_init(len(q), 6, torch.float32, "cuda")
    out, cache, refreshed = tcp.closest_point_cached_group(qt, *args, cache)
    check(refreshed, "phase 16: the first group-cache query did not refresh")
    against_brute("group refresh", q, out)
    sl = cache.slack.cpu().numpy()
    check(np.median(sl) > 0, "phase 16: the group cache's median slack is "
          "not positive")
    step = min(0.1 * float(np.median(sl)), 0.2 * edge)
    q2 = q + np.asarray([step, 0.0, 0.0], np.float32)
    out2, _, refreshed = tcp.closest_point_cached_group(
        torch.from_numpy(q2).cuda(), *args, cache)
    against_brute(f"group cache after a move of {step:.3e} "
                  f"({'refreshed' if refreshed else 'fast path'})", q2, out2)
    q3 = q[sl > 0]
    cache3 = tcp.cp_cache_group_init(len(q3), 6, torch.float32, "cuda")
    _, cache3, _ = tcp.closest_point_cached_group(torch.from_numpy(q3)
                                                  .cuda(), *args, cache3)
    q3 = q3 + np.asarray([0.4 * float(cache3.slack.min()), 0.0, 0.0],
                         np.float32)
    q3t = torch.from_numpy(q3).cuda()
    out3, _, refreshed = tcp.closest_point_cached_group(q3t, *args, cache3)
    check(not refreshed, "phase 16: the forced fast path refreshed")
    against_brute("group fast path", q3, out3)
    return q3t, cache3


def phase_f32_contract(ck, seed):
    """Phase 16: (a) beams' f32 step against the C++ golden (early-phase
    parity and milestone) and AA m = 5's convergence; (b) closest points at
    f32 on the main path's reference surface (39,762 triangles, phase 5's),
    2,000 near-surface and 2,000 far-field queries from `seed`, as
    tests_tpu/test_closest_point_tpu.py makes them, through the 2-stage
    sweep and the group cache (kernel B1) against the plain torch brute
    force on the card. Returns the kernels' launches in the checks."""
    from aa_admm_tpu_torch.ops import closest_point as tcp
    ck.reset_launch_counts()
    cpp = np.loadtxt(GOLDEN)
    prim, ms = beams_f32_step(False)
    rel, n_early, ours, theirs = early_phase(prim, cpp)
    print(f"  (a) beams f32, one step of 100 plain iterations ({ms:.1f} ms): "
          f"early-phase max rel error {rel:.3e} over {n_early} iterations "
          f"(bound {EARLY_REL}); 1e-2 milestone at iteration {ours}, C++ "
          f"{theirs} (bound +/-{MILESTONE_SLACK})")
    check(np.isfinite(prim).all(), "phase 16: non-finite f32 beams prim")
    check(rel < EARLY_REL, f"phase 16: beams f32 early-phase error {rel}")
    check(abs(ours - theirs) <= MILESTONE_SLACK,
          f"phase 16: milestone at {ours}, C++ {theirs}")
    prim, ms = beams_f32_step(True)
    hit = int(np.argmax(prim < 1e-2 * prim[0]))
    print(f"      beams f32 -a 1 -am 5 ({ms:.1f} ms): 1e-2 of the first "
          f"residual at iteration {hit} (bound {AA_HIT_MAX})")
    check(np.isfinite(prim).all() and prim[hit] < 1e-2 * prim[0]
          and hit <= AA_HIT_MAX, f"phase 16: AA f32 milestone at {hit}")

    ref_v, ref_f = full_reference()
    tv = ref_v[ref_f].astype(np.float32)
    tri = torch.from_numpy(tv).cuda()
    S = 64
    tp, cent, rad, gc, gr = tcp.build_tri_groups(tv, group_size=S)
    G = len(gc)
    args = [torch.from_numpy(a).to("cuda", torch.float32)
            for a in (tp.reshape(G, S, 3, 3), cent.reshape(G, S, 3),
                      rad.reshape(G, S), gc, gr)]
    rng = np.random.default_rng(seed)
    edge = float(np.linalg.norm(tv[:, 0] - tv[:, 1], axis=1).mean())
    base = tv[rng.integers(0, len(tv), CP_QUERIES)].mean(axis=1)
    near = (base + 2.0 * edge * rng.standard_normal((CP_QUERIES, 3))) \
        .astype(np.float32)
    rng = np.random.default_rng(seed)
    lo, hi = ref_v.min(0), ref_v.max(0)
    far = (lo + (hi - lo) * rng.random((CP_QUERIES, 3))).astype(np.float32)
    print(f"  (b) closest points, f32, on the main path's reference "
          f"({len(tv)} triangles, {G} groups of {S}), queries from seed "
          f"{seed}:")
    q3t, cache3 = near_regime(tri, args, near, edge)

    ft = torch.from_numpy(far).cuda()
    d_brute = cp_dist(far, tcp.closest_point_on_mesh(ft, tri))
    d_2s = cp_dist(far, tcp.closest_point_on_mesh_2stage(ft, tri, k=48))
    frel = np.abs(d_2s - d_brute) / np.maximum(d_brute, 1e-6)
    n_off = int((frel > 1e-4).sum())
    print(f"    far field, 2-stage: {n_off} of {CP_QUERIES} queries off "
          f"(bound {FAR_FRAC_OFF:.0%}), worst relative error "
          f"{frel.max():.3e} (bound {FAR_REL_MAX})")
    check(n_off <= FAR_FRAC_OFF * CP_QUERIES,
          f"phase 16: far-field recall, {n_off} queries off")
    check(frel.max() <= FAR_REL_MAX,
          f"phase 16: worst far-field error {frel.max()}")
    counts = ck.launch_counts()
    print(f"    kernel launches in the phase's checks: {counts}")
    check(counts["ericson_idx"] > 0, "phase 16: B1 was not launched")

    # eager ms per call (CUDA events; host syncs and launches included)
    nt = torch.from_numpy(near).cuda()
    fresh = tcp.cp_cache_group_init(CP_QUERIES, 6, torch.float32, "cuda")
    times = {
        "brute force (plain torch)": lambda: tcp.closest_point_on_mesh(nt,
                                                                       tri),
        "2-stage": lambda: tcp.closest_point_on_mesh_2stage(nt, tri, k=48),
        "group refresh": lambda: tcp.closest_point_cached_group(
            nt, *args, fresh),
        f"group fast path ({len(q3t)} queries)":
            lambda: tcp.closest_point_cached_group(q3t, *args, cache3)}
    print("    ms per call on the near queries: " + ", ".join(
        f"{k} {cuda_ms(f, iters=10):.3f}" for k, f in times.items()))
    return counts


def main(argv):
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from aa_admm_tpu_torch.ops import cuda_kernels as ck
    want, seed = set(range(1, 17)), CP_SEED
    args = list(argv)
    try:
        while args:
            flag, value = args.pop(0), args.pop(0)
            if flag == "--phases":
                want = {1} | {int(a) for a in value.split(",")}
            elif flag == "--seed":
                seed = int(value)
            else:
                raise ValueError(flag)
    except (IndexError, ValueError):
        print("usage: python3 chip_smoke.py [--phases 2,3,...] [--seed N]",
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

    variants = None
    if 2 in want:
        t0 = time.perf_counter()
        finish = start_variants_build(ck) if 3 in want else None
        logs = ck.build_all(verbose=True)
        for name, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line or "error" in line:
                    print(f"  nvcc {name}: {line.strip()}")
        if finish is not None:
            variants = finish()[0]
            print("  built the replaced CG kernels and the floor kernels "
                  "(tools/port_cg_given_variants.cu) beside them")
        phase("2 build", t0)

    record = {}
    dev = torch.device("cuda")
    n_small = small_scene()[0].n_verts()
    if 3 in want:
        t0 = time.perf_counter()
        check_ericson(ck, dev, record, n_small)
        check_ericson_idx(ck, dev, record)
        if variants is None:
            variants = start_variants_build(ck)()[0]
        check_cg(ck, dev, record, n_small, variants)
        check_cg_given(ck, dev, record, variants)
        phase("3 kernels vs twins", t0)

    if 4 in want:
        t0 = time.perf_counter()
        phase_f64_solve(ck, SMALL_N_REF, MAIN_PATH_KERNELS)
        candT_counts = phase_f64_solve(ck, CANDT_N_REF, CANDT_PATH_KERNELS)
        phase("4 f64 solves GPU vs CPU (subgroup cache; flat cache + candT)",
              t0)

    full = None
    if 5 in want:
        t0 = time.perf_counter()
        counts, solver, split, full = phase_full_solve(ck)
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

    if 12 in want:
        t0 = time.perf_counter()
        phase_ensembles(ck)
        phase("12 scene ensembles and element sharding", t0)

    if 13 in want:
        t0 = time.perf_counter()
        if full is None:
            full = full_scene()
        shard_ranks = phase_sharded_geometry(
            ck, full, solver.stats["solve_s"] / solver.stats["trials"] * 1e3
            if 5 in want else None)
        phase("13 geometry sharded over vertex rows and elements (2 gloo "
              "ranks)", t0)

    if 14 in want:
        t0 = time.perf_counter()
        if full is None:
            full = full_scene()
        gloo_ms = None
        if 13 in want:
            st = shard_ranks[0]["stats"]
            gloo_ms = st["solve_s"] / st["trials"] * 1e3
        cards, card_ranks = phase_multicard(
            ck, full, solver.stats["solve_s"] / solver.stats["trials"] * 1e3
            if 5 in want else None, gloo_ms)
        phase(f"14 sharded paths over cards ({cards} cards under NCCL)"
              if cards else "14 sharded paths over cards (not run)", t0)

    if 15 in want:
        t0 = time.perf_counter()
        if full is None:
            full = full_scene()
        phase_multihost(
            ck, full, shard_ranks if 13 in want else None,
            card_ranks if 14 in want else None,
            solver.stats["solve_s"] / solver.stats["trials"] * 1e3
            if 5 in want else None)
        phase("15 the launch across hosts (torchrun)", t0)

    if 16 in want:
        t0 = time.perf_counter()
        f32_counts = phase_f32_contract(ck, seed)
        phase("16 the f32 contract of tests_tpu/ (beams vs the C++ golden, "
              "closest points vs brute force)", t0)

    if want != set(range(1, 17)):
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
        "cg_dot": ("aa_admm_tpu_torch/csrc/cg_update.cu",
                   "aa_admm_tpu/ops/pallas_kernels.py:230"),
        "cg_update1_given": ("aa_admm_tpu_torch/csrc/cg_update.cu",
                             "aa_admm_tpu/ops/pallas_kernels.py:207"),
        "cg_update2_given": ("aa_admm_tpu_torch/csrc/cg_update.cu",
                             "aa_admm_tpu/ops/pallas_kernels.py:230"),
    }
    # the given entries' launches: both ranks of phase 13's main path
    for name in ("cg_dot", "cg_update1_given", "cg_update2_given"):
        counts[name] = sum(r["launches"][name] for r in shard_ranks)
    kernels = []
    for name, (src, repl) in meta.items():
        r = record[name]
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=repl, launches=counts[name],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            library_ms=r.get("library_ms"),
                            phase16_launches=f32_counts[name]))
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
