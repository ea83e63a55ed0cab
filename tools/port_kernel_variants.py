"""Design experiments for the port's kernels B1 (indexed entry), B2 and B3 on
one CUDA card, and B2/B3 of another checkout for comparison.

    python tools/port_kernel_variants.py                # variants of this tree
    python tools/port_kernel_variants.py --tree DIR     # B2/B3 of DIR only

Each variant is the checked-in source (aa_admm_tpu_torch/csrc) with one named
edit, built by nvcc into aa_admm_tpu_torch/build/variants, and timed by
chip_smoke's CUDA-graph replays at the main path's shapes (f32): B1 at its
three tiles over a 39,808-row table, B2 and B3 at n=230,400, c=3. Each B1
variant is checked against the checked-in kernel's output first; the B2
and B3 variants that drop a synchronisation are wrong by design and time
what it costs. With --tree, the
kernels B2 and B3 of the checkout DIR are timed instead (run it for two
checkouts in turns, on one card, to compare them). Prints one line per
measurement; needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _variants_b2(src):
    t1 = "constexpr int kThreads1 = 256;"
    m1 = "constexpr int kMaxBlocksPerSm1 = 1;"
    reread = ("switch (chunks_per_thread(n, nb, kThreads1)) {",
              "switch (0) {")
    reread2 = ("switch (chunks_per_thread(n, nb, kThreads2)) {",
               "switch (0) {")
    m2 = "constexpr int kMaxBlocksPerSm2 = 2;"
    t2 = "constexpr int kThreads2 = 512;"
    reduce2 = "  warp_reduce_partials<T, C>(partials, nb, rzn);\n"
    load_rz = ("        load_chunk<T, E>(r, q0 + u * stride, N, rv[u]);\n"
               "        load_chunk<T, E>(z, q0 + u * stride, N, zr[u]);\n")
    load_p = "        load_chunk<T, E>(p, q0 + u * stride, N, pr[u]);\n"
    reload_zp = ("      if (q0 + u * stride < nq) {\n"
                 "        load_chunk<T, E>(z, q0 + u * stride, N, zr[u]);\n"
                 "        load_chunk<T, E>(p, q0 + u * stride, N, pr[u]);\n"
                 "      }\n")
    bar2 = "  grid_barrier(sync, nb);\n\n  T rzn[C]"
    no_bar2 = (bar2, bar2.replace("grid_barrier(sync, nb)",
                                  "__syncthreads()"))
    # z and p loaded right after the barrier, before the partials' reads
    early_zp = (bar2, "  grid_barrier(sync, nb);\n\n#pragma unroll\n"
                "  for (int u = 0; u < RR; ++u) {\n"
                "    if (R > 0 && q0 + u * stride < nq) {\n"
                "      load_chunk<T, E>(z, q0 + u * stride, N, zr[u]);\n"
                "      load_chunk<T, E>(p, q0 + u * stride, N, pr[u]);\n"
                "    }\n  }\n  T rzn[C]")
    fenced = [("    const unsigned long long old = ticket_acq_rel(count);\n",
               "    __threadfence();\n"
               "    const unsigned long long old = atomicAdd(count, 1ULL);\n"),
              ("    while (ld_acquire(count) < target) __nanosleep(32);\n",
               "    while (ld_acquire(count) < target) __nanosleep(32);\n"
               "    __threadfence();\n")]
    # the partials summed by the whole block
    block_sum2 = (reduce2,
                  "  reduce_partials<T, C, kThreads2>(partials, nb, rzn);\n")

    a = src.index("  if (threadIdx.x == 0) {\n", src.index("block_sum("))
    b = src.index("  __syncthreads();\n", a)
    shuffle = ("  if (warp == 0) {\n#pragma unroll\n"
               "    for (int j = 0; j < C; ++j) {\n"
               "      T s = lane < kWarps ? warp_sums[j][lane] : T(0);\n"
               "#pragma unroll\n"
               "      for (int off = kWarps / 2; off > 0; off >>= 1)\n"
               "        s += __shfl_down_sync(0xffffffffu, s, off);\n"
               "      if (lane == 0) total[j] = s;\n    }\n  }\n")

    def cfg2(threads, per_sm):
        return [(t2, t2.replace("512", str(threads))),
                (m2, m2.replace("= 2;", f"= {per_sm};"))]

    def cfg(threads, per_sm):
        return [(t1, t1.replace("256", str(threads))),
                (m1, m1.replace("1;", f"{per_sm};"))]
    # name: (edits, B2's threads a block, B3's)
    return {
        "checked in (B2 256 threads x 1 per SM, B3 512 x 2)": (
            [], 256, 512),
        "256 threads x 2 per SM": (cfg(256, 2), 256, 512),
        "256 threads x 4 per SM": (cfg(256, 4), 256, 512),
        "512 threads x 1 per SM": (cfg(512, 1), 512, 512),
        "1024 threads x 1 per SM": (cfg(1024, 1), 1024, 512),
        "p, Ap read again, not kept": ([reread], 256, 512),
        "no grid barrier (wrong alpha)": (
            [("  grid_barrier(sync, nb);\n\n  T pap[C]",
              "  __syncthreads();\n\n  T pap[C]")], 256, 512),
        "no last-block r.r sum (no rr)": (
            [("if (last) {", "if (false && last) {")], 256, 512),
        "block sums' second stage by a warp shuffle, not one thread": (
            [(src[a:b], shuffle)], 256, 512),
        "B3: 512 threads x 1 per SM": (cfg2(512, 1), 256, 512),
        "B3: 256 threads x 2 per SM": (cfg2(256, 2), 256, 256),
        "B3: 256 threads x 1 per SM": (cfg2(256, 1), 256, 256),
        "B3: 128 threads x 2 per SM": (cfg2(128, 2), 256, 128),
        "B3: 1024 threads x 1 per SM": (cfg2(1024, 1), 256, 1024),
        "B3: z, p read after the partials are summed (R = 0)": (
            [reread2], 256, 512),
        "B3: z, p loaded with r, z and held across the barrier": (
            [(load_rz, load_rz + load_p), (reload_zp, "")], 256, 512),
        "B3: z, p loaded right after the barrier": ([early_zp], 256, 512),
        "B3: the partials summed by the whole block": (
            [block_sum2], 256, 512),
        "B3: 256 threads x 1 per SM, the partials summed by the whole "
        "block": (cfg2(256, 1) + [block_sum2], 256, 256),
        "B3: no grid barrier (wrong beta)": ([no_bar2], 256, 512),
        "B3: no barrier, no sum of the partials (wrong beta)": (
            [no_bar2,
             (reduce2, "  for (int j = 0; j < C; ++j) rzn[j] = s[j];\n")],
            256, 512),
        "B2 and B3: grid barrier with fences around a plain atomic": (
            fenced, 256, 512),
        "B3: up to 128 registers a thread (one block per SM)": (
            [("__launch_bounds__(kThreads2)",
              "__launch_bounds__(kThreads2, 1)")], 256, 512),
        "B2 and B3: grid barrier polled without sleeping": (
            [("__nanosleep(32);", ";")], 256, 512),
    }


def _variants_b1(src):
    a = src.index("__device__ __forceinline__ void load_row(const float* tab")
    b = src.index("__device__ __forceinline__ void load_row(const double* tab")
    plain = ("__device__ __forceinline__ void load_row(const float* tab, "
             "long long r, float* t) {\n  const float* v = tab + r * 9;\n"
             "#pragma unroll\n  for (int j = 0; j < 9; ++j) t[j] = __ldg(v + j);"
             "\n}\n\n")
    return {"12-word rows, 16-byte loads (checked in)": src,
            "9-word rows of the plain table, 4-byte loads":
                src[:a] + plain + src[b:]}


def _build(ck, sources, tag):
    """{name: source text} -> {name: CDLL}, one nvcc each, in parallel;
    files named by tag (a path loaded twice would return the first)."""
    out_dir = ck.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu, so = out_dir / f"{tag}{i}.cu", out_dir / f"lib{tag}{i}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [ck._nvcc(), *ck.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def _entry(lib, ck, entry):
    f = getattr(lib, entry + "_f32")
    f.argtypes = ck._ARGTYPES[entry]
    f.restype = ctypes.c_int
    return f


def b1_rows(cs, ck, torch, dev, rounds):
    src = (ck.CSRC_DIR / "ericson.cu").read_text()
    libs = _build(ck, _variants_b1(src), "b1_")
    for rnd in range(rounds):
        for where, (Q, G, sub) in cs.ERICSON_SHAPES.items():
            p, tris, idx = cs.ericson_idx_inputs(Q, G, sub, torch.float32,
                                                 dev, 5, cs.MAIN_T)
            want, _ = ck.ericson_candidates_idx(p, tris, idx, sub)
            T = tris.shape[0]
            for name, lib in libs.items():
                f = _entry(lib, ck, "ericson_candidates_idx")
                tab = (ck._row_table(tris) if "12-word" in name
                       else tris.reshape(T, 9).contiguous())
                q = torch.empty((Q, 3), device=dev)
                d = torch.empty((Q,), device=dev)

                def call():
                    ck._check(f(p.data_ptr(), tab.data_ptr(), idx.data_ptr(),
                                q.data_ptr(), d.data_ptr(), G, sub,
                                ck.ericson_lanes(Q, G * sub), Q, T,
                                torch.cuda.current_stream().cuda_stream),
                              name)
                call()
                assert torch.equal(q, want), name
                ms = cs.device_ms(call, iters=10, reps=10)
                print(f"round {rnd} B1 {where} Q={Q} G={G} sub={sub}: "
                      f"{name}: {ms:.4f} ms", flush=True)
        target = ck.ERICSON_TARGET_THREADS
        for t in (32768, 65536, 131072, 262144):
            ck.ERICSON_TARGET_THREADS = t
            for where, (Q, G, sub) in cs.ERICSON_SHAPES.items():
                p, tris, idx = cs.ericson_idx_inputs(Q, G, sub, torch.float32,
                                                     dev, 5, cs.MAIN_T)
                ms = cs.device_ms(
                    lambda: ck.ericson_candidates_idx(p, tris, idx, sub),
                    iters=10, reps=10)
                print(f"round {rnd} B1 {where}: lane target {t} threads, "
                      f"{ck.ericson_lanes(Q, G * sub)} lanes: {ms:.4f} ms",
                      flush=True)
        ck.ERICSON_TARGET_THREADS = target


def b2_variants(cs, ck, torch, dev, rounds):
    src = (ck.CSRC_DIR / "cg_update.cu").read_text()
    variants = _variants_b2(src)
    texts = {}
    for name, (edits, _, _) in variants.items():
        text = src
        for a, b in edits:
            if a not in text:
                raise RuntimeError(f"variant {name}: no {a!r} in the source")
            text = text.replace(a, b)
        texts[name] = text
    libs = _build(ck, texts, "b2_")
    n, c = cs.MAIN_N, 3
    v, rz, _, rr_prev, thresh = cs.cg_inputs(n, c, torch.float32, dev, 8)
    for rnd in range(rounds):
        for name, lib in libs.items():
            f = _entry(lib, ck, "cg_update1")
            g = _entry(lib, ck, "cg_update1_max_blocks")
            most = ctypes.c_int(0)
            ck._check(g(c, dev.index or 0, ctypes.addressof(most)), name)
            threads, threads2 = variants[name][1:]
            nb = max(1, min(most.value, -(-n // (4 * threads))))
            part = torch.empty((2, nb, c), device=dev)
            counters = torch.zeros(2, dtype=torch.int64, device=dev)
            rr = torch.empty(c, device=dev)
            x, r = v["x"].clone(), v["r"].clone()

            def call():
                ck._check(f(rz.data_ptr(), rr_prev.data_ptr(),
                            thresh.data_ptr(), v["p"].data_ptr(),
                            v["ap"].data_ptr(), x.data_ptr(), r.data_ptr(),
                            rr.data_ptr(), part.data_ptr(),
                            counters.data_ptr(), n, c, nb,
                            torch.cuda.current_stream().cuda_stream), name)
            ms = cs.device_ms(call, iters=20, reps=10)
            f2 = _entry(lib, ck, "cg_update2")
            g2 = _entry(lib, ck, "cg_update2_max_blocks")
            ck._check(g2(c, dev.index or 0, ctypes.addressof(most)), name)
            nb2 = max(1, min(most.value, -(-n // (4 * threads2))))
            part2 = torch.empty((2, nb2, c), device=dev)
            counters2 = torch.zeros(2, dtype=torch.int64, device=dev)
            rz2 = torch.empty(c, device=dev)
            p = v["p"].clone()
            rz_old = (r * v["z"]).sum(0)     # beta ~ 1: p stays finite

            def call2():
                ck._check(f2(rz_old.data_ptr(), rr_prev.data_ptr(),
                             thresh.data_ptr(), r.data_ptr(),
                             v["z"].data_ptr(), p.data_ptr(), rz2.data_ptr(),
                             part2.data_ptr(), counters2.data_ptr(), n, c,
                             nb2, torch.cuda.current_stream().cuda_stream),
                          name)
            ms2 = cs.device_ms(call2, iters=20, reps=10)
            print(f"round {rnd} n={n} c={c}: {name}: B2 {ms:.4f} ms "
                  f"({nb} blocks), B3 {ms2:.4f} ms ({nb2} blocks)",
                  flush=True)


def cg_of_tree(tree, rounds):
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    import chip_smoke as cs
    from aa_admm_tpu_torch.ops import cuda_kernels as ck
    dev = torch.device("cuda", 0)
    n, c = cs.MAIN_N, 3
    v, rz, _, rr_prev, thresh = cs.cg_inputs(n, c, torch.float32, dev, 8)
    x, r, p = v["x"], v["r"], v["p"]
    rz_old = (r * v["z"]).sum(0)
    for rnd in range(rounds):
        ms1 = cs.device_ms(
            lambda: ck.cg_update1(rz, p, v["ap"], x, r, rr_prev, thresh))
        e1 = cs.cuda_ms(
            lambda: ck.cg_update1(rz, p, v["ap"], x, r, rr_prev, thresh))
        ms2 = cs.device_ms(
            lambda: ck.cg_update2(rz_old, r, v["z"], p, rr_prev, thresh))
        print(f"round {rnd} tree {tree}: B2 {ms1:.4f} ms device, {e1:.4f} ms "
              f"per eager call; B3 {ms2:.4f} ms device", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", help="time B2/B3 of this checkout only")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", choices=("b1", "b2"),
                    help="run the B1 or the B2 experiments only")
    args = ap.parse_args(argv)
    if args.tree:
        cg_of_tree(args.tree, args.rounds)
        return 0
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from aa_admm_tpu_torch.ops import cuda_kernels as ck
    dev = torch.device("cuda", 0)
    os.makedirs(ck.BUILD_DIR, exist_ok=True)
    if args.only != "b2":
        b1_rows(cs, ck, torch, dev, args.rounds)
    if args.only != "b1":
        b2_variants(cs, ck, torch, dev, args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
