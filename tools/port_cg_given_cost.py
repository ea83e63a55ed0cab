"""cg_dot and cg_update1_given on one NVIDIA GPU: the package's one-launch
kernels against the two-launch design they replaced and against a variant
that sums the blocks' partials in thread-block clusters.

    python3 tools/port_cg_given_cost.py [--rounds 2] [--out FILE]

Builds aa_admm_tpu_torch/csrc/cg_update.cu with
tools/port_cg_given_variants.cu appended (one nvcc, sm_90a, the package's
flags and -Xptxas -v) and prints each kernel's registers, stack and spills.
Then, at a rank's rows of the main path's 230,400 over two and over four
ranks (n = 115,200 and 57,600), float32, c = 3:
  * each variant once against the twin (cg_dot_plain,
    cg_update1_given_plain) on chip_smoke's inputs, and twice against
    itself (equal bits);
  * device ms per call from CUDA-graph replays and ms per eager call (the
    host's Python and launch cost included), in turns: two-launch,
    one-launch, one-launch, two-launch, then the cluster variants of 2, 4
    and 8 blocks and the package's kernels with one edit each (EDITS:
    128- and 512-thread blocks; the ticket drawn by a plain atomic between
    two fences, as the kernels first did, in place of one release/acquire
    atomic), for --rounds rounds;
  * the bound (bytes: 2 n c words for cg_dot, 6 n c for the update, at
    3.35 TB/s), the twin's ms and torch.linalg.vecdot's.
The package's kernels are called through their wrappers (ops.cuda_kernels),
the two-launch kernels through copies of the wrappers they had (one
allocation more per call), the other variants through ctypes alone with
the package's grid (the cluster variants' rounded up to a multiple of the
cluster; the edits' for their block size). Prints one line per measurement
and, last, one JSON object of them all (also written to FILE when given).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
VARIANTS = Path(__file__).resolve().parent / "port_cg_given_variants.cu"
CLUSTERS = (2, 4, 8)
_ACQ_REL = "    last = ticket_acq_rel(ticket) % nb == nb - 1;\n  }\n" \
    "  __syncthreads();\n  if (last) {\n"
_FENCED = ("    __threadfence();\n"
           "    last = atomicAdd(ticket, 1ULL) % nb == nb - 1;\n"
           "  }\n  __syncthreads();\n  if (last) {\n    __threadfence();\n")
_THREADS = "constexpr int kThreadsG = 256;"
# name: (edits of cg_update.cu, threads a block)
EDITS = {
    "128-thread blocks": ([(_THREADS, _THREADS.replace("256", "128"))], 128),
    "512-thread blocks": ([(_THREADS, _THREADS.replace("256", "512"))], 512),
    "fenced ticket": ([(_ACQ_REL, _FENCED)], 256),
}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "two_cg_dot_f32": [_P, _P, _P, _P, _LL, _I, _P],
    "two_cg_update1_given_f32": [_P] * 10 + [_LL, _I, _P],
    "cl_cg_dot_f32": [_P] * 5 + [_LL, _I, _I, _P],
    "cl_cg_update1_given_f32": [_P] * 11 + [_LL, _I, _I, _P],
}


def build(ck):
    """The package's source with the variants appended, and each of EDITS,
    built into BUILD_DIR/variants (one nvcc each, in parallel); returns
    (CDLL of the first, {edit: CDLL}, ptxas lines per kernel of the
    first)."""
    out_dir = ck.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (ck.CSRC_DIR / "cg_update.cu").read_text()
    texts = {"variants": src + "\n" + VARIANTS.read_text()}
    for i, (name, (edits, _)) in enumerate(EDITS.items()):
        text = src
        for a, b in edits:
            if a not in text:
                raise RuntimeError(f"edit {name}: no {a!r} in the source")
            text = text.replace(a, b)
        texts[name] = text
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        cu, so = out_dir / f"cg_given_{i}.cu", out_dir / f"libcg_given_{i}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [ck._nvcc(), *ck.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs, log = {}, ""
    for name, (so, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = ctypes.CDLL(str(so))
        log = log or out
    lib = libs.pop("variants")
    for name, types in _ARGTYPES.items():
        f = getattr(lib, name)
        f.argtypes, f.restype = types, _I
    for elib in libs.values():
        for name in ("cg_dot", "cg_update1_given", "cg_given_max_blocks"):
            f = getattr(elib, name + "_f32")
            f.argtypes, f.restype = ck._ARGTYPES[name], _I
    return lib, libs, ptxas_table(log)


def ptxas_table(log):
    """{kernel: 'N registers, S bytes stack, X bytes spill stores, Y bytes
    spill loads'} for the given entries' kernels in nvcc's -Xptxas -v log
    (names demangled by cu++filt when the toolkit has it)."""
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    table, name, frame = {}, None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            frame = (f"{m.group(1)} bytes stack, {m.group(2)} bytes spill "
                     f"stores, {m.group(3)} bytes spill loads")
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            table[name] = f"{m.group(1)} registers, {frame}"
            name, frame = None, ""
    keep = ("dot_given", "cg1_given", "two_", "cl_dot", "cl_cg1_given")
    names = [k for k in table if any(s in k for s in keep)]
    if names and Path(filt).exists():
        shown = subprocess.run([filt, *names], capture_output=True,
                               text=True).stdout.split("\n")
    else:
        shown = names
    return {s.strip() or k: table[k] for k, s in zip(names, shown)}


def earlier_wrappers(ck, lib, torch):
    """The two-launch kernels behind wrappers as the package had them (its
    checks, a partials and a result tensor allocated per call, the launch
    under the tensors' card), so that eager calls compare like with like."""
    def launch(dev, fn, *args):
        with torch.cuda.device(dev):
            ck._check(fn(*args, torch.cuda.current_stream(dev).cuda_stream),
                      fn.__name__)

    def dot(a, b):
        n, c = ck._check_cg("cg_dot", [a, b], [])
        ck._on_cuda([a, b], "cg_dot")
        ck._cg_cols("cg_dot", c)
        nb = ck.cg_blocks(n)
        partials = torch.empty((nb, c), dtype=a.dtype, device=a.device)
        out = torch.empty((c,), dtype=a.dtype, device=a.device)
        launch(a.device, lib.two_cg_dot_f32, a.data_ptr(), b.data_ptr(),
               out.data_ptr(), partials.data_ptr(), n, nb)
        return out

    def update1(pap, rz, p, ap, x, r, rr_prev, thresh):
        n, c = ck._check_cg("cg_update1_given", [p, ap, x, r],
                            [pap, rz, rr_prev, thresh])
        ck._on_cuda([pap, rz, p, ap, x, r, rr_prev, thresh],
                    "cg_update1_given")
        ck._cg_cols("cg_update1_given", c)
        nb = ck.cg_blocks(n)
        partials = torch.empty((nb, c), dtype=x.dtype, device=x.device)
        rr = torch.empty((c,), dtype=x.dtype, device=x.device)
        launch(x.device, lib.two_cg_update1_given_f32, pap.data_ptr(),
               rz.data_ptr(), rr_prev.data_ptr(), thresh.data_ptr(),
               p.data_ptr(), ap.data_ptr(), x.data_ptr(), r.data_ptr(),
               rr.data_ptr(), partials.data_ptr(), n, nb)
        return rr
    return dot, update1


def cases(cs, ck, torch, lib, elibs, n, dev):
    """({variant: (state, cg_dot call, cg_update1_given call, blocks,
    through a wrapper)}, the twin's (dot, rr, x, r), the inputs) on one set
    of chip_smoke's f32 inputs at n rows, c = 3. Each call returns its
    result; the update updates its state's x and r."""
    c = 3
    v, rz, _, rr_prev, thresh = cs.cg_inputs(n, c, torch.float32, dev, 9)
    p, ap = v["p"], v["ap"]
    pap = (p * ap).sum(0)
    calls = {}

    def state(nb):
        return dict(x=v["x"].clone(), r=v["r"].clone(),
                    d=torch.empty(c, device=dev), rr=torch.empty(c, device=dev),
                    part=torch.empty((nb, c), device=dev),
                    ticket=torch.zeros(1, dtype=torch.int64, device=dev))

    def raw(name, nb, f_dot, f_upd, *extra):
        """A variant's C entries called through ctypes alone."""
        s = state(nb)
        ptr = {k: t.data_ptr() for k, t in s.items()}

        def dot():
            ck._check(f_dot(p.data_ptr(), ap.data_ptr(), ptr["d"],
                            ptr["part"], ptr["ticket"], n, *extra,
                            torch.cuda.current_stream().cuda_stream), name)
            return s["d"]

        def upd():
            ck._check(f_upd(pap.data_ptr(), rz.data_ptr(), rr_prev.data_ptr(),
                            thresh.data_ptr(), p.data_ptr(), ap.data_ptr(),
                            ptr["x"], ptr["r"], ptr["rr"], ptr["part"],
                            ptr["ticket"], n, *extra,
                            torch.cuda.current_stream().cuda_stream), name)
            return s["rr"]
        calls[name] = (s, dot, upd, nb, False)

    nb1 = ck.cg_given_blocks(n, c, torch.float32, dev)
    s = state(1)
    calls["one-launch (package)"] = (
        s, lambda: ck.cg_dot(p, ap),
        lambda s=s: ck.cg_update1_given(pap, rz, p, ap, s["x"], s["r"],
                                        rr_prev, thresh), nb1, True)
    two_dot, two_upd = earlier_wrappers(ck, lib, torch)
    s = state(1)
    calls["two-launch"] = (
        s, lambda: two_dot(p, ap),
        lambda s=s: two_upd(pap, rz, p, ap, s["x"], s["r"], rr_prev, thresh),
        ck.cg_blocks(n), True)
    for cl in CLUSTERS:
        nbc = -(-nb1 // cl) * cl
        raw(f"cluster of {cl}", nbc, lib.cl_cg_dot_f32,
            lib.cl_cg_update1_given_f32, nbc, cl)
    for name, elib in elibs.items():
        most = ctypes.c_int(0)
        ck._check(elib.cg_given_max_blocks_f32(c, dev.index,
                                               ctypes.addressof(most)), name)
        nbe = max(1, min(most.value, -(-n // (ck.CG1_ROWS * EDITS[name][1]))))
        raw(name, nbe, elib.cg_dot_f32, elib.cg_update1_given_f32, c, nbe)
    x, r = v["x"].clone(), v["r"].clone()
    d = ck.cg_dot_plain(p, ap)
    rr = ck.cg_update1_given_plain(pap, rz, p, ap, x, r, rr_prev, thresh)
    inputs = dict(v=v, rz=rz, rr_prev=rr_prev, thresh=thresh, pap=pap)
    return calls, (d, rr, x, r), inputs


def check(torch, calls, twin, inputs, n):
    """Each variant from the same inputs: against the twin (rtol 1e-3; the
    column sums also at atol 1e-3 sqrt(n)) and bit-equal on a repeat."""
    errs = {}
    for name, (s, dot, upd, _, _) in calls.items():
        outs = []
        for _ in range(2):
            s["x"].copy_(inputs["v"]["x"])
            s["r"].copy_(inputs["v"]["r"])
            d, rr = dot().clone(), upd().clone()
            torch.cuda.synchronize()
            outs.append([d, rr, s["x"].clone(), s["r"].clone()])
        if not all(torch.equal(a, b) for a, b in zip(*outs)):
            raise SystemExit(f"{name}: two calls differ")
        err = 0.0
        for i, (a, b) in enumerate(zip(outs[0], twin)):
            atol = 1e-3 * (n ** 0.5 if i < 2 else 1)
            if not torch.allclose(a, b, rtol=1e-3, atol=atol):
                raise SystemExit(f"{name}: output {i} differs from the twin")
            err = max(err, float((a - b).abs().max()))
        errs[name] = err
    return errs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", help="also write the JSON summary here")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from aa_admm_tpu_torch.ops import cuda_kernels as ck
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    ck.build_all()
    lib, elibs, regs = build(ck)
    for k, line in regs.items():
        print(f"ptxas: {k}: {line}", flush=True)
    summary = dict(card=card, ptxas=regs, shares={})
    for n in (cs.SHARD_N, cs.QUARTER_N):
        calls, twin, inputs = cases(cs, ck, torch, lib, elibs, n, dev)
        errs = check(torch, calls, twin, inputs, n)
        v, p, ap_ = inputs["v"], inputs["v"]["p"], inputs["v"]["ap"]
        x, r = v["x"].clone(), v["r"].clone()
        pap, rz = inputs["pap"], inputs["rz"]
        rr_prev, thresh = inputs["rr_prev"], inputs["thresh"]
        c = 3
        bounds = {"cg_dot": cs.bound_ms(2 * n * c * 4 + c * 4, 2 * n * c,
                                        torch.float32)[0],
                  "cg_update1_given": cs.bound_ms(
                      6 * n * c * 4 + 5 * c * 4, 6 * n * c,
                      torch.float32)[0]}
        ref = {"cg_dot": (
            cs.device_ms(lambda: ck.cg_dot_plain(p, ap_)),
            cs.device_ms(lambda: torch.linalg.vecdot(p, ap_, dim=0))),
            "cg_update1_given": (cs.device_ms(
                lambda: ck.cg_update1_given_plain(pap, rz, p, ap_, x, r,
                                                  rr_prev, thresh)), None)}
        order = (["two-launch", "one-launch (package)",
                  "one-launch (package)", "two-launch"]
                 + [f"cluster of {cl}" for cl in CLUSTERS] + list(EDITS))
        times = {k: {"cg_dot": [], "cg_update1_given": []} for k in calls}
        for rnd in range(args.rounds):
            for name in order:
                _, dot, upd, nb, wrapped = calls[name]
                for kern, fn in (("cg_dot", dot), ("cg_update1_given", upd)):
                    ms = cs.device_ms(fn, iters=20, reps=10)
                    eager = cs.cuda_ms(fn, iters=50)
                    times[name][kern].append((ms, eager))
                    print(f"round {rnd} n={n} c={c} {kern}: {name} "
                          f"({nb} blocks): {ms:.4f} ms device, {eager:.4f} "
                          f"ms per eager call ("
                          + ("through its wrapper" if wrapped else "ctypes")
                          + ")", flush=True)
        for kern in ("cg_dot", "cg_update1_given"):
            twin_ms, lib_ms = ref[kern]
            print(f"n={n} c={c} {kern}: bound {bounds[kern]:.4f} ms (bytes); "
                  f"twin {twin_ms:.4f} ms"
                  + (f"; torch.linalg.vecdot {lib_ms:.4f} ms"
                     if lib_ms is not None else ""), flush=True)
        summary["shares"][n] = dict(
            blocks={k: t[3] for k, t in calls.items()},
            max_abs_err_vs_twin=errs, bound_ms=bounds,
            twin_ms={k: t for k, (t, _) in ref.items()},
            vecdot_ms=ref["cg_dot"][1], times=times)
    text = json.dumps(summary)
    if args.out:
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
