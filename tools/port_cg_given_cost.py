"""The CG kernels' redesigns on one NVIDIA GPU: cg_dot and cg_update1_given
(one launch each) against the two-launch design they replaced and against a
variant that sums the blocks' partials in thread-block clusters; B3
(cg_update2) and cg_update2_given against the kernels they replaced and
against the floor of any one-launch kernel over their vectors.

    python3 tools/port_cg_given_cost.py [--rounds 2] [--only b3] [--out FILE]

Builds aa_admm_tpu_torch/csrc/cg_update.cu with
tools/port_cg_given_variants.cu appended, and the package's source with
each one-edit variant (EDITS, EDITS2; one nvcc each, in parallel, sm_90a,
the package's flags and -Xptxas -v) and prints each kernel's registers,
stack and spills of the first.
B3 and cg_update2_given (the last part; --only b3 runs it alone), float32,
c = 3, B3 at the main path's n = 230,400 and cg_update2_given at a rank's
n = 115,200 and 57,600: each new and old kernel once against its twin;
then device ms per call from CUDA-graph replays, per round in the order
old, new, new, old, an empty kernel over the new kernel's grid and one
pass of 16-byte chunks over the same vectors (r, z and p; z and p), a
thread per chunk, with the new kernel's block size, and cg_update2_given
with 256- and 512-thread blocks (EDITS2); and ms per eager call of old
and new; beside the bound (bytes, at 3.35 TB/s).
cg_dot and cg_update1_given, at a rank's rows of the main path's 230,400
over two and over four ranks (n = 115,200 and 57,600), float32, c = 3:
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
# cg_update2_given's block size (kThreadsG2, 128 in the package): name:
# (edits, threads a block)
_THREADS2 = "constexpr int kThreadsG2 = 128;"
EDITS2 = {f"cg_update2_given with {t}-thread blocks": (
    [(_THREADS2, _THREADS2.replace("128", str(t)))], t) for t in (256, 512)}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "two_cg_dot_f32": [_P, _P, _P, _P, _LL, _I, _P],
    "two_cg_update1_given_f32": [_P] * 10 + [_LL, _I, _P],
    "cl_cg_dot_f32": [_P] * 5 + [_LL, _I, _I, _P],
    "cl_cg_update1_given_f32": [_P] * 11 + [_LL, _I, _I, _P],
}


def build(cs, ck):
    """The package's source with the variants appended, and each of EDITS,
    built into BUILD_DIR/variants by
    chip_smoke.start_variants_build (one nvcc each, in parallel); returns
    (CDLL of the first, {edit: CDLL}, ptxas lines per kernel of the
    first)."""
    src = (ck.CSRC_DIR / "cg_update.cu").read_text()
    started = {"variants": cs.start_variants_build(ck, "cg_given_0")}
    for i, (name, (changes, _)) in enumerate({**EDITS, **EDITS2}.items()):
        text = src
        for a, b in changes:
            if a not in text:
                raise RuntimeError(f"edit {name}: no {a!r} in the source")
            text = text.replace(a, b)
        started[name] = cs.start_variants_build(ck, f"cg_given_{i + 1}", text)
    libs = {name: finish() for name, finish in started.items()}
    lib, log = libs.pop("variants")
    libs = {name: elib for name, (elib, _) in libs.items()}
    for name, types in _ARGTYPES.items():
        f = getattr(lib, name)
        f.argtypes, f.restype = types, _I
    for elib in libs.values():
        for name in ("cg_dot", "cg_update1_given", "cg_update2_given",
                     "cg_given_max_blocks", "cg_update2_given_max_blocks"):
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
    keep = ("dot_given", "cg1_given", "cg2_fused", "cg2_given", "two_",
            "old_", "floor_", "cl_dot", "cl_cg1_given")
    names = [k for k in table if any(s in k for s in keep)]
    if names and Path(filt).exists():
        shown = subprocess.run([filt, *names], capture_output=True,
                               text=True).stdout.split("\n")
    else:
        shown = names
    return {s.strip() or k: table[k] for k, s in zip(names, shown)}


def earlier_wrappers(cs, ck, lib, torch):
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
        nb = cs.old_blocks(n)
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
        nb = cs.old_blocks(n)
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
    two_dot, two_upd = earlier_wrappers(cs, ck, lib, torch)
    s = state(1)
    calls["two-launch"] = (
        s, lambda: two_dot(p, ap),
        lambda s=s: two_upd(pap, rz, p, ap, s["x"], s["r"], rr_prev, thresh),
        cs.old_blocks(n), True)
    for cl in CLUSTERS:
        nbc = -(-nb1 // cl) * cl
        raw(f"cluster of {cl}", nbc, lib.cl_cg_dot_f32,
            lib.cl_cg_update1_given_f32, nbc, cl)
    for name in EDITS:
        elib = elibs[name]
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


def b3_rows(cs, ck, torch, lib, elibs, dev, rounds):
    """B3 at n = 230,400 and cg_update2_given at n = 115,200 and 57,600
    (f32, c = 3): the new and the old kernel against the twin, then timed
    in turns beside the floor (chip_smoke.variants_calls), and
    cg_update2_given also with the block sizes of EDITS2 (`elibs`; ctypes,
    their own grid). Returns the summary's rows."""
    c, rows = 3, {}
    for name, n in (("cg_update2", cs.MAIN_N), ("cg_update2_given", cs.SHARD_N),
                    ("cg_update2_given", cs.QUARTER_N)):
        given = name == "cg_update2_given"
        v, _, _, rr_prev, thresh = cs.cg_inputs(n, c, torch.float32, dev, 9)
        r, z, p = v["r"], v["z"], v["p"]
        rz_old = (r * z).sum(0)       # beta ~ 1: repeated calls stay finite
        nb = (ck.cg2_given_blocks if given else ck.cg2_blocks)(
            n, c, torch.float32, dev)
        calls = cs.variants_calls(
            ck, lib, n, c, v, rz_old, rr_prev, thresh, nb,
            ck.CG2_GIVEN_THREADS if given else ck.CG2_THREADS)
        sizes = []
        if given:
            calls[name] = lambda: ck.cg_update2_given(rz_old, rz_old, z, p,
                                                      rr_prev, thresh)
            for edit, (_, threads) in EDITS2.items():
                elib = elibs[edit]
                most = ctypes.c_int(0)
                ck._check(elib.cg_update2_given_max_blocks_f32(
                    c, dev.index, ctypes.addressof(most)), edit)
                nbe = max(1, min(most.value, -(-n // (ck.CG1_ROWS * threads))))
                sizes.append(f"{edit} ({nbe} blocks)")
                calls[sizes[-1]] = lambda f=elib.cg_update2_given_f32, nbe=nbe: \
                    ck._check(f(rz_old.data_ptr(), rz_old.data_ptr(),
                                rr_prev.data_ptr(), thresh.data_ptr(),
                                z.data_ptr(), p.data_ptr(), n, c, nbe,
                                torch.cuda.current_stream().cuda_stream),
                              edit)
        else:
            calls[name] = lambda: ck.cg_update2(rz_old, r, z, p, rr_prev,
                                                thresh)
        old = "old " + name
        floor = "pass over z, p" if given else "pass over r, z, p"
        p0, want = p.clone(), p.clone()
        if given:
            ck.cg_update2_given_plain(rz_old, rz_old, z, want, rr_prev, thresh)
        else:
            ck.cg_update2_plain(rz_old, r, z, want, rr_prev, thresh)
        errs = {}
        for k in (name, old):
            p.copy_(p0)
            calls[k]()
            torch.cuda.synchronize()
            if not torch.allclose(p, want, rtol=1e-3, atol=1e-3):
                raise SystemExit(f"{k} n={n}: p differs from the twin")
            errs[k] = float((p - want).abs().max())
        p.copy_(p0)
        times = {k: [] for k in (old, name, "empty kernel", floor, *sizes)}
        eager = {old: [], name: []}
        for rnd in range(rounds):
            t = cs.in_turns(calls, (old, name, name, old, "empty kernel",
                                    floor, *sizes))
            for k, ms in t.items():
                times[k] += ms
            for k in eager:
                eager[k].append(cs.cuda_ms(calls[k], iters=50))
            print(f"round {rnd} n={n} c={c} {name} ({nb} blocks; old "
                  f"{cs.old_blocks(n)}): old/new/new/old "
                  + " / ".join(f"{m:.4f}" for m in (t[old][0], *t[name],
                                                   t[old][1]))
                  + f" ms device; empty kernel {t['empty kernel'][0]:.4f} ms, "
                  f"{floor} {t[floor][0]:.4f} ms; per eager call old "
                  f"{eager[old][-1]:.4f} ms (ctypes), new "
                  f"{eager[name][-1]:.4f} ms (its wrapper)"
                  + "".join(f"; {k} {t[k][0]:.4f} ms" for k in sizes),
                  flush=True)
        if given:
            bound = cs.bound_ms(3 * n * c * 4 + 4 * c * 4, 2 * n * c,
                                torch.float32)[0]
        else:
            bound = cs.bound_ms(4 * n * c * 4, 4 * n * c, torch.float32)[0]
        new_ms = sum(times[name]) / len(times[name])
        print(f"n={n} c={c} {name}: new {new_ms:.4f} ms, old "
              f"{sum(times[old]) / len(times[old]):.4f} ms, bound "
              f"{bound:.4f} ms (bytes, {bound / new_ms:.0%} of the new); "
              f"max abs err vs twin {errs}", flush=True)
        rows[f"{name} n={n}"] = dict(
            blocks=nb, old_blocks=cs.old_blocks(n), bound_ms=bound,
            max_abs_err_vs_twin=errs, device_ms=times, eager_ms=eager)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", choices=("b3",),
                    help="time B3 and cg_update2_given only")
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
    lib, elibs, regs = build(cs, ck)
    for k, line in regs.items():
        print(f"ptxas: {k}: {line}", flush=True)
    summary = dict(card=card, ptxas=regs, shares={})
    for n in (cs.SHARD_N, cs.QUARTER_N) if args.only is None else ():
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
    summary["b3"] = b3_rows(cs, ck, torch, lib, elibs, dev, args.rounds)
    text = json.dumps(summary)
    if args.out:
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
