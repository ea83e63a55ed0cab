"""The port's Anderson ``compute`` for one window against another
checkout's (e.g. the parent commit's, unpacked with ``git archive``):

* bits: 40 mixing steps from a seeded start through the first step, the
  ring buffer's wrap and two resets, in float64 and float32, at a tiny
  size and at the physics scenes' sizes (a plain iterate and a (u, x) pair
  whose head alone drives the mixing);
* host time: microseconds per call (one call holds the Gram matrix's host
  read, so it waits for the device), the two checkouts' calls interleaved,
  20 rounds of 50 calls each, float32; minimum and median over the rounds.

    python3 tools/port_aa_compute.py --tree DIR [--cpu]

Runs on the card unless ``--cpu``. Prints one line per case and, last, one
JSON object of them all; exits 1 if any case differs in any bit.
"""

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = os.path.join("aa_admm_tpu_torch", "solver", "anderson.py")
# (d, effective dim, m): tiny; beams' z (-a 1 -am 5); a zxu (u, x) pair.
CASES = [(60, 40, 3), (180_000, 180_000, 5), (240_000, 200_000, 5)]


def load(tree, name):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(tree, REL))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(mod, d, de, m, dtype, device, steps=40):
    """The window's iterates and final state after `steps` mixing steps."""
    g = torch.Generator().manual_seed(d + m)
    W = (0.05 * torch.randn(64, generator=g, dtype=dtype)).to(device)
    st = mod.init(m, torch.randn(d, generator=g, dtype=dtype).to(device),
                  effective_dim=de)
    outs = []
    for it in range(steps):
        noise = torch.randn(d, generator=g, dtype=dtype).to(device)
        G = torch.tanh(st.current_u * W.repeat(d // 64 + 1)[:d]) + 0.1 * noise
        st, u = mod.compute(st, G)
        outs.append(u)
        if it % 11 == 5:
            st = mod.reset(st, st.current_u)
    return outs, st


def host_us(here, there, d, de, m, device, rounds=20, calls=50):
    """Microseconds per compute() of each module, interleaved rounds."""
    g = torch.Generator().manual_seed(d)
    Gs = [torch.randn(d, generator=g).to(device) for _ in range(calls)]
    us = {"this": [], "other": []}
    for _ in range(rounds):
        for name, mod in (("this", here), ("other", there)):
            st = mod.init(m, Gs[0], effective_dim=de)
            st, _ = mod.compute(st, Gs[0])
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for G in Gs:
                st, u = mod.compute(st, G)
            if device == "cuda":
                torch.cuda.synchronize()
            us[name].append((time.perf_counter() - t0) / calls * 1e6)
    return {f"{k}_{f.__name__}": f(v) for k, v in us.items()
            for f in (min, statistics.median)}


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    here, there = load(ROOT, "aa_here"), load(args.tree, "aa_there")
    result, ok = {}, True
    for dtype in (torch.float64, torch.float32):
        for d, de, m in CASES:
            ua, sa = run(here, d, de, m, dtype, device)
            ub, sb = run(there, d, de, m, dtype, device)
            same = (all(torch.equal(a, b) for a, b in zip(ua, ub))
                    and all(torch.equal(getattr(sa, f), getattr(sb, f))
                            for f in here.AAState.__dataclass_fields__))
            key = f"{str(dtype)[6:]} d={d} de={de} m={m}"
            result[key] = same
            ok &= same
            print(f"{device} {key}: bit-equal {same}", flush=True)
    timing = {}
    for d, de, m in CASES:
        key = f"d={d} de={de} m={m}"
        timing[key] = host_us(here, there, d, de, m, device)
        t = timing[key]
        print(f"{device} {key}: us per call, this checkout min "
              f"{t['this_min']:.1f} median {t['this_median']:.1f}; the other "
              f"min {t['other_min']:.1f} median {t['other_median']:.1f}",
              flush=True)
    print(json.dumps({"device": device, "bit_equal": result,
                      "host_us": timing}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
