"""The tet batches' local-step kernel (aa_admm_tpu_torch/csrc/tet_prox.cu)
on the card: its registers and spills, each entry against its twin at the
beams shapes, and the device milliseconds of one call beside the twin's
CUDA-graph replay (the path the kernel replaced), at E = 540 (one batch of
the published beams scene) and E = 4,320 (the batch tiled for the 8-scene
sweep), in float64 and float32.

    python3 tools/port_tet_prox_cost.py [--reps N]

Blocks: each batch's deformation gradients at the beams scene's state
after one frame. Kernel time: N calls captured in one CUDA graph, replayed
and timed by CUDA events, over N. Twin time: the graph of one twin call
(physics._GraphedCall: copy in, replay, clone out), N replays timed by
CUDA events, over N. Bounds: the block, its parameters and the result
read and written once at 3.35 TB/s; the twin's elementwise results an
element (its aten outputs over E, a floor on the kernel's operations) at
67 TFLOP/s (f32) or 34 TFLOP/s (f64). Prints the card's name and power
limit first.
"""

import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_BYTES = 3.35e12


def ptxas(ck):
    """nvcc's -Xptxas -v lines of the tet kernels (registers, spills)."""
    with tempfile.TemporaryDirectory() as d:
        proc = subprocess.run(
            [ck._nvcc(), *ck.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(d, "lib.so"), str(ck.CSRC_DIR / "tet_prox.cu")],
            capture_output=True, text=True)
    lines, name = [], None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif name and ("registers" in line or "spill" in line):
            lines.append(f"{name}: {line.strip()}")
    return proc.returncode, lines


def elementwise_per_element(fn, x, E):
    """The twin's elementwise results an element: the numel of every aten
    output of fn(x), over E."""
    from torch.utils._python_dispatch import TorchDispatchMode
    import torch

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor) and "view" not in str(func):
                    self.n += t.numel()
            return out

    with Count() as c:
        fn(x)
    return c.n / E


def kernel_ms(fn, reps):
    """Device ms of one fn() from `reps` calls captured in one graph."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def replay_ms(fn, x, reps):
    """ms of one call of fn(x) replayed from its CUDA graph."""
    import torch
    from aa_admm_tpu_torch.solver.physics import _GraphedCall
    g = _GraphedCall(fn, x)
    g(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g(x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv):
    import torch
    from aa_admm_tpu_torch.apps import beams
    from aa_admm_tpu_torch.core.config import AccelType, Settings
    from aa_admm_tpu_torch.ops import cuda_kernels as ck
    from aa_admm_tpu_torch.parallel.ensemble import tile_system

    reps = int(argv[argv.index("--reps") + 1]) if "--reps" in argv else 200
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rc, lines = ptxas(ck)
    print(f"nvcc -Xptxas -v: exit {rc}")
    for line in lines:
        print("  " + line)
    s = Settings()
    s.admm_iters, s.verbose, s.anderson_m = 100, 0, 5
    s.acceleration_type = AccelType.ANDERSON
    solver, stretch = beams.build_scene(s, device="cuda")
    stretch(s.timestep_s)
    solver.step()
    system, x = solver.system, solver._x_dev
    tiled = tile_system(system, 8)
    xs = x.repeat(8, 1)
    for name, sysm, pos in (("one scene", system, x),
                            ("8 scenes", tiled, xs)):
        for b, F in zip(sysm.batches, sysm.deform(pos)):
            if b.zdim != (3, 3):
                continue
            E = F.shape[1]
            for dt in (torch.float64, torch.float32):
                v = F.to(dt).contiguous()
                p = [t.to(dt) for t in (b.mu, b.lam, b.k, b.vol)]
                for op in ("prox", "grad"):
                    args = p[:3] if op == "prox" else p
                    kern = ck.tet_prox if op == "prox" else ck.tet_grad
                    twin = (ck.tet_prox_plain if op == "prox"
                            else ck.tet_grad_plain)
                    out = kern(v, *args, b.kind)
                    ref = twin(v.cpu(), *[a.cpu() for a in args], b.kind)
                    scale = ref.double().abs().amax(0).clamp_min(1.0)
                    err = float(((out.cpu().double() - ref.double()).abs()
                                 / scale).max())
                    ms = kernel_ms(lambda: kern(v, *args, b.kind), reps)
                    tw = replay_ms(lambda a: twin(a, *args, b.kind), v,
                                   max(10, reps // 10))
                    ops = elementwise_per_element(
                        lambda a: twin(a, *args, b.kind), v, E)
                    nbytes = (18 + len(args)) * E * v.element_size()
                    bound_b = nbytes / PEAK_BYTES * 1e3
                    bound_o = ops * E / PEAK_FLOPS[str(dt)[6:]] * 1e3
                    bound = max(bound_b, bound_o)
                    print(f"{name:9s} {op} {b.kind:10s} E={E:5d} "
                          f"{str(dt)[6:]}: kernel {ms:.4f} ms, twin graph "
                          f"{tw:.4f} ms ({tw / ms:.0f}x), bound "
                          f"{bound:.5f} ms ({'bytes' if bound_b > bound_o else 'operations'}: "
                          f"{nbytes} B, {ops:.0f} results/element), "
                          f"{100 * bound / ms:.2f}% of it; max err "
                          f"{err:.2e} of scale", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
