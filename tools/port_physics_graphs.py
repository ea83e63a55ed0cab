"""What the CUDA graphs of the port's xzu physics step save, and what the
singular-value Newton's polish costs, on the published beams scene at
float64 (three batches of 540 tets: linear, NeoHookean, StVK).

    python3 tools/port_physics_graphs.py          # on a CUDA device
    python3 tools/port_physics_graphs.py --cpu    # operation counts only

Per element batch: the aten operations of one prox call, with the polish
and without it (``prox._POLISH_ITERS`` set to 0 in this process). On a CUDA
device also, with and without the polish: the device kernels of one eager
prox call (torch.profiler) and the milliseconds of one prox call replayed
from a CUDA graph (CUDA events). Then, from the state after the first
Anderson-accelerated frame, one 100-iteration step on the host's clock:
with the prox, gradient and CG operator replayed from CUDA graphs (as the
solver runs on the card), eagerly (``physics._graphed`` replaced in this
process by a direct call), and through graphs without the polish; with the
largest differences of their results.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def count_ops(fn, x):
    """aten operations dispatched by fn(x)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as c:
        fn(x)
    return c.n


def device_kernels(fn, x):
    """Device kernels launched by one eager fn(x) (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(x)
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA"))


def replay_ms(fn, x, reps=50):
    """Milliseconds per call of fn(x) replayed from a CUDA graph."""
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
    from aa_admm_tpu_torch.ops import prox
    from aa_admm_tpu_torch.solver import physics as ph

    device = "cpu" if "--cpu" in argv else "cuda"
    if device == "cpu":
        torch.set_num_threads(1)
    else:
        import subprocess
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    s = Settings()
    s.admm_iters = 100
    s.verbose = 0
    s.acceleration_type = AccelType.ANDERSON
    s.anderson_m = 5
    solver, stretch = beams.build_scene(s, device=device)
    stretch(s.timestep_s)
    solver.step()
    system = solver.system
    x, v, pp = solver._x_dev, solver._v_dev, solver._pin_pos_dev()
    polish = prox._POLISH_ITERS

    for b, F in zip(system.batches, system.deform(x)):
        row = {}
        for p in (polish, 0):
            prox._POLISH_ITERS = p
            try:
                row[p] = [count_ops(b.prox, F)]
                if device == "cuda":
                    row[p] += [device_kernels(b.prox, F), replay_ms(b.prox, F)]
            finally:
                prox._POLISH_ITERS = polish
        line = (f"prox {b.kind:10s} {F.shape[-1]} tets: aten ops "
                f"{row[polish][0]} with the polish, {row[0][0]} without")
        if device == "cuda":
            line += (f"; device kernels per eager call {row[polish][1]} / "
                     f"{row[0][1]}; graph replay {row[polish][2]:.4f} / "
                     f"{row[0][2]:.4f} ms")
        print(line, flush=True)
    if device == "cpu":
        return 0

    def timed_step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xn, _, tr = ph.step_xzu(system, x, v, pp)
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) * 1e3, xn.cpu().numpy(),
                tr.prim.cpu().numpy())

    ms_g, x_g, p_g = timed_step()
    graphed = ph._graphed
    ph._graphed = lambda system, key, fn, x: fn(x)
    try:
        ms_e, x_e, p_e = timed_step()
    finally:
        ph._graphed = graphed
    system.__dict__.pop("_graphs")
    prox._POLISH_ITERS = 0
    try:
        timed_step()                  # captures graphs without the polish
        ms_n, x_n, p_n = timed_step()
    finally:
        prox._POLISH_ITERS = polish
        system.__dict__.pop("_graphs")

    def diff(a, b):
        both = ~np.isnan(a) & ~np.isnan(b)
        return np.abs(a - b)[both].max() / a[0]
    print(f"one accelerated step (100 iterations) after the first frame: "
          f"graphs {ms_g:.1f} ms, eager {ms_e:.1f} ms "
          f"({ms_e / ms_g:.2f}x), graphs without the polish {ms_n:.1f} ms")
    print(f"graphs vs eager: max |x diff| {np.abs(x_g - x_e).max():.3e}, max "
          f"prim diff / prim[0] {diff(p_g, p_e):.3e}; without the polish: max "
          f"|x diff| {np.abs(x_g - x_n).max():.3e}, max prim diff / prim[0] "
          f"{diff(p_g, p_n):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
