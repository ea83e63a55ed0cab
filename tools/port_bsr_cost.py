"""The JAX package's Morton-blocked (BSR) operator against the port's ELL
operator, on one NVIDIA GPU. The port does not ship the blocked path (on the
H100 it is slower; PERF.md): this script keeps a copy of it, translated from
aa_admm_tpu/solver/geometry.py (``BsrMatrix`` :88-230, the blocked branch
of ``_solve_x`` :360-388, its arming :800-834), to measure it.

    python3 tools/port_bsr_cost.py [--out FILE]

On chip_smoke's phase-5 scene (wiremesh-synthetic-231k, 231,361 vertices,
float32, 20 iterations) it measures:
  * one blocked matvec against one ELL matvec on a random vector (relative
    difference) and the device ms of each from CUDA-graph replays, with
    apply_blocked's three parts timed alone: the neighbour blocks' gather
    and product, the spill blocks' gather and product, and the spill
    blocks' sum into their block rows (the port's fixed-order gather);
  * a torch.profiler table of one apply_blocked's device kernels;
  * ms per trial of the whole solve on each operator, in turns ELL,
    blocked, blocked, ELL on one set-up system, with CG iterations and
    B2/B3 launches per solve (the blocked CG runs B2/B3 at n_pad rows).
Prints one line per measurement and, last, one JSON object of them all
(also written to FILE when given).
"""

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import scipy.sparse as sp
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def morton_order(verts):
    """Vertex order along a 30-bit Morton curve of the bounding box."""
    v = np.asarray(verts, np.float64)
    lo, hi = v.min(0), v.max(0)
    q = np.clip((v - lo) / np.maximum(hi - lo, 1e-30) * 1023.0,
                0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 32)) & np.uint64(0x1F00000000FFFF)
        x = (x | (x << 16)) & np.uint64(0x1F0000FF0000FF)
        x = (x | (x << 8)) & np.uint64(0x100F00F00F00F00F)
        x = (x | (x << 4)) & np.uint64(0x10C30C30C30C30C3)
        x = (x | (x << 2)) & np.uint64(0x1249249249249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) \
        | (spread(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable")


@dataclasses.dataclass(frozen=True)
class Bsr:
    """Vertices in Morton order, grouped into B-vertex blocks; each block
    row holds a dense (B, deg*B) matrix over its deg most populated
    neighbour blocks, and the entries past that cap spill into whole (B, B)
    blocks, summed into their block rows by a gather over an inverse table
    of sblk_row."""

    iperm: object      # (n,) original vertex -> blocked position
    nbr: object        # (nb, deg) neighbour block ids
    a_loc: object      # (nb, B, deg*B)
    sblk_row: object   # (ns,) block row of each spill block, ascending
    sblk_nbr: object   # (ns,) its neighbour block
    sblk_a: object     # (ns, B, B)
    inv_idx: object    # (<= nb, Ks) spill blocks of each block row
    inv_mask: object
    block: int = 16

    @classmethod
    def from_csr(cls, A, dtype, verts, device, block=16, deg_cap=9):
        from aa_admm_tpu_torch.ops._batchutil import inverse_table
        n, B = A.shape[0], block
        perm = morton_order(verts)
        nb = -(-n // B)
        iperm = np.empty(n, np.int64)
        iperm[perm] = np.arange(n)
        coo = A.tocoo()
        Ap = sp.csr_matrix((coo.data, (iperm[coo.row], iperm[coo.col])),
                           shape=(nb * B, nb * B))
        Ap.sum_duplicates()
        coo_p = Ap.tocoo()
        rows, cols = coo_p.row.astype(np.int64), coo_p.col.astype(np.int64)
        data = coo_p.data
        br, bc = rows // B, cols // B
        pair = br * nb + bc
        upair, counts = np.unique(pair, return_counts=True)
        ubr, ubc = upair // nb, upair % nb
        order = np.lexsort((-counts, ubr))
        ubr_s, ubc_s = ubr[order], ubc[order]
        rank = np.arange(len(ubr_s)) - np.searchsorted(ubr_s, ubr_s)
        kept = rank < deg_cap
        nbr = np.tile(np.arange(nb, dtype=np.int64)[:, None], (1, deg_cap))
        nbr[ubr_s[kept], rank[kept]] = ubc_s[kept]
        kept_pair = ubr_s[kept] * nb + ubc_s[kept]
        kp = np.argsort(kept_pair)
        kept_pair_s, kept_slot_s = kept_pair[kp], rank[kept][kp]
        pos = np.minimum(np.searchsorted(kept_pair_s, pair),
                         len(kept_pair_s) - 1)
        slot = np.where(kept_pair_s[pos] == pair, kept_slot_s[pos], -1)
        a_loc = np.zeros((nb, B, deg_cap * B))
        m = slot >= 0
        np.add.at(a_loc, (br[m], rows[m] - br[m] * B,
                          slot[m] * B + (cols[m] - bc[m] * B)), data[m])
        sp_r, sp_c, sp_v = rows[~m], cols[~m], data[~m]
        sbr, sbc = sp_r // B, sp_c // B
        upair_s, inv = np.unique(sbr * nb + sbc, return_inverse=True)
        sblk_a = np.zeros((max(len(upair_s), 1), B, B))
        np.add.at(sblk_a, (inv, sp_r - sbr * B, sp_c - sbc * B), sp_v)
        sblk_row = upair_s // nb if len(upair_s) else np.zeros(1, np.int64)
        sblk_nbr = upair_s % nb if len(upair_s) else np.zeros(1, np.int64)

        def t(a, dt=None):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=device, dtype=dt)
        inv_idx, inv_mask = inverse_table(t(sblk_row), dtype)
        return cls(iperm=t(iperm), nbr=t(nbr), a_loc=t(a_loc, dtype),
                   sblk_row=t(sblk_row), sblk_nbr=t(sblk_nbr),
                   sblk_a=t(sblk_a, dtype), inv_idx=inv_idx,
                   inv_mask=inv_mask, block=B)

    @property
    def n_pad(self):
        return self.nbr.shape[0] * self.block

    def to_blocked(self, v):
        vp = v.new_zeros((self.n_pad,) + tuple(v.shape[1:]))
        return vp.index_copy_(0, self.iperm, v)

    def from_blocked(self, vp):
        return vp.index_select(0, self.iperm)

    def neighbours(self, vb):
        nb, c = vb.shape[0], vb.shape[2]
        return torch.bmm(self.a_loc, vb[self.nbr].reshape(nb, -1, c))

    def spill(self, vb):
        return torch.bmm(self.sblk_a, vb[self.sblk_nbr])

    def spill_sum(self, extra, nb):
        from aa_admm_tpu_torch.ops._batchutil import _gather_scatter
        return _gather_scatter(extra, self.inv_idx, self.inv_mask, nb)

    def apply_blocked(self, vp):
        B, nb, c = self.block, self.nbr.shape[0], vp.shape[1]
        vb = vp.reshape(nb, B, c)
        out = self.neighbours(vb) + self.spill_sum(self.spill(vb), nb)
        return out.reshape(nb * B, c)


def blocked_preconditioners(bsr, A, mg, device, dtype):
    """The Jacobi diagonal (1 in the padded rows) and the two-level
    preconditioner in blocked numbering (JAX geometry.py:817-834)."""
    iperm = bsr.iperm.cpu().numpy()
    diag_b = np.ones(bsr.n_pad)
    diag_b[iperm] = np.maximum(np.asarray(A.diagonal()), 1e-12)
    agg_b = torch.zeros(bsr.n_pad, dtype=mg.agg.dtype, device=device)
    invd_b = torch.zeros(bsr.n_pad, dtype=mg.inv_diag.dtype, device=device)
    mg_b = dataclasses.replace(
        mg, agg=agg_b.index_copy_(0, bsr.iperm, mg.agg),
        inv_diag=invd_b.index_copy_(0, bsr.iperm, mg.inv_diag),
        inv_idx=bsr.iperm[mg.inv_idx])
    return torch.from_numpy(diag_b).to(device=device, dtype=dtype), mg_b


@contextlib.contextmanager
def blocked_cg(geometry, bsr, diag_b, mg_b):
    """Inside the block the geometry solver's CG runs in blocked numbering
    on the BSR operator: one permutation in and one out per solve, as the
    JAX package's blocked branch of _solve_x does."""
    pcg = geometry.pcg_fused

    def pcg_blocked(operator, rhs, diag, tol, max_iters, x0=None,
                    precond=None):
        x_b, it = pcg(
            bsr.apply_blocked, bsr.to_blocked(rhs), diag_b, tol=tol,
            max_iters=max_iters,
            x0=None if x0 is None else bsr.to_blocked(x0),
            precond=mg_b.apply)
        return bsr.from_blocked(x_b), it

    geometry.pcg_fused = pcg_blocked
    try:
        yield
    finally:
        geometry.pcg_fused = pcg


def profile_table(fn, n=5, top=10):
    """(kernel name, device ms per call, launches per call) of `fn`'s
    device kernels under torch.profiler, the costliest first."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        if us > 0:
            rows.append((e.key, us / n / 1e3, e.count / n))
    return sorted(rows, key=lambda r: -r[1])[:top]


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    if not torch.cuda.is_available():
        print("port_bsr_cost: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from aa_admm_tpu_torch.apps.wire_mesh_opt import (F32_CG_ITERS,
                                                      optimize_mesh)
    from aa_admm_tpu_torch.ops import cuda_kernels as ck
    from aa_admm_tpu_torch.solver import geometry
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    ck.build_all()
    out = dict(card=card)
    dev, dt = torch.device("cuda"), torch.float32

    sub, el, ref_v, ref_f = cs.full_scene()
    n = sub.n_verts()
    tmp = tempfile.mkdtemp(prefix="bsr_cost_")
    with contextlib.redirect_stdout(io.StringIO()):
        solver = optimize_mesh(sub, ref_v, ref_f, max_iter=20, anderson_m=5,
                               edge_length=el, min_angle_radian=np.pi * 0.25,
                               max_angle_radian=np.pi * 0.75,
                               dtype=np.float32, result_dir=tmp, device="cuda")
    system = solver.system
    t0 = time.perf_counter()
    bsr = Bsr.from_csr(solver._A_host, dt, sub.verts, dev)
    diag_b, mg_b = blocked_preconditioners(bsr, solver._A_host, system.mg,
                                           dev, dt)
    build_s = time.perf_counter() - t0
    nb, deg = bsr.nbr.shape
    ns, ks = int(bsr.sblk_row.shape[0]), int(bsr.inv_idx.shape[1])
    mib = (bsr.a_loc.numel() + bsr.sblk_a.numel()) * 4 / 2**20
    out["operator"] = dict(n=n, n_pad=bsr.n_pad, block_rows=nb, deg=deg,
                           spill_blocks=ns, spill_per_row_max=ks,
                           block_mib=mib, build_s=build_s)
    print(f"BSR operator: n {n}, n_pad {bsr.n_pad}, {nb} block rows of "
          f"{bsr.block}, {deg} neighbour blocks each, {ns} spill blocks (at "
          f"most {ks} per block row), {mib:.1f} MiB of local and spill "
          f"blocks; built in {build_s:.2f} s", flush=True)

    # one matvec each, and apply_blocked's parts, device ms
    g = torch.Generator(device="cuda").manual_seed(0)
    v = torch.randn((n, 3), generator=g, device="cuda")
    vp = bsr.to_blocked(v)
    vb = vp.reshape(nb, bsr.block, 3)
    extra = bsr.spill(vb)
    want = system.ell.apply(v)
    got = bsr.from_blocked(bsr.apply_blocked(vp))
    err = float((got - want).abs().max() / want.abs().max())
    ms = dict(ell_apply=cs.device_ms(lambda: system.ell.apply(v)),
              apply_blocked=cs.device_ms(lambda: bsr.apply_blocked(vp)),
              neighbours=cs.device_ms(lambda: bsr.neighbours(vb)),
              spill=cs.device_ms(lambda: bsr.spill(vb)),
              spill_sum=cs.device_ms(lambda: bsr.spill_sum(extra, nb)))
    out["matvec_ms"], out["matvec_rel_diff"] = ms, err
    print(f"one matvec, f32, device ms: ELL apply {ms['ell_apply']:.4f}, "
          f"apply_blocked {ms['apply_blocked']:.4f} = neighbour gather and "
          f"product {ms['neighbours']:.4f} + spill gather and product "
          f"{ms['spill']:.4f} + spill sum {ms['spill_sum']:.4f} (each "
          f"alone); blocked vs ELL max rel diff {err:.2e}", flush=True)
    prof = profile_table(lambda: bsr.apply_blocked(vp))
    out["apply_blocked_kernels"] = [dict(kernel=k, ms=t, launches=c)
                                    for k, t, c in prof]
    for k, t, c in prof:
        print(f"  apply_blocked kernel {t:.4f} ms x{c:g}: {k[:110]}")

    # the whole solve, per trial, in turns on one set-up system
    per_trial = {"ELL": [], "blocked": []}
    solves = []
    for name in ("ELL", "blocked", "blocked", "ELL"):
        ck.reset_launch_counts()
        arm = (blocked_cg(geometry, bsr, diag_b, mg_b) if name == "blocked"
               else contextlib.nullcontext())
        with arm, contextlib.redirect_stdout(io.StringIO()):
            solver.solve_ADMM(sub.verts, 1e-8, 20, 5,
                              cg_max_iters=F32_CG_ITERS)
        torch.cuda.synchronize()
        st, counts = solver.stats, ck.launch_counts()
        row = dict(operator=name, ms_per_trial=st["solve_s"] / st["trials"]
                   * 1e3, trials=st["trials"], cg_iters=st["cg_iters"],
                   cp_refreshes=st["cp_refreshes"],
                   cg_update1=counts["cg_update1"],
                   cg_update2=counts["cg_update2"],
                   final_fv=float(solver.function_values[-1]))
        solves.append(row)
        per_trial[name].append(row["ms_per_trial"])
        print(f"{name} solve: {row['ms_per_trial']:.3f} ms per trial, "
              f"{row['trials']} trials, {row['cg_iters']} CG iterations, "
              f"{row['cp_refreshes']} cp-cache refreshes, B2/B3 launches "
              f"{row['cg_update1']}/{row['cg_update2']}, last function "
              f"value {row['final_fv']:.6e}", flush=True)
    ratio = np.mean(per_trial["blocked"]) / np.mean(per_trial["ELL"])
    out["solves"], out["blocked_over_ell"] = solves, float(ratio)
    print(f"blocked / ELL ms per trial: {ratio:.4f}")
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
