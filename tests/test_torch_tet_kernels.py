"""The tet batches' local-step kernel (aa_admm_tpu_torch/csrc/tet_prox.cu;
ops/cuda_kernels.py ``tet_prox`` and ``tet_grad``) against its twins, the
batched torch math of ops/prox.py and ops/svd3.py:

* on the CPU: the wrappers' checks and dispatch (CPU tensors run the twin
  and count no launch; TetBatch's CPU path and ``svd_method="lapack"`` are
  the torch math as before; the physics step keeps CUDA graphs only for the
  other batches), the source and its entries, and the kernels' own device
  code compiled as host C++ by g++ and run over adversarial deformation
  gradients against the twins;
* on the card (``cuda`` marker, skips without one): every entry against
  its twin on the same gradients, one beams frame and one tiled 8-scene
  frame of the pin-speed sweep against the same frames on the CPU, and the
  launches an iteration.

Tolerances. The kernel repeats the twin's IEEE operations in the twin's
order, but torch's CPU sqrt and log are not correctly rounded and its
norms and cross products may contract into fused multiply-adds, so an
element may part from the twin in its last bits: f64 within 1e-12 of the
twin on unit-scale entries, f32 within 1e-5 of the element's largest
entry. A rank-one F is left out: there the prox is not a function of F
(one ulp of input moves the twin's linear prox by 0.4).
"""

import ctypes
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from aa_admm_tpu_torch.apps import beams
from aa_admm_tpu_torch.core.config import AccelType, Lame, Settings
from aa_admm_tpu_torch.core.factory import make_tet_blocks
from aa_admm_tpu_torch.ops import cuda_kernels as ck
from aa_admm_tpu_torch.ops.elements import PinBatch, TetBatch
from aa_admm_tpu_torch.solver import physics as tphys

KINDS = ck.TET_KINDS
DTYPES = {"f64": torch.float64, "f32": torch.float32}
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# The beams scene's soft rubber (apps/beams.py) for the prox; unit-scale
# parameters for the gradients, so that their entries are unit-scale too.
RUBBER = Lame.from_young_poisson(10000000, 0.399)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rotation(rng):
    q, r = np.linalg.qr(rng.standard_normal((3, 3)))
    q = q * np.sign(np.diag(r))
    return q if np.linalg.det(q) > 0 else -q


def adversarial_F(seed=7):
    """(N, 3, 3) float64 deformation gradients: well-conditioned ones, then
    near-singular, rank-deficient, inverted (det < 0), det straddling the
    linear prox's 1e-16, repeated singular values, zero, identity and large
    stretch. Each is one where the prox and gradient are functions of F
    that rounding does not tip. A singular value below the Jacobi SVD's
    noise (about 1e-8 of the largest: it is the root of an eigenvalue of
    F^T F) decides the linear flip and the signed SVD's sign by the noise
    of its own computation, and starts the sigma-Newton where 14 steps do
    not settle it: one ulp of input moves the twin's prox by up to 1.0
    there. So such F come exact (diagonal or permuted), and the rotated
    ones are held apart in ill_posed_F."""
    rng = np.random.default_rng(seed)

    def rsr(*s):
        return _rotation(rng) @ np.diag(s) @ _rotation(rng)

    perm = np.array([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])
    flip = np.diag([1.0, 1.0, -1.0])
    out = [np.eye(3) + 0.3 * rng.standard_normal((3, 3)) for _ in range(48)]
    out += [rsr(1e-3, 1.0, 2.0), np.diag([2.0, 1.0, 1e-13]),
            perm @ np.diag([1e-12, 3.0, 0.7])]                  # near-singular
    out += [np.diag([2.0, 0.0, 0.0]), np.diag([0.0, 0.5, 0.0]),
            perm @ np.diag([0.0, 1.0, 1.5]), np.diag([1.0, 1.0, 0.0]),
            perm.T @ np.diag([2.0, 0.0, 0.0])]                  # rank < 3
    out += [rsr(*s) @ flip for s in ((0.5, 1.0, 1.8), (0.4, 1.3, 2.0),
                                     (0.9, 1.5, 3.0), (0.3, 0.7, 1.1))]
    out += [flip, -np.eye(3), perm @ flip, rsr(2.0, 1.0, -0.5)]  # det < 0
    out += [np.diag([1.0, 1.0, 1e-16 * f])
            for f in (-1.0, 0.5, 0.999, 1.0, 1.001, 1.5)]
    out += [perm @ np.diag([2.0, 0.5, 1e-16 * f]) for f in (0.9, 1.1)]
    out += [rsr(2.0, 2.0, 1.0), rsr(1.0, 0.5, 0.5),
            1.5 * _rotation(rng), rsr(1.2, 1.2, 1.2)]            # repeated
    out += [np.zeros((3, 3)), np.eye(3)]
    out += [rsr(8.0, 5.0, 0.3), rsr(6.0, 2.0, 0.2), rsr(4.0, 0.25, 0.1)]
    out += [np.diag([20.0, 0.05, 1.0])]                         # large stretch
    return np.stack(out)


def ill_posed_F(seed=11):
    """Deformation gradients with a singular value below the SVD's noise:
    rotated near-singular, rank-deficient and rank-one F, and det ~ 1e-16
    after a rotation."""
    rng = np.random.default_rng(seed)

    def rsr(*s):
        return _rotation(rng) @ np.diag(s) @ _rotation(rng)

    out = [rsr(1e-9, 1.0, 2.0), rsr(1e-6, 0.5, 1.0), rsr(1e-13, 0.5, 1.0),
           rsr(0.0, 1.0, 1.5), rsr(0.0, 1.0, 1.0),
           rsr(0.0, 0.0, 2.0), rsr(1.0, 1.0, 1e-16), rsr(1.0, 1.0, 1.5e-16)]
    out += [np.outer(rng.standard_normal(3), rng.standard_normal(3))
            for _ in range(4)]
    return np.stack(out)


def _inputs(F, dtype, device="cpu", seed=7):
    """The plane-form block of F (N, 3, 3) and per-element parameters: the
    prox's (beams' rubber, mu varied per element) and the gradient's (unit
    scale)."""
    E = len(F)
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    block = t(F.reshape(E, 9).T)
    prox = (t(RUBBER.mu * rng.uniform(0.5, 1.5, E)),
            t(np.full(E, RUBBER.lam)), t(np.full(E, RUBBER.bulk_modulus)))
    grad = (t(rng.uniform(0.5, 1.5, E)), t(rng.uniform(0.5, 1.5, E)),
            t(rng.uniform(0.5, 1.5, E)), t(rng.uniform(0.5, 1.5, E)))
    return block, prox, grad


def _twin(op, kind, dtype, F, device="cpu"):
    """(block, params, twin's output on the CPU) for one entry on F."""
    block, prox, grad = _inputs(F, dtype, device)
    params = prox if op == "prox" else grad
    cpu = [a.cpu() for a in (block, *params)]
    fn = ck.tet_prox_plain if op == "prox" else ck.tet_grad_plain
    return block, params, fn(*cpu, kind)


def _assert_near_twin(out, ref, dtype):
    """Per element: |out - ref| <= TOL * max(1, its largest |entry|); NaN
    where the twin has NaN (f32 divides by 1e-300 = 0 at det 0)."""
    out, ref = out.double().cpu(), ref.double().cpu()
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    ok = ~torch.isnan(ref)
    scale = ref.nan_to_num(0).abs().amax(0).clamp_min(1.0)
    err = ((out - ref).abs() * ok).nan_to_num(0) / scale
    worst = int(err.amax(0).argmax())
    assert float(err.max()) <= TOL[dtype], (
        f"element {worst}: {float(err.max()):.3e} of its scale")


def _assert_sound(out, ref, op, kind, block, params):
    """On ill_posed_F, where the entries are not functions of F: the twin's
    pattern of non-finite entries, and for the linear entries an orthogonal
    polar factor (P = 2 out - F of the prox, R = F - out / (k vol) of the
    gradient)."""
    dtype = out.dtype
    out, ref = out.double().cpu(), ref.double().cpu()
    assert torch.equal(torch.isfinite(out), torch.isfinite(ref))
    if kind == "linear":
        F = block.double().cpu()
        P = (2.0 * out - F if op == "prox"
             else F - out / (params[2] * params[3]).double().cpu())
        P = P.T.reshape(-1, 3, 3)
        eye = torch.eye(3, dtype=torch.float64)
        assert float((P @ P.transpose(1, 2) - eye).abs().max()) <= TOL[dtype]


def _check_entry(run, op, kind, dtype, device="cpu"):
    """run(block, params) -> the entry's output, held to the twin on
    adversarial_F and sound on ill_posed_F."""
    for F, check in ((adversarial_F(), "near"), (ill_posed_F(), "sound")):
        block, params, ref = _twin(op, kind, dtype, F, device)
        out = run(block, params)
        if check == "near":
            _assert_near_twin(out, ref, dtype)
        else:
            _assert_sound(out, ref, op, kind, block, params)


# ---------------------------------------------------------------------------
# CPU: dispatch, checks, the source
# ---------------------------------------------------------------------------

def _beam_batch(kind, svd_method="jacobi"):
    mesh = make_tet_blocks(2, 1, 1)
    return TetBatch.from_mesh(mesh.verts, mesh.tets, RUBBER, kind=kind,
                              svd_method=svd_method)


@pytest.mark.parametrize("kind", KINDS)
def test_twin_on_cpu_counts_no_launch(kind):
    """CPU tensors: the wrappers run the twins, TetBatch runs the torch math
    of ops/prox.py as it did, and no launch is counted."""
    ck.reset_launch_counts()
    b = _beam_batch(kind)
    F = torch.from_numpy(adversarial_F()[:b.w.shape[0]].reshape(-1, 9).T
                         .copy())
    assert torch.equal(ck.tet_prox(F, b.mu, b.lam, b.k, kind), b.prox(F))
    assert torch.equal(ck.tet_grad(F, b.mu, b.lam, b.k, b.vol, kind),
                       b.grad(F))
    # TetBatch on the CPU takes any layout (the solver hands it views);
    # torch's CPU sqrt rounds by layout, so only to the last bits
    Ft = F.T.contiguous().T
    g = b.grad(F)
    assert not Ft.is_contiguous()
    assert torch.allclose(b.grad(Ft), g, rtol=0,
                          atol=1e-12 * float(g.abs().max()))
    counts = ck.launch_counts()
    assert counts["tet_prox"] == 0 and counts["tet_grad"] == 0


def _bad_call(case):
    """Arguments of a tet_prox or tet_grad call that must raise, and the
    message expected."""
    E = 6
    v = torch.zeros((9, E), dtype=torch.float64)
    p = torch.ones(E, dtype=torch.float64)
    return {
        "int_dtype": (("prox", v.long(), p.long(), p.long(), p.long(),
                       "linear"), "dtype"),
        "half_dtype": (("grad", v.half(), p.half(), p.half(), p.half(),
                        p.half(), "stvk"), "dtype"),
        "mixed_dtypes": (("prox", v, p.float(), p, p, "neohookean"),
                         "one dtype"),
        "block_shape": (("prox", v[:6], p, p, p, "linear"), r"\(9, E\)"),
        "transposed_block": (("grad", v.T.contiguous(), p, p, p, p,
                              "linear"), r"\(9, E\)"),
        "param_shape": (("grad", v, p, p[:5], p, p, "neohookean"),
                        r"\(E,\)"),
        "non_contiguous": (("prox", torch.zeros((E, 9), dtype=torch.float64)
                            .T, p, p, p, "stvk"), "contiguous"),
        "mixed_devices": (("grad", v, p, p, p, p.to("meta"), "linear"),
                          "one device"),
        "unknown_kind": (("prox", v, p, p, p, "corotated"), "kind"),
    }[case]


@pytest.mark.parametrize("case", [
    "int_dtype", "half_dtype", "mixed_dtypes", "block_shape",
    "transposed_block", "param_shape", "non_contiguous", "mixed_devices",
    "unknown_kind"])
def test_wrappers_refuse_what_the_kernel_does_not_take(case):
    (op, *args), match = _bad_call(case)
    ck.reset_launch_counts()
    with pytest.raises(ValueError, match=match):
        (ck.tet_prox if op == "prox" else ck.tet_grad)(*args)
    assert ck.launch_counts()["tet_prox"] == ck.launch_counts()["tet_grad"] \
        == 0


def test_lapack_svd_stays_torch_linalg_svd(monkeypatch):
    """svd_method="lapack" is torch.linalg.svd, as the user asked; the
    Jacobi batches never call it."""
    calls = []
    svd = torch.linalg.svd

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return svd(*a, **kw)

    monkeypatch.setattr(torch.linalg, "svd", counted)
    E = _beam_batch("linear").w.shape[0]
    F = torch.from_numpy(adversarial_F()[:E].reshape(-1, 9).T.copy())
    for kind in KINDS:
        _beam_batch(kind).prox(F)
        _beam_batch(kind).grad(F)
    assert calls == []
    lap = _beam_batch("linear", "lapack")
    jac = _beam_batch("linear")
    np.testing.assert_allclose(lap.prox(F).numpy(), jac.prox(F).numpy(),
                               rtol=0, atol=1e-12)
    lap.grad(F)
    assert len(calls) == 2
    _beam_batch("neohookean", "lapack").prox(F)
    assert len(calls) == 3


def test_physics_step_graphs_only_the_other_batches(monkeypatch):
    """_prox_all and _grad_all call a Jacobi tet batch directly (one
    kernel launch on the card) and keep _graphed for every other batch
    (here a pin batch and a tet batch on the lapack SVD)."""
    graphed = []

    def record(system, key, fn, x):
        graphed.append(key)
        return fn(x)

    monkeypatch.setattr(tphys, "_graphed", record)
    pins = PinBatch.create([0, 1], np.zeros((2, 3)))
    system = types.SimpleNamespace(batches=(
        _beam_batch("stvk"), pins, _beam_batch("linear", "lapack"),
        _beam_batch("neohookean")))
    E = system.batches[0].w.shape[0]
    F = torch.from_numpy(adversarial_F()[:E].reshape(-1, 9).T.copy())
    blocks = (F, torch.zeros((3, 2), dtype=torch.float64), F, F)
    tphys._prox_all(system, blocks)
    tphys._grad_all(system, blocks)
    assert graphed == [("prox", 1), ("prox", 2), ("grad", 1), ("grad", 2)]


def test_source_is_built_with_its_entries():
    """tet_prox.cu is in SOURCES (built like B1-B3, same flags), and every
    entry has its argtypes, its library and a C definition in both dtypes
    taking as many arguments."""
    assert ck.SOURCES["tet_prox"] == "tet_prox.cu"
    src = (ck.CSRC_DIR / "tet_prox.cu").read_text()
    assert "-fmad=false" in ck.NVCC_FLAGS
    n_args = {}
    for op in ("prox", "grad"):
        sig = src.split(f"int tet_{op}_##KIND##_f32(")[1].split(")")[0]
        n_args[op] = sig.count(",") + 1
        assert f"int tet_{op}_##KIND##_f64(" in src
    for kind in KINDS:
        assert f"TET_ENTRIES({kind}, " in src
        for op in ("prox", "grad"):
            entry = f"tet_{op}_{kind}"
            assert ck._LIB_OF[entry] == "tet_prox"
            assert len(ck._ARGTYPES[entry]) == n_args[op]
    assert {e for e, lib in ck._LIB_OF.items() if lib == "tet_prox"} == {
        f"tet_{op}_{kind}" for op in ("prox", "grad") for kind in KINDS}


# ---------------------------------------------------------------------------
# CPU: the kernels' device code, compiled as host C++
# ---------------------------------------------------------------------------

_HOST = r"""
#include <cmath>
using std::isfinite;
#define __device__
#define __forceinline__ inline
#define __global__
#define __launch_bounds__(n)
static struct { unsigned x; } blockIdx, threadIdx;
#include "tet_prox.cu"

template <typename T, int K>
static void prox_each(const T* v, const T* mu, const T* lam, const T* k,
                      T* out, long long E) {
  for (long long e = 0; e < E; ++e) {
    blockIdx.x = unsigned(e / kThreads);
    threadIdx.x = unsigned(e % kThreads);
    tet_prox_kernel<T, K>(v, mu, lam, k, out, E);
  }
}

template <typename T, int K>
static void grad_each(const T* z, const T* mu, const T* lam, const T* k,
                      const T* vol, T* out, long long E) {
  for (long long e = 0; e < E; ++e) {
    blockIdx.x = unsigned(e / kThreads);
    threadIdx.x = unsigned(e % kThreads);
    tet_grad_kernel<T, K>(z, mu, lam, k, vol, out, E);
  }
}

#define HOST_ENTRIES(KIND, K)                                              \
  extern "C" void host_prox_##KIND##_f32(const float* v, const float* mu,  \
      const float* lam, const float* k, float* out, long long E) {         \
    prox_each<float, K>(v, mu, lam, k, out, E); }                          \
  extern "C" void host_prox_##KIND##_f64(const double* v, const double* mu,\
      const double* lam, const double* k, double* out, long long E) {      \
    prox_each<double, K>(v, mu, lam, k, out, E); }                         \
  extern "C" void host_grad_##KIND##_f32(const float* z, const float* mu,  \
      const float* lam, const float* k, const float* vol, float* out,      \
      long long E) { grad_each<float, K>(z, mu, lam, k, vol, out, E); }    \
  extern "C" void host_grad_##KIND##_f64(const double* z,                  \
      const double* mu, const double* lam, const double* k,                \
      const double* vol, double* out, long long E) {                       \
    grad_each<double, K>(z, mu, lam, k, vol, out, E); }

HOST_ENTRIES(linear, kLinear)
HOST_ENTRIES(neohookean, kNeoHookean)
HOST_ENTRIES(stvk, kStVK)
"""


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """csrc/tet_prox.cu's device code built by g++ for the host, one
    element at a time, IEEE operations without contraction."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++: the kernels' device code is compiled for the "
                    "host by g++")
    d = tmp_path_factory.mktemp("tet_prox_host")
    (d / "host.cpp").write_text(_HOST)
    lib = d / "libtet_prox_host.so"
    proc = subprocess.run(
        [cxx, "-O2", "-std=c++17", "-ffp-contract=off", "-fno-fast-math",
         "-shared", "-fPIC", f"-I{ck.CSRC_DIR}", "-o", str(lib),
         str(d / "host.cpp")], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(lib))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("op", ["prox", "grad"])
def test_kernel_code_on_host_matches_twin(host_kernels, op, kind, dtype):
    fn = getattr(host_kernels, f"host_{op}_{kind}_{dtype}")
    fn.restype = None
    fn.argtypes = [ctypes.c_void_p] * (3 + (op == "grad") + 2) + [
        ctypes.c_longlong]

    def run(block, params):
        out = torch.empty_like(block)
        fn(block.data_ptr(), *[p.data_ptr() for p in params], out.data_ptr(),
           block.shape[1])
        return out

    _check_entry(run, op, kind, DTYPES[dtype])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("op", ["prox", "grad"])
def test_kernel_matches_twin_on_card(cuda_device, op, kind, dtype):
    key = f"tet_{op}"
    fn = ck.tet_prox if op == "prox" else ck.tet_grad

    def run(block, params):
        before = ck.launch_counts()[key]
        out = fn(block, *params, kind)
        torch.cuda.synchronize()
        assert ck.launch_counts()[key] == before + 1
        assert out.is_cuda and out.is_contiguous()
        assert out.shape == block.shape
        # an empty block launches nothing
        empty = fn(block[:, :0].contiguous(), *[p[:0] for p in params], kind)
        assert empty.shape == (9, 0)
        assert ck.launch_counts()[key] == before + 1
        return out

    _check_entry(run, op, kind, DTYPES[dtype], cuda_device)


def _published_settings():
    """beams-published: 100 iterations a frame, AA m = 5, f64."""
    s = Settings()
    s.admm_iters, s.anderson_m, s.verbose = 100, 5, 0
    s.acceleration_type = AccelType.ANDERSON
    s.dtype = np.dtype("float64")
    return s


@pytest.mark.cuda
def test_beams_frame_on_card_matches_cpu(cuda_device):
    """One frame of the published beams scene (100 iterations, AA m = 5,
    f64): the kernel path on the card against the twins on the CPU, and
    the launches: 6 prox and 3 gradient launches an iteration (each tet
    batch's gradient, and its prox in the z-update and in the combined
    residual), 3 prox launches in the step's set-up, no graph for a tet
    batch."""
    xs = {}
    for dev in ("cpu", cuda_device):
        solver, stretch = beams.build_scene(_published_settings(),
                                            device=dev)
        stretch(solver.settings.timestep_s)
        ck.reset_launch_counts()
        solver.step()
        xs[str(dev)] = solver.x
        counts = ck.launch_counts()
    iters = solver.settings.admm_iters
    assert counts["tet_prox"] == 6 * iters + 3
    assert counts["tet_grad"] == 3 * iters
    tets = [i for i, b in enumerate(solver.system.batches)
            if isinstance(b, TetBatch)]
    assert len(tets) == 3
    assert not {("prox", i) for i in tets} & set(
        solver.system.__dict__.get("_graphs", {}))
    assert np.abs(xs["cuda"] - xs["cpu"]).max() <= 1e-12


@pytest.mark.cuda
def test_sweep_frame_on_card_matches_cpu(cuda_device):
    """One frame of the 8-scene pin-speed sweep (the tiled system, E =
    4,320 a tet batch) on the card against the CPU: every scene's
    positions within 1e-12 m, and one launch a tiled batch's call."""
    s = _published_settings()
    speeds = [0.25 * (i + 1) for i in range(8)]
    xs = {}
    for dev in ("cpu", cuda_device):
        _, sw = beams.build_sweep(s, speeds, device=dev)
        ck.reset_launch_counts()
        sw.frame()
        xs[str(dev)] = sw.xs.cpu().numpy()
        counts = ck.launch_counts()
    assert counts["tet_prox"] == 6 * s.admm_iters + 3
    assert counts["tet_grad"] == 3 * s.admm_iters
    assert np.abs(xs["cuda"] - xs["cpu"]).max() <= 1e-12
