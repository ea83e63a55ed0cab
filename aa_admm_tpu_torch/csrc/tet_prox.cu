// The physics local step of a tet batch: the prox and the energy gradient
// of the linear (corotated), NeoHookean and StVK materials, one launch a
// call, one thread an element.
//
// Replaces no TPU kernel: the JAX package leaves this step to XLA, which
// fuses it (aa_admm_tpu/ops/prox.py, aa_admm_tpu/ops/svd3.py). In the port
// the same batched math is a chain of torch elementwise ops (ops/prox.py,
// ops/svd3.py, kept as the twins): 1,100-3,300 kernels a call on the beams
// scene, each over a few hundred elements, so each pays the card's fixed
// cost of a launch. The entries here compute, for each element, exactly
// what the twins compute for it, step for step:
//   * svd3x3: Jacobi eigendecomposition of F^T F with 6 cyclic sweeps and
//     _jacobi_rotation's guards (eigh3x3), _sort_desc3's sorting network,
//     then U by Gram-Schmidt with _orthonormal_u's per-column fallbacks
//     (first-on-ties _least_axis);
//   * linear: P = U diag(1, 1, s) V^T, s = -1 where det(F) < 1e-16, and
//     0.5 (P + F); its gradient k vol (F - U V^T);
//   * NeoHookean and StVK: _signed_svd3x3, then _sigma_newton (12 damped
//     Newton steps with the Levenberg term and the four step scales, each
//     kept where it is finite and strictly lower, then 2 polish steps kept
//     where they shrink the gradient) and U diag(s) V^T; their gradients in
//     closed form with the twins' 1e-300 clamps.
// Every sum and product is written in the twin's order, and the build uses
// -fmad=false, so each op rounds as the twin's does; only log, the norms'
// and cross products' contractions on the host and the sign of a zero may
// differ in the last bit. The polished Newton settles s to roundoff
// (ops/prox.py), so those bits do not grow.
//
// What bounds it on this card. A call moves 9 words in and 9 out an
// element, plus 3 or 4 parameters: about 95 KB at E = 540 in f64, 0.03 us
// at 3.35 TB/s. The bound is each thread's chain of dependent operations:
// 18 Jacobi rotations (each with two divides and two square roots), the
// Gram-Schmidt, and for the hyperelastic materials 14 Newton solves with
// their logs, a few thousand f64 instructions in a row.
// What the design does about it:
//   * One thread an element, everything in registers (3x3 arrays indexed
//     only by unrolled constants), so a call is one launch and the only
//     memory traffic is the coalesced plane-form reads and writes.
//   * Blocks of 32 threads (one warp), the grid sized from E: at E = 540 the
//     17 warps land on 17 SMs rather than sharing a few, so each warp's
//     dependent chain runs alone on its SM's schedulers; the tiled 8-scene
//     batches (E = 4,320) give 135 blocks, about one an SM.
//
// Layouts (row-major, contiguous): the block in plane form (9, E), plane
// c = 3 i + j holding F[i][j] of every element (element e at c E + e);
// mu, lam, k, vol (E,) -> out (9, E) in the same plane form.
//
// Without nvcc (__CUDACC__ undefined) the launchers and the C entries drop
// out, and the device math and kernel bodies compile as host C++ once
// __device__, __global__ and the thread indices are defined:
// tests/test_torch_tet_kernels.py runs every element through them with g++
// against the twins.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kThreads = 32;
constexpr int kSweeps = 6;          // svd3._JACOBI_SWEEPS
constexpr int kNewtonIters = 12;    // prox._NEWTON_ITERS
constexpr int kPolishIters = 2;     // prox._POLISH_ITERS

enum Kind { kLinear = 0, kNeoHookean = 1, kStVK = 2 };

__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double abs_(double x) { return fabs(x); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }

// svd3._tiny's two values: the guard of divides and clamps, and the
// relative tolerance of _orthonormal_u's fallbacks.
template <typename T>
struct Tiny;
template <>
struct Tiny<double> {
  static __device__ __forceinline__ double guard() { return 1e-300; }
  static __device__ __forceinline__ double rel() { return 1e-12; }
};
template <>
struct Tiny<float> {
  static __device__ __forceinline__ float guard() { return 1e-30f; }
  static __device__ __forceinline__ float rel() { return 1e-5f; }
};

// torch.sign: (0 < x) - (x < 0), so +0 for either zero and for NaN.
template <typename T>
__device__ __forceinline__ T sgn(T x) {
  return T(int(T(0) < x) - int(x < T(0)));
}

// torch.clamp_min(x, lo): NaN passes through.
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return x < lo ? lo : x;
}

// The twins' scalar literals (1e-300, 1e-16, ...) are cast to the tensor's
// dtype, as torch casts a Python scalar: T(1e-300) is 0 in float.

template <typename T>
__device__ __forceinline__ void load9(const T* __restrict__ p, long long e,
                                      long long E, T (&a)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) a[i][j] = p[(3 * i + j) * E + e];
}

template <typename T>
__device__ __forceinline__ void store9(T* __restrict__ p, long long e,
                                       long long E, const T (&a)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) p[(3 * i + j) * E + e] = a[i][j];
}

// mat3.det.
template <typename T>
__device__ __forceinline__ T det3(const T (&a)[3][3]) {
  return a[0][0] * (a[1][1] * a[2][2] - a[1][2] * a[2][1])
       - a[0][1] * (a[1][0] * a[2][2] - a[1][2] * a[2][0])
       + a[0][2] * (a[1][0] * a[2][1] - a[1][1] * a[2][0]);
}

// mat3.adjugate's entry (i, j): its rolled rows give a[(j+1)%3][(i+1)%3]
// a[(j+2)%3][(i+2)%3] - a[(j+1)%3][(i+2)%3] a[(j+2)%3][(i+1)%3].
template <typename T>
__device__ __forceinline__ T adj3(const T (&a)[3][3], int i, int j) {
  const int i1 = (i + 1) % 3, i2 = (i + 2) % 3;
  const int j1 = (j + 1) % 3, j2 = (j + 2) % 3;
  return a[j1][i1] * a[j2][i2] - a[j1][i2] * a[j2][i1];
}

// mat3.solve: a^-1 b by the adjugate, a zero determinant divided as 1e-300.
template <typename T>
__device__ __forceinline__ void solve3(const T (&a)[3][3], const T (&b)[3],
                                       T (&x)[3]) {
  const T d = det3(a);
  const T safe = d == T(0) ? T(1e-300) : d;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    x[i] = (adj3(a, i, 0) * b[0] + adj3(a, i, 1) * b[1]
            + adj3(a, i, 2) * b[2]) / safe;
}

template <typename T>
__device__ __forceinline__ T dot3(const T (&a)[3], const T (&b)[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// svd3._norm (torch.linalg.vector_norm over 3 entries).
template <typename T>
__device__ __forceinline__ T norm3(const T (&a)[3]) {
  return sqrt_(a[0] * a[0] + a[1] * a[1] + a[2] * a[2]);
}

// ---------------------------------------------------------------------------
// svd3.svd3x3 (method "jacobi")
// ---------------------------------------------------------------------------

// svd3._jacobi_rotation.
template <typename T>
__device__ __forceinline__ void jacobi_rotation(T app, T aqq, T apq, T& c,
                                                T& s) {
  const T small = Tiny<T>::guard();
  const T denom = T(2) * apq;
  const T tau = (aqq - app) / (abs_(denom) < small ? small : denom);
  T t = sgn(tau) / (abs_(tau) + sqrt_(T(1) + tau * tau));
  t = abs_(apq) < small ? T(0) : t;
  c = T(1) / sqrt_(T(1) + t * t);
  s = t * c;
}

// svd3._apply_jacobi on the symmetric A (both halves kept) and V.
template <int P, int Q, typename T>
__device__ __forceinline__ void apply_jacobi(T (&A)[3][3], T (&V)[3][3]) {
  constexpr int R = 3 - P - Q;
  T c, s;
  jacobi_rotation(A[P][P], A[Q][Q], A[P][Q], c, s);
  const T app = A[P][P], aqq = A[Q][Q], apq = A[P][Q];
  const T apr = A[P][R], aqr = A[Q][R];
  A[P][P] = c * c * app - T(2) * c * s * apq + s * s * aqq;
  A[Q][Q] = s * s * app + T(2) * c * s * apq + c * c * aqq;
  A[P][Q] = A[Q][P] = T(0);
  A[P][R] = A[R][P] = c * apr - s * aqr;
  A[Q][R] = A[R][Q] = s * apr + c * aqr;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T vp = V[i][P], vq = V[i][Q];
    V[i][P] = c * vp - s * vq;
    V[i][Q] = s * vp + c * vq;
  }
}

// One compare-swap of svd3._sort_desc3: eigenpairs I and J swap where
// w[I] < w[J].
template <int I, int J, typename T>
__device__ __forceinline__ void sort_pair(T (&w)[3], T (&V)[3][3]) {
  const bool swap = w[I] < w[J];
  const T wi = w[I], wj = w[J];
  w[I] = swap ? wj : wi;
  w[J] = swap ? wi : wj;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const T a = V[r][I], b = V[r][J];
    V[r][I] = swap ? b : a;
    V[r][J] = swap ? a : b;
  }
}

// svd3._orthonormal_u's fallback normalization: v / max(|v|, tiny).
template <typename T>
__device__ __forceinline__ void unit3(T (&v)[3]) {
  const T n = clamp_min(norm3(v), Tiny<T>::guard());
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = v[i] / n;
}

// svd3._orthonormal_u: U from F V = U diag(S), columns u0, u1, u2.
template <typename T>
__device__ __forceinline__ void orthonormal_u(const T (&F)[3][3],
                                              const T (&V)[3][3], T S0,
                                              T (&U)[3][3]) {
  const T tiny = Tiny<T>::guard();
  T FV[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      FV[i][j] = F[i][0] * V[0][j] + F[i][1] * V[1][j] + F[i][2] * V[2][j];
  const T tol = clamp_min(S0, T(1)) * Tiny<T>::rel();

  T u0[3], c0[3] = {FV[0][0], FV[1][0], FV[2][0]};
  const T n0 = norm3(c0);
  const T d0 = clamp_min(n0, tiny);
#pragma unroll
  for (int i = 0; i < 3; ++i) u0[i] = n0 > tol ? c0[i] / d0 : T(i == 0);

  T u1[3], c1[3] = {FV[0][1], FV[1][1], FV[2][1]};
  const T p1 = dot3(c1, u0);
#pragma unroll
  for (int i = 0; i < 3; ++i) c1[i] = c1[i] - p1 * u0[i];
  const T n1 = norm3(c1);
  // _least_axis(u0): the axis of u0's smallest |component|, first on ties
  // (torch.argmin).
  const T a0 = abs_(u0[0]), a1 = abs_(u0[1]), a2 = abs_(u0[2]);
  int least = a1 < a0 ? 1 : 0;
  least = a2 < (least == 1 ? a1 : a0) ? 2 : least;
  T alt1[3] = {T(least == 0), T(least == 1), T(least == 2)};
  const T pa = dot3(alt1, u0);
#pragma unroll
  for (int i = 0; i < 3; ++i) alt1[i] = alt1[i] - pa * u0[i];
  unit3(alt1);
  const T d1 = clamp_min(n1, tiny);
#pragma unroll
  for (int i = 0; i < 3; ++i) u1[i] = n1 > tol ? c1[i] / d1 : alt1[i];

  T c2[3] = {FV[0][2], FV[1][2], FV[2][2]};
  const T p20 = dot3(c2, u0), p21 = dot3(c2, u1);
#pragma unroll
  for (int i = 0; i < 3; ++i) c2[i] = c2[i] - p20 * u0[i] - p21 * u1[i];
  const T n2 = norm3(c2);
  // torch.linalg.cross(u0, u1)
  const T alt2[3] = {u0[1] * u1[2] - u0[2] * u1[1],
                     u0[2] * u1[0] - u0[0] * u1[2],
                     u0[0] * u1[1] - u0[1] * u1[0]};
  const T d2 = clamp_min(n2, tiny);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    U[i][0] = u0[i];
    U[i][1] = u1[i];
    U[i][2] = n2 > tol ? c2[i] / d2 : alt2[i];
  }
}

// svd3.svd3x3: F = U diag(S) V^T, S descending and >= 0.
template <typename T>
__device__ __forceinline__ void svd3x3(const T (&F)[3][3], T (&U)[3][3],
                                       T (&S)[3], T (&V)[3][3]) {
  T A[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      A[i][j] = F[0][i] * F[0][j] + F[1][i] * F[1][j] + F[2][i] * F[2][j];
      V[i][j] = T(i == j);
    }
#pragma unroll 1
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    apply_jacobi<0, 1>(A, V);
    apply_jacobi<0, 2>(A, V);
    apply_jacobi<1, 2>(A, V);
  }
  T w[3] = {A[0][0], A[1][1], A[2][2]};
  sort_pair<0, 1>(w, V);
  sort_pair<1, 2>(w, V);
  sort_pair<0, 1>(w, V);
#pragma unroll
  for (int i = 0; i < 3; ++i) S[i] = sqrt_(clamp_min(w[i], T(0)));
  orthonormal_u(F, V, S[0], U);
}

// prox._signed_svd3x3: V made a rotation by its last column, U likewise,
// the sign carried by S[2].
template <typename T>
__device__ __forceinline__ void signed_svd3x3(const T (&F)[3][3],
                                              T (&U)[3][3], T (&S)[3],
                                              T (&V)[3][3]) {
  svd3x3(F, U, S, V);
  const T detU = det3(U), detV = det3(V);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    V[i][2] = V[i][2] * detV;
    U[i][2] = U[i][2] * detU;
  }
  S[2] = S[2] * (detU * detV);
}

// mat3.usv: U diag(s) V^T.
template <typename T>
__device__ __forceinline__ void usv(const T (&U)[3][3], const T (&s)[3],
                                    const T (&V)[3][3], T (&out)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[i][j] = U[i][0] * s[0] * V[j][0] + U[i][1] * s[1] * V[j][1]
                + U[i][2] * s[2] * V[j][2];
}

// ---------------------------------------------------------------------------
// prox._sigma_newton and its two materials
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T sqdist3(const T (&s)[3], const T (&sv)[3]) {
  const T d0 = s[0] - sv[0], d1 = s[1] - sv[1], d2 = s[2] - sv[2];
  return d0 * d0 + d1 * d1 + d2 * d2;
}

template <typename T>
struct NeoHookean {
  // prox._nh_grad_hess
  static __device__ __forceinline__ void grad_hess(
      const T (&s)[3], const T (&sv)[3], T mu, T lam, T k, T (&g)[3],
      T (&H)[3][3]) {
    const T eps = T(1e-12);
    T safe[3], inv[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      safe[i] = abs_(s[i]) < eps
          ? sgn(s[i]) * eps + T(s[i] == T(0)) * eps : s[i];
      inv[i] = T(1) / safe[i];
    }
    const T J = safe[0] * safe[1] * safe[2];
    const T L = log_(abs_(J));
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      g[i] = mu * (s[i] - inv[i]) + lam * L * inv[i] + k * (s[i] - sv[i]);
#pragma unroll
      for (int j = 0; j < 3; ++j) H[i][j] = lam * inv[i] * inv[j];
      H[i][i] = H[i][i]
          + (mu * (T(1) + inv[i] * inv[i]) - lam * L * inv[i] * inv[i] + k);
    }
  }

  // prox._nh_value
  static __device__ __forceinline__ T value(const T (&s)[3], const T (&sv)[3],
                                            T mu, T lam, T k) {
    const T J = abs_(s[0] * s[1] * s[2]);
    const T L = log_(clamp_min(J, T(1e-300)));
    return T(0.5) * mu * (dot3(s, s) - T(2) * L - T(3))
         + T(0.5) * lam * L * L + T(0.5) * k * sqdist3(s, sv);
  }
};

template <typename T>
struct StVK {
  // prox._stvk_grad_hess
  static __device__ __forceinline__ void grad_hess(
      const T (&s)[3], const T (&sv)[3], T mu, T lam, T k, T (&g)[3],
      T (&H)[3][3]) {
    T e[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) e[i] = T(0.5) * (s[i] * s[i] - T(1));
    const T tre = e[0] + e[1] + e[2];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      g[i] = (T(2) * mu * e[i] + lam * tre) * s[i] + k * (s[i] - sv[i]);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const T ss = s[i] * s[j];
        H[i][j] = lam * ss + T(2) * mu * ss * T(i == j);
      }
      H[i][i] = H[i][i] + (T(2) * mu * e[i] + lam * tre + k);
    }
  }

  // prox._stvk_value
  static __device__ __forceinline__ T value(const T (&s)[3], const T (&sv)[3],
                                            T mu, T lam, T k) {
    T e[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) e[i] = T(0.5) * (s[i] * s[i] - T(1));
    const T tre = e[0] + e[1] + e[2];
    return mu * dot3(e, e) + T(0.5) * lam * (tre * tre)
         + T(0.5) * k * sqdist3(s, sv);
  }
};

// prox._sigma_newton: 12 damped Newton steps on the singular values, each
// step scaled by the first of (1, 0.5, 0.25, 0.0625) whose value is finite
// and lower than the best so far (branch-free selects, in that order),
// then 2 undamped steps kept where they shrink the squared gradient.
template <typename M, typename T>
__device__ __forceinline__ void sigma_newton(const T (&sv)[3], T mu, T lam,
                                             T k, T (&s)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) s[i] = sv[i];
#pragma unroll 1
  for (int it = 0; it < kNewtonIters; ++it) {
    T g[3], H[3][3], step[3];
    M::grad_hess(s, sv, mu, lam, k, g, H);
    const T reg = T(1e-9) * clamp_min(abs_(H[0][0] + H[1][1] + H[2][2]),
                                      T(1));
#pragma unroll
    for (int i = 0; i < 3; ++i) H[i][i] = H[i][i] + reg;
    solve3(H, g, step);
    T best[3] = {s[0], s[1], s[2]};
    T best_f = M::value(s, sv, mu, lam, k);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const T alpha = a == 0 ? T(1) : a == 1 ? T(0.5) : a == 2 ? T(0.25)
                                                          : T(0.0625);
      T cand[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) cand[i] = s[i] - alpha * step[i];
      const T fc = M::value(cand, sv, mu, lam, k);
      const bool ok = isfinite(fc) && fc < best_f;
#pragma unroll
      for (int i = 0; i < 3; ++i) best[i] = ok ? cand[i] : best[i];
      best_f = ok ? fc : best_f;
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) s[i] = best[i];
  }
#pragma unroll 1
  for (int it = 0; it < kPolishIters; ++it) {
    T g[3], H[3][3], step[3], cand[3], gc[3], Hc[3][3];
    M::grad_hess(s, sv, mu, lam, k, g, H);
    solve3(H, g, step);
#pragma unroll
    for (int i = 0; i < 3; ++i) cand[i] = s[i] - step[i];
    M::grad_hess(cand, sv, mu, lam, k, gc, Hc);
    const T gn = dot3(g, g), gcn = dot3(gc, gc);
    const bool ok = isfinite(gcn) && gcn < gn;
#pragma unroll
    for (int i = 0; i < 3; ++i) s[i] = ok ? cand[i] : s[i];
  }
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

// prox.prox_tet_linear / prox_tet_neohookean / prox_tet_stvk.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
tet_prox_kernel(const T* __restrict__ v, const T* __restrict__ mu,
                const T* __restrict__ lam, const T* __restrict__ kk,
                T* __restrict__ out, long long E) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= E) return;
  T F[3][3], U[3][3], S[3], V[3][3], Z[3][3];
  load9(v, e, E, F);
  if (K == kLinear) {
    const T s3 = det3(F) < T(1e-16) ? T(-1) : T(1);
    svd3x3(F, U, S, V);
    const T s[3] = {T(1), T(1), s3};
    usv(U, s, V, Z);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) Z[i][j] = T(0.5) * (Z[i][j] + F[i][j]);
  } else {
    signed_svd3x3(F, U, S, V);
    T s[3];
    if (K == kNeoHookean)
      sigma_newton<NeoHookean<T>>(S, mu[e], lam[e], kk[e], s);
    else
      sigma_newton<StVK<T>>(S, mu[e], lam[e], kk[e], s);
    usv(U, s, V, Z);
  }
  store9(out, e, E, Z);
}

// prox.grad_tet_linear / grad_tet_neohookean / grad_tet_stvk.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
tet_grad_kernel(const T* __restrict__ z, const T* __restrict__ mu,
                const T* __restrict__ lam, const T* __restrict__ kk,
                const T* __restrict__ vol, T* __restrict__ out, long long E) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= E) return;
  T F[3][3], G[3][3];
  load9(z, e, E, F);
  if (K == kLinear) {
    // k vol (F - U V^T)
    T U[3][3], S[3], V[3][3];
    svd3x3(F, U, S, V);
    const T kv = kk[e] * vol[e];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        G[i][j] = kv * (F[i][j] - (U[i][0] * V[j][0] + U[i][1] * V[j][1]
                                   + U[i][2] * V[j][2]));
  } else if (K == kNeoHookean) {
    // vol (mu (F - F^-T) + lam log(J) F^-T)
    const T J = det3(F);
    const T safe = J == T(0) ? T(1e-300) : J;
    const T logJ = log_(clamp_min(J, T(1e-300)));
    const T m = mu[e], ll = lam[e] * logJ, w = vol[e];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const T finvT = adj3(F, j, i) / safe;
        G[i][j] = w * (m * (F[i][j] - finvT) + ll * finvT);
      }
  } else {
    // vol F (2 mu E + lam tr(E) I), E = (F^T F - I) / 2
    T Es[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        Es[i][j] = T(0.5) * ((F[0][i] * F[0][j] + F[1][i] * F[1][j]
                              + F[2][i] * F[2][j]) - T(i == j));
    const T trE = Es[0][0] + Es[1][1] + Es[2][2];
    const T m2 = T(2) * mu[e], lt = lam[e] * trE, w = vol[e];
    T Mx[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) Mx[i][j] = m2 * Es[i][j] + lt * T(i == j);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        G[i][j] = w * (F[i][0] * Mx[0][j] + F[i][1] * Mx[1][j]
                       + F[i][2] * Mx[2][j]);
  }
  store9(out, e, E, G);
}

#ifdef __CUDACC__
unsigned blocks_for(long long E) {
  return (unsigned)((E + kThreads - 1) / kThreads);
}

template <typename T, int K>
int launch_prox(const void* v, const void* mu, const void* lam, const void* k,
                void* out, long long E, void* stream) {
  if (E <= 0) return (int)cudaSuccess;
  tet_prox_kernel<T, K><<<blocks_for(E), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)v, (const T*)mu, (const T*)lam, (const T*)k, (T*)out, E);
  return (int)cudaGetLastError();
}

template <typename T, int K>
int launch_grad(const void* z, const void* mu, const void* lam, const void* k,
                const void* vol, void* out, long long E, void* stream) {
  if (E <= 0) return (int)cudaSuccess;
  tet_grad_kernel<T, K><<<blocks_for(E), kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)z, (const T*)mu, (const T*)lam, (const T*)k, (const T*)vol,
      (T*)out, E);
  return (int)cudaGetLastError();
}
#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__
extern "C" {

#define TET_ENTRIES(KIND, K)                                                  \
  int tet_prox_##KIND##_f32(const void* v, const void* mu, const void* lam,   \
                            const void* k, void* out, long long E,            \
                            void* stream) {                                   \
    return launch_prox<float, K>(v, mu, lam, k, out, E, stream);              \
  }                                                                           \
  int tet_prox_##KIND##_f64(const void* v, const void* mu, const void* lam,   \
                            const void* k, void* out, long long E,            \
                            void* stream) {                                   \
    return launch_prox<double, K>(v, mu, lam, k, out, E, stream);             \
  }                                                                           \
  int tet_grad_##KIND##_f32(const void* z, const void* mu, const void* lam,   \
                            const void* k, const void* vol, void* out,        \
                            long long E, void* stream) {                      \
    return launch_grad<float, K>(z, mu, lam, k, vol, out, E, stream);         \
  }                                                                           \
  int tet_grad_##KIND##_f64(const void* z, const void* mu, const void* lam,   \
                            const void* k, const void* vol, void* out,        \
                            long long E, void* stream) {                      \
    return launch_grad<double, K>(z, mu, lam, k, vol, out, E, stream);        \
  }

TET_ENTRIES(linear, kLinear)
TET_ENTRIES(neohookean, kNeoHookean)
TET_ENTRIES(stvk, kStVK)

#undef TET_ENTRIES

}  // extern "C"
#endif  // __CUDACC__
