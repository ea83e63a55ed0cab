// B1: exact closest point over per-query candidate triangles, first minimum.
//
// Replaces the TPU kernel aa_admm_tpu/ops/pallas_kernels.py::_ericson_kernel
// (reached through ericson_candidates_T / ericson_candidates). For each query
// i and each of its K candidate triangles it runs Ericson's closest point on
// a triangle (Real-Time Collision Detection 5.1.5: Voronoi-region tests,
// divides guarded against zero exactly as the JAX safe_div and the zero
// denom guard), and keeps the point and squared distance of the FIRST
// minimum over K (strict < running minimum: ties go to the lowest k, the
// argmin rule of aa_admm_tpu/ops/closest_point.py:605).
//
// What bounds it on the card: bytes. It reads 9*K*Q coordinates once and
// does ~100 flops per (query, candidate), about 3 flops per byte at float32,
// far below the H100's ridge point, so the floor is 36*K*Q bytes over
// 3.35 TB/s (K=96, Q=65,536: 0.23 GB, about 68 us).
// What the design does about it: one thread per query walks its K
// candidates in registers and writes only the winner; the (9, K, Q) layout
// keeps queries contiguous, so each of the nine loads of a candidate is a
// fully coalesced warp-wide read, and no (Q, K) intermediate ever touches
// device memory.
//
// Layout: pT (3, Q); candT (9, K, Q) planes [ax ay az bx by bz cx cy cz];
// outputs qv (3, Q), dv (1, Q). Row-major, contiguous.

#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ T safe_div(T n, T d) {
  return n / (d == T(0) ? T(1) : d);
}

template <typename T>
__device__ __forceinline__ T clip01(T v) {
  // jnp.clip(v, 0, 1) = min(max(v, 0), 1); NaN passes through.
  v = v < T(0) ? T(0) : v;
  return v > T(1) ? T(1) : v;
}

template <typename T>
__global__ void ericson_kernel(const T* __restrict__ pT,
                               const T* __restrict__ candT,
                               T* __restrict__ qv, T* __restrict__ dv,
                               int K, long long Q) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const T px = pT[i], py = pT[Q + i], pz = pT[2 * Q + i];
  const long long plane = (long long)K * Q;
  T best = T(0), bx = T(0), by = T(0), bz = T(0);
  for (int k = 0; k < K; ++k) {
    const T* c = candT + (long long)k * Q + i;
    const T ax = c[0], ay = c[plane], az = c[2 * plane];
    const T bxx = c[3 * plane], byy = c[4 * plane], bzz = c[5 * plane];
    const T cx = c[6 * plane], cy = c[7 * plane], cz = c[8 * plane];

    const T abx = bxx - ax, aby = byy - ay, abz = bzz - az;
    const T acx = cx - ax, acy = cy - ay, acz = cz - az;
    const T apx = px - ax, apy = py - ay, apz = pz - az;
    const T bpx = px - bxx, bpy = py - byy, bpz = pz - bzz;
    const T cpx = px - cx, cpy = py - cy, cpz = pz - cz;

    const T d1 = abx * apx + aby * apy + abz * apz;
    const T d2 = acx * apx + acy * apy + acz * apz;
    const T d3 = abx * bpx + aby * bpy + abz * bpz;
    const T d4 = acx * bpx + acy * bpy + acz * bpz;
    const T d5 = abx * cpx + aby * cpy + abz * cpz;
    const T d6 = acx * cpx + acy * cpy + acz * cpz;

    const T va = d3 * d6 - d5 * d4;
    const T vb = d5 * d2 - d1 * d6;
    const T vc = d1 * d4 - d3 * d2;

    const bool in_a = (d1 <= T(0)) && (d2 <= T(0));
    const bool in_b = (d3 >= T(0)) && (d4 <= d3);
    const bool in_c = (d6 >= T(0)) && (d5 <= d6);
    const bool on_ab = (vc <= T(0)) && (d1 >= T(0)) && (d3 <= T(0));
    const bool on_ac = (vb <= T(0)) && (d2 >= T(0)) && (d6 <= T(0));
    const bool on_bc = (va <= T(0)) && (d4 - d3 >= T(0)) && (d5 - d6 >= T(0));

    const T v_ab = clip01(safe_div(d1, d1 - d3));
    const T w_ac = clip01(safe_div(d2, d2 - d6));
    const T w_bc = clip01(safe_div(d4 - d3, (d4 - d3) + (d5 - d6)));
    const T sum = va + vb + vc;
    const T denom = sum == T(0) ? T(1) : sum;
    const T v_in = vb / denom;
    const T w_in = vc / denom;

    // Region select in the JAX order: later regions override earlier ones.
    T qx = ax + v_in * abx + w_in * acx;
    T qy = ay + v_in * aby + w_in * acy;
    T qz = az + v_in * abz + w_in * acz;
    if (on_bc) {
      qx = bxx + w_bc * (cx - bxx);
      qy = byy + w_bc * (cy - byy);
      qz = bzz + w_bc * (cz - bzz);
    }
    if (on_ac) { qx = ax + w_ac * acx; qy = ay + w_ac * acy; qz = az + w_ac * acz; }
    if (on_ab) { qx = ax + v_ab * abx; qy = ay + v_ab * aby; qz = az + v_ab * abz; }
    if (in_c) { qx = cx; qy = cy; qz = cz; }
    if (in_b) { qx = bxx; qy = byy; qz = bzz; }
    if (in_a) { qx = ax; qy = ay; qz = az; }

    const T ex = px - qx, ey = py - qy, ez = pz - qz;
    const T sqd = ex * ex + ey * ey + ez * ez;
    if (k == 0 || sqd < best) {
      best = sqd; bx = qx; by = qy; bz = qz;
    }
  }
  qv[i] = bx;
  qv[Q + i] = by;
  qv[2 * Q + i] = bz;
  dv[i] = best;
}

template <typename T>
int launch(const void* pT, const void* candT, void* qv, void* dv, int K,
           long long Q, void* stream) {
  const int threads = 256;
  const long long blocks = (Q + threads - 1) / threads;
  ericson_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)pT, (const T*)candT, (T*)qv, (T*)dv, K, Q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ericson_candidates_f32(const void* pT, const void* candT, void* qv,
                           void* dv, int K, long long Q, void* stream) {
  return launch<float>(pT, candT, qv, dv, K, Q, stream);
}

int ericson_candidates_f64(const void* pT, const void* candT, void* qv,
                           void* dv, int K, long long Q, void* stream) {
  return launch<double>(pT, candT, qv, dv, K, Q, stream);
}

}  // extern "C"
