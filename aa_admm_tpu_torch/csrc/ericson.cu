// B1: exact closest point over per-query candidate triangles, first minimum.
//
// Replaces the TPU kernel aa_admm_tpu/ops/pallas_kernels.py::_ericson_kernel
// (reached through ericson_candidates_T / ericson_candidates). For each query
// i and each of its K candidate triangles it runs Ericson's closest point on
// a triangle (Real-Time Collision Detection 5.1.5: Voronoi-region tests,
// divides guarded against zero exactly as the JAX safe_div and the zero
// denom guard), and keeps the point and squared distance of the FIRST
// minimum over K: the lexicographic minimum of (sqdist, k), so ties go to
// the lowest k, the argmin rule of aa_admm_tpu/ops/closest_point.py:605.
//
// Two entries share the per-candidate test (ericson_point) and the tie rule
// (better):
//   ericson_candidates_{f32,f64}: candidates given as (9, K, Q) coordinate
//     planes (the candT cache's layout);
//   ericson_candidates_idx_{f32,f64}: candidates named by index into a
//     static triangle table, candidate k of query i being table row
//     idx[i, k / sub] * sub + k % sub. The kernel gathers its own
//     triangles, so no (Q, K, 3, 3) or (9, K, Q) candidate buffer exists.
//
// What bounds it on this card. The TPU's (9, K, Q) VMEM layout made the
// callers gather every candidate into a (Q, K, 3, 3) buffer and relay it
// into planes, about 57 MB of device traffic per 8,192 x 48 tile, for a
// kernel that reads 14 MB of it. The indexed entry's own floor is its idx
// (8 bytes per (query, subgroup)), points, the table (1.4 MB at 40k
// triangles) and outputs, so at the refresh tile it is bound by bytes
// (about 1.4 us), and at Q x K = 65,536 x 96 by operations (about 120 per
// (query, candidate) over 67 TFLOP/s f32, 11 us; -fmad=false makes each an
// instruction of its own). At those small tiles one thread per query gave
// 16-32 blocks for 132 SMs.
// What the design does about it:
//   * L lanes per query (a power of two up to 32, chosen by the wrapper so
//     that about 131k threads, four 256-thread blocks per SM, are in
//     flight), lane l taking k = l, l + L, ...; each lane keeps its own
//     first minimum, and the lanes combine by the same lexicographic rule,
//     which is associative and commutative, so the winner does not depend
//     on the order of combination.
//   * Indexed entry: the L lanes of a query are adjacent in the warp, so
//     their idx reads are coalesced, and they combine by warp shuffles.
//     The table has rows of 12 words (padded once per table by the
//     wrapper), so a triangle is three 16-byte loads (f32) or five (f64),
//     read through the read-only path; the table stays in the 50 MB L2.
//   * Plane entry: neighbouring threads take neighbouring queries for one
//     lane, so each of the nine coordinate loads is a coalesced read; the
//     lanes of a query combine through shared memory.
// Built with -fmad=false: every candidate is rounded op by op, as in the
// plain torch twin, whichever lane computes it.
//
// Layouts (row-major, contiguous): pT (3, Q) and candT (9, K, Q) planes
// [ax ay az bx by bz cx cy cz] -> qv (3, Q), dv (1, Q); p (Q, 3), tab
// (n_rows, 12), idx (Q, G) int64 -> q (Q, 3), d (Q,).

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kRowWords = 12;      // table row: 9 coordinates + 3 pad
constexpr int kNone = INT_MAX;     // a lane that has no candidate yet

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

// Closest point q on triangle t = [a b c] (9 coordinates) to (px, py, pz);
// returns the squared distance.
template <typename T>
__device__ __forceinline__ T ericson_point(T px, T py, T pz, const T* t,
                                           T& qx, T& qy, T& qz) {
  const T ax = t[0], ay = t[1], az = t[2];
  const T bxx = t[3], byy = t[4], bzz = t[5];
  const T cx = t[6], cy = t[7], cz = t[8];

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
  qx = ax + v_in * abx + w_in * acx;
  qy = ay + v_in * aby + w_in * acy;
  qz = az + v_in * abz + w_in * acz;
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
  return ex * ex + ey * ey + ez * ez;
}

// One lane's (or one combination's) first minimum so far.
template <typename T>
struct Best {
  T d, x, y, z;
  int k;
};

// True if candidate (d2, k2) beats the current (d1, k1): the lexicographic
// minimum of (sqdist, k), where an empty slot (kNone) loses to anything.
template <typename T>
__device__ __forceinline__ bool better(T d2, int k2, T d1, int k1) {
  return k2 != kNone && (k1 == kNone || d2 < d1 || (d2 == d1 && k2 < k1));
}

template <typename T>
__device__ __forceinline__ void offer(Best<T>& b, T d, int k, T x, T y, T z) {
  if (better(d, k, b.d, b.k)) { b.d = d; b.k = k; b.x = x; b.y = y; b.z = z; }
}

// Nine coordinates of table row r (12 words, 16-byte aligned), read through
// the read-only path.
__device__ __forceinline__ void load_row(const float* tab, long long r, float* t) {
  const float4* v = reinterpret_cast<const float4*>(tab + r * kRowWords);
  const float4 a = __ldg(v), b = __ldg(v + 1), c = __ldg(v + 2);
  t[0] = a.x; t[1] = a.y; t[2] = a.z; t[3] = a.w;
  t[4] = b.x; t[5] = b.y; t[6] = b.z; t[7] = b.w; t[8] = c.x;
}

__device__ __forceinline__ void load_row(const double* tab, long long r, double* t) {
  const double2* v = reinterpret_cast<const double2*>(tab + r * kRowWords);
  const double2 a = __ldg(v), b = __ldg(v + 1), c = __ldg(v + 2),
                d = __ldg(v + 3), e = __ldg(v + 4);
  t[0] = a.x; t[1] = a.y; t[2] = b.x; t[3] = b.y;
  t[4] = c.x; t[5] = c.y; t[6] = d.x; t[7] = d.y; t[8] = e.x;
}

// Indexed entry: thread t serves query t / L as lane t % L (L | 32, so the
// lanes of a query sit in one warp, adjacent).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ericson_idx_kernel(const T* __restrict__ p, const T* __restrict__ tab,
                   const long long* __restrict__ idx, T* __restrict__ q,
                   T* __restrict__ d, int G, int sub, int L, long long Q,
                   long long n_rows) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long i = t / L;
  const int lane = (int)(t % L);
  Best<T> b{T(0), T(0), T(0), T(0), kNone};
  if (i < Q) {
    const T px = p[3 * i], py = p[3 * i + 1], pz = p[3 * i + 2];
    const long long* row = idx + i * G;
    const int K = G * sub;
    for (int k = lane; k < K; k += L) {
      const int g = k / sub;
      const long long r = __ldg(row + g) * sub + (k - g * sub);
      if (r < 0 || r >= n_rows) __trap();    // as torch indexing asserts
      T tri[9], qx, qy, qz;
      load_row(tab, r, tri);
      const T sqd = ericson_point(px, py, pz, tri, qx, qy, qz);
      offer(b, sqd, k, qx, qy, qz);
    }
  }
  // Butterfly over the L lanes of each query; every thread takes part.
  for (int off = L >> 1; off > 0; off >>= 1) {
    const T d2 = __shfl_xor_sync(0xffffffffu, b.d, off);
    const int k2 = __shfl_xor_sync(0xffffffffu, b.k, off);
    const T x2 = __shfl_xor_sync(0xffffffffu, b.x, off);
    const T y2 = __shfl_xor_sync(0xffffffffu, b.y, off);
    const T z2 = __shfl_xor_sync(0xffffffffu, b.z, off);
    offer(b, d2, k2, x2, y2, z2);
  }
  if (i < Q && lane == 0) {
    q[3 * i] = b.x;
    q[3 * i + 1] = b.y;
    q[3 * i + 2] = b.z;
    d[i] = b.d;
  }
}

// Plane entry: a block serves QB = kThreads / L consecutive queries; thread
// t is lane t / QB of query t % QB.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ericson_planes_kernel(const T* __restrict__ pT, const T* __restrict__ candT,
                      T* __restrict__ qv, T* __restrict__ dv, int K, int L,
                      long long Q) {
  __shared__ Best<T> part[kThreads];
  const int QB = kThreads / L;
  const int qi = threadIdx.x % QB, lane = threadIdx.x / QB;
  const long long i = (long long)blockIdx.x * QB + qi;
  Best<T> b{T(0), T(0), T(0), T(0), kNone};
  if (i < Q) {
    const T px = pT[i], py = pT[Q + i], pz = pT[2 * Q + i];
    const long long plane = (long long)K * Q;
    for (int k = lane; k < K; k += L) {
      const T* c = candT + (long long)k * Q + i;
      T tri[9], qx, qy, qz;
#pragma unroll
      for (int j = 0; j < 9; ++j) tri[j] = c[j * plane];
      const T sqd = ericson_point(px, py, pz, tri, qx, qy, qz);
      offer(b, sqd, k, qx, qy, qz);
    }
  }
  part[threadIdx.x] = b;
  __syncthreads();
  if (lane == 0 && i < Q) {
    for (int l = 1; l < L; ++l) {
      const Best<T>& o = part[l * QB + qi];
      offer(b, o.d, o.k, o.x, o.y, o.z);
    }
    qv[i] = b.x;
    qv[Q + i] = b.y;
    qv[2 * Q + i] = b.z;
    dv[i] = b.d;
  }
}

long long blocks_for(long long threads) {
  return (threads + kThreads - 1) / kThreads;
}

template <typename T>
int launch_planes(const void* pT, const void* candT, void* qv, void* dv, int K,
                  int L, long long Q, void* stream) {
  if (L < 1 || L > 32 || (L & (L - 1)) != 0) return (int)cudaErrorInvalidValue;
  const long long qb = kThreads / L;
  ericson_planes_kernel<T><<<(unsigned)((Q + qb - 1) / qb), kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const T*)pT, (const T*)candT, (T*)qv, (T*)dv, K, L, Q);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_idx(const void* p, const void* tab, const void* idx, void* q,
               void* d, int G, int sub, int L, long long Q, long long n_rows,
               void* stream) {
  if (L < 1 || L > 32 || (L & (L - 1)) != 0) return (int)cudaErrorInvalidValue;
  ericson_idx_kernel<T><<<(unsigned)blocks_for(Q * L), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const T*)p, (const T*)tab, (const long long*)idx, (T*)q, (T*)d, G, sub,
      L, Q, n_rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ericson_candidates_f32(const void* pT, const void* candT, void* qv,
                           void* dv, int K, int L, long long Q, void* stream) {
  return launch_planes<float>(pT, candT, qv, dv, K, L, Q, stream);
}

int ericson_candidates_f64(const void* pT, const void* candT, void* qv,
                           void* dv, int K, int L, long long Q, void* stream) {
  return launch_planes<double>(pT, candT, qv, dv, K, L, Q, stream);
}

int ericson_candidates_idx_f32(const void* p, const void* tab, const void* idx,
                               void* q, void* d, int G, int sub, int L,
                               long long Q, long long n_rows, void* stream) {
  return launch_idx<float>(p, tab, idx, q, d, G, sub, L, Q, n_rows, stream);
}

int ericson_candidates_idx_f64(const void* p, const void* tab, const void* idx,
                               void* q, void* d, int G, int sub, int L,
                               long long Q, long long n_rows, void* stream) {
  return launch_idx<double>(p, tab, idx, q, d, G, sub, L, Q, n_rows, stream);
}

}  // extern "C"
