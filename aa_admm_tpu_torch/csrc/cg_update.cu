// B2 cg_update1 and B3 cg_update2: the vector halves of a CG iteration on
// (n, c) vectors, c <= 4 columns solved together (per-column alpha/beta,
// frozen columns).
//
// Replace the TPU kernels aa_admm_tpu/ops/pallas_kernels.py::_cg_k1 (via
// cg_update1) and ::_cg_k2 (via cg_update2). The TPU kernels were one block
// over the whole vector in band layout. On the GPU alpha (beta) needs the
// full column dot before any element of x, r (p) may change, which is a
// reduction across all blocks.
//
// alpha = rz / pAp (pAp == 0 divides by 1), 0 for a frozen column
// (rr_prev <= thresh); beta = rz_new / rz_old (rz_old == 0 divides by 1),
// 0 for a frozen column — pcg's semantics (aa_admm_tpu/solver/linear.py).
//
// What bounds them on this card: bytes. B2 must read p, Ap, x, r and write
// x, r (6*n*c words); B3 must read r, z, p and write p (4*n*c words), with
// about one flop per byte: at the main path's n = 230,400, c = 3 that is
// 5.0 us and 3.3 us at 3.35 TB/s, so each launch, and each grid-wide
// synchronisation (about 1.2 us, measured by tools/port_kernel_variants.py),
// costs a good part of the work.
//
// B2, one launch (it was three: partial dots, update, final sum):
//   1. the grid is the blocks the card holds at once, at most one
//      256-thread block per SM (cg_update1_max_blocks: the occupancy API
//      times the SMs); fewer blocks meet sooner at the barrier, and the
//      size is fixed for a card and n, so the reduction order is fixed;
//   2. a thread owns 4-row chunks of the flat (n * c) vectors, moved as
//      16-byte loads and stores; it keeps its chunks of p and Ap in
//      registers (up to two chunks; beyond that it reads them again after
//      the barrier) and the block writes its partial p.Ap;
//   3. a grid-wide barrier: an arrival counter that only grows (each launch
//      adds one per block, so a launch waits for the next multiple of the
//      grid size), which also holds under CUDA-graph replay;
//   4. every block reduces the partials in one fixed order, forms alpha,
//      reads x and r, updates them with p and Ap from its registers and
//      writes its partial r.r;
//   5. the last block to finish, known from an integer ticket after a
//      __threadfence(), reduces the r.r partials in the same fixed order.
//   No float atomics: f32 CG is bit-reproducible run to run. The scratch
//   (partials, the two counters) belongs to the wrapper, which keeps one
//   set per (device, dtype, c, grid) for calls ordered on one stream.
// B3 (not yet redesigned): a partial-sum launch, then an update launch in
// which every block reduces the partials in one fixed order, forms beta
// and updates p = z + beta p in place; block 0 writes rz_new.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // B3
constexpr int kThreads1 = 256;      // B2
constexpr int kMaxBlocksPerSm1 = 1;

// Sum v[0..C) over the block in a fixed order (a shuffle tree within each
// warp, then thread 0 adds the warps' sums in warp order); the total is
// returned in out[] of every thread.
template <typename T, int C, int NT>
__device__ void block_sum(const T v[C], T out[C]) {
  constexpr int kWarps = NT / 32;
  __shared__ T warp_sums[C][kWarps];
  __shared__ T total[C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    T s = v[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) warp_sums[j][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      T s = warp_sums[j][0];
      for (int w = 1; w < kWarps; ++w) s += warp_sums[j][w];
      total[j] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < C; ++j) out[j] = total[j];
  __syncthreads();
}

// Reduce partials (nb, C) to (C,) in a fixed order, identically in every
// block that calls it. Partials written by other blocks of the same launch
// (kSameLaunch) are read through L2 (__ldcg), never through the incoherent
// L1; those of an earlier launch through the read-only path.
template <typename T, int C, int NT, bool kSameLaunch>
__device__ void reduce_partials(const T* partials, int nb, T out[C]) {
  T v[C];
#pragma unroll
  for (int j = 0; j < C; ++j) v[j] = T(0);
  for (int b = threadIdx.x; b < nb; b += NT) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const T* a = partials + b * C + j;
      v[j] += kSameLaunch ? __ldcg(a) : __ldg(a);
    }
  }
  block_sum<T, C, NT>(v, out);
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.global.acquire.gpu.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Grid-wide barrier on a counter that only grows: each launch adds nb (one
// per block), so the launch's arrivals end at the next multiple of nb.
__device__ void grid_barrier(unsigned long long* count, unsigned nb) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned long long old = atomicAdd(count, 1ULL);
    const unsigned long long target = (old / nb + 1) * nb;
    while (ld_acquire(count) < target) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
}

// 16-byte loads and stores of 4 floats or 2 doubles.
__device__ __forceinline__ void ld16(const float* s, float* d) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
}
__device__ __forceinline__ void ld16(const double* s, double* d) {
  const double2 v = *reinterpret_cast<const double2*>(s);
  d[0] = v.x; d[1] = v.y;
}
__device__ __forceinline__ void st16(float* s, const float* d) {
  *reinterpret_cast<float4*>(s) = make_float4(d[0], d[1], d[2], d[3]);
}
__device__ __forceinline__ void st16(double* s, const double* d) {
  *reinterpret_cast<double2*>(s) = make_double2(d[0], d[1]);
}

// Chunk q of a flat (n * C) vector: E = 4 C elements (4 rows), 16-byte
// aligned, so it moves as C (f32) or 2 C (f64) 16-byte accesses; the last
// chunk, cut by N = n * C, element by element (zeros past the end).
template <typename T, int E>
__device__ __forceinline__ void load_chunk(const T* base, long long q, long long N,
                                           T* d) {
  constexpr int W = 16 / sizeof(T);
  const long long e0 = q * E;
  if (e0 + E <= N) {
#pragma unroll
    for (int k = 0; k < E; k += W) ld16(base + e0 + k, d + k);
  } else {
#pragma unroll
    for (int k = 0; k < E; ++k) d[k] = e0 + k < N ? base[e0 + k] : T(0);
  }
}

template <typename T, int E>
__device__ __forceinline__ void store_chunk(T* base, long long q, long long N,
                                            const T* d) {
  constexpr int W = 16 / sizeof(T);
  const long long e0 = q * E;
  if (e0 + E <= N) {
#pragma unroll
    for (int k = 0; k < E; k += W) st16(base + e0 + k, d + k);
  } else {
#pragma unroll
    for (int k = 0; k < E; ++k)
      if (e0 + k < N) base[e0 + k] = d[k];
  }
}

// The update of one chunk: x += alpha p, r -= alpha Ap; adds r.r to v.
template <typename T, int C>
__device__ __forceinline__ void update_chunk(const T* alpha, const T* pc,
                                             const T* apc, T* xc, T* rc, T* v) {
#pragma unroll
  for (int k = 0; k < 4 * C; ++k) {
    xc[k] = xc[k] + alpha[k % C] * pc[k];
    rc[k] = rc[k] - alpha[k % C] * apc[k];
    v[k % C] += rc[k] * rc[k];
  }
}

// B2 in one launch over 4-row chunks. R > 0: the chunks q0 + u*stride,
// u < R, of p and Ap are held in registers between the two phases; R == 0:
// p and Ap are read again after the barrier. x and r are read after it.
template <typename T, int C, int R>
__global__ void __launch_bounds__(kThreads1)
cg1_fused(const T* __restrict__ rz, const T* __restrict__ rr_prev,
          const T* __restrict__ thresh, const T* __restrict__ p,
          const T* __restrict__ ap, T* __restrict__ x, T* __restrict__ r,
          T* __restrict__ rr, T* __restrict__ partials,
          unsigned long long* __restrict__ sync, long long n) {
  constexpr int E = 4 * C;
  constexpr int RR = R > 0 ? R : 1;
  const unsigned nb = gridDim.x;
  const long long N = n * C, nq = (n + 3) / 4;
  const long long stride = (long long)nb * kThreads1;
  const long long q0 = (long long)blockIdx.x * kThreads1 + threadIdx.x;
  T* pap_part = partials;
  T* rr_part = partials + (long long)nb * C;

  T pr[RR][E], apr[RR][E], xr[RR][E], rv[RR][E];
  T v[C];
#pragma unroll
  for (int j = 0; j < C; ++j) v[j] = T(0);
#pragma unroll
  for (int u = 0; u < RR; ++u) {
    if (R == 0) break;
    const long long q = q0 + u * stride;
    if (q < nq) {
      load_chunk<T, E>(p, q, N, pr[u]);
      load_chunk<T, E>(ap, q, N, apr[u]);
#pragma unroll
      for (int k = 0; k < E; ++k) v[k % C] += pr[u][k] * apr[u][k];
    }
  }
  if (R == 0) {
    for (long long q = q0; q < nq; q += stride) {
      load_chunk<T, E>(p, q, N, pr[0]);
      load_chunk<T, E>(ap, q, N, apr[0]);
#pragma unroll
      for (int k = 0; k < E; ++k) v[k % C] += pr[0][k] * apr[0][k];
    }
  }
  T s[C];
  block_sum<T, C, kThreads1>(v, s);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < C; ++j) pap_part[blockIdx.x * C + j] = s[j];
  }
  grid_barrier(sync, nb);

  T pap[C], alpha[C];
  reduce_partials<T, C, kThreads1, true>(pap_part, nb, pap);
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const T a = rz[j] / (pap[j] == T(0) ? T(1) : pap[j]);
    alpha[j] = rr_prev[j] > thresh[j] ? a : T(0);
  }
#pragma unroll
  for (int j = 0; j < C; ++j) v[j] = T(0);
#pragma unroll
  for (int u = 0; u < RR; ++u) {
    if (R == 0) break;
    const long long q = q0 + u * stride;
    if (q < nq) {
      load_chunk<T, E>(x, q, N, xr[u]);
      load_chunk<T, E>(r, q, N, rv[u]);
      update_chunk<T, C>(alpha, pr[u], apr[u], xr[u], rv[u], v);
      store_chunk<T, E>(x, q, N, xr[u]);
      store_chunk<T, E>(r, q, N, rv[u]);
    }
  }
  if (R == 0) {
    for (long long q = q0; q < nq; q += stride) {
      load_chunk<T, E>(p, q, N, pr[0]);
      load_chunk<T, E>(ap, q, N, apr[0]);
      load_chunk<T, E>(x, q, N, xr[0]);
      load_chunk<T, E>(r, q, N, rv[0]);
      update_chunk<T, C>(alpha, pr[0], apr[0], xr[0], rv[0], v);
      store_chunk<T, E>(x, q, N, xr[0]);
      store_chunk<T, E>(r, q, N, rv[0]);
    }
  }
  block_sum<T, C, kThreads1>(v, s);
  __shared__ bool last;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < C; ++j) rr_part[blockIdx.x * C + j] = s[j];
    __threadfence();
    last = atomicAdd(sync + 1, 1ULL) % nb == nb - 1;
  }
  __syncthreads();
  if (last) {
    __threadfence();
    reduce_partials<T, C, kThreads1, true>(rr_part, nb, s);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int j = 0; j < C; ++j) rr[j] = s[j];
    }
  }
}

// partials[block, j] = sum over this block's rows of a[i, j] * b[i, j].
template <typename T, int C>
__global__ void col_dot_partial(const T* __restrict__ a, const T* __restrict__ b,
                                long long n, T* __restrict__ partials) {
  T v[C];
#pragma unroll
  for (int j = 0; j < C; ++j) v[j] = T(0);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
#pragma unroll
    for (int j = 0; j < C; ++j) v[j] += a[i * C + j] * b[i * C + j];
  }
  T s[C];
  block_sum<T, C, kThreads>(v, s);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < C; ++j) partials[blockIdx.x * C + j] = s[j];
  }
}

template <typename T, int C>
__global__ void cg2_update(const T* __restrict__ rz_old, const T* __restrict__ rr_prev,
                           const T* __restrict__ thresh, const T* __restrict__ z,
                           T* __restrict__ p, const T* __restrict__ rz_partials,
                           T* __restrict__ rz_out, long long n) {
  T rz[C], beta[C];
  reduce_partials<T, C, kThreads, false>(rz_partials, gridDim.x, rz);
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const T b = rz[j] / (rz_old[j] == T(0) ? T(1) : rz_old[j]);
    beta[j] = rr_prev[j] > thresh[j] ? b : T(0);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < C; ++j) rz_out[j] = rz[j];
  }
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const long long e = i * C + j;
      p[e] = z[e] + beta[j] * p[e];
    }
  }
}

// 4-row chunks per thread for n rows over nb blocks: 1 or 2 held in
// registers, or 0 when more (the kernel then reads its rows again after
// the barrier).
int chunks_per_thread(long long n, int nb) {
  const long long threads = (long long)nb * kThreads1;
  const long long chunks = ((n + 3) / 4 + threads - 1) / threads;
  return chunks <= 1 ? 1 : chunks <= 2 ? 2 : 0;
}

template <typename T, int C, int R>
int launch1(const T* rz, const T* rr_prev, const T* thresh, const T* p, const T* ap,
            T* x, T* r, T* rr, T* partials, unsigned long long* sync, long long n,
            int nb, cudaStream_t s) {
  cg1_fused<T, C, R><<<nb, kThreads1, 0, s>>>(rz, rr_prev, thresh, p, ap, x, r, rr,
                                             partials, sync, n);
  return (int)cudaGetLastError();
}

template <typename T, int C>
int update1(const T* rz, const T* rr_prev, const T* thresh, const T* p, const T* ap,
            T* x, T* r, T* rr, T* partials, unsigned long long* sync, long long n,
            int nb, cudaStream_t s) {
  switch (chunks_per_thread(n, nb)) {
    case 1: return launch1<T, C, 1>(rz, rr_prev, thresh, p, ap, x, r, rr, partials, sync, n, nb, s);
    case 2: return launch1<T, C, 2>(rz, rr_prev, thresh, p, ap, x, r, rr, partials, sync, n, nb, s);
    default: return launch1<T, C, 0>(rz, rr_prev, thresh, p, ap, x, r, rr, partials, sync, n, nb, s);
  }
}

// Blocks of cg1_fused<T, C, R> that the card holds at once, over all R.
template <typename T, int C>
int max_blocks1(int device, int* out) {
  int sms = 0, occ = 0, least = kMaxBlocksPerSm1;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const void* kernels[] = {(const void*)cg1_fused<T, C, 0>, (const void*)cg1_fused<T, C, 1>,
                           (const void*)cg1_fused<T, C, 2>};
  for (const void* k : kernels) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k, kThreads1, 0);
    if (e != cudaSuccess) return (int)e;
    least = occ < least ? occ : least;
  }
  *out = least * sms;
  return least > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

template <typename T, int C>
int update2(const T* rz_old, const T* rr_prev, const T* thresh, const T* r, const T* z,
            T* p, T* rz, T* partials, long long n, int nb, cudaStream_t s) {
  col_dot_partial<T, C><<<nb, kThreads, 0, s>>>(r, z, n, partials);
  cg2_update<T, C><<<nb, kThreads, 0, s>>>(rz_old, rr_prev, thresh, z, p, partials, rz, n);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch1(const void* rz, const void* rr_prev, const void* thresh, const void* p,
              const void* ap, void* x, void* r, void* rr, void* partials, void* sync,
              long long n, int c, int nb, void* stream) {
  auto s = (cudaStream_t)stream;
#define CG1_ARGS (const T*)rz, (const T*)rr_prev, (const T*)thresh, (const T*)p, \
    (const T*)ap, (T*)x, (T*)r, (T*)rr, (T*)partials, (unsigned long long*)sync, n, nb, s
  switch (c) {
    case 1: return update1<T, 1>(CG1_ARGS);
    case 2: return update1<T, 2>(CG1_ARGS);
    case 3: return update1<T, 3>(CG1_ARGS);
    case 4: return update1<T, 4>(CG1_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CG1_ARGS
}

template <typename T>
int dispatch_max_blocks1(int c, int device, int* out) {
  switch (c) {
    case 1: return max_blocks1<T, 1>(device, out);
    case 2: return max_blocks1<T, 2>(device, out);
    case 3: return max_blocks1<T, 3>(device, out);
    case 4: return max_blocks1<T, 4>(device, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch2(const void* rz_old, const void* rr_prev, const void* thresh, const void* r,
              const void* z, void* p, void* rz, void* partials, long long n, int c,
              int nb, void* stream) {
  auto s = (cudaStream_t)stream;
#define CG2_ARGS (const T*)rz_old, (const T*)rr_prev, (const T*)thresh, (const T*)r, \
    (const T*)z, (T*)p, (T*)rz, (T*)partials, n, nb, s
  switch (c) {
    case 1: return update2<T, 1>(CG2_ARGS);
    case 2: return update2<T, 2>(CG2_ARGS);
    case 3: return update2<T, 3>(CG2_ARGS);
    case 4: return update2<T, 4>(CG2_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CG2_ARGS
}

}  // namespace

extern "C" {

int cg_update1_f32(const void* rz, const void* rr_prev, const void* thresh, const void* p,
                   const void* ap, void* x, void* r, void* rr, void* partials, void* sync,
                   long long n, int c, int nb, void* stream) {
  return dispatch1<float>(rz, rr_prev, thresh, p, ap, x, r, rr, partials, sync, n, c, nb,
                          stream);
}

int cg_update1_f64(const void* rz, const void* rr_prev, const void* thresh, const void* p,
                   const void* ap, void* x, void* r, void* rr, void* partials, void* sync,
                   long long n, int c, int nb, void* stream) {
  return dispatch1<double>(rz, rr_prev, thresh, p, ap, x, r, rr, partials, sync, n, c, nb,
                           stream);
}

int cg_update1_max_blocks_f32(int c, int device, int* out) {
  return dispatch_max_blocks1<float>(c, device, out);
}

int cg_update1_max_blocks_f64(int c, int device, int* out) {
  return dispatch_max_blocks1<double>(c, device, out);
}

int cg_update2_f32(const void* rz_old, const void* rr_prev, const void* thresh, const void* r,
                   const void* z, void* p, void* rz, void* partials, long long n, int c,
                   int nb, void* stream) {
  return dispatch2<float>(rz_old, rr_prev, thresh, r, z, p, rz, partials, n, c, nb, stream);
}

int cg_update2_f64(const void* rz_old, const void* rr_prev, const void* thresh, const void* r,
                   const void* z, void* p, void* rz, void* partials, long long n, int c,
                   int nb, void* stream) {
  return dispatch2<double>(rz_old, rr_prev, thresh, r, z, p, rz, partials, n, c, nb, stream);
}

}  // extern "C"
