// B2 cg_update1 and B3 cg_update2: the vector halves of a CG iteration on
// (n, c) vectors, c <= 4 columns solved together (per-column alpha/beta,
// frozen columns).
//
// Replace the TPU kernels aa_admm_tpu/ops/pallas_kernels.py::_cg_k1 (via
// cg_update1) and ::_cg_k2 (via cg_update2). The TPU kernels were one block
// over the whole vector in band layout; here each update is a reduction
// phase and an update phase, because alpha (beta) needs the full column dot
// before any element of x, r (p) may change:
//   B2: partial p.Ap per block -> every block reduces the partials to pAp,
//       forms alpha, updates x += alpha p and r -= alpha Ap in place and
//       writes its partial r.r -> one block reduces those to rr.
//   B3: partial r.z per block -> every block reduces the partials to
//       rz_new, forms beta and updates p = z + beta p in place; block 0
//       writes rz_new.
// alpha = rz / pAp (pAp == 0 divides by 1), 0 for a frozen column
// (rr_prev <= thresh); beta = rz_new / rz_old (rz_old == 0 divides by 1),
// 0 for a frozen column — pcg's semantics (aa_admm_tpu/solver/linear.py).
//
// Deterministic: the grid size depends on n only, each block sums its rows
// in a fixed order, and the partials are reduced in a fixed tree order by
// every block alike. No float atomics (f32 ALM trajectories are chaotic
// under a change of summation order).
//
// What bounds them on the card: bytes. B2 must read p, Ap, x, r and write
// x, r (6*n*c words); B3 must read r, z, p and write p (4*n*c words), with
// about one flop per byte. The design streams each vector with neighbouring
// threads on neighbouring rows; the second read of p and Ap in B2 (and of z
// in B3) comes from the 50 MB L2 at the main path's n = 230,400
// (n*c*4 = 2.8 MB per vector).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Sum v[0..C) over the block in a fixed order; the result is valid in
// thread 0 (returned in out[] of every thread after the final broadcast).
template <typename T, int C>
__device__ void block_sum(T v[C], T out[C]) {
  __shared__ T warp_sums[kWarps][C];
  __shared__ T total[C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < C; ++j) {
    T s = v[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) warp_sums[warp][j] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      T s = warp_sums[0][j];
      for (int w = 1; w < kWarps; ++w) s += warp_sums[w][j];
      total[j] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < C; ++j) out[j] = total[j];
  __syncthreads();
}

// Reduce partials (nb, C) to (C,) in a fixed order, identically in every
// block that calls it.
template <typename T, int C>
__device__ void reduce_partials(const T* __restrict__ partials, int nb, T out[C]) {
  T v[C];
#pragma unroll
  for (int j = 0; j < C; ++j) v[j] = T(0);
  for (int b = threadIdx.x; b < nb; b += kThreads) {
#pragma unroll
    for (int j = 0; j < C; ++j) v[j] += partials[b * C + j];
  }
  block_sum<T, C>(v, out);
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
  block_sum<T, C>(v, s);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < C; ++j) partials[blockIdx.x * C + j] = s[j];
  }
}

template <typename T, int C>
__global__ void cg1_update(const T* __restrict__ rz, const T* __restrict__ rr_prev,
                           const T* __restrict__ thresh, const T* __restrict__ p,
                           const T* __restrict__ ap, T* __restrict__ x,
                           T* __restrict__ r, const T* __restrict__ pap_partials,
                           T* __restrict__ rr_partials, long long n) {
  T pap[C], alpha[C];
  reduce_partials<T, C>(pap_partials, gridDim.x, pap);
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const T a = rz[j] / (pap[j] == T(0) ? T(1) : pap[j]);
    alpha[j] = rr_prev[j] > thresh[j] ? a : T(0);
  }
  T v[C];
#pragma unroll
  for (int j = 0; j < C; ++j) v[j] = T(0);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const long long e = i * C + j;
      x[e] = x[e] + alpha[j] * p[e];
      const T rn = r[e] - alpha[j] * ap[e];
      r[e] = rn;
      v[j] += rn * rn;
    }
  }
  T s[C];
  block_sum<T, C>(v, s);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < C; ++j) rr_partials[blockIdx.x * C + j] = s[j];
  }
}

template <typename T, int C>
__global__ void col_sum_final(const T* __restrict__ partials, int nb, T* __restrict__ out) {
  T s[C];
  reduce_partials<T, C>(partials, nb, s);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < C; ++j) out[j] = s[j];
  }
}

template <typename T, int C>
__global__ void cg2_update(const T* __restrict__ rz_old, const T* __restrict__ rr_prev,
                           const T* __restrict__ thresh, const T* __restrict__ z,
                           T* __restrict__ p, const T* __restrict__ rz_partials,
                           T* __restrict__ rz_out, long long n) {
  T rz[C], beta[C];
  reduce_partials<T, C>(rz_partials, gridDim.x, rz);
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

template <typename T, int C>
int update1(const T* rz, const T* rr_prev, const T* thresh, const T* p, const T* ap,
            T* x, T* r, T* rr, T* partials, long long n, int nb, cudaStream_t s) {
  T* pap_partials = partials;
  T* rr_partials = partials + (long long)nb * C;
  col_dot_partial<T, C><<<nb, kThreads, 0, s>>>(p, ap, n, pap_partials);
  cg1_update<T, C><<<nb, kThreads, 0, s>>>(rz, rr_prev, thresh, p, ap, x, r,
                                           pap_partials, rr_partials, n);
  col_sum_final<T, C><<<1, kThreads, 0, s>>>(rr_partials, nb, rr);
  return (int)cudaGetLastError();
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
              const void* ap, void* x, void* r, void* rr, void* partials,
              long long n, int c, int nb, void* stream) {
  auto s = (cudaStream_t)stream;
#define CG1_ARGS (const T*)rz, (const T*)rr_prev, (const T*)thresh, (const T*)p, \
    (const T*)ap, (T*)x, (T*)r, (T*)rr, (T*)partials, n, nb, s
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
                   const void* ap, void* x, void* r, void* rr, void* partials,
                   long long n, int c, int nb, void* stream) {
  return dispatch1<float>(rz, rr_prev, thresh, p, ap, x, r, rr, partials, n, c, nb, stream);
}

int cg_update1_f64(const void* rz, const void* rr_prev, const void* thresh, const void* p,
                   const void* ap, void* x, void* r, void* rr, void* partials,
                   long long n, int c, int nb, void* stream) {
  return dispatch1<double>(rz, rr_prev, thresh, p, ap, x, r, rr, partials, n, c, nb, stream);
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
