// Variants of the CG kernels for tools/port_cg_given_cost.py and
// chip_smoke.py, which append this file to aa_admm_tpu_torch/csrc/cg_update.cu
// (it uses that file's helpers: block_sum, reduce_partials, load_chunk,
// store_chunk, update_chunk, kThreadsG) and build the two as one source.
//
// two_*: the two-launch design of cg_dot and cg_update1_given that the
//   package shipped before the one-launch kernels (a partial-sum launch over
//   old_blocks(n) = min(528, ceil(n / 256)) blocks of a row a thread with
//   4-byte loads, then one block that sums the partials), kept as it was.
// old_*: B3 and cg_update2_given as the package shipped them before they
//   were redesigned (B3: a partial r.z launch, then an update launch whose
//   every block reduces the partials; cg_update2_given: one pass; both a
//   row a thread, 4-byte loads, over old_blocks(n)), kept as they were.
// floor_*: what any one-launch kernel over these vectors costs at least:
//   an empty kernel over a given grid, and one pass over the vectors with
//   16-byte loads and stores (p = z + s p + s r with s = 0, r optional: the
//   bytes of B3, or of cg_update2_given without r), a thread per 4-row
//   chunk; both with the given threads a block.
// cl_*: the one-launch kernels with the cross-block sum done in
//   thread-block clusters: the blocks of a cluster add their sums through
//   distributed shared memory, one partial per cluster reaches global
//   memory, and the last cluster's first block reduces those (ncl = nb /
//   cluster size of them). Launched with the cluster size as a launch
//   attribute; nb must be a multiple of it.

#include <cooperative_groups.h>

namespace {

constexpr int kThreads = 256;       // the two-launch and old kernels

// reduce_partials as the two-launch kernels had it: the partials of an
// earlier launch, read through the read-only path.
template <typename T, int C, int NT>
__device__ void old_reduce_partials(const T* partials, int nb, T out[C]) {
  T v[C];
#pragma unroll
  for (int j = 0; j < C; ++j) v[j] = T(0);
  for (int b = threadIdx.x; b < nb; b += NT) {
#pragma unroll
    for (int j = 0; j < C; ++j) v[j] += __ldg(partials + b * C + j);
  }
  block_sum<T, C, NT>(v, out);
}

template <typename T, int C>
__global__ void two_col_dot_partial(const T* __restrict__ a, const T* __restrict__ b,
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
__global__ void two_reduce_final(const T* __restrict__ partials, int nb, T* __restrict__ out) {
  T s[C];
  old_reduce_partials<T, C, kThreads>(partials, nb, s);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < C; ++j) out[j] = s[j];
  }
}

template <typename T, int C>
__global__ void two_cg1_given(const T* __restrict__ pap, const T* __restrict__ rz,
                              const T* __restrict__ rr_prev, const T* __restrict__ thresh,
                              const T* __restrict__ p, const T* __restrict__ ap,
                              T* __restrict__ x, T* __restrict__ r,
                              T* __restrict__ partials, long long n) {
  T alpha[C], v[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const T a = rz[j] / (pap[j] == T(0) ? T(1) : pap[j]);
    alpha[j] = rr_prev[j] > thresh[j] ? a : T(0);
    v[j] = T(0);
  }
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const long long e = i * C + j;
      x[e] = x[e] + alpha[j] * p[e];
      const T re = r[e] - alpha[j] * ap[e];
      r[e] = re;
      v[j] += re * re;
    }
  }
  T s[C];
  block_sum<T, C, kThreads>(v, s);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < C; ++j) partials[blockIdx.x * C + j] = s[j];
  }
}

// The cluster form of finish_sum: the cluster's blocks add their sums in
// block-rank order through distributed shared memory, its first block
// writes the cluster's partial and draws a ticket; the first block of the
// cluster that draws the launch's last ticket reduces the ncl partials.
template <typename T, int C>
__device__ void cluster_finish(const T v[C], T* partials, unsigned long long* ticket,
                               T* out) {
  namespace cgr = cooperative_groups;
  cgr::cluster_group cluster = cgr::this_cluster();
  __shared__ T mine[C];
  __shared__ bool last;
  T s[C];
  block_sum<T, C, kThreadsG>(v, s);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < C; ++j) mine[j] = s[j];
  }
  cluster.sync();
  const unsigned cl = cluster.num_blocks();
  const unsigned ncl = gridDim.x / cl;
  const bool first = cluster.block_rank() == 0;
  if (first && threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      T t = mine[j];
      for (unsigned b = 1; b < cl; ++b) t += cluster.map_shared_rank(&mine[0], b)[j];
      partials[(blockIdx.x / cl) * C + j] = t;
    }
    __threadfence();
    last = atomicAdd(ticket, 1ULL) % ncl == ncl - 1;
  }
  cluster.sync();  // the other blocks' shared memory lives until it is read
  if (first && last) {
    __threadfence();
    reduce_partials<T, C, kThreadsG>(partials, ncl, s);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int j = 0; j < C; ++j) out[j] = s[j];
    }
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreadsG)
cl_dot(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
       T* __restrict__ partials, unsigned long long* __restrict__ ticket, long long n) {
  constexpr int E = 4 * C;
  const long long N = n * C, nq = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * kThreadsG;
  T v[C];
#pragma unroll
  for (int j = 0; j < C; ++j) v[j] = T(0);
  for (long long q = (long long)blockIdx.x * kThreadsG + threadIdx.x; q < nq;
       q += stride) {
    T ac[E], bc[E];
    load_chunk<T, E>(a, q, N, ac);
    load_chunk<T, E>(b, q, N, bc);
#pragma unroll
    for (int k = 0; k < E; ++k) v[k % C] += ac[k] * bc[k];
  }
  cluster_finish<T, C>(v, partials, ticket, out);
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreadsG)
cl_cg1_given(const T* __restrict__ pap, const T* __restrict__ rz,
             const T* __restrict__ rr_prev, const T* __restrict__ thresh,
             const T* __restrict__ p, const T* __restrict__ ap, T* __restrict__ x,
             T* __restrict__ r, T* __restrict__ rr, T* __restrict__ partials,
             unsigned long long* __restrict__ ticket, long long n) {
  constexpr int E = 4 * C;
  const long long N = n * C, nq = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * kThreadsG;
  T alpha[C], v[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const T a = rz[j] / (pap[j] == T(0) ? T(1) : pap[j]);
    alpha[j] = rr_prev[j] > thresh[j] ? a : T(0);
    v[j] = T(0);
  }
  for (long long q = (long long)blockIdx.x * kThreadsG + threadIdx.x; q < nq;
       q += stride) {
    T pc[E], apc[E], xc[E], rc[E];
    load_chunk<T, E>(p, q, N, pc);
    load_chunk<T, E>(ap, q, N, apc);
    load_chunk<T, E>(x, q, N, xc);
    load_chunk<T, E>(r, q, N, rc);
    update_chunk<T, C>(alpha, pc, apc, xc, rc, v);
    store_chunk<T, E>(x, q, N, xc);
    store_chunk<T, E>(r, q, N, rc);
  }
  cluster_finish<T, C>(v, partials, ticket, rr);
}

// The old B3 update launch: every block reduces the r.z partials in a fixed
// order, forms beta and updates p = z + beta p; block 0 writes rz_new.
template <typename T, int C>
__global__ void old_cg2_update(const T* __restrict__ rz_old, const T* __restrict__ rr_prev,
                               const T* __restrict__ thresh, const T* __restrict__ z,
                               T* __restrict__ p, const T* __restrict__ rz_partials,
                               T* __restrict__ rz_out, long long n) {
  T rz[C], beta[C];
  old_reduce_partials<T, C, kThreads>(rz_partials, gridDim.x, rz);
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

// The old cg_update2_given: beta from the given rz_new; p = z + beta p.
template <typename T, int C>
__global__ void old_cg2_given(const T* __restrict__ rz, const T* __restrict__ rz_old,
                              const T* __restrict__ rr_prev, const T* __restrict__ thresh,
                              const T* __restrict__ z, T* __restrict__ p, long long n) {
  T beta[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
    const T b = rz[j] / (rz_old[j] == T(0) ? T(1) : rz_old[j]);
    beta[j] = rr_prev[j] > thresh[j] ? b : T(0);
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

__global__ void floor_empty() {}

// One pass of 16-byte chunks: p = z + s p (+ s r when r is given).
template <int C>
__global__ void floor_pass(const float* __restrict__ r, const float* __restrict__ z,
                           float* __restrict__ p, float s, long long n) {
  constexpr int E = 4 * C;
  const long long N = n * C, nq = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < nq;
       q += stride) {
    float rc[E], zc[E], pc[E];
    if (r != nullptr) load_chunk<float, E>(r, q, N, rc);
    load_chunk<float, E>(z, q, N, zc);
    load_chunk<float, E>(p, q, N, pc);
#pragma unroll
    for (int k = 0; k < E; ++k) {
      pc[k] = zc[k] + s * pc[k];
      if (r != nullptr) pc[k] = pc[k] + s * rc[k];
    }
    store_chunk<float, E>(p, q, N, pc);
  }
}

cudaLaunchConfig_t cluster_config(int nb, int cl, cudaStream_t s,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb);
  cfg.blockDim = dim3(kThreadsG);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// float32, c = 3: the shapes the tool times.
extern "C" {

int two_cg_dot_f32(const void* a, const void* b, void* out, void* partials, long long n,
                   int nb, void* stream) {
  auto s = (cudaStream_t)stream;
  two_col_dot_partial<float, 3><<<nb, kThreads, 0, s>>>((const float*)a, (const float*)b, n,
                                                        (float*)partials);
  two_reduce_final<float, 3><<<1, kThreads, 0, s>>>((const float*)partials, nb, (float*)out);
  return (int)cudaGetLastError();
}

int two_cg_update1_given_f32(const void* pap, const void* rz, const void* rr_prev,
                             const void* thresh, const void* p, const void* ap, void* x,
                             void* r, void* rr, void* partials, long long n, int nb,
                             void* stream) {
  auto s = (cudaStream_t)stream;
  two_cg1_given<float, 3><<<nb, kThreads, 0, s>>>(
      (const float*)pap, (const float*)rz, (const float*)rr_prev, (const float*)thresh,
      (const float*)p, (const float*)ap, (float*)x, (float*)r, (float*)partials, n);
  two_reduce_final<float, 3><<<1, kThreads, 0, s>>>((const float*)partials, nb, (float*)rr);
  return (int)cudaGetLastError();
}

int old_cg_update2_f32(const void* rz_old, const void* rr_prev, const void* thresh,
                       const void* r, const void* z, void* p, void* rz, void* partials,
                       long long n, int nb, void* stream) {
  auto s = (cudaStream_t)stream;
  two_col_dot_partial<float, 3><<<nb, kThreads, 0, s>>>((const float*)r, (const float*)z, n,
                                                        (float*)partials);
  old_cg2_update<float, 3><<<nb, kThreads, 0, s>>>(
      (const float*)rz_old, (const float*)rr_prev, (const float*)thresh, (const float*)z,
      (float*)p, (const float*)partials, (float*)rz, n);
  return (int)cudaGetLastError();
}

int old_cg_update2_given_f32(const void* rz, const void* rz_old, const void* rr_prev,
                             const void* thresh, const void* z, void* p, long long n, int nb,
                             void* stream) {
  old_cg2_given<float, 3><<<nb, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rz, (const float*)rz_old, (const float*)rr_prev, (const float*)thresh,
      (const float*)z, (float*)p, n);
  return (int)cudaGetLastError();
}

int floor_empty_f32(int nb, int threads, void* stream) {
  floor_empty<<<nb, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

int floor_pass_f32(const void* r, const void* z, void* p, long long n, int nb, int threads,
                   void* stream) {
  floor_pass<3><<<nb, threads, 0, (cudaStream_t)stream>>>(
      (const float*)r, (const float*)z, (float*)p, 0.0f, n);
  return (int)cudaGetLastError();
}

int cl_cg_dot_f32(const void* a, const void* b, void* out, void* partials, void* ticket,
                  long long n, int nb, int cl, void* stream) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(nb, cl, (cudaStream_t)stream, &attr);
  cudaError_t e = cudaLaunchKernelEx(&cfg, cl_dot<float, 3>, (const float*)a,
                                     (const float*)b, (float*)out, (float*)partials,
                                     (unsigned long long*)ticket, n);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

int cl_cg_update1_given_f32(const void* pap, const void* rz, const void* rr_prev,
                            const void* thresh, const void* p, const void* ap, void* x,
                            void* r, void* rr, void* partials, void* ticket, long long n,
                            int nb, int cl, void* stream) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(nb, cl, (cudaStream_t)stream, &attr);
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, cl_cg1_given<float, 3>, (const float*)pap, (const float*)rz,
      (const float*)rr_prev, (const float*)thresh, (const float*)p, (const float*)ap,
      (float*)x, (float*)r, (float*)rr, (float*)partials, (unsigned long long*)ticket, n);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // extern "C"
