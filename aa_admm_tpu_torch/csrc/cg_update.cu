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
//      adds one per block, by a release/acquire atomic, so a launch waits
//      for the next multiple of the grid size), which also holds under
//      CUDA-graph replay;
//   4. every block reduces the partials in one fixed order, forms alpha,
//      reads x and r, updates them with p and Ap from its registers and
//      writes its partial r.r;
//   5. the last block to finish, known from an integer ticket (a
//      release/acquire atomic), reduces the r.r partials in the same fixed
//      order.
//   No float atomics: f32 CG is bit-reproducible run to run. The scratch
//   (partials, the two counters) belongs to the wrapper, which keeps one
//   set per (device, dtype, c, grid) for calls ordered on one stream.
// B3, one launch (it was two: partial dots r.z, then an update launch
// whose every block reduced the partials; 4-byte loads in both), B2's grid
// and barrier with B3's work on each side:
//   1. the grid is one wave of 512-thread blocks, at most two per SM
//      (cg_update2_max_blocks), fixed for a card, dtype, c and n; at the
//      main path's n that is a chunk per thread on 113 SMs;
//   2. a thread owns 4-row chunks moved as 16-byte loads; it loads its
//      chunks of r and z (up to two before its first multiply) and the
//      block writes its partial r.z;
//   3. the grid-wide barrier;
//   4. every block reduces the partials in one fixed order, by its first
//      warp (warp_reduce_partials), and forms beta; each thread then loads its chunks of z and p (z again: up to
//      two before its first multiply) and stores p = z + beta p; block 0
//      writes rz_new.
//   Loads issued ahead of the partials' reads (z and p held in registers
//   across the barrier, as B2 holds p and Ap, or loaded just after it)
//   made it slower, not faster: the partials' reads, on which every store
//   waits, queue behind them (tools/port_kernel_variants.py). No float
//   atomics; the scratch is kept by the wrapper as B2's.
// The given entries, for a CG whose rows are split over ranks (the sharded
// geometry solve): alpha and beta need the column dots of ALL rows, so the
// caller forms each rank's partial dot (cg_dot), sums the partials over the
// ranks and hands the sum in:
//   cg_dot: this rank's column dots a.b;
//   cg_update1_given: from the summed pAp, alpha; x += alpha p, r -= alpha
//     Ap and this rank's r.r;
//   cg_update2_given: from the summed rz_new, beta; p = z + beta p.
// cg_dot and cg_update1_given are one launch each (they were two: partial
// sums, then a one-block final sum that waited for the first launch to
// drain, more than cg_dot's whole bound of 0.8 us at a rank's n = 115,200):
//   1. the grid is one wave: one 256-thread block per 256 4-row chunks, no
//      more blocks than the card holds at once (cg_given_max_blocks: the
//      occupancy API times the SMs); fixed for a card, dtype, c and n, so
//      the reduction order is fixed;
//   2. a thread owns 4-row chunks, moved as 16-byte loads and stores (the
//      ragged last chunk element by element); while the card holds a
//      thread per chunk (n up to 4 rows a resident thread) each thread has
//      one and issues all its loads (p, Ap; and x, r) before its first
//      multiply, so each warp keeps several 16-byte loads in flight;
//      beyond that a grid-stride loop over chunks;
//   3. each block writes its partial sum and draws a ticket from a counter
//      that only grows, by one release/acquire atomic (about 0.3-0.5 us
//      less than a fence on each side of a plain one); the block that
//      draws the last ticket of the launch reduces the partials in one
//      fixed order, through L2, and writes the (c,) result. No block
//      waits for another, so no launch needs its grid resident at once
//      (two rank processes may share a card), and the counter stays valid
//      under CUDA-graph replay.
//   No float atomics, so the sums repeat bit for bit. At a rank's
//   n = 115,200, f32, c = 3, an H100 takes about 3.5 and 5.3 us (bounds 0.8
//   and 2.5 us): latency bounds them, not bytes (the launch, one round trip
//   for the loads, then the ticket's chain of L2 round trips). A variant
//   whose blocks sum their partials in thread-block clusters through
//   distributed shared memory was slower (tools/port_cg_given_cost.py).
// cg_update2_given is one plain pass (it had 4-byte loads, a row a thread,
// over up to 528 blocks): a one-wave grid of 128-thread blocks (its own
// cg_update2_given_max_blocks; at a rank's n = 57,600 128 threads a block
// spread the chunks over 113 SMs, where 256 left 75 idle, and took 0.2 us
// less), 16-byte chunks with z and p loaded before the multiply, no
// reduction and so no ticket and no wait.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads1 = 256;      // B2
constexpr int kMaxBlocksPerSm1 = 1;
constexpr int kThreads2 = 512;      // B3
constexpr int kMaxBlocksPerSm2 = 2;
constexpr int kThreadsG = 256;      // cg_dot, cg_update1_given
constexpr int kThreadsG2 = 128;     // cg_update2_given

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
// block that calls it. The partials, written by other blocks of the same
// launch, are read through L2 (__ldcg), never through the incoherent L1.
template <typename T, int C, int NT>
__device__ void reduce_partials(const T* partials, int nb, T out[C]) {
  T v[C];
#pragma unroll
  for (int j = 0; j < C; ++j) v[j] = T(0);
  for (int b = threadIdx.x; b < nb; b += NT) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      v[j] += __ldcg(partials + b * C + j);
    }
  }
  block_sum<T, C, NT>(v, out);
}

// reduce_partials by the block's first warp alone, which issues all its
// loads (K a lane, for up to 32 K partials) before it adds any; the others
// wait at one block barrier. The same fixed order in every block.
template <typename T, int C>
__device__ void warp_reduce_partials(const T* partials, int nb, T out[C]) {
  constexpr int K = 8;
  __shared__ T total[C];
  if (threadIdx.x < 32) {
    T w[C];
#pragma unroll
    for (int j = 0; j < C; ++j) w[j] = T(0);
    for (int b0 = 0; b0 < nb; b0 += 32 * K) {
      T x[K][C];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int b = b0 + 32 * k + threadIdx.x;
#pragma unroll
        for (int j = 0; j < C; ++j) x[k][j] = b < nb ? __ldcg(partials + b * C + j) : T(0);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int j = 0; j < C; ++j) w[j] += x[k][j];
      }
    }
#pragma unroll
    for (int j = 0; j < C; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) w[j] += __shfl_down_sync(0xffffffffu, w[j], off);
    }
    if (threadIdx.x == 0) {
#pragma unroll
      for (int j = 0; j < C; ++j) total[j] = w[j];
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < C; ++j) out[j] = total[j];
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.global.acquire.gpu.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// A ticket: adds 1 to *t and returns the old value, with release semantics
// (this thread's earlier writes are visible to whoever reads the count it
// leaves) and acquire semantics (the writes released by earlier tickets are
// visible to it). One atomic in place of a fence before and after it.
__device__ __forceinline__ unsigned long long ticket_acq_rel(unsigned long long* t) {
  unsigned long long old;
  asm volatile("atom.add.acq_rel.gpu.u64 %0, [%1], 1;" : "=l"(old) : "l"(t) : "memory");
  return old;
}

// Grid-wide barrier on a counter that only grows: each launch adds nb (one
// per block), so the launch's arrivals end at the next multiple of nb.
// Thread 0 arrives with a ticket (which releases its block's partial, the
// one write the other blocks read after the barrier) and waits with acquire
// loads, which make the partials released by the others visible to it; the
// block barrier passes them on to its other threads, which read them
// through L2.
__device__ void grid_barrier(unsigned long long* count, unsigned nb) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long old = ticket_acq_rel(count);
    const unsigned long long target = (old / nb + 1) * nb;
    while (ld_acquire(count) < target) __nanosleep(32);
  }
  __syncthreads();
}

// The end of a one-launch reduction: the block's sum of v is its partial;
// the block that draws the launch's last ticket (a counter that only grows,
// nb per launch) reduces the nb partials in a fixed order into out (C,).
// Its thread 0 acquired the other blocks' partials with the ticket; the
// block barrier passes them on to its other threads, which read them
// through L2.
template <typename T, int C, int NT>
__device__ void finish_sum(const T v[C], T* partials, unsigned long long* ticket,
                           unsigned nb, T* out) {
  T s[C];
  block_sum<T, C, NT>(v, s);
  __shared__ bool last;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < C; ++j) partials[blockIdx.x * C + j] = s[j];
    last = ticket_acq_rel(ticket) % nb == nb - 1;
  }
  __syncthreads();
  if (last) {
    reduce_partials<T, C, NT>(partials, nb, s);
    if (threadIdx.x == 0) {
#pragma unroll
      for (int j = 0; j < C; ++j) out[j] = s[j];
    }
  }
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
  reduce_partials<T, C, kThreads1>(pap_part, nb, pap);
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
  finish_sum<T, C, kThreads1>(v, rr_part, sync + 1, nb, rr);
}

// The update of one chunk: p = z + beta p.
template <typename T, int C>
__device__ __forceinline__ void beta_chunk(const T* beta, const T* zc, T* pc) {
#pragma unroll
  for (int k = 0; k < 4 * C; ++k) pc[k] = zc[k] + beta[k % C] * pc[k];
}

// beta = rz / rz_old (rz_old == 0 divides by 1), 0 for a frozen column
// (rr_prev <= thresh). The divisor and the column's state are read when it
// is made, before the column dot rz is known.
template <typename T, int C>
struct Beta {
  T div[C];
  bool live[C];
  __device__ __forceinline__ Beta(const T* rz_old, const T* rr_prev, const T* thresh) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      div[j] = rz_old[j] == T(0) ? T(1) : rz_old[j];
      live[j] = rr_prev[j] > thresh[j];
    }
  }
  __device__ __forceinline__ void of(const T* rz, T* beta) const {
#pragma unroll
    for (int j = 0; j < C; ++j) beta[j] = live[j] ? rz[j] / div[j] : T(0);
  }
};

// B3 in one launch over 4-row chunks. R > 0: a thread's R chunks q0 +
// u*stride, u < R, each side of the barrier issuing all its loads (r and z;
// then z and p) before its first multiply; R == 0 (more chunks than
// that): grid-stride loops on both sides. z and p are loaded only once
// the partials are summed: loads issued before them delay the partials'
// reads, which every store waits for.
template <typename T, int C, int R>
__global__ void __launch_bounds__(kThreads2)
cg2_fused(const T* __restrict__ rz_old, const T* __restrict__ rr_prev,
          const T* __restrict__ thresh, const T* __restrict__ r,
          const T* __restrict__ z, T* __restrict__ p, T* __restrict__ rz,
          T* __restrict__ partials, unsigned long long* __restrict__ sync, long long n) {
  constexpr int E = 4 * C;
  constexpr int RR = R > 0 ? R : 1;
  const unsigned nb = gridDim.x;
  const long long N = n * C, nq = (n + 3) / 4;
  const long long stride = (long long)nb * kThreads2;
  const long long q0 = (long long)blockIdx.x * kThreads2 + threadIdx.x;
  const Beta<T, C> bt(rz_old, rr_prev, thresh);   // read before the barrier

  T rv[RR][E], zr[RR][E], pr[RR][E];
  T v[C];
#pragma unroll
  for (int j = 0; j < C; ++j) v[j] = T(0);
  if (R > 0) {
#pragma unroll
    for (int u = 0; u < RR; ++u) {
      if (q0 + u * stride < nq) {
        load_chunk<T, E>(r, q0 + u * stride, N, rv[u]);
        load_chunk<T, E>(z, q0 + u * stride, N, zr[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < RR; ++u) {
      if (q0 + u * stride < nq) {
#pragma unroll
        for (int k = 0; k < E; ++k) v[k % C] += rv[u][k] * zr[u][k];
      }
    }
  } else {
    for (long long q = q0; q < nq; q += stride) {
      load_chunk<T, E>(r, q, N, rv[0]);
      load_chunk<T, E>(z, q, N, zr[0]);
#pragma unroll
      for (int k = 0; k < E; ++k) v[k % C] += rv[0][k] * zr[0][k];
    }
  }
  T s[C];
  block_sum<T, C, kThreads2>(v, s);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < C; ++j) partials[blockIdx.x * C + j] = s[j];
  }
  grid_barrier(sync, nb);

  T rzn[C], beta[C];
  warp_reduce_partials<T, C>(partials, nb, rzn);
  bt.of(rzn, beta);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < C; ++j) rz[j] = rzn[j];
  }
  if (R > 0) {
#pragma unroll
    for (int u = 0; u < RR; ++u) {
      if (q0 + u * stride < nq) {
        load_chunk<T, E>(z, q0 + u * stride, N, zr[u]);
        load_chunk<T, E>(p, q0 + u * stride, N, pr[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < RR; ++u) {
      if (q0 + u * stride < nq) {
        beta_chunk<T, C>(beta, zr[u], pr[u]);
        store_chunk<T, E>(p, q0 + u * stride, N, pr[u]);
      }
    }
  } else {
    for (long long q = q0; q < nq; q += stride) {
      load_chunk<T, E>(z, q, N, zr[0]);
      load_chunk<T, E>(p, q, N, pr[0]);
      beta_chunk<T, C>(beta, zr[0], pr[0]);
      store_chunk<T, E>(p, q, N, pr[0]);
    }
  }
}

// cg_dot in one launch: out = a.b per column over a grid of nb blocks,
// a thread per 4-row chunk (a grid-stride loop when chunks outnumber the
// threads), its loads issued before its products.
template <typename T, int C>
__global__ void __launch_bounds__(kThreadsG)
dot_given(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
          T* __restrict__ partials, unsigned long long* __restrict__ ticket,
          long long n) {
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
  finish_sum<T, C, kThreadsG>(v, partials, ticket, gridDim.x, out);
}

// cg_update1_given in one launch: alpha from the given (all-rank) pAp;
// x += alpha p, r -= alpha Ap in place; rr = this rank's r.r per column.
template <typename T, int C>
__global__ void __launch_bounds__(kThreadsG)
cg1_given(const T* __restrict__ pap, const T* __restrict__ rz,
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
  finish_sum<T, C, kThreadsG>(v, partials, ticket, gridDim.x, rr);
}

// cg_update2_given: beta from the given (all-rank) rz_new; p = z + beta p,
// a thread per 4-row chunk (a grid-stride loop when chunks outnumber the
// threads), z and p loaded before the multiply. No reduction, so no block
// waits for another.
template <typename T, int C>
__global__ void __launch_bounds__(kThreadsG2)
cg2_given(const T* __restrict__ rz, const T* __restrict__ rz_old,
          const T* __restrict__ rr_prev, const T* __restrict__ thresh,
          const T* __restrict__ z, T* __restrict__ p, long long n) {
  constexpr int E = 4 * C;
  const long long N = n * C, nq = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * kThreadsG2;
  T beta[C];
  Beta<T, C>(rz_old, rr_prev, thresh).of(rz, beta);
  for (long long q = (long long)blockIdx.x * kThreadsG2 + threadIdx.x; q < nq;
       q += stride) {
    T zc[E], pc[E];
    load_chunk<T, E>(z, q, N, zc);
    load_chunk<T, E>(p, q, N, pc);
    beta_chunk<T, C>(beta, zc, pc);
    store_chunk<T, E>(p, q, N, pc);
  }
}

template <typename T, int C>
int dot(const T* a, const T* b, T* out, T* partials, unsigned long long* ticket,
        long long n, int nb, cudaStream_t s) {
  dot_given<T, C><<<nb, kThreadsG, 0, s>>>(a, b, out, partials, ticket, n);
  return (int)cudaGetLastError();
}

template <typename T, int C>
int update1_given(const T* pap, const T* rz, const T* rr_prev, const T* thresh, const T* p,
                  const T* ap, T* x, T* r, T* rr, T* partials, unsigned long long* ticket,
                  long long n, int nb, cudaStream_t s) {
  cg1_given<T, C><<<nb, kThreadsG, 0, s>>>(pap, rz, rr_prev, thresh, p, ap, x, r, rr,
                                           partials, ticket, n);
  return (int)cudaGetLastError();
}

// Blocks of dot_given<T, C> and cg1_given<T, C> that the card holds at
// once (the fewer of the two).
template <typename T, int C>
int given_max_blocks(int device, int* out) {
  int sms = 0, occ = 0, least = 1 << 30;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const void* kernels[] = {(const void*)dot_given<T, C>, (const void*)cg1_given<T, C>};
  for (const void* k : kernels) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k, kThreadsG, 0);
    if (e != cudaSuccess) return (int)e;
    least = occ < least ? occ : least;
  }
  *out = least * sms;
  return least > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

// Blocks of cg2_given<T, C> that the card holds at once.
template <typename T, int C>
int given2_max_blocks(int device, int* out) {
  int sms = 0, occ = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, (const void*)cg2_given<T, C>,
                                                    kThreadsG2, 0);
  if (e != cudaSuccess) return (int)e;
  *out = occ * sms;
  return occ > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
}

template <typename T, int C>
int update2_given(const T* rz, const T* rz_old, const T* rr_prev, const T* thresh, const T* z,
                  T* p, long long n, int nb, cudaStream_t s) {
  cg2_given<T, C><<<nb, kThreadsG2, 0, s>>>(rz, rz_old, rr_prev, thresh, z, p, n);
  return (int)cudaGetLastError();
}

// 4-row chunks per thread for n rows over nb blocks of nt threads (B2's
// and B3's): 1 or 2 held in registers, or 0 when more (the kernel then
// reads its rows again after the barrier).
int chunks_per_thread(long long n, int nb, int nt) {
  const long long threads = (long long)nb * nt;
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
  switch (chunks_per_thread(n, nb, kThreads1)) {
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

template <typename T, int C, int R>
int launch2(const T* rz_old, const T* rr_prev, const T* thresh, const T* r, const T* z,
            T* p, T* rz, T* partials, unsigned long long* sync, long long n, int nb,
            cudaStream_t s) {
  cg2_fused<T, C, R><<<nb, kThreads2, 0, s>>>(rz_old, rr_prev, thresh, r, z, p, rz,
                                             partials, sync, n);
  return (int)cudaGetLastError();
}

template <typename T, int C>
int update2(const T* rz_old, const T* rr_prev, const T* thresh, const T* r, const T* z,
            T* p, T* rz, T* partials, unsigned long long* sync, long long n, int nb,
            cudaStream_t s) {
  switch (chunks_per_thread(n, nb, kThreads2)) {
    case 1: return launch2<T, C, 1>(rz_old, rr_prev, thresh, r, z, p, rz, partials, sync, n, nb, s);
    case 2: return launch2<T, C, 2>(rz_old, rr_prev, thresh, r, z, p, rz, partials, sync, n, nb, s);
    default: return launch2<T, C, 0>(rz_old, rr_prev, thresh, r, z, p, rz, partials, sync, n, nb, s);
  }
}

// Blocks of cg2_fused<T, C, R> that the card holds at once, over all R.
template <typename T, int C>
int max_blocks2(int device, int* out) {
  int sms = 0, occ = 0, least = kMaxBlocksPerSm2;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const void* kernels[] = {(const void*)cg2_fused<T, C, 0>, (const void*)cg2_fused<T, C, 1>,
                           (const void*)cg2_fused<T, C, 2>};
  for (const void* k : kernels) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k, kThreads2, 0);
    if (e != cudaSuccess) return (int)e;
    least = occ < least ? occ : least;
  }
  *out = least * sms;
  return least > 0 ? 0 : (int)cudaErrorInvalidConfiguration;
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

// c = 1..4 columns to the template of C columns; other c: invalid value.
#define CG_BY_COLS(fn, ...)                                \
  switch (c) {                                             \
    case 1: return fn<T, 1>(__VA_ARGS__);                  \
    case 2: return fn<T, 2>(__VA_ARGS__);                  \
    case 3: return fn<T, 3>(__VA_ARGS__);                  \
    case 4: return fn<T, 4>(__VA_ARGS__);                  \
    default: return (int)cudaErrorInvalidValue;            \
  }

template <typename T>
int dispatch2(const void* rz_old, const void* rr_prev, const void* thresh, const void* r,
              const void* z, void* p, void* rz, void* partials, void* sync, long long n,
              int c, int nb, void* stream) {
  CG_BY_COLS(update2, (const T*)rz_old, (const T*)rr_prev, (const T*)thresh, (const T*)r,
             (const T*)z, (T*)p, (T*)rz, (T*)partials, (unsigned long long*)sync, n, nb,
             (cudaStream_t)stream)
}

template <typename T>
int dispatch_max_blocks2(int c, int device, int* out) {
  CG_BY_COLS(max_blocks2, device, out)
}

template <typename T>
int dispatch_dot(const void* a, const void* b, void* out, void* partials, void* ticket,
                 long long n, int c, int nb, void* stream) {
  CG_BY_COLS(dot, (const T*)a, (const T*)b, (T*)out, (T*)partials,
             (unsigned long long*)ticket, n, nb, (cudaStream_t)stream)
}

template <typename T>
int dispatch1_given(const void* pap, const void* rz, const void* rr_prev, const void* thresh,
                    const void* p, const void* ap, void* x, void* r, void* rr, void* partials,
                    void* ticket, long long n, int c, int nb, void* stream) {
  CG_BY_COLS(update1_given, (const T*)pap, (const T*)rz, (const T*)rr_prev,
             (const T*)thresh, (const T*)p, (const T*)ap, (T*)x, (T*)r, (T*)rr,
             (T*)partials, (unsigned long long*)ticket, n, nb, (cudaStream_t)stream)
}

template <typename T>
int dispatch_given_max_blocks(int c, int device, int* out) {
  CG_BY_COLS(given_max_blocks, device, out)
}

template <typename T>
int dispatch_given2_max_blocks(int c, int device, int* out) {
  CG_BY_COLS(given2_max_blocks, device, out)
}

template <typename T>
int dispatch2_given(const void* rz, const void* rz_old, const void* rr_prev,
                    const void* thresh, const void* z, void* p, long long n, int c, int nb,
                    void* stream) {
  CG_BY_COLS(update2_given, (const T*)rz, (const T*)rz_old, (const T*)rr_prev,
             (const T*)thresh, (const T*)z, (T*)p, n, nb, (cudaStream_t)stream)
}

#undef CG_BY_COLS

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
                   const void* z, void* p, void* rz, void* partials, void* sync, long long n,
                   int c, int nb, void* stream) {
  return dispatch2<float>(rz_old, rr_prev, thresh, r, z, p, rz, partials, sync, n, c, nb,
                          stream);
}

int cg_update2_f64(const void* rz_old, const void* rr_prev, const void* thresh, const void* r,
                   const void* z, void* p, void* rz, void* partials, void* sync, long long n,
                   int c, int nb, void* stream) {
  return dispatch2<double>(rz_old, rr_prev, thresh, r, z, p, rz, partials, sync, n, c, nb,
                           stream);
}

int cg_update2_max_blocks_f32(int c, int device, int* out) {
  return dispatch_max_blocks2<float>(c, device, out);
}

int cg_update2_max_blocks_f64(int c, int device, int* out) {
  return dispatch_max_blocks2<double>(c, device, out);
}

int cg_dot_f32(const void* a, const void* b, void* out, void* partials, void* ticket,
               long long n, int c, int nb, void* stream) {
  return dispatch_dot<float>(a, b, out, partials, ticket, n, c, nb, stream);
}

int cg_dot_f64(const void* a, const void* b, void* out, void* partials, void* ticket,
               long long n, int c, int nb, void* stream) {
  return dispatch_dot<double>(a, b, out, partials, ticket, n, c, nb, stream);
}

int cg_update1_given_f32(const void* pap, const void* rz, const void* rr_prev,
                         const void* thresh, const void* p, const void* ap, void* x, void* r,
                         void* rr, void* partials, void* ticket, long long n, int c, int nb,
                         void* stream) {
  return dispatch1_given<float>(pap, rz, rr_prev, thresh, p, ap, x, r, rr, partials, ticket,
                                n, c, nb, stream);
}

int cg_update1_given_f64(const void* pap, const void* rz, const void* rr_prev,
                         const void* thresh, const void* p, const void* ap, void* x, void* r,
                         void* rr, void* partials, void* ticket, long long n, int c, int nb,
                         void* stream) {
  return dispatch1_given<double>(pap, rz, rr_prev, thresh, p, ap, x, r, rr, partials, ticket,
                                 n, c, nb, stream);
}

int cg_given_max_blocks_f32(int c, int device, int* out) {
  return dispatch_given_max_blocks<float>(c, device, out);
}

int cg_given_max_blocks_f64(int c, int device, int* out) {
  return dispatch_given_max_blocks<double>(c, device, out);
}

int cg_update2_given_f32(const void* rz, const void* rz_old, const void* rr_prev,
                         const void* thresh, const void* z, void* p, long long n, int c,
                         int nb, void* stream) {
  return dispatch2_given<float>(rz, rz_old, rr_prev, thresh, z, p, n, c, nb, stream);
}

int cg_update2_given_f64(const void* rz, const void* rz_old, const void* rr_prev,
                         const void* thresh, const void* z, void* p, long long n, int c,
                         int nb, void* stream) {
  return dispatch2_given<double>(rz, rz_old, rr_prev, thresh, z, p, n, c, nb, stream);
}

int cg_update2_given_max_blocks_f32(int c, int device, int* out) {
  return dispatch_given2_max_blocks<float>(c, device, out);
}

int cg_update2_given_max_blocks_f64(int c, int device, int* out) {
  return dispatch_given2_max_blocks<double>(c, device, out);
}

}  // extern "C"
