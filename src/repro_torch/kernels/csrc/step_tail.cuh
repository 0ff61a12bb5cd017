// The tail of one fused Lanczos + GQL step, shared by K3 (dense_step.cu)
// and K4 (bell.cu).
//
// Replaces _tail / _write_tail of src/repro/kernels/lanczos_step.py
// (lines 64-92). On the TPU the tail runs inside the matvec kernel at its
// last column step, with the whole (lanes, N) accumulator in VMEM. On the
// H100 the tail's reductions over N need every column block of the
// matvec first, and blocks of one launch cannot wait for each other, so
// the tail is a second launch:
//   1. w = s_out * acc + t * v              (acc is the sum of the
//      matvec's `splits` partial slices, in a fixed order)
//   2. alpha = <v, w>
//   3. r = w - alpha v - beta_p v_prev
//   4. with a basis: the dot products of r with the live basis rows, then
//      one subtraction pass (classical Gram-Schmidt, lanczos_step.py:73-80)
//   5. beta = ||r||
//   6. thread 0 of rank 0 runs recurrence_math and writes alpha, beta and
//      the 8 raw values.
//
// Bound on the H100: bytes. It reads acc, v, v_prev (and s_out, t where
// they are vectors) and the live basis rows once, and writes r. The
// Gram-Schmidt pass needs every dot product before any subtraction, so it
// reads the live rows a second time (from L2 where they fit).
//
// Design: a thread-block cluster of C CTAs per lane (C = 1, 2, 4 or 8).
// Rank c owns the contiguous slice [c * per, (c + 1) * per) of N and keeps
// its slice of w and r in shared memory across the passes, so r never
// round-trips through device memory (when a slice would not fit, r stays
// in the r output instead). Every reduction is a fixed-order block sum in
// each CTA, written to a slot in its shared memory, then, after
// cluster.sync(), each CTA adds the C slots in rank order 0..C-1 through
// distributed shared memory: all ranks get the same bits, and so does
// every run. At 64 lanes C = 4 gives 256 CTAs, about two per SM, where a
// CTA per lane left half the card idle (tail_cluster picks C from the
// card's SM count; timed on the card, 4 beat 1, 2 and 8 there, PERF.md).
//
// Live rows: at solver step s only basis rows 0 .. min(s + 2, M) - 1 can
// be non-zero (the solver writes rows 0 and 1 at init and row
// min(s + 2, M - 1) after step s). The optional device-side count `rows`
// bounds both basis passes; without it the tail reads all M rows, as the
// reference does. The skipped rows are exact zeros, which add exact zeros
// in the reference, so the result is the reference's up to summation order.
#pragma once

#include <cooperative_groups.h>

#include "recurrence.cuh"

namespace repro {

namespace cg = cooperative_groups;

constexpr int kTailThreads = 256;
constexpr int kCoeffRows = 8;        // basis rows per pass of the dot products
constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr int kSliceSmemBytes = 96 * 1024;  // largest r slice kept on chip

template <typename T>
struct TailArgs {
  const T* acc;                       // (splits, K, n) partial A @ (s_in * v)
  int splits; long long split_stride; // slices, and K * n between them
  const T* s_out; long long so_ls, so_es;
  const T* t; long long t_ls, t_es;
  const T* v;                         // (K, n)
  const T* v_prev;                    // (K, n)
  const T* basis; int m;              // (K, m, n) or nullptr
  const int* rows = nullptr;          // device count of live basis rows, or null: all m
  const T* sc[8];                     // (K,) beta_p, g, c, delta, d_lr, d_rr, lam_min, lam_max
  T* alpha; T* beta; T* r;            // (K,), (K,), (K, n)
  T* raw[8];                          // (K,) each
  long long n;
  long long per = 0;                  // slice of N per rank (set by launch_tail)
  int slice_smem = 0;                 // 1: r slice in shared memory
};

template <typename T>
__device__ T block_sum(T v, T* red) {
  v = warp_sum(v);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  __syncthreads();  // red may still be read by a previous call
  if (l == 0) red[w] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    T s = (l < (int)(blockDim.x >> 5)) ? red[l] : T(0);
    s = warp_sum(s);
    if (l == 0) red[0] = s;
  }
  __syncthreads();
  return red[0];
}

// The block-wide sums of R values per thread at once; out[u] gets the sum
// of v[u] for u < count (warp sums, then the warps' in warp order).
template <typename T, int R>
__device__ void block_sums(T (&v)[R], T* red, T* out, int count) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31, nw = blockDim.x >> 5;
#pragma unroll
  for (int u = 0; u < R; ++u) v[u] = warp_sum(v[u]);
  __syncthreads();  // red may still be read by a previous call
  if (l == 0) {
#pragma unroll
    for (int u = 0; u < R; ++u) red[w * R + u] = v[u];
  }
  __syncthreads();
  if ((int)threadIdx.x < R && (int)threadIdx.x < count) {
    T s = T(0);
    for (int ww = 0; ww < nw; ++ww) s += red[ww * R + threadIdx.x];
    out[threadIdx.x] = s;
  }
}

// The cluster-wide sum of `local` (this CTA's block sum): rank c writes it
// to slot[0] of its shared memory; after cluster.sync() every thread adds
// the ranks' slots in rank order.
template <typename T>
__device__ T cluster_sum(T local, T* slot, cg::cluster_group& cl) {
  if (threadIdx.x == 0) slot[0] = local;
  cl.sync();
  T s = T(0);
  const unsigned nc = cl.num_blocks();
  for (unsigned c = 0; c < nc; ++c) s += *cl.map_shared_rank(slot, c);
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kTailThreads) fused_tail_kernel(TailArgs<T> a) {
  __shared__ T red[32 * kCoeffRows];
  extern __shared__ __align__(16) unsigned char tail_smem[];
  cg::cluster_group cl = cg::this_cluster();
  const unsigned rank = cl.block_rank();
  const long long k = blockIdx.x / cl.num_blocks();
  const long long n = a.n;
  const int m = a.basis != nullptr ? a.m : 0;
  // shared memory: coefficient parts (m), coefficients (m), 4 slots, r slice
  T* cpart = reinterpret_cast<T*>(tail_smem);
  T* coeff = cpart + m;
  T* slots = coeff + m;
  const long long lo = (long long)rank * a.per;
  const long long hi = (lo + a.per < n) ? lo + a.per : n;
  T* rs = a.slice_smem ? slots + 4 - lo : a.r + k * n;  // r at global index i
  T* r = a.r + k * n;
  const T* acc = a.acc + k * n;
  const T* v = a.v + k * n;
  const T* vp = a.v_prev + k * n;
  const T* so = a.s_out + k * a.so_ls;
  const T* tt = a.t + k * a.t_ls;
  int live = m;
  if (m > 0 && a.rows != nullptr) {
    const int c = *a.rows;
    live = c < 0 ? 0 : (c < m ? c : m);
  }

  T part = T(0);
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    T ax = acc[i];
    for (int sp = 1; sp < a.splits; ++sp) ax += acc[sp * a.split_stride + i];
    const T w = so[i * a.so_es] * ax + tt[i * a.t_es] * v[i];
    rs[i] = w;
    part += v[i] * w;
  }
  const T alpha = cluster_sum(block_sum(part, red), slots + 0, cl);
  const T beta_p = a.sc[0][k];

  part = T(0);
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const T ri = rs[i] - alpha * v[i] - beta_p * vp[i];
    if (live == 0) {
      r[i] = ri;
    } else {
      rs[i] = ri;
    }
    part += ri * ri;
  }
  if (live > 0) {
    const T* bk = a.basis + k * (long long)a.m * n;
    // dot products kCoeffRows rows at a time: each thread keeps that many
    // independent loads in flight, and one block reduction serves them all
    for (int m0 = 0; m0 < live; m0 += kCoeffRows) {
      T p[kCoeffRows];
#pragma unroll
      for (int u = 0; u < kCoeffRows; ++u) p[u] = T(0);
      for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
        const T ri = rs[i];
#pragma unroll
        for (int u = 0; u < kCoeffRows; ++u)
          if (m0 + u < live) p[u] += bk[(m0 + u) * n + i] * ri;  // uniform in the block
      }
      block_sums<T, kCoeffRows>(p, red, cpart + m0, live - m0);
    }
    cl.sync();  // every rank's coefficient parts are written
    for (int u = threadIdx.x; u < live; u += blockDim.x) {
      T s = T(0);
      for (unsigned c = 0; c < cl.num_blocks(); ++c) s += *cl.map_shared_rank(cpart + u, c);
      coeff[u] = s;
    }
    __syncthreads();
    part = T(0);
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      T proj = T(0);
#pragma unroll 8
      for (int mm = 0; mm < live; ++mm) proj += coeff[mm] * bk[mm * n + i];
      const T ri = rs[i] - proj;
      r[i] = ri;
      part += ri * ri;
    }
  }
  const T beta = sqrt(cluster_sum(block_sum(part, red), slots + 1, cl));
  if (rank == 0 && threadIdx.x == 0) {
    T o[8];
    recurrence_math<T>(alpha, beta, beta_p, a.sc[1][k], a.sc[2][k], a.sc[3][k],
                       a.sc[4][k], a.sc[5][k], a.sc[6][k], a.sc[7][k], o);
    a.alpha[k] = alpha;
    a.beta[k] = beta;
#pragma unroll
    for (int j = 0; j < 8; ++j) a.raw[j][k] = o[j];
  }
  cl.sync();  // no CTA leaves while another may still read its slots
}

// The cluster size for `lanes` lanes of length n: the smallest power of
// two that gives every SM of the card a CTA, while every rank keeps at
// least one element per thread. The SM count is read once per process, on
// the first launch's device: it only steers the choice.
inline int tail_cluster(long long lanes, long long n) {
  static const int sms = [] {
    int count = 132, dev = 0;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  int c = 1;
  while (c < kMaxCluster && lanes * c < sms && n / (2 * c) >= kTailThreads) c *= 2;
  return c;
}

// Launch the tail over `lanes` lanes as clusters of tail_cluster's size.
// Returns the launch's error.
template <typename T>
cudaError_t launch_tail(TailArgs<T> a, long long lanes, cudaStream_t stream) {
  const int c = tail_cluster(lanes, a.n);
  a.per = (a.n + c - 1) / c;
  const int m = a.basis != nullptr ? a.m : 0;
  size_t smem = (2 * (size_t)m + 4) * sizeof(T);
  a.slice_smem = (a.per * (long long)sizeof(T) <= kSliceSmemBytes) ? 1 : 0;
  if (a.slice_smem) smem += (size_t)a.per * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_tail_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(lanes * c));
  cfg.blockDim = dim3(kTailThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fused_tail_kernel<T>, a);
}

}  // namespace repro
