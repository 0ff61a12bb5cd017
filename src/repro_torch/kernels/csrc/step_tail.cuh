// The tail of one fused Lanczos + GQL step, shared by K3 (dense_step.cu)
// and K4 (bell.cu).
//
// Replaces _tail / _write_tail of src/repro/kernels/lanczos_step.py
// (lines 64-92). On the TPU the tail runs inside the matvec kernel at its
// last column step, with the whole (lanes, N) accumulator in VMEM. On the
// H100 the tail's reductions over N need every column block of the
// matvec first, and blocks of one launch cannot wait for each other, so
// the tail is a second launch with one CTA per lane:
//   1. w = s_out * acc + t * v              (kept in the r output; acc is
//      the sum of the matvec's `splits` partial slices, in a fixed order)
//   2. alpha = <v, w>                       (block reduction)
//   3. r = w - alpha v - beta_p v_prev
//   4. with a basis: M dot products against the SAME r, then one
//      subtraction pass (classical Gram-Schmidt, lanczos_step.py:73-80)
//   5. beta = ||r||                          (block reduction)
//   6. thread 0 runs recurrence_math and writes alpha, beta and the 8 raw
//      values.
// Bound: bytes. It reads acc, v, v_prev (and s_out, t where they are
// vectors) and the basis once, and writes r; the reorth pass reads the
// basis a second time (from L2 when it fits). With a basis the two passes
// over it are most of the work: the dot products are taken kCoeffRows
// basis rows at a time, so each thread keeps that many independent loads
// in flight and one block reduction serves them all.
#pragma once

#include "recurrence.cuh"

namespace repro {

constexpr int kTailThreads = 512;
constexpr int kCoeffRows = 8;  // basis rows per pass of the dot products

template <typename T>
struct TailArgs {
  const T* acc;                       // (splits, K, n) partial A @ (s_in * v)
  int splits; long long split_stride; // slices, and K * n between them
  const T* s_out; long long so_ls, so_es;
  const T* t; long long t_ls, t_es;
  const T* v;                         // (K, n)
  const T* v_prev;                    // (K, n)
  const T* basis; int m;              // (K, m, n) or nullptr
  const T* sc[8];                     // (K,) beta_p, g, c, delta, d_lr, d_rr, lam_min, lam_max
  T* alpha; T* beta; T* r;            // (K,), (K,), (K, n)
  T* raw[8];                          // (K,) each
  long long n;
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
// of v[u] for u < count.
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
  if (w < R) {  // warp w sums value w over the warps (R <= warps)
    T s = l < nw ? red[l * R + w] : T(0);
    s = warp_sum(s);
    if (l == 0 && w < count) out[w] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kTailThreads) fused_tail_kernel(TailArgs<T> a) {
  __shared__ T red[32 * kCoeffRows];
  extern __shared__ __align__(16) unsigned char tail_smem[];
  T* coeff = reinterpret_cast<T*>(tail_smem);  // (m,)
  const long long k = blockIdx.x;
  const long long n = a.n;
  const T* acc = a.acc + k * n;
  const T* v = a.v + k * n;
  const T* vp = a.v_prev + k * n;
  T* r = a.r + k * n;
  const T* so = a.s_out + k * a.so_ls;
  const T* tt = a.t + k * a.t_ls;

  T part = T(0);
  for (long long i = threadIdx.x; i < n; i += blockDim.x) {
    T ax = acc[i];
    for (int sp = 1; sp < a.splits; ++sp) ax += acc[sp * a.split_stride + i];
    const T w = so[i * a.so_es] * ax + tt[i * a.t_es] * v[i];
    r[i] = w;
    part += v[i] * w;
  }
  const T alpha = block_sum(part, red);
  const T beta_p = a.sc[0][k];

  part = T(0);
  for (long long i = threadIdx.x; i < n; i += blockDim.x) {
    const T ri = r[i] - alpha * v[i] - beta_p * vp[i];
    r[i] = ri;
    part += ri * ri;
  }
  if (a.basis != nullptr) {
    const T* bk = a.basis + k * (long long)a.m * n;
    for (int m0 = 0; m0 < a.m; m0 += kCoeffRows) {
      T p[kCoeffRows];
#pragma unroll
      for (int u = 0; u < kCoeffRows; ++u) p[u] = T(0);
      for (long long i = threadIdx.x; i < n; i += blockDim.x) {
        const T ri = r[i];
#pragma unroll
        for (int u = 0; u < kCoeffRows; ++u)
          if (m0 + u < a.m) p[u] += bk[(m0 + u) * n + i] * ri;  // uniform in the block
      }
      block_sums<T, kCoeffRows>(p, red, coeff + m0, a.m - m0);
    }
    __syncthreads();
    part = T(0);
    for (long long i = threadIdx.x; i < n; i += blockDim.x) {
      T proj = T(0);
#pragma unroll 8
      for (int mm = 0; mm < a.m; ++mm) proj += coeff[mm] * bk[mm * n + i];
      const T ri = r[i] - proj;
      r[i] = ri;
      part += ri * ri;
    }
  }
  const T beta = sqrt(block_sum(part, red));
  if (threadIdx.x == 0) {
    T o[8];
    recurrence_math<T>(alpha, beta, beta_p, a.sc[1][k], a.sc[2][k], a.sc[3][k],
                       a.sc[4][k], a.sc[5][k], a.sc[6][k], a.sc[7][k], o);
    a.alpha[k] = alpha;
    a.beta[k] = beta;
#pragma unroll
    for (int j = 0; j < 8; ++j) a.raw[j][k] = o[j];
  }
}

template <typename T>
void launch_tail(const TailArgs<T>& a, long long lanes, cudaStream_t stream) {
  const size_t smem = (size_t)(a.m > 0 ? a.m : 1) * sizeof(T);
  fused_tail_kernel<T><<<(unsigned)lanes, kTailThreads, smem, stream>>>(a);
}

}  // namespace repro
