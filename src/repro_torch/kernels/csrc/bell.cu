// K2: blocked-ELL SpMV y = A x, and K4: one fused Lanczos + GQL step on a
// blocked-ELL A (matvec launch + the shared tail launch).
//
// Replaces the TPU kernels
//   K2 src/repro/kernels/spmv_bell.py, function bell_matvec (pallas_call
//      at line 63, body _kernel at line 30);
//   K4 src/repro/kernels/lanczos_step.py, function fused_step_bell
//      (pallas_call at line 267, body _bell_kernel at line 205).
//
// Bound on the H100: bytes. Each stored bs x bs block is read once per
// lane for 2 flops per entry (f32 data: 2 flops per 4 bytes), so the
// least time is the bytes of `data` plus the vectors over 3.35 TB/s.
// When the block table is shared by all lanes, the lanes' CTAs for one
// block row run side by side and the repeated reads of `data` come from
// L2, so the table crosses device memory about once per call.
//
// Design: one CTA per (block row r, lane), 128 threads. The CTA reads its
// own cols[r, k] (in place of the TPU's scalar prefetch), stages the
// gathered x tile (for K4: s_in * v) in shared memory, and walks k. Each
// warp owns a set of the block's rows; its 32 threads read one row of
// the block side by side (coalesced) and a fixed xor-tree shuffle sums
// them, so the result is the same from run to run. The per-row sums
// accumulate over the k walk in shared memory. Shared versus per-lane
// tables is a lane stride of 0. K2 accumulates and writes f32 (the TPU
// contract, spmv_bell.py:38-40, :66); K4 casts `data` to the vector
// dtype and accumulates there, as lanczos_step.py:221 does.
#include <cuda_runtime.h>

#include "recurrence.cuh"
#include "step_tail.cuh"

namespace {

constexpr int kThreads = 128;

template <typename TD, typename TV, typename TA>
__global__ void __launch_bounds__(kThreads) bell_matvec_kernel(
    const TD* data, const int* cols, const TV* x, const TV* s_in, long long si_ls,
    long long si_es, TA* y, int kb, int bs, long long data_ls, long long cols_ls,
    long long x_ls, long long y_ls) {
  extern __shared__ __align__(16) unsigned char bell_smem[];
  TA* xs = reinterpret_cast<TA*>(bell_smem);  // (bs,) gathered x tile
  TA* ys = xs + bs;                           // (bs,) row sums
  const long long r = blockIdx.x;
  const long long lane = blockIdx.y;
  const TD* d = data + lane * data_ls + r * kb * (long long)bs * bs;
  const int* c = cols + lane * cols_ls + r * kb;
  const TV* xl = x + lane * x_ls;
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int i = threadIdx.x; i < bs; i += blockDim.x) ys[i] = TA(0);
  for (int k = 0; k < kb; ++k) {
    const long long c0 = (long long)c[k] * bs;
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < bs; j += blockDim.x) {
      TA xv;
      if (s_in != nullptr) {
        xv = TA(s_in[lane * si_ls + (c0 + j) * si_es] * xl[c0 + j]);
      } else {
        xv = TA(xl[c0 + j]);
      }
      xs[j] = xv;
    }
    __syncthreads();
    const TD* blk = d + (long long)k * bs * bs;
    for (int i = warp; i < bs; i += nw) {
      TA part = TA(0);
      for (int j = ln; j < bs; j += 32) part += TA(blk[(long long)i * bs + j]) * xs[j];
      part = repro::warp_sum(part);
      if (ln == 0) ys[i] += part;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < bs; i += blockDim.x) y[lane * y_ls + r * bs + i] = ys[i];
}

// dims: lanes, R, Kb, bs, data_ls, cols_ls (lane strides in elements, 0 = shared)
template <typename TD>
int bell_matvec(const void* const* ins, void* const* outs, const long long* dims,
                void* stream) {
  const long long lanes = dims[0], nr = dims[1], kb = dims[2], bs = dims[3];
  if (lanes > 0 && nr > 0) {
    const size_t smem = 2 * (size_t)bs * sizeof(float);
    bell_matvec_kernel<TD, float, float>
        <<<dim3((unsigned)nr, (unsigned)lanes), kThreads, smem, (cudaStream_t)stream>>>(
            static_cast<const TD*>(ins[0]), static_cast<const int*>(ins[1]),
            static_cast<const float*>(ins[2]), nullptr, 0, 0, static_cast<float*>(outs[0]),
            (int)kb, (int)bs, dims[4], dims[5], nr * bs, nr * bs);
  }
  return (int)cudaGetLastError();
}

// ins:  data, cols, s_out, s_in, t, v, v_prev, 8 scalars (K,)
// outs: alpha, beta, r, 8 raw, acc scratch (K, n)
// dims: lanes, R, Kb, bs, data_ls, cols_ls, so_ls, so_es, si_ls, si_es, t_ls, t_es
template <typename TD, typename TV>
int fused_step_bell(const void* const* ins, void* const* outs, const long long* dims,
                    void* stream) {
  const long long lanes = dims[0], nr = dims[1], kb = dims[2], bs = dims[3];
  const long long n = nr * bs;
  cudaStream_t s = (cudaStream_t)stream;
  if (lanes > 0 && nr > 0) {
    const size_t smem = 2 * (size_t)bs * sizeof(TV);
    bell_matvec_kernel<TD, TV, TV><<<dim3((unsigned)nr, (unsigned)lanes), kThreads, smem, s>>>(
        static_cast<const TD*>(ins[0]), static_cast<const int*>(ins[1]),
        static_cast<const TV*>(ins[5]), static_cast<const TV*>(ins[3]), dims[8], dims[9],
        static_cast<TV*>(outs[11]), (int)kb, (int)bs, dims[4], dims[5], n, n);
    repro::TailArgs<TV> a;
    a.acc = static_cast<const TV*>(outs[11]);
    a.splits = 1;
    a.split_stride = 0;
    a.s_out = static_cast<const TV*>(ins[2]);
    a.so_ls = dims[6];
    a.so_es = dims[7];
    a.t = static_cast<const TV*>(ins[4]);
    a.t_ls = dims[10];
    a.t_es = dims[11];
    a.v = static_cast<const TV*>(ins[5]);
    a.v_prev = static_cast<const TV*>(ins[6]);
    a.basis = nullptr;
    a.m = 0;
    for (int j = 0; j < 8; ++j) a.sc[j] = static_cast<const TV*>(ins[7 + j]);
    a.alpha = static_cast<TV*>(outs[0]);
    a.beta = static_cast<TV*>(outs[1]);
    a.r = static_cast<TV*>(outs[2]);
    for (int j = 0; j < 8; ++j) a.raw[j] = static_cast<TV*>(outs[3 + j]);
    a.n = n;
    repro::launch_tail<TV>(a, lanes, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bell_matvec_f32(const void* const* ins, void* const* outs,
                               const long long* dims, void* stream) {
  return bell_matvec<float>(ins, outs, dims, stream);
}

extern "C" int bell_matvec_f64(const void* const* ins, void* const* outs,
                               const long long* dims, void* stream) {
  return bell_matvec<double>(ins, outs, dims, stream);
}

extern "C" int fused_step_bell_f32_f64(const void* const* ins, void* const* outs,
                                       const long long* dims, void* stream) {
  return fused_step_bell<float, double>(ins, outs, dims, stream);
}

extern "C" int fused_step_bell_f64_f64(const void* const* ins, void* const* outs,
                                       const long long* dims, void* stream) {
  return fused_step_bell<double, double>(ins, outs, dims, stream);
}

extern "C" int fused_step_bell_f32_f32(const void* const* ins, void* const* outs,
                                       const long long* dims, void* stream) {
  return fused_step_bell<float, float>(ins, outs, dims, stream);
}
