// K1: the Alg. 5 recurrence update over a flat batch of lanes.
//
// Replaces the TPU kernel src/repro/kernels/gql_update.py, function
// gql_update (pallas_call at line 95, body _kernel / recurrence_math).
//
// Bound on the H100: bytes. Each lane reads 10 and writes 8 values (144
// bytes in f64) for about 60 flops, far below the card's flops-per-byte
// balance, so the least time is 18 * 8 * B bytes over 3.35 TB/s; at the
// solver's batch sizes (B ~ 64) the launch itself dominates. Design: one
// thread per lane with a masked tail (no padded lanes, no fill values,
// unlike the TPU's pad to block=1024); the arithmetic lives once in
// recurrence.cuh.
#include <cuda_runtime.h>

#include "recurrence.cuh"

namespace {

template <typename T>
struct Ptrs {
  const T* in[10];  // alpha_n, beta_n, beta_p, g, c, delta, d_lr, d_rr, lam_min, lam_max
  T* out[8];        // g, c, delta, d_lr, d_rr, g_rr, g_lr, g_lo
};

template <typename T>
__global__ void gql_update_kernel(Ptrs<T> p, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  T o[8];
  repro::recurrence_math<T>(p.in[0][i], p.in[1][i], p.in[2][i], p.in[3][i],
                            p.in[4][i], p.in[5][i], p.in[6][i], p.in[7][i],
                            p.in[8][i], p.in[9][i], o);
#pragma unroll
  for (int k = 0; k < 8; ++k) p.out[k][i] = o[k];
}

template <typename T>
int launch(const void* const* ins, void* const* outs, long long n, void* stream) {
  Ptrs<T> p;
  for (int k = 0; k < 10; ++k) p.in[k] = static_cast<const T*>(ins[k]);
  for (int k = 0; k < 8; ++k) p.out[k] = static_cast<T*>(outs[k]);
  if (n > 0) {
    const int threads = 128;
    const long long blocks = (n + threads - 1) / threads;
    gql_update_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(p, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gql_update_f32(const void* const* ins, void* const* outs, long long n,
                              void* stream) {
  return launch<float>(ins, outs, n, stream);
}

extern "C" int gql_update_f64(const void* const* ins, void* const* outs, long long n,
                              void* stream) {
  return launch<double>(ins, outs, n, stream);
}
