// K1: the Alg. 5 recurrence update over a flat batch of lanes.
//
// Replaces the TPU kernel src/repro/kernels/gql_update.py, function
// gql_update (pallas_call at line 95, body _kernel / recurrence_math).
//
// Bound on the H100: bytes, on paper. Each lane reads 10 and writes 8
// values (144 bytes in f64) for about 60 flops, far below the card's
// flops-per-byte balance, so the least time is 18 * 8 * B bytes over
// 3.35 TB/s: under 0.2 us even at B = 4177. The solver calls it with B =
// 1-4177 lanes, where that bound is far below the cost of a launch, so
// the design is about the call, not the bytes:
//   * every operand is read where it lies, as a pointer and a lane
//     stride; stride 0 is a broadcast value (the solver's 0-d lam_min /
//     lam_max), so the wrapper copies and allocates nothing for it;
//   * the eight outputs are the rows of one (8, B) buffer;
//   * the ten pointer / stride pairs travel in one struct;
//   * one thread a lane with a masked tail, the block sized to the lane
//     count (one warp at B <= 32).
// Tensor cores, TMA and clusters have no work here: there is no product
// and no tile to stage. empty_kernel is the launch floor the timing
// reports beside K1 (a launch that does nothing).
#include <cuda_runtime.h>

#include "recurrence.cuh"

// in: alpha_n, beta_n, beta_p, g, c, delta, d_lr, d_rr, lam_min, lam_max
// out rows: g, c, delta, d_lr, d_rr, g_rr, g_lr, g_lo (row k at out + k * n)
// (outside the unnamed namespace: the C entry points take it, and a
// type of internal linkage would give them internal linkage too)
struct Args {
  const void* in[10];
  long long stride[10];
  void* out;
  long long n;
};

namespace {

template <typename T>
__global__ void __launch_bounds__(128) gql_update_kernel(const Args a) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  T x[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    const T* __restrict__ src = static_cast<const T*>(a.in[k]);
    x[k] = __ldg(src + i * a.stride[k]);
  }
  T o[8];
  repro::recurrence_math<T>(x[0], x[1], x[2], x[3], x[4], x[5], x[6], x[7],
                            x[8], x[9], o);
  T* __restrict__ dst = static_cast<T*>(a.out);
#pragma unroll
  for (int k = 0; k < 8; ++k) dst[k * a.n + i] = o[k];
}

__global__ void empty_kernel() {}

template <typename T>
int launch(const Args* a, void* stream) {
  if (a->n > 0) {
    const long long warps = (a->n + 31) / 32;
    const int threads = warps >= 4 ? 128 : (int)warps * 32;
    const long long blocks = (a->n + threads - 1) / threads;
    gql_update_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(*a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gql_update_f32(const Args* a, void* stream) {
  return launch<float>(a, stream);
}

extern "C" int gql_update_f64(const Args* a, void* stream) {
  return launch<double>(a, stream);
}

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
