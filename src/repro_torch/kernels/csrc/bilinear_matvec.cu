// K6: fused bilinear matvec, y = A x and alpha = x^T A x, batched over
// independent systems, in one pass over A.
//
// Replaces the TPU kernel src/repro/kernels/bilinear_matvec.py, function
// fused_matvec (pallas_call at line 75, body _kernel at line 28): A (B, N, N)
// in f32 or bf16, x (B, N) rounded to f32, f32 accumulation, y (B, N) and
// alpha (B,) in f32, as src/repro/kernels/ref.py:10-15 defines them.
//
// Bound on the H100: bytes. The work is 2 flops per entry of A, each read
// once, so A's bytes over the memory rate (1.12 GB, about 0.33 ms, at the
// main path's (16, 4177, 4177) f32) are the least time; everything else is
// small beside them.
//
// Design (simple and right first): a warp per row, 16-byte loads along the
// row. N need not be a multiple of anything: at N = 4177 a row of A starts
// only 4-byte aligned, so each warp first takes the elements up to the next
// 16-byte boundary one by one (at most 3 in f32, 7 in bf16), then the
// aligned 16-byte vectors, then the tail, all in place: the wrapper does
// not pad A. A is read with streaming loads (evict first), so that x, read
// through the read-only cache by every row of its system, stays in L1.
// bf16 A is read as bf16 and widened in registers.
// A CTA of 8 warps owns 32 rows of one system and writes y for them.
//
// alpha needs a sum across CTAs. There are no atomics: each CTA writes the
// sum of x_i y_i over its rows (in row order) to a partial slot, and a
// second launch, one warp per system, adds the partial slots in a fixed
// order. Every sum here has one fixed order, so y and alpha are the same
// bits from run to run. (The TPU kernel adds alpha from partial y per
// column tile; the port is held to ref.py's value within the JAX tests'
// tolerances, not to that rounding order.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // rows of one system per CTA

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(double v) { return (float)v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename TA>
struct Vec;  // one 16-byte load of A, widened
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // a bf16 is the high half of an f32: widen by shifting
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename TA, typename TX>
__global__ void __launch_bounds__(kWarps * 32) fused_matvec_kernel(
    const TA* __restrict__ a, const TX* __restrict__ x, float* __restrict__ y,
    float* __restrict__ partial, long long n, int tiles) {
  __shared__ float prod[kRows];  // x_i * y_i of this CTA's rows
  constexpr int kV = Vec<TA>::kN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = blockIdx.y;
  const long long r0 = (long long)blockIdx.x * kRows;
  const TX* xb = x + b * n;

  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int local = warp + kWarps * k;
    const long long i = r0 + local;
    float p = 0.0f;
    if (i < n) {
      const TA* row = a + (b * n + i) * n;
      // elements before the first 16-byte boundary of the row
      const uintptr_t addr = reinterpret_cast<uintptr_t>(row);
      long long head = (long long)(((16 - (addr & 15)) & 15) / sizeof(TA));
      if (head > n) head = n;
      const long long nvec = (n - head) / kV;
      const long long body_end = head + nvec * kV;
      float s = 0.0f;
      if (lane < head) s = fmaf(to_f(row[lane]), to_f(__ldg(xb + lane)), s);
      const TA* body = row + head;
      const TX* xbody = xb + head;
#pragma unroll 4
      for (long long v = lane; v < nvec; v += 32) {
        float av[kV];
        Vec<TA>::load(body + v * kV, av);
#pragma unroll
        for (int c = 0; c < kV; ++c) s = fmaf(av[c], to_f(__ldg(xbody + v * kV + c)), s);
      }
      for (long long j = body_end + lane; j < n; j += 32)
        s = fmaf(to_f(row[j]), to_f(__ldg(xb + j)), s);
      const float yi = warp_sum(s);
      if (lane == 0) y[b * n + i] = yi;
      p = to_f(__ldg(xb + i)) * yi;
    }
    if (lane == 0) prod[local] = p;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int r = 0; r < kRows; ++r) s += prod[r];  // rows in order
    partial[b * tiles + blockIdx.x] = s;
  }
}

// alpha[b] = sum over tiles of partial[b, :], one warp per system, in a
// fixed order (each lane a strided run of tiles, then a fixed butterfly)
__global__ void alpha_kernel(const float* __restrict__ partial, float* __restrict__ alpha,
                             int tiles) {
  const long long b = blockIdx.x;
  float s = 0.0f;
  for (int t = threadIdx.x; t < tiles; t += 32) s += partial[b * tiles + t];
  s = warp_sum(s);
  if (threadIdx.x == 0) alpha[b] = s;
}

// ins: A (B, N, N), x (B, N); outs: y (B, N) f32, alpha (B,) f32,
// partial (B, tiles) f32 scratch with tiles = ceil(N / 32); dims: B, N
template <typename TA, typename TX>
int fused_matvec(const void* const* ins, void* const* outs, const long long* dims,
                 void* stream) {
  const long long nb = dims[0], n = dims[1];
  if (nb <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const long long tiles = (n + kRows - 1) / kRows;
  if (nb > 65535 || tiles > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  float* partial = static_cast<float*>(outs[2]);
  fused_matvec_kernel<TA, TX><<<dim3((unsigned)tiles, (unsigned)nb), kWarps * 32, 0, s>>>(
      static_cast<const TA*>(ins[0]), static_cast<const TX*>(ins[1]),
      static_cast<float*>(outs[0]), partial, n, (int)tiles);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  alpha_kernel<<<(unsigned)nb, 32, 0, s>>>(partial, static_cast<float*>(outs[1]), (int)tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_matvec_f32_f32(const void* const* ins, void* const* outs,
                                    const long long* dims, void* stream) {
  return fused_matvec<float, float>(ins, outs, dims, stream);
}
extern "C" int fused_matvec_f32_f64(const void* const* ins, void* const* outs,
                                    const long long* dims, void* stream) {
  return fused_matvec<float, double>(ins, outs, dims, stream);
}
extern "C" int fused_matvec_bf16_f32(const void* const* ins, void* const* outs,
                                     const long long* dims, void* stream) {
  return fused_matvec<__nv_bfloat16, float>(ins, outs, dims, stream);
}
extern "C" int fused_matvec_bf16_f64(const void* const* ins, void* const* outs,
                                     const long long* dims, void* stream) {
  return fused_matvec<__nv_bfloat16, double>(ins, outs, dims, stream);
}
