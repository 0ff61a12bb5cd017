// K3: one fused Lanczos + GQL step with a dense A, in the diagonal-
// sandwich form w = s_out * (A @ (s_in * v)) + t * v (matvec launch + the
// shared tail launch of step_tail.cuh).
//
// Replaces the TPU kernel src/repro/kernels/lanczos_step.py, function
// fused_step_dense (pallas_call at line 187, body _dense_kernel at line
// 99 and _tail at line 64).
//
// Bound on the H100: bytes. Per iteration the step must read A once (8 N^2
// bytes in f64) and, with reorth, the banked basis (8 K M N bytes, 2.5
// times A at K = 64, M = 161), over 3.35 TB/s; the matvec's 2 K N^2 flops take
// less time at the card's FP64 tensor-core rate. This kernel does its FMAs
// on the CUDA cores, at half that rate, and reads A once per 64 lanes;
// chip_smoke.py prints its time beside the bound.
//
// Design, shared A: a register-tiled product acc = x A^T with x = s_in * v
// (K x N). One CTA of 128 threads owns a tile of 64 lanes x 32 output rows
// and walks its share of the columns 32 at a time: it stages the x tile and
// the A tile in shared memory, transposed so that the reads below are
// conflict-free, and each thread keeps a 4 lanes x 4 rows block of partial
// sums in registers (8 shared-memory reads per 16 FMAs). So A crosses
// device memory once per 64 lanes. To fill the card at N = 4177 (131 row
// tiles for 132 SMs), the columns are split into `splits` ranges, each
// written to its own (K, N) slice of the scratch; the tail adds the slices
// in a fixed order, so the result does not change from run to run.
// A per-lane A (K, N, N) is one matrix-vector product per lane: one CTA
// per (lane, 32 rows), each warp reading 4 rows side by side (coalesced)
// against the staged x, summed by a fixed xor-tree shuffle. The ragged N
// (for example 4177) is masked in place, where the TPU pads to 128
// (lanczos_step.py:147-165).
#include <cuda_runtime.h>

#include "recurrence.cuh"
#include "step_tail.cuh"

namespace {

// shared A: a 64-lane x 32-row tile per CTA, 32 columns per stage
constexpr int kGemmThreads = 128;
constexpr int kTileLanes = 64;
constexpr int kTileRows = 32;
constexpr int kTileCols = 32;

template <typename T>
__global__ void __launch_bounds__(kGemmThreads) shared_matvec_kernel(
    const T* a, const T* s_in, long long si_ls, long long si_es, const T* v, T* acc,
    long long lanes, long long n, long long cols_per_split) {
  // +1 pads keep the transposed stores and the tile reads conflict-free
  __shared__ T xs[kTileCols][kTileLanes + 1];
  __shared__ T as[kTileCols][kTileRows + 1];
  const long long lane0 = (long long)blockIdx.x * kTileLanes;
  const long long row0 = (long long)blockIdx.y * kTileRows;
  const long long c_lo = (long long)blockIdx.z * cols_per_split;
  const long long c_hi = (c_lo + cols_per_split < n) ? c_lo + cols_per_split : n;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;  // 16 x 8
  const int j_ld = threadIdx.x & 31, i_ld = threadIdx.x >> 5;  // loader: 32 x 4
  T part[4][4];  // [row ty + 8p][lane tx + 16q]
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) part[p][q] = T(0);

  for (long long c0 = c_lo; c0 < c_hi; c0 += kTileCols) {
    const long long col = c0 + j_ld;
    const bool col_ok = col < c_hi;
    __syncthreads();  // the previous tile is no longer read
#pragma unroll
    for (int e = 0; e < kTileLanes / 4; ++e) {
      const int l = i_ld + 4 * e;
      const long long lane = lane0 + l;
      T xv = T(0);
      if (col_ok && lane < lanes) xv = s_in[lane * si_ls + col * si_es] * v[lane * n + col];
      xs[j_ld][l] = xv;
    }
#pragma unroll
    for (int e = 0; e < kTileRows / 4; ++e) {
      const int i = i_ld + 4 * e;
      const long long row = row0 + i;
      as[j_ld][i] = (col_ok && row < n) ? a[row * n + col] : T(0);
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < kTileCols; ++j) {
      T xr[4], ar[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) xr[q] = xs[j][tx + 16 * q];
#pragma unroll
      for (int p = 0; p < 4; ++p) ar[p] = as[j][ty + 8 * p];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[p][q] += ar[p] * xr[q];
    }
  }
  T* out = acc + (long long)blockIdx.z * lanes * n;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const long long row = row0 + ty + 8 * p;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long lane = lane0 + tx + 16 * q;
      if (row < n && lane < lanes) out[lane * n + row] = part[p][q];
    }
  }
}

// per-lane A: one CTA per (lane, 32 rows)
constexpr int kLaneThreads = 256;
constexpr int kRowsPerWarp = 4;
constexpr int kLaneRows = (kLaneThreads / 32) * kRowsPerWarp;
constexpr int kChunk = 512;  // staged columns

template <typename T>
__global__ void __launch_bounds__(kLaneThreads) lane_matvec_kernel(
    const T* a, const T* s_in, long long si_ls, long long si_es, const T* v, T* acc,
    long long n) {
  __shared__ T xs[kChunk];
  const long long lane = blockIdx.x;
  const long long row0 = (long long)blockIdx.y * kLaneRows;
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const T* al = a + lane * n * n;
  const long long left = n - (row0 + warp * kRowsPerWarp);
  const int rows_here = left < 0 ? 0 : (left < kRowsPerWarp ? (int)left : kRowsPerWarp);
  T part[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) part[rr] = T(0);

  for (long long c0 = 0; c0 < n; c0 += kChunk) {
    __syncthreads();  // the previous chunk is no longer read
    for (int j = threadIdx.x; j < kChunk; j += kLaneThreads) {
      const long long col = c0 + j;
      xs[j] = col < n ? s_in[lane * si_ls + col * si_es] * v[lane * n + col] : T(0);
    }
    __syncthreads();
    const long long lim = (n - c0 < kChunk) ? (n - c0) : kChunk;
    const T* arow = al + (row0 + warp * kRowsPerWarp) * n + c0;
    for (int j = ln; j < lim; j += 32) {
      const T xv = xs[j];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr)
        if (rr < rows_here) part[rr] += arow[rr * n + j] * xv;  // uniform in the warp
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const long long row = row0 + warp * kRowsPerWarp + rr;
    const T s = repro::warp_sum(part[rr]);
    if (ln == 0 && row < n) acc[lane * n + row] = s;
  }
}

// ins:  a, s_out, s_in, t, v, v_prev, 8 scalars (K,), basis (or null)
// outs: alpha, beta, r, 8 raw, acc scratch (splits, K, n)
// dims: lanes, n, m, shared_a, so_ls, so_es, si_ls, si_es, t_ls, t_es, splits
// (a per-lane A takes splits = 1)
template <typename T>
int fused_step_dense(const void* const* ins, void* const* outs, const long long* dims,
                     void* stream) {
  const long long lanes = dims[0], n = dims[1], m = dims[2];
  const bool shared_a = dims[3] != 0;
  const long long splits = shared_a ? dims[10] : 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (lanes > 0 && n > 0) {
    const T* a = static_cast<const T*>(ins[0]);
    const T* s_in = static_cast<const T*>(ins[2]);
    const T* v = static_cast<const T*>(ins[4]);
    T* acc = static_cast<T*>(outs[11]);
    if (shared_a) {
      const long long per_split = ((n + splits - 1) / splits + kTileCols - 1) / kTileCols * kTileCols;
      dim3 grid((unsigned)((lanes + kTileLanes - 1) / kTileLanes),
                (unsigned)((n + kTileRows - 1) / kTileRows), (unsigned)splits);
      shared_matvec_kernel<T><<<grid, kGemmThreads, 0, s>>>(a, s_in, dims[6], dims[7], v, acc,
                                                             lanes, n, per_split);
    } else {
      dim3 grid((unsigned)lanes, (unsigned)((n + kLaneRows - 1) / kLaneRows));
      lane_matvec_kernel<T><<<grid, kLaneThreads, 0, s>>>(a, s_in, dims[6], dims[7], v, acc, n);
    }
    repro::TailArgs<T> ta;
    ta.acc = acc;
    ta.splits = (int)splits;
    ta.split_stride = lanes * n;
    ta.s_out = static_cast<const T*>(ins[1]);
    ta.so_ls = dims[4];
    ta.so_es = dims[5];
    ta.t = static_cast<const T*>(ins[3]);
    ta.t_ls = dims[8];
    ta.t_es = dims[9];
    ta.v = v;
    ta.v_prev = static_cast<const T*>(ins[5]);
    ta.basis = static_cast<const T*>(ins[14]);
    ta.m = (int)m;
    for (int j = 0; j < 8; ++j) ta.sc[j] = static_cast<const T*>(ins[6 + j]);
    ta.alpha = static_cast<T*>(outs[0]);
    ta.beta = static_cast<T*>(outs[1]);
    ta.r = static_cast<T*>(outs[2]);
    for (int j = 0; j < 8; ++j) ta.raw[j] = static_cast<T*>(outs[3 + j]);
    ta.n = n;
    repro::launch_tail<T>(ta, lanes, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_step_dense_f32(const void* const* ins, void* const* outs,
                                    const long long* dims, void* stream) {
  return fused_step_dense<float>(ins, outs, dims, stream);
}

extern "C" int fused_step_dense_f64(const void* const* ins, void* const* outs,
                                    const long long* dims, void* stream) {
  return fused_step_dense<double>(ins, outs, dims, stream);
}
