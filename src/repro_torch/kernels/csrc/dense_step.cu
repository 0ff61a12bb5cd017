// K3: one fused Lanczos + GQL step with a dense A, in the diagonal-
// sandwich form w = s_out * (A @ (s_in * v)) + t * v (matvec launch + the
// shared tail launch of step_tail.cuh).
//
// Replaces the TPU kernel src/repro/kernels/lanczos_step.py, function
// fused_step_dense (pallas_call at line 187, body _dense_kernel at line
// 99 and _tail at line 64).
//
// Bound on the H100: bytes. Per iteration the step must read A once (8 N^2
// bytes in f64, 0.042 ms at N = 4177) and, with reorth, the live rows of
// the banked basis (8 K R N bytes for R live rows: at R = 161, K = 64, 2.5
// times A), over 3.35 TB/s. The matvec's 2 K N^2 flops take 0.033 ms at the
// card's FP64 tensor-core rate (67 TFLOP/s), under the bytes of A.
//
// Matvec, shared f64 A (the main path, and the masked sandwich of the
// argmax round): the product acc^T = A (s_in * v)^T on the FP64 tensor
// cores, mma.sync m16n8k16 f64 (the shape PTX 7.8 adds for sm_90; wgmma
// has no f64), M = the rows of A, N = the lanes, K = the columns of A. A
// CTA owns a tile of 128 rows x 64 lanes, so A crosses device memory once
// per 64 lanes; its warps own
// 32 x 32 sub-tiles (16 accumulator fragments each). A and the lanes' v
// (and s_in where it is a vector) stream through a 3-stage cp.async ring,
// so loads overlap the MMAs. A's rows start only 8-byte aligned at odd N
// (4177 * 8 = 33,416 bytes: no TMA tensor map takes that stride), so the
// copies are 8 bytes each, and the ragged edges are zero-filled in place;
// A is never padded or copied. Shared rows are padded by 4 doubles, so
// fragment reads are free of bank conflicts. The columns are split into
// `splits` ranges, each written to its own (K, N) slice of the scratch,
// and the tail adds the slices in a fixed order: the result has the same
// bits from run to run. The shape was chosen by timing on the card (PERF.md
// keeps the sweep): m16n8k16 beat m8n8k4, and 128-row tiles beat 64-row
// ones, at the main path's 64 lanes and N = 4177; lanczos_step.py derives
// the split count from the card's SM count (4 there).
//
// Other routes, unchanged: a shared f32 A keeps the CUDA-core tile below
// (f32 must not go through TF32; it is not on the main path): 64 lanes x
// 32 rows per CTA, 4 x 4 register blocks, 32 columns per stage. A per-lane
// A (K, N, N) is one matrix-vector product per lane, bytes-bound, where
// tensor cores gain nothing: one CTA per (lane, 32 rows), each warp
// reading 4 rows side by side (coalesced) against the staged x, summed by
// a fixed xor-tree shuffle.
//
// Tail: step_tail.cuh, a cluster of CTAs per lane over the live basis
// rows only when the caller passes their count (`rows`, read on the card).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "recurrence.cuh"
#include "step_tail.cuh"

namespace {

// ---------------------------------------------------------------------------
// shared f64 A: FP64 tensor cores (mma.sync m16n8k16)

constexpr int kDmmaRows = 128;          // rows of A per CTA
constexpr int kDmmaThreads = 2 * kDmmaRows;
constexpr int kDmmaLanes = 64;          // lanes per CTA
constexpr int kDmmaCols = 32;           // columns per stage
constexpr int kDmmaStages = 3;
constexpr int kDmmaLd = kDmmaCols + 4;  // padded shared row, in doubles

template <bool kVecScale>
constexpr int dmma_smem_bytes() {
  return kDmmaStages * (kDmmaRows + (kVecScale ? 2 : 1) * kDmmaLanes) * kDmmaLd * 8;
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src, bool in) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// c (16 x 8) += a (16 x 16, row) * b (16 x 8, col), the f64 shape PTX 7.8
// adds for sm_90: per thread a_i at (row g + 8 (i % 2), col t + 4 (i / 2)),
// b_i at (row t + 4 i, col g), c_q at (row g + 8 (q / 2), col 2 t + q % 2)
// for the fragment's row g = lane / 4 and column t = lane % 4
__device__ __forceinline__ void dmma16816(double& c0, double& c1, double& c2, double& c3,
                                          const double (&a)[8], const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(c0), "+d"(c1), "+d"(c2), "+d"(c3)
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
        "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// acc[split][lane][row] = sum over the split's columns col of
// A[row, col] * s_in[lane, col] * v[lane, col]; s_in is one scalar unless
// kVecScale, then a contiguous (lanes, n) tensor. Each warp issues 8
// m16n8k16 instructions per 16 columns of its 32 x 32 tile.
template <bool kVecScale>
__global__ void __launch_bounds__(kDmmaThreads, 1) dmma_matvec_kernel(
    const double* __restrict__ a, const double* __restrict__ s_in, const double* __restrict__ v,
    double* __restrict__ acc, long long lanes, long long n, long long cols_per_split) {
  constexpr int kRows = kDmmaRows;
  constexpr int kWarps = kDmmaThreads / 32;  // kRows / 32 along the rows x 2 along the lanes
  constexpr int kStage = (kRows + (kVecScale ? 2 : 1) * kDmmaLanes) * kDmmaLd;
  extern __shared__ __align__(16) double dsm[];
  const long long row0 = (long long)blockIdx.x * kRows;
  const long long lane0 = (long long)blockIdx.y * kDmmaLanes;
  const long long c_lo = (long long)blockIdx.z * cols_per_split;
  const long long c_hi = (c_lo + cols_per_split < n) ? c_lo + cols_per_split : n;
  const int nk = c_hi > c_lo ? (int)((c_hi - c_lo + kDmmaCols - 1) / kDmmaCols) : 0;
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const int g = ln >> 2, tq = ln & 3;             // the fragments' row and column
  const int wm = warp % (kRows / 32), wn = warp / (kRows / 32);
  const int jl = ln, il = warp;                   // loader: column jl, rows il + kWarps e
  const double sc = kVecScale ? 1.0 : s_in[0];

  auto load_stage = [&](int kt, int slot) {
    double* as = dsm + slot * kStage;
    double* xs = as + kRows * kDmmaLd;
    double* ss = xs + kDmmaLanes * kDmmaLd;
    const long long col = c_lo + (long long)kt * kDmmaCols + jl;
    const bool col_ok = col < c_hi;
#pragma unroll
    for (int e = 0; e < kRows / kWarps; ++e) {
      const int i = il + kWarps * e;
      const bool in = col_ok && row0 + i < n;
      cp_async8(as + i * kDmmaLd + jl, in ? a + (row0 + i) * n + col : a, in);
    }
#pragma unroll
    for (int e = 0; e < kDmmaLanes / kWarps; ++e) {
      const int l = il + kWarps * e;
      const bool in = col_ok && lane0 + l < lanes;
      cp_async8(xs + l * kDmmaLd + jl, in ? v + (lane0 + l) * n + col : v, in);
      if constexpr (kVecScale)
        cp_async8(ss + l * kDmmaLd + jl, in ? s_in + (lane0 + l) * n + col : s_in, in);
    }
  };

  // the warp's 32 x 32 accumulator: [row fragment][lane fragment][values]
  // as (2 x 4 x 4)
  double cr[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) cr[q] = 0.0;

#pragma unroll
  for (int st = 0; st < kDmmaStages - 1; ++st) {
    if (st < nk) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kDmmaStages - 2>();
    __syncthreads();  // stage kt landed for all threads; stage kt - 1 is free
    {
      const int nx = kt + kDmmaStages - 1;
      if (nx < nk) load_stage(nx, nx % kDmmaStages);
      cp_async_commit();
    }
    const double* as = dsm + (kt % kDmmaStages) * kStage + (wm * 32 + g) * kDmmaLd + tq;
    const double* xs = dsm + (kt % kDmmaStages) * kStage + kRows * kDmmaLd +
                       (wn * 32 + g) * kDmmaLd + tq;
    const double* ss = xs + kDmmaLanes * kDmmaLd;
#pragma unroll
    for (int kk = 0; kk < kDmmaCols; kk += 16) {
      double af[2][8], bf[4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          af[i][e] = as[(i * 16 + 8 * (e & 1)) * kDmmaLd + kk + 4 * (e >> 1)];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = j * 8 * kDmmaLd + kk + 4 * e;
          bf[j][e] = kVecScale ? ss[o] * xs[o] : sc * xs[o];
        }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          double* c = cr + (i * 4 + j) * 4;
          dmma16816(c[0], c[1], c[2], c[3], af[i], bf[j]);
        }
    }
  }
  cp_async_wait<0>();

  double* out = acc + (long long)blockIdx.z * lanes * n;
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    // the value's row and lane within the warp's tile
    const int r = (q / 16) * 16 + g + 8 * ((q % 4) / 2);
    const int l = ((q / 4) % 4) * 8 + 2 * tq + q % 2;
    const long long row = row0 + wm * 32 + r;
    const long long lane = lane0 + wn * 32 + l;
    if (row < n && lane < lanes) out[lane * n + row] = cr[q];
  }
}

template <bool kVecScale>
cudaError_t launch_dmma(const double* a, const double* s_in, const double* v, double* acc,
                        long long lanes, long long n, long long splits, cudaStream_t s) {
  constexpr int bytes = dmma_smem_bytes<kVecScale>();
  static bool configured = false;  // the attribute is per kernel, set once
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(dmma_matvec_kernel<kVecScale>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const long long per_split =
      ((n + splits - 1) / splits + kDmmaCols - 1) / kDmmaCols * kDmmaCols;
  dim3 grid((unsigned)((n + kDmmaRows - 1) / kDmmaRows),
            (unsigned)((lanes + kDmmaLanes - 1) / kDmmaLanes), (unsigned)splits);
  dmma_matvec_kernel<kVecScale>
      <<<grid, kDmmaThreads, bytes, s>>>(a, s_in, v, acc, lanes, n, per_split);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// shared f32 A: CUDA cores

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

// ins:  a, s_out, s_in, t, v, v_prev, 8 scalars (K,), basis (or null),
//       rows (device int32 count of live basis rows, or null: all m)
// outs: alpha, beta, r, 8 raw, acc scratch (splits, K, n)
// dims: lanes, n, m, shared_a, so_ls, so_es, si_ls, si_es, t_ls, t_es, splits
// (a per-lane A takes splits = 1; a shared f64 A takes s_in as one scalar,
// si_ls = si_es = 0, or as a contiguous (K, n) tensor)
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
      if constexpr (std::is_same<T, double>::value) {
        const bool scalar = dims[6] == 0 && dims[7] == 0;
        if (!scalar && (dims[6] != n || dims[7] != 1)) return (int)cudaErrorInvalidValue;
        const cudaError_t e =
            scalar ? launch_dmma<false>(a, s_in, v, acc, lanes, n, splits, s)
                   : launch_dmma<true>(a, s_in, v, acc, lanes, n, splits, s);
        if (e != cudaSuccess) return (int)e;
      } else {
        const long long per_split =
            ((n + splits - 1) / splits + kTileCols - 1) / kTileCols * kTileCols;
        dim3 grid((unsigned)((lanes + kTileLanes - 1) / kTileLanes),
                  (unsigned)((n + kTileRows - 1) / kTileRows), (unsigned)splits);
        shared_matvec_kernel<T><<<grid, kGemmThreads, 0, s>>>(a, s_in, dims[6], dims[7], v, acc,
                                                               lanes, n, per_split);
      }
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
    ta.rows = static_cast<const int*>(ins[15]);
    for (int j = 0; j < 8; ++j) ta.sc[j] = static_cast<const T*>(ins[6 + j]);
    ta.alpha = static_cast<T*>(outs[0]);
    ta.beta = static_cast<T*>(outs[1]);
    ta.r = static_cast<T*>(outs[2]);
    for (int j = 0; j < 8; ++j) ta.raw[j] = static_cast<T*>(outs[3 + j]);
    ta.n = n;
    const cudaError_t e = repro::launch_tail<T>(ta, lanes, s);
    if (e != cudaSuccess) return (int)e;
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
