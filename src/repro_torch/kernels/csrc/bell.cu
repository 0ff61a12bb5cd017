// K2: blocked-ELL SpMV y = A x, and K4: one fused Lanczos + GQL step on a
// blocked-ELL A (matvec launch + the shared tail launch of step_tail.cuh).
//
// Replaces the TPU kernels
//   K2 src/repro/kernels/spmv_bell.py, function bell_matvec (pallas_call
//      at line 63, body _kernel at line 30);
//   K4 src/repro/kernels/lanczos_step.py, function fused_step_bell
//      (pallas_call at line 267, body _bell_kernel at line 205).
// Both walk one lane's (bs, bs) @ (bs,) products in a sequential grid.
// With one table shared by the lanes, the product of block row r for all
// lanes at once is a GEMM of depth Kb * bs,
//   Y[:, r*bs : (r+1)*bs] = sum_k X[:, cols[r,k]*bs : ...] @ data[r,k]^T,
// whose X operand is gathered through the block-column table.
//
// Bound on the H100: the table crosses device memory once per launch (at
// the main path's data (64, 3, 128, 128) f32 and 64 lanes, 16.8 MB with the
// vectors: 0.005 ms at 3.35 TB/s), and the tile multiplies the zeros
// stored inside each block too: 2 * lanes * R * Kb * bs^2 flops, 0.40 GFLOP
// at 64 lanes, about 0.006 ms at 67 TFLOP/s (f32 FMA on the CUDA cores for
// K2, f64 on the FP64 tensor cores for K4).
//
// Tiled route (a shared table): a CTA owns kRows rows of one block row
// times 64 lanes and walks k < Kb and the block's depth in chunks of 32
// columns. Each chunk stages the block chunk once for all 64 lanes, and
// the 64 lanes' gathered x chunk (for K4 also s_in where it is a vector,
// shared or per lane), through a 3-stage cp.async ring: 16-byte copies
// where the table's rows and the vectors allow them, one element each
// otherwise, zero-filled past every edge. One CTA per (block row, lane)
// read each block 64 times (from L2, 805 MB a launch at the main path);
// this tile reads it once per 64 lanes.
//   f32 vectors (K2; K4's f32_f32): true f32 FMA on the CUDA cores (no
//   TF32: K2's contract is f32 accumulation), 4 rows x 4 lanes of sums per
//   thread, 16-byte shared reads along the depth, an f64 table narrowed as
//   it is read (K2's plain version casts it to f32 first).
//   f64 vectors (K4's f32_f64 on the main path, f64_f64): mma.sync m16n8k16
//   f64 as K3's matvec (dense_step.cu), warps of 32 rows x 32 lanes over
//   padded shared rows; f32 blocks are staged as f32 and widened as the
//   fragments are read (lanczos_step.py:221 casts them). The chunk walk may
//   be split over `splits` slices of the scratch, which the tail adds in a
//   fixed order.
// The shapes were chosen by timing on the card (PERF.md keeps the sweep):
// at the main path's 64 lanes and 64 block rows, 128-row f64 tiles with the
// walk split in two (128 CTAs; lanczos_step.bell_splits derives the split
// count from the SM count) beat 64-row tiles unsplit and 128-row tiles
// unsplit; 64-row f32 tiles beat 32-row ones by 2%.
// Every output sums in one fixed order (chunk by chunk, depth within a
// chunk), with no atomics: two launches give the same bits. Padding blocks
// (zero data, column 0) add zeros like any stored zero; ragged lanes, rows
// and depth (bs not a multiple of the tile) are masked.
//
// Rows route (K4 only: a shared table with f64 vectors whose stored values
// per non-zero pass spmv_bell.ROWS_FILL): the block tile's work follows the
// stored values, and a table filled by scattered edges stores hundreds per
// non-zero (a rewired ring of 5242 nodes: 20.8 M for 34,232, so a 4096-lane
// step is 170 GFLOP, 2.5 ms at the full 67 TFLOP/s, where its bytes take
// 0.15 ms). This route walks the table's row list (spmv_bell.bell_row_list:
// row pointers, ascending int32 columns, values in the table's dtype) and
// bounds on the lane vectors' bytes: v and s_in read once, the scratch
// written once, the list (8 bytes a non-zero) read from L2 once per CTA. A
// CTA of 1024 threads owns a pair of lanes (a table whose two lanes' rows
// do not fit in shared memory stays on the block tile): it stages s_in * v
// for them into shared memory, interleaved [row][2] (16-byte loads where n
// is even and the rows aligned), then each thread takes rows and walks each
// row's entries in the list's order, two f64 sums by FMA with the value
// widened as it is read. The pair and the thread count were chosen by
// timing 1, 2 and 4 lanes a CTA and 256, 512, 1024 threads on the card
// (PERF.md keeps the sweep). One fixed order, no
// atomics: two launches give the same bits.
//
// Lane route (a per-lane table, stack_ops of BELL operators): no table is
// shared, so there is nothing to reuse across lanes; one CTA per (block
// row, lane), 128 threads, each warp reading rows of the block side by
// side against the staged x tile, summed by a fixed xor-tree shuffle.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "recurrence.cuh"
#include "step_tail.cuh"

namespace {

// ---------------------------------------------------------------------------
// tiled route: a table shared by the lanes

constexpr int kLanes = 64;       // lanes per CTA
constexpr int kDepth = 32;       // columns of a block per chunk
constexpr int kStages = 3;       // cp.async ring
constexpr int kLd = kDepth + 4;  // padded shared row, in elements
constexpr int kFmaRows = 64;     // block rows per CTA, f32 FMA tile
constexpr int kDmmaRows = 128;   // block rows per CTA, f64 tensor-core tile

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool in) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(in ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(kBytes), "r"(in ? kBytes : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Stage kRowsT rows x kDepth columns into shared rows of kLd elements: row
// q from src + q * stride, zero-filled where q >= valid_rows or the column
// is >= valid_cols. With `vec16` every row start and valid_cols are
// multiples of 16 bytes, and each copy moves 16 bytes.
template <typename T, int kRowsT, int kThreads>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, long long stride,
                                           int valid_rows, int valid_cols, bool vec16) {
  if (vec16) {
    constexpr int kVec = 16 / (int)sizeof(T);
    constexpr int kSegs = kDepth / kVec;
#pragma unroll
    for (int e = threadIdx.x; e < kRowsT * kSegs; e += kThreads) {
      const int q = e / kSegs, c = (e % kSegs) * kVec;
      const bool in = q < valid_rows && c < valid_cols;
      cp_async<16>(dst + q * kLd + c, in ? src + q * stride + c : src, in);
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < kRowsT * kDepth; e += kThreads) {
      const int q = e / kDepth, c = e % kDepth;
      const bool in = q < valid_rows && c < valid_cols;
      cp_async<(int)sizeof(T)>(dst + q * kLd + c, in ? src + q * stride + c : src, in);
    }
  }
}

template <typename TD, typename TV>
struct TileArgs {
  const TD* data;      // (R, Kb, bs, bs)
  const int* cols;     // (R, Kb)
  const TV* x;         // (lanes, n)
  const TV* s_in;      // K4: one scalar, or rows of lane stride si_ls (0 or n)
  long long si_ls;
  TV* out;             // (splits, lanes, n)
  long long lanes, n;
  int kb, bs;
  int itiles;          // row tiles per block row
  int per_split;       // chunks per split
  int vec16;           // 16-byte copies
};

// The chunk walk of one CTA: chunk q is depth [c0, c0 + kDepth) of block k.
// stage(q, slot) issues chunk q's copies; compute(slot) reads a landed one.
template <typename Stage, typename Compute>
__device__ __forceinline__ void chunk_ring(int q_lo, int nq, Stage stage, Compute compute) {
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < nq) stage(q_lo + st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nq; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk kt landed for all threads; chunk kt - 1 is no longer read
    const int nx = kt + kStages - 1;
    if (nx < nq) stage(q_lo + nx, nx % kStages);
    cp_async_commit();
    compute(kt % kStages);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring may be reused
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const double* p, float (&v)[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = (float)a.x; v[1] = (float)a.y; v[2] = (float)b.x; v[3] = (float)b.y;
}

// f32 FMA tile: out[lane][row] = sum_k,c data[r,k,row,c] * (s x)[lane, col_k + c]
// over kRows rows x 64 lanes, 4 x 4 sums per thread (rows ty + kRows/4 p,
// lanes tx + 16 q). kScale: 0 none (K2), 1 one scalar, 2 staged rows.
template <typename TD, int kScale, int kRows>
__host__ __device__ constexpr int fma_smem_bytes() {
  return kStages * (kRows * kLd * (int)sizeof(TD) + (kScale == 2 ? 2 : 1) * kLanes * kLd * 4);
}

template <typename TD, int kScale, int kRows>
__global__ void __launch_bounds__(4 * kRows) bell_fma_kernel(TileArgs<TD, float> a) {
  constexpr int kThreads = 4 * kRows;
  constexpr int kRowStep = kRows / 4;
  constexpr int kDBytes = kRows * kLd * (int)sizeof(TD);
  constexpr int kStage = fma_smem_bytes<TD, kScale, kRows>() / kStages;
  extern __shared__ __align__(16) unsigned char bell_smem[];
  const long long r = blockIdx.x / a.itiles;
  const int i0 = (int)(blockIdx.x % a.itiles) * kRows;
  const long long lane0 = (long long)blockIdx.y * kLanes;
  const int cpb = (a.bs + kDepth - 1) / kDepth;
  const int rows_in = a.bs - i0;
  const int lanes_in = (int)(a.lanes - lane0 < kLanes ? a.lanes - lane0 : kLanes);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float sc = kScale == 1 ? a.s_in[0] : 1.0f;

  auto stage = [&](int q, int slot) {
    unsigned char* base = bell_smem + slot * kStage;
    const int k = q / cpb, c0 = (q % cpb) * kDepth;
    const int valid = a.bs - c0 < kDepth ? a.bs - c0 : kDepth;
    const long long col0 = (long long)a.cols[r * a.kb + k] * a.bs + c0;
    stage_rows<TD, kRows, kThreads>(reinterpret_cast<TD*>(base),
                                    a.data + ((r * a.kb + k) * a.bs + i0) * (long long)a.bs + c0,
                                    a.bs, rows_in, valid, a.vec16);
    float* xs = reinterpret_cast<float*>(base + kDBytes);
    stage_rows<float, kLanes, kThreads>(xs, a.x + lane0 * a.n + col0, a.n, lanes_in, valid,
                                        a.vec16);
    if constexpr (kScale == 2)
      stage_rows<float, kLanes, kThreads>(xs + kLanes * kLd, a.s_in + lane0 * a.si_ls + col0,
                                          a.si_ls, lanes_in, valid, a.vec16);
  };

  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.0f;

  auto compute = [&](int slot) {
    const unsigned char* base = bell_smem + slot * kStage;
    const TD* ds = reinterpret_cast<const TD*>(base) + ty * kLd;
    const float* xs = reinterpret_cast<const float*>(base + kDBytes) + tx * kLd;
#pragma unroll
    for (int c = 0; c < kDepth; c += 4) {
      float dv[4][4], xv[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p) load4(ds + p * kRowStep * kLd + c, dv[p]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        load4(xs + q * 16 * kLd + c, xv[q]);
        if constexpr (kScale == 1) {
#pragma unroll
          for (int e = 0; e < 4; ++e) xv[q][e] *= sc;
        } else if constexpr (kScale == 2) {
          float sv[4];
          load4(xs + kLanes * kLd + q * 16 * kLd + c, sv);
#pragma unroll
          for (int e = 0; e < 4; ++e) xv[q][e] *= sv[e];
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(dv[p][e], xv[q][e], acc[p][q]);
    }
  };

  chunk_ring(0, a.kb * cpb, stage, compute);

  // transpose through shared memory, so each lane's rows store contiguously
  float* os = reinterpret_cast<float*>(bell_smem);
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) os[(tx + 16 * q) * (kRows + 1) + ty + kRowStep * p] = acc[p][q];
  __syncthreads();
  for (int e = threadIdx.x; e < kLanes * kRows; e += kThreads) {
    const int l = e / kRows, i = e % kRows;
    if (l < lanes_in && i < rows_in)
      a.out[(lane0 + l) * a.n + r * a.bs + i0 + i] = os[l * (kRows + 1) + i];
  }
}

// c (16 x 8) += a (16 x 16, row) * b (16 x 8, col), the f64 shape PTX 7.8
// adds for sm_90: per thread a_i at (row g + 8 (i % 2), col t + 4 (i / 2)),
// b_i at (row t + 4 i, col g), c_q at (row g + 8 (q / 2), col 2 t + q % 2)
// for the fragment's row g = lane / 4 and column t = lane % 4 (the helper
// of dense_step.cu, which stays K3's own)
__device__ __forceinline__ void dmma16816(double& c0, double& c1, double& c2, double& c3,
                                          const double (&a)[8], const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(c0), "+d"(c1), "+d"(c2), "+d"(c3)
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
        "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// f64 tensor-core tile: kRows rows x 64 lanes per CTA, 2 kRows threads,
// warps of 32 rows x 32 lanes (2 x 4 fragments, 16 m16n8k16 per 32
// columns); split blockIdx.z walks chunks [z per_split, (z + 1) per_split)
// into its own slice of the scratch.
template <typename TD, bool kVecScale, int kRows>
__host__ __device__ constexpr int dmma_smem_bytes() {
  return kStages * (kRows * kLd * (int)sizeof(TD) + (kVecScale ? 2 : 1) * kLanes * kLd * 8);
}

template <typename TD, bool kVecScale, int kRows>
__global__ void __launch_bounds__(2 * kRows, 1) bell_dmma_kernel(TileArgs<TD, double> a) {
  constexpr int kThreads = 2 * kRows;
  constexpr int kRowWarps = kRows / 32;
  constexpr int kDBytes = kRows * kLd * (int)sizeof(TD);
  constexpr int kStage = dmma_smem_bytes<TD, kVecScale, kRows>() / kStages;
  extern __shared__ __align__(16) unsigned char bell_smem[];
  const long long r = blockIdx.x / a.itiles;
  const int i0 = (int)(blockIdx.x % a.itiles) * kRows;
  const long long lane0 = (long long)blockIdx.y * kLanes;
  const int cpb = (a.bs + kDepth - 1) / kDepth;
  const int nk = a.kb * cpb;
  const int q_lo = (int)blockIdx.z * a.per_split;
  const int q_hi = q_lo + a.per_split < nk ? q_lo + a.per_split : nk;
  const int rows_in = a.bs - i0;
  const int lanes_in = (int)(a.lanes - lane0 < kLanes ? a.lanes - lane0 : kLanes);
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const int g = ln >> 2, tq = ln & 3;  // the fragments' row and column
  const int wm = warp % kRowWarps, wn = warp / kRowWarps;
  const double sc = kVecScale ? 1.0 : a.s_in[0];

  auto stage = [&](int q, int slot) {
    unsigned char* base = bell_smem + slot * kStage;
    const int k = q / cpb, c0 = (q % cpb) * kDepth;
    const int valid = a.bs - c0 < kDepth ? a.bs - c0 : kDepth;
    const long long col0 = (long long)a.cols[r * a.kb + k] * a.bs + c0;
    stage_rows<TD, kRows, kThreads>(reinterpret_cast<TD*>(base),
                                    a.data + ((r * a.kb + k) * a.bs + i0) * (long long)a.bs + c0,
                                    a.bs, rows_in, valid, a.vec16);
    double* xs = reinterpret_cast<double*>(base + kDBytes);
    stage_rows<double, kLanes, kThreads>(xs, a.x + lane0 * a.n + col0, a.n, lanes_in, valid,
                                         a.vec16);
    if constexpr (kVecScale)
      stage_rows<double, kLanes, kThreads>(xs + kLanes * kLd, a.s_in + lane0 * a.si_ls + col0,
                                           a.si_ls, lanes_in, valid, a.vec16);
  };

  // the warp's 32 x 32 accumulator: [row fragment][lane fragment][values]
  // as (2 x 4 x 4)
  double cr[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) cr[q] = 0.0;

  auto compute = [&](int slot) {
    const unsigned char* base = bell_smem + slot * kStage;
    const TD* as = reinterpret_cast<const TD*>(base) + (wm * 32 + g) * kLd + tq;
    const double* xs = reinterpret_cast<const double*>(base + kDBytes) + (wn * 32 + g) * kLd + tq;
    const double* ss = xs + kLanes * kLd;
#pragma unroll
    for (int kk = 0; kk < kDepth; kk += 16) {
      double af[2][8], bf[4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          af[i][e] = (double)as[(i * 16 + 8 * (e & 1)) * kLd + kk + 4 * (e >> 1)];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = j * 8 * kLd + kk + 4 * e;
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
  };

  chunk_ring(q_lo, q_hi > q_lo ? q_hi - q_lo : 0, stage, compute);

  double* out = a.out + (long long)blockIdx.z * a.lanes * a.n + r * a.bs + i0;
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    // the value's row and lane within the warp's tile
    const int i = wm * 32 + (q / 16) * 16 + g + 8 * ((q % 4) / 2);
    const int l = wn * 32 + ((q / 4) % 4) * 8 + 2 * tq + q % 2;
    if (i < rows_in && l < lanes_in) out[(lane0 + l) * a.n + i] = cr[q];
  }
}

template <typename TD, typename TV>
TileArgs<TD, TV> tile_args(const void* data, const void* cols, const void* x, const void* s_in,
                           long long si_ls, void* out, long long lanes, long long nr,
                           long long kb, long long bs, long long rows, long long splits,
                           long long vec16) {
  TileArgs<TD, TV> a;
  a.data = static_cast<const TD*>(data);
  a.cols = static_cast<const int*>(cols);
  a.x = static_cast<const TV*>(x);
  a.s_in = static_cast<const TV*>(s_in);
  a.si_ls = si_ls;
  a.out = static_cast<TV*>(out);
  a.lanes = lanes;
  a.n = nr * bs;
  a.kb = (int)kb;
  a.bs = (int)bs;
  a.itiles = (int)((bs + rows - 1) / rows);
  const long long nk = kb * ((bs + kDepth - 1) / kDepth);
  a.per_split = (int)((nk + splits - 1) / splits);
  a.vec16 = (int)vec16;
  return a;
}

// Set a kernel's dynamic shared memory limit once, then launch it over
// (R * row tiles, lane tiles, splits).
template <typename Kernel, typename Args>
cudaError_t launch_tile(Kernel kernel, bool& configured, int bytes, int threads, Args a,
                        long long nr, long long splits, cudaStream_t s) {
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const long long ltiles = (a.lanes + kLanes - 1) / kLanes;
  if (nr * a.itiles > 2147483647LL || ltiles > 65535 || splits > 65535)
    return cudaErrorInvalidConfiguration;
  kernel<<<dim3((unsigned)(nr * a.itiles), (unsigned)ltiles, (unsigned)splits), threads, bytes,
           s>>>(a);
  return cudaGetLastError();
}

template <typename TD, int kScale>
cudaError_t launch_fma(TileArgs<TD, float> a, long long nr, cudaStream_t s) {
  static bool configured = false;  // the attribute is per kernel, set once
  constexpr int bytes = fma_smem_bytes<TD, kScale, kFmaRows>();
  static_assert(kLanes * (kFmaRows + 1) * 4 <= bytes, "the epilogue fits in the ring");
  return launch_tile(bell_fma_kernel<TD, kScale, kFmaRows>, configured, bytes, 4 * kFmaRows, a,
                     nr, 1, s);
}

template <typename TD, bool kVecScale>
cudaError_t launch_dmma(TileArgs<TD, double> a, long long nr, long long splits,
                        cudaStream_t s) {
  static bool configured = false;
  constexpr int bytes = dmma_smem_bytes<TD, kVecScale, kDmmaRows>();
  return launch_tile(bell_dmma_kernel<TD, kVecScale, kDmmaRows>, configured, bytes,
                     2 * kDmmaRows, a, nr, splits, s);
}

// ---------------------------------------------------------------------------
// rows route: a shared table walked by its row list (K4, f64 vectors)

constexpr int kRowThreads = 1024;
constexpr int kRowLanes = 2;  // lanes a CTA, staged as one 16-byte pair a row

template <typename TD>
struct RowArgs {
  const int* row_ptr;  // (n + 1,)
  const int* col;      // (nnz,), ascending within a row
  const TD* val;       // (nnz,)
  const double* x;     // (lanes, n)
  const double* s_in;  // one scalar, or rows of lane stride si_ls (0 or n)
  long long si_ls;
  double* out;         // (lanes, n)
  long long lanes, n;
  int vec16;           // 16-byte staging loads
};

// kScale: 1 one scalar s_in, 2 staged rows
template <typename TD, int kScale>
__global__ void __launch_bounds__(kRowThreads) rows_bell_fma_kernel(RowArgs<TD> a) {
  constexpr int G = kRowLanes;
  extern __shared__ __align__(16) unsigned char bell_smem[];
  double* xs = reinterpret_cast<double*>(bell_smem);  // (n, G)
  const long long lane0 = (long long)blockIdx.x * G;
  const int lanes_in = (int)(a.lanes - lane0 < G ? a.lanes - lane0 : G);
  const double sc = kScale == 1 ? a.s_in[0] : 1.0;

  // stage s_in * v, a lane past the last as zeros
  if (a.vec16) {
    for (long long e = threadIdx.x; 2 * e < a.n; e += kRowThreads) {
      double t[2 * G];  // row 2e's G lanes, then row 2e + 1's
#pragma unroll
      for (int g = 0; g < G; ++g) {
        double2 v = make_double2(0.0, 0.0);
        if (g < lanes_in) {
          v = *reinterpret_cast<const double2*>(a.x + (lane0 + g) * a.n + 2 * e);
          if constexpr (kScale == 1) {
            v.x = sc * v.x;
            v.y = sc * v.y;
          } else {
            const double2 s =
                *reinterpret_cast<const double2*>(a.s_in + (lane0 + g) * a.si_ls + 2 * e);
            v.x = s.x * v.x;
            v.y = s.y * v.y;
          }
        }
        t[g] = v.x;
        t[G + g] = v.y;
      }
#pragma unroll
      for (int q = 0; q < 2 * G; q += 2)
        *reinterpret_cast<double2*>(xs + 2 * e * G + q) = make_double2(t[q], t[q + 1]);
    }
  } else {
    for (long long e = threadIdx.x; e < a.n * G; e += kRowThreads) {
      const long long i = e / G;
      const int g = (int)(e % G);
      double v = 0.0;
      if (g < lanes_in) {
        v = a.x[(lane0 + g) * a.n + i];
        v = kScale == 1 ? sc * v : a.s_in[(lane0 + g) * a.si_ls + i] * v;
      }
      xs[e] = v;
    }
  }
  __syncthreads();

  for (long long i = threadIdx.x; i < a.n; i += kRowThreads) {
    double acc0 = 0.0, acc1 = 0.0;
    const int j_hi = a.row_ptr[i + 1];
#pragma unroll 4
    for (int j = a.row_ptr[i]; j < j_hi; ++j) {
      const double w = (double)a.val[j];
      const double2 xv = *reinterpret_cast<const double2*>(xs + (long long)a.col[j] * G);
      acc0 = fma(w, xv.x, acc0);
      acc1 = fma(w, xv.y, acc1);
    }
    a.out[lane0 * a.n + i] = acc0;
    if (lanes_in > 1) a.out[(lane0 + 1) * a.n + i] = acc1;
  }
}

// One CTA a pair of lanes, with 2 * n doubles of shared memory.
template <typename TD, int kScale>
cudaError_t launch_rows(RowArgs<TD> a, cudaStream_t s) {
  static bool configured = false;  // the attribute is per kernel, set once
  auto kernel = rows_bell_fma_kernel<TD, kScale>;
  if (!configured) {
    int dev = 0, most = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const long long pairs = (a.lanes + kRowLanes - 1) / kRowLanes;
  if (pairs > 2147483647LL) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)pairs, kRowThreads, (size_t)a.n * kRowLanes * sizeof(double), s>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// lane route: a per-lane table

constexpr int kLaneThreads = 128;

template <typename TD, typename TV, typename TA>
__global__ void __launch_bounds__(kLaneThreads) bell_lane_kernel(
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

// ---------------------------------------------------------------------------
// entry points

// ins: data, cols, x (lanes, n) f32; outs: y (lanes, n) f32
// dims: lanes, R, Kb, bs, data_ls, cols_ls (lane strides in elements, 0 =
// shared), tiled (the route), vec16 (16-byte copies)
template <typename TD>
int bell_matvec(const void* const* ins, void* const* outs, const long long* dims,
                void* stream) {
  const long long lanes = dims[0], nr = dims[1], kb = dims[2], bs = dims[3];
  cudaStream_t s = (cudaStream_t)stream;
  if (lanes <= 0 || nr <= 0 || kb <= 0 || bs <= 0) return (int)cudaErrorInvalidValue;
  if (dims[6]) {
    if (dims[4] != 0 || dims[5] != 0) return (int)cudaErrorInvalidValue;
    const cudaError_t e = launch_fma<TD, 0>(
        tile_args<TD, float>(ins[0], ins[1], ins[2], nullptr, 0, outs[0], lanes, nr, kb, bs,
                             kFmaRows, 1, dims[7]),
        nr, s);
    if (e != cudaSuccess) return (int)e;
  } else {
    const size_t smem = 2 * (size_t)bs * sizeof(float);
    bell_lane_kernel<TD, float, float><<<dim3((unsigned)nr, (unsigned)lanes), kLaneThreads, smem, s>>>(
        static_cast<const TD*>(ins[0]), static_cast<const int*>(ins[1]),
        static_cast<const float*>(ins[2]), nullptr, 0, 0, static_cast<float*>(outs[0]), (int)kb,
        (int)bs, dims[4], dims[5], nr * bs, nr * bs);
  }
  return (int)cudaGetLastError();
}

// ins:  data, cols, s_out, s_in, t, v, v_prev, 8 scalars (K,), and for the
//       rows route the row list: row_ptr, col, val
// outs: alpha, beta, r, 8 raw, acc scratch (splits, K, n)
// dims: lanes, R, Kb, bs, data_ls, cols_ls, so_ls, so_es, si_ls, si_es, t_ls, t_es,
//       tiled (the route), splits (tiled f64 only; else 1), vec16,
//       rows (the rows route, within tiled), rows_vec16 (16-byte staging of
//       v and s_in)
// The tiled and rows routes take s_in as one scalar (si_ls = si_es = 0) or
// as rows (si_es = 1, si_ls = 0 for one shared row or n for a row a lane).
template <typename TD, typename TV>
int fused_step_bell(const void* const* ins, void* const* outs, const long long* dims,
                    void* stream) {
  const long long lanes = dims[0], nr = dims[1], kb = dims[2], bs = dims[3];
  const long long n = nr * bs;
  const bool tiled = dims[12] != 0;
  const bool rows = tiled && dims[15] != 0;
  const long long splits = tiled && !rows ? dims[13] : 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (lanes <= 0 || nr <= 0 || kb <= 0 || bs <= 0 || splits < 1)
    return (int)cudaErrorInvalidValue;
  TV* acc = static_cast<TV*>(outs[11]);
  if (tiled) {
    const long long si_ls = dims[8], si_es = dims[9];
    const bool scalar = si_ls == 0 && si_es == 0;
    if (dims[4] != 0 || dims[5] != 0) return (int)cudaErrorInvalidValue;
    if (!scalar && (si_es != 1 || (si_ls != 0 && si_ls != n))) return (int)cudaErrorInvalidValue;
    cudaError_t e;
    if (rows) {
      if constexpr (std::is_same<TV, double>::value) {
        RowArgs<TD> a;
        a.row_ptr = static_cast<const int*>(ins[15]);
        a.col = static_cast<const int*>(ins[16]);
        a.val = static_cast<const TD*>(ins[17]);
        a.x = static_cast<const double*>(ins[5]);
        a.s_in = static_cast<const double*>(ins[3]);
        a.si_ls = si_ls;
        a.out = acc;
        a.lanes = lanes;
        a.n = n;
        a.vec16 = (int)dims[16];
        e = scalar ? launch_rows<TD, 1>(a, s) : launch_rows<TD, 2>(a, s);
      } else {
        return (int)cudaErrorInvalidValue;  // f64 vectors only
      }
    } else if constexpr (std::is_same<TV, double>::value) {
      const auto a = tile_args<TD, double>(ins[0], ins[1], ins[5], ins[3], si_ls, acc, lanes, nr,
                                           kb, bs, kDmmaRows, splits, dims[14]);
      e = scalar ? launch_dmma<TD, false>(a, nr, splits, s) : launch_dmma<TD, true>(a, nr, splits, s);
    } else {
      if (splits != 1) return (int)cudaErrorInvalidValue;
      const auto a = tile_args<TD, float>(ins[0], ins[1], ins[5], ins[3], si_ls, acc, lanes, nr,
                                          kb, bs, kFmaRows, 1, dims[14]);
      e = scalar ? launch_fma<TD, 1>(a, nr, s) : launch_fma<TD, 2>(a, nr, s);
    }
    if (e != cudaSuccess) return (int)e;
  } else {
    const size_t smem = 2 * (size_t)bs * sizeof(TV);
    bell_lane_kernel<TD, TV, TV><<<dim3((unsigned)nr, (unsigned)lanes), kLaneThreads, smem, s>>>(
        static_cast<const TD*>(ins[0]), static_cast<const int*>(ins[1]),
        static_cast<const TV*>(ins[5]), static_cast<const TV*>(ins[3]), dims[8], dims[9], acc,
        (int)kb, (int)bs, dims[4], dims[5], n, n);
  }
  repro::TailArgs<TV> a;
  a.acc = acc;
  a.splits = (int)splits;
  a.split_stride = lanes * n;
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
  const cudaError_t e = repro::launch_tail<TV>(a, lanes, s);
  if (e != cudaSuccess) return (int)e;
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
