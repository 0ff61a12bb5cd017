// K5: blocked-ELL SpMM Y = A X over row-stacked right-hand sides, the
// operator application of block-Krylov mode.
//
// Replaces the TPU kernel src/repro/kernels/spmv_bell.py, function
// bell_matvec_mrhs (pallas_call at line 95, body _kernel at line 30): one
// walk over the stored blocks, a (bs, bs) @ (bs, m) product per block, f32
// accumulation and an f32 result.
//
// Layout: X and Y are (rows, N) row stacks with N = R * bs, in f32 (the
// wrapper rounds X to f32 once, as the TPU kernel's astype(f32) does).
// The table is data (R, Kb, bs, bs), cols (R, Kb) int32. `groups` tables
// serve `rows` right-hand sides each; with one shared table (groups = 1)
// every row of every lane rides one pass, so the m of the product is
// lanes * b. A per-lane table is a table lane stride.
//
// For block row r the output tile is Y[:, r*bs : (r+1)*bs] = sum_k
// X[:, cols[r,k]*bs : ...] @ data[r, k]^T: a GEMM of depth Kb * bs whose
// A operand is gathered through the block-column table. Rows of X are
// contiguous along N, so each gathered tile loads as 128-byte runs.
//
// Bound on the H100: bytes. Counted per stored nonzero (2 flops for each
// nonzero of A and each right-hand side) the work is small beside the
// bytes of X, Y and the table. The kernel itself multiplies the stored
// zeros inside each block too, so at the path's shapes (R = 64, Kb = 3,
// bs = 128, 512 right-hand sides) it does 3.2 GFLOP of f32 FMA, which at
// the card's f32 rate is several times the byte bound: a wgmma/TMA tile or
// a block-sparse inner layout is the later work.
//
// Design (simple and right first): a CTA of 256 threads owns a tile of
// 64 right-hand sides x 128 output entries of one block row; each thread
// keeps 4 x 8 f32 sums in registers. For each stored block k (the CTA
// reads its own cols[r, k]) and each 32-wide chunk of the block's depth,
// the CTA stages the block chunk and the gathered X chunk in shared
// memory (transposed, padded against bank conflicts) and every thread
// adds 32 products per sum with fmaf: true f32 FMA, no TF32. Each output
// is summed in one fixed order (k, then depth), with no atomics, so the
// result is the same from run to run. Padding blocks (zero data, column
// 0) add exact zeros; ragged right-hand sides and bs not a multiple of
// the tile are masked.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 64;   // right-hand sides per CTA
constexpr int kTN = 128;  // output entries (block rows' i) per CTA
constexpr int kKC = 32;   // depth chunk staged at once
constexpr int kQ = kTM / 16;
constexpr int kJ = kTN / 16;

template <typename TD>
__global__ void __launch_bounds__(kThreads) bell_mrhs_kernel(
    const TD* __restrict__ data, const int* __restrict__ cols, const float* __restrict__ x,
    float* __restrict__ y, long long rows, long long n, int kb, int bs, int itiles,
    long long data_ls, long long cols_ls) {
  __shared__ float ds[kKC][kTN + 1];  // ds[c][i] = data[r, k, i0 + i, c0 + c]
  __shared__ float xs[kKC][kTM + 1];  // xs[c][m] = X[m0 + m, col * bs + c0 + c]
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const long long r = blockIdx.x / itiles;
  const int i0 = (int)(blockIdx.x % itiles) * kTN;
  const long long m0 = (long long)blockIdx.y * kTM;
  const long long g = blockIdx.z;
  const TD* d = data + g * data_ls + r * kb * (long long)bs * bs;
  const int* c = cols + g * cols_ls + r * kb;
  const float* xg = x + g * rows * n;

  float acc[kQ][kJ];
#pragma unroll
  for (int q = 0; q < kQ; ++q)
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[q][j] = 0.0f;

  for (int k = 0; k < kb; ++k) {
    const long long col0 = (long long)c[k] * bs;
    const TD* blk = d + (long long)k * bs * bs;
    for (int c0 = 0; c0 < bs; c0 += kKC) {
      __syncthreads();  // the previous chunk is no longer read
      for (int e = tid; e < kKC * kTN; e += kThreads) {
        const int cc = e & (kKC - 1), ii = e / kKC;
        const int i = i0 + ii, cd = c0 + cc;
        ds[cc][ii] = (i < bs && cd < bs) ? float(blk[(long long)i * bs + cd]) : 0.0f;
      }
      for (int e = tid; e < kKC * kTM; e += kThreads) {
        const int cc = e & (kKC - 1), mm = e / kKC;
        const long long m = m0 + mm;
        const int cd = c0 + cc;
        xs[cc][mm] = (m < rows && cd < bs) ? xg[m * n + col0 + cd] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int cc = 0; cc < kKC; ++cc) {
        float xv[kQ], dv[kJ];
#pragma unroll
        for (int q = 0; q < kQ; ++q) xv[q] = xs[cc][ty + 16 * q];
#pragma unroll
        for (int j = 0; j < kJ; ++j) dv[j] = ds[cc][tx + 16 * j];
#pragma unroll
        for (int q = 0; q < kQ; ++q)
#pragma unroll
          for (int j = 0; j < kJ; ++j) acc[q][j] = fmaf(xv[q], dv[j], acc[q][j]);
      }
    }
  }

#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const long long m = m0 + ty + 16 * q;
    if (m >= rows) continue;
    float* yr = y + (g * rows + m) * n + r * bs;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int i = i0 + tx + 16 * j;
      if (i < bs) yr[i] = acc[q][j];
    }
  }
}

// ins: data, cols, X (groups * rows, N) f32; outs: Y (groups * rows, N) f32
// dims: groups, rows, R, Kb, bs, data_ls, cols_ls (lane strides in elements)
template <typename TD>
int bell_matvec_mrhs(const void* const* ins, void* const* outs, const long long* dims,
                     void* stream) {
  const long long groups = dims[0], rows = dims[1], nr = dims[2], kb = dims[3], bs = dims[4];
  if (groups <= 0 || rows <= 0 || nr <= 0 || bs <= 0) return (int)cudaErrorInvalidValue;
  const long long itiles = (bs + kTN - 1) / kTN;
  const long long mtiles = (rows + kTM - 1) / kTM;
  if (mtiles > 65535 || groups > 65535 || nr * itiles > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  bell_mrhs_kernel<TD><<<dim3((unsigned)(nr * itiles), (unsigned)mtiles, (unsigned)groups),
                         kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const TD*>(ins[0]), static_cast<const int*>(ins[1]),
      static_cast<const float*>(ins[2]), static_cast<float*>(outs[0]), rows, nr * bs,
      (int)kb, (int)bs, (int)itiles, dims[5], dims[6]);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bell_matvec_mrhs_f32(const void* const* ins, void* const* outs,
                                    const long long* dims, void* stream) {
  return bell_matvec_mrhs<float>(ins, outs, dims, stream);
}

extern "C" int bell_matvec_mrhs_f64(const void* const* ins, void* const* outs,
                                    const long long* dims, void* stream) {
  return bell_matvec_mrhs<double>(ins, outs, dims, stream);
}
