// K5: blocked-ELL SpMM Y = A X over row-stacked right-hand sides, the
// operator application of block-Krylov mode.
//
// Replaces the TPU kernel src/repro/kernels/spmv_bell.py, function
// bell_matvec_mrhs (pallas_call at line 95, body _kernel at line 30): one
// walk over the stored blocks, a (bs, bs) @ (bs, m) product per block, f32
// accumulation and an f32 result.
//
// Layout: X and Y are (rows, N) row stacks with N = R * bs; X is read in
// its own type (f32 or f64) and rounded to f32 as it is staged, as the TPU
// kernel's astype(f32) does, so the wrapper makes no rounding pass. The
// table is data (R, Kb, bs, bs), cols (R, Kb) int32. `groups` tables serve
// `rows` right-hand sides each; with one shared table (groups = 1) every
// row of every lane rides one pass, so the m of the product is lanes * b.
// A per-lane table is a table lane stride.
//
// For block row r the output tile is Y[:, r*bs : (r+1)*bs] = sum_k
// X[:, cols[r,k]*bs : ...] @ data[r, k]^T: a GEMM of depth Kb * bs whose
// X operand is gathered through the block-column table.
//
// Bound on the H100: bytes, counted per stored nonzero (12.6 MB of table,
// 33.6 MB of f64 X and 16.8 MB of f32 Y at the path's shapes: R = 64,
// Kb = 3, bs = 128, 512 right-hand sides; 0.0188 ms). The kernel also
// multiplies the stored zeros inside each block, 3.2 GFLOP at those shapes,
// which on f32 FMA (67 TFLOP/s) alone would take 0.048 ms: so the product
// goes to the tensor cores.
//
// Two routes, chosen by a pure function of the shapes and types
// (spmv_bell.mrhs_route):
//
// "wgmma" (a shared f32 table, bs a multiple of 128): 3xTF32 on wgmma.
//   The tensor cores take tf32 (10-bit mantissa), so each f32 operand v is
//   split into hi = tf32(v) (cvt.rna: the tensor cores never get raw f32
//   bits) and lo = v - hi cut to tf32, and a product is hi*hi + hi*lo + lo*hi,
//   summed in f32 accumulators: about 2^-21 relative per product, within
//   the f32 contract's 1e-5. A CTA owns 128 rows of one block row's output
//   (the wgmma M side, two consumer warpgroups of 64) for 128 right-hand
//   sides (the N side) and walks the block row's Kb blocks in 32-deep
//   chunks through a ring of 4 stages (full and empty mbarriers):
//    - the data chunk (128 rows x 32 depth, f32) comes by TMA in the
//      128-byte swizzle; each consumer thread reads its rows' 8 depths as
//      two 16-byte loads and splits them into hi and lo A fragments in
//      registers (A from registers);
//    - the X chunk (128 right-hand sides x 32 depths at column
//      cols[r, k] * bs) is gathered by a producer warpgroup, which reads X
//      in its own type (TMA cannot convert f64), rounds it to f32, splits
//      it and writes a hi and a lo tile, K-major in the 128-byte swizzle,
//      for wgmma to read by descriptor. These loads are the kernel's
//      longest wait (a round trip to L2 a stage), so two producer
//      warpgroups take the stages in turn and two stages' loads are in
//      flight; setmaxnreg gives the producers 96 registers and the
//      consumers 160. (Hiding the wait with one producer warpgroup was
//      slower on the card, PERF.md: X by TMA into a ring of raw chunks
//      converted from shared memory, or the next stage's X prefetched into
//      registers, which spilled.)
//   Within a chunk the depth is permuted the same way for both operands
//   (it is a sum): the 16-byte group k of a swizzled X row holds depths k,
//   k + 8, k + 16 and k + 24, so a converter thread reads 4 depths of one
//   row 64 bytes apart and writes them as one 16-byte store, and a
//   consumer thread's A fragments for the chunk's four k-steps are its
//   rows' 8 contiguous depths.
// "fma" (everything else: a table per lane, f64 data, bs not a multiple of
//   128): CUDA-core f32 FMA. A CTA of 256 threads owns 64 right-hand sides
//   x 128 output entries of one block row; each thread keeps 4 x 8 sums.
//   For each stored block and 32-wide depth chunk, the CTA stages the block
//   chunk and the gathered X chunk in shared memory (transposed, padded
//   against bank conflicts) and adds 32 products per sum with fmaf.
//
// Both routes sum each output in one fixed order (block, then depth; the
// tensor cores' order within a chunk is fixed too), with no atomics, so
// the result is the same bits from run to run. Padding blocks (zero data,
// column 0) add exact zeros, or NaN where X has NaN there, as the plain
// version does; ragged right-hand sides are masked.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// "fma": CUDA-core f32 FMA

constexpr int kThreads = 256;
constexpr int kTM = 64;   // right-hand sides per CTA
constexpr int kTN = 128;  // output entries (block rows' i) per CTA
constexpr int kKC = 32;   // depth chunk staged at once
constexpr int kQ = kTM / 16;
constexpr int kJ = kTN / 16;

template <typename TD, typename TX>
__global__ void __launch_bounds__(kThreads) bell_mrhs_kernel(
    const TD* __restrict__ data, const int* __restrict__ cols, const TX* __restrict__ x,
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
  const TX* xg = x + g * rows * n;

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
        xs[cc][mm] = (m < rows && cd < bs) ? float(xg[m * n + col0 + cd]) : 0.0f;
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


// ---------------------------------------------------------------------------
// "wgmma": 3xTF32 on the tensor cores, TMA and two converter warpgroups

constexpr int kWgRows = 128;      // output rows of a block row a CTA owns (M)
constexpr int kWgRhs = 128;       // right-hand sides a CTA owns (N)
constexpr int kWgDepth = 32;      // depth a stage: one 128-byte swizzled row of f32
constexpr int kWgThreads = 512;   // consumer warpgroups 0 and 1, producer warpgroups 2 and 3
constexpr int kStages = 4;  // the ring: two stages being converted, two consumed
constexpr int kTileBytes = kWgRows * kWgDepth * 4;  // 16 KB: data, X hi and X lo alike
constexpr int kStageBytes = 3 * kTileBytes;
constexpr int kWgSmem = kStages * kStageBytes + 1024;  // + alignment

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(double v) { return (float)v; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// spin until the phase of parity `parity` has completed; a wait of more
// than about 10 s traps (the launch fails) rather than hang the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > 20000000000LL) __trap();
  } while (!done);
}

// one box of a 2-d tensor map (coordinates innermost first) into shared
// memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A wgmma shared-memory descriptor for a K-major tile in the 128-byte
// swizzle (rows of 128 bytes, 8-row groups 1024 bytes apart)
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of r across a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo to about 2^-21 relative, both tf32: hi rounded to nearest
// (cvt.rna), lo = v - hi (exact in f32) cut to its top 10 mantissa bits by a
// mask, which errs by under 2^-10 of lo and costs an integer operation
// instead of a second conversion (conversions run at a quarter of the f32
// rate); a NaN stays a NaN
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = __float_as_uint(v - __uint_as_float(hi)) & 0xFFFFE000u;
}

// d (64 x 128, f32) += a (64 x 8, tf32 in registers) * b (8 x 128, tf32 in
// shared memory by descriptor, K-major)
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The producer warpgroup's share of one stage: X rows [m0, m0 + 128) at
// columns [col, col + 32), read in their own type, rounded to f32 and split,
// into the hi and lo tiles (K-major, 128-byte swizzle, rows past `rows`
// zero). Task (n, k) of a thread: row n's depths k, k + 8, k + 16, k + 24,
// one 16-byte store into group k of the swizzled row n in each tile.
template <typename TX>
__device__ __forceinline__ void convert_chunk(const TX* __restrict__ x, long long n_cols,
                                              long long rows, long long m0, long long col,
                                              uint8_t* bhi, uint8_t* blo, int tid) {
  constexpr int kTasks = kWgRhs * 8 / 128;
  float v[kTasks][4];
#pragma unroll
  for (int t = 0; t < kTasks; ++t) {
    const int task = tid + 128 * t, row = task >> 3, k = task & 7;
    const long long m = m0 + row;
    const TX* src = x + m * n_cols + col + k;
#pragma unroll
    for (int j = 0; j < 4; ++j) v[t][j] = (m < rows) ? to_f(__ldg(src + 8 * j)) : 0.0f;
  }
#pragma unroll
  for (int t = 0; t < kTasks; ++t) {
    const int task = tid + 128 * t, row = task >> 3, k = task & 7;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split_tf32(v[t][j], hi[j], lo[j]);
    const int off = row * 128 + ((k ^ (row & 7)) << 4);
    *reinterpret_cast<uint4*>(bhi + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(blo + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// A CTA owns output rows [i0, i0 + 128) of block row r for right-hand sides
// [m0, m0 + 128). Warpgroups 2 and 3 produce, taking the stages in turn (so
// two stages' loads of X are in flight at once): the first thread of the
// one whose turn it is loads the stage's data chunk by TMA, and all of its
// threads convert the stage's X chunk.
// Warpgroups 0 and 1 consume, 64 output rows each: A fragments (hi and lo)
// from the data chunk in registers, B from the X tiles by descriptor, three
// wgmma m64n128k8 per 8-deep k-step into 64 f32 sums a thread.
template <typename TX>
__global__ void __launch_bounds__(kWgThreads, 1) bell_mrhs_wgmma_kernel(
    const __grid_constant__ CUtensorMap tdata, const int* __restrict__ cols,
    const TX* __restrict__ x, float* __restrict__ y, long long rows, long long n, int kb, int bs,
    int itiles) {
  extern __shared__ uint8_t wg_smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~uintptr_t(1023));
  // stage s: the data tile, then the X hi tile, then the X lo tile
  auto tile = [&](int s, int which) { return smem + s * kStageBytes + which * kTileBytes; };

  // blockIdx.x is the right-hand-side tile, so that the CTAs that read one
  // block row's data chunks run side by side (and its neighbours, which
  // gather the same X columns, just before and after)
  const int wg = threadIdx.x >> 7;
  const long long r = blockIdx.y / itiles;
  const int i0 = (int)(blockIdx.y % itiles) * kWgRows;
  const long long m0 = (long long)blockIdx.x * kWgRhs;
  const int cpb = bs / kWgDepth;  // chunks a block
  const int nq = kb * cpb;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + 4);  // the TMA's expect_tx and the four converter warps
      mbar_init(&empty[s], 8);     // the eight consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg >= 2) {
    // ---- producers: TMA for the data, conversion for X, stages wg - 2,
    // wg, wg + 2, ...; the registers go to the consumers' sums
    asm volatile("setmaxnreg.dec.sync.aligned.u32 96;\n" ::: "memory");
    const int tid = threadIdx.x & 127;
    for (int q = wg - 2; q < nq; q += 2) {
      const int s = q % kStages, k = q / cpb, c0 = (q % cpb) * kWgDepth;
      mbar_wait(&empty[s], (uint32_t)(((q / kStages) & 1) ^ 1));
      if (tid == 0) {
        mbar_expect_tx(&full[s], kTileBytes);
        tma_load_2d(tile(s, 0), &tdata, &full[s], c0, (int)((r * kb + k) * bs + i0));
      }
      const long long col = (long long)__ldg(cols + r * kb + k) * bs + c0;
      convert_chunk(x, n, rows, m0, col, tile(s, 1), tile(s, 2), tid);
      // the tiles were written by threads; wgmma reads them through the
      // async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if ((tid & 31) == 0) mbar_arrive(&full[s]);
    }
  } else {
    // ---- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n" ::: "memory");
    const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, t = lane & 3;
    const int row = 64 * wg + 16 * w4 + g;  // this thread's rows: row and row + 8
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    for (int q = 0; q < nq; ++q) {
      const int s = q % kStages;
      mbar_wait(&full[s], (uint32_t)((q / kStages) & 1));
      // depths 8t .. 8t + 7 of rows `row` and `row + 8` (swizzle: group
      // k of row i sits at k ^ (i % 8); both rows are g modulo 8)
      const uint8_t* dt = tile(s, 0);
      float v[2][8];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float4 f = *reinterpret_cast<const float4*>(
              dt + (row + 8 * h) * 128 + (((2 * t + half) ^ g) << 4));
          v[h][4 * half] = f.x; v[h][4 * half + 1] = f.y;
          v[h][4 * half + 2] = f.z; v[h][4 * half + 3] = f.w;
        }
      // k-step kk takes logical depths t and t + 4, which the permutation
      // puts at depths 8t + 2kk and 8t + 2kk + 1
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        split_tf32(v[0][2 * kk], ahi[kk][0], alo[kk][0]);
        split_tf32(v[1][2 * kk], ahi[kk][1], alo[kk][1]);
        split_tf32(v[0][2 * kk + 1], ahi[kk][2], alo[kk][2]);
        split_tf32(v[1][2 * kk + 1], ahi[kk][3], alo[kk][3]);
      }
      const uint8_t* bhi = tile(s, 1);
      const uint8_t* blo = tile(s, 2);
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_tf32_n128(acc, alo[kk], wg_desc(bhi + 32 * kk));
        wgmma_tf32_n128(acc, ahi[kk], wg_desc(blo + 32 * kk));
        wgmma_tf32_n128(acc, ahi[kk], wg_desc(bhi + 32 * kk));
      }
      wg_commit();
      wg_wait_all();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // acc[4 j + e]: output row row + 8 (e >> 1), right-hand side
    // m0 + 8 j + 2 t + (e & 1)
    float* yr = y + r * bs + i0 + row;
#pragma unroll
    for (int j = 0; j < kWgRhs / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long m = m0 + 8 * j + 2 * t + (e & 1);
        if (m < rows) yr[m * n + 8 * (e >> 1)] = acc[4 * j + e];
      }
  }
}

// ---------------------------------------------------------------------------
// launch

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// ins: data (R, Kb, bs, bs), cols, X (groups * rows, N) in TX; outs: Y
// (groups * rows, N) f32; dims: groups, rows, R, Kb, bs, data_ls, cols_ls
// (lane strides in elements)
template <typename TD, typename TX>
int bell_matvec_mrhs(const void* const* ins, void* const* outs, const long long* dims,
                     void* stream) {
  const long long groups = dims[0], rows = dims[1], nr = dims[2], kb = dims[3], bs = dims[4];
  if (groups <= 0 || rows <= 0 || nr <= 0 || bs <= 0) return (int)cudaErrorInvalidValue;
  const long long itiles = (bs + kTN - 1) / kTN;
  const long long mtiles = (rows + kTM - 1) / kTM;
  if (mtiles > 65535 || groups > 65535 || nr * itiles > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  bell_mrhs_kernel<TD, TX><<<dim3((unsigned)(nr * itiles), (unsigned)mtiles, (unsigned)groups),
                             kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const TD*>(ins[0]), static_cast<const int*>(ins[1]),
      static_cast<const TX*>(ins[2]), static_cast<float*>(outs[0]), rows, nr * bs, (int)kb,
      (int)bs, (int)itiles, dims[5], dims[6]);
  return (int)cudaGetLastError();
}

template <typename TX>
int bell_matvec_mrhs_wgmma(const void* const* ins, void* const* outs, const long long* dims,
                           void* stream) {
  const long long groups = dims[0], rows = dims[1], nr = dims[2], kb = dims[3], bs = dims[4];
  if (groups != 1 || rows <= 0 || nr <= 0 || kb <= 0 || bs <= 0 || bs % kWgRows != 0 ||
      reinterpret_cast<uintptr_t>(ins[0]) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long itiles = bs / kWgRows, mtiles = (rows + kWgRhs - 1) / kWgRhs;
  if (nr * itiles > 65535 || mtiles > 2147483647LL || nr * kb * bs > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorInvalidValue;
  // data as a (R Kb bs, bs) f32 matrix, read in boxes of 32 columns x 128
  // rows (128-byte rows: the swizzle's span)
  CUtensorMap map;
  const cuuint64_t dim[2] = {(cuuint64_t)bs, (cuuint64_t)(nr * kb * bs)};
  const cuuint64_t stride[1] = {(cuuint64_t)bs * 4};
  const cuuint32_t box[2] = {kWgDepth, kWgRows};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ins[0]), dim, stride,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        bell_mrhs_wgmma_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  bell_mrhs_wgmma_kernel<TX><<<dim3((unsigned)mtiles, (unsigned)(nr * itiles)), kWgThreads,
                               kWgSmem, (cudaStream_t)stream>>>(
      map, static_cast<const int*>(ins[1]), static_cast<const TX*>(ins[2]),
      static_cast<float*>(outs[0]), rows, nr * bs, (int)kb, (int)bs, (int)itiles);
  return (int)cudaGetLastError();
}

}  // namespace

// "fma" route: data f32 or f64, X f32 or f64
extern "C" int bell_matvec_mrhs_f32_f32(const void* const* ins, void* const* outs,
                                        const long long* dims, void* stream) {
  return bell_matvec_mrhs<float, float>(ins, outs, dims, stream);
}
extern "C" int bell_matvec_mrhs_f32_f64(const void* const* ins, void* const* outs,
                                        const long long* dims, void* stream) {
  return bell_matvec_mrhs<float, double>(ins, outs, dims, stream);
}
extern "C" int bell_matvec_mrhs_f64_f32(const void* const* ins, void* const* outs,
                                        const long long* dims, void* stream) {
  return bell_matvec_mrhs<double, float>(ins, outs, dims, stream);
}
extern "C" int bell_matvec_mrhs_f64_f64(const void* const* ins, void* const* outs,
                                        const long long* dims, void* stream) {
  return bell_matvec_mrhs<double, double>(ins, outs, dims, stream);
}
// "wgmma" route: one shared f32 table, X f32 or f64
extern "C" int bell_matvec_mrhs_wgmma_f32(const void* const* ins, void* const* outs,
                                          const long long* dims, void* stream) {
  return bell_matvec_mrhs_wgmma<float>(ins, outs, dims, stream);
}
extern "C" int bell_matvec_mrhs_wgmma_f64(const void* const* ins, void* const* outs,
                                          const long long* dims, void* stream) {
  return bell_matvec_mrhs_wgmma<double>(ins, outs, dims, stream);
}
