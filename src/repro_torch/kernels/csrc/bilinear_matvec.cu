// K6: fused bilinear matvec, y = A x and alpha = x^T A x, batched over
// independent systems, in one pass over A and one launch.
//
// Replaces the TPU kernel src/repro/kernels/bilinear_matvec.py, function
// fused_matvec (pallas_call at line 75, body _kernel at line 28): A (B, N, N)
// in f32 or bf16, x (B, N) rounded to f32, f32 accumulation, y (B, N) and
// alpha (B,) in f32, as src/repro/kernels/ref.py:10-15 defines them.
//
// Bound on the H100: bytes. The work is 2 flops per entry of A, each read
// once (0.5 flop a byte in f32), so A's bytes over the memory rate are the
// least time (1.12 GB, about 0.33 ms, at the main path's (16, 4177, 4177)
// f32); x, y and alpha are small beside them. The whole task is to stream A
// at the card's byte rate.
//
// Design:
//  * A persistent grid: one CTA per SM, each taking an equal, contiguous
//    share of the B * N rows of A (the partition is a pure function of B, N
//    and the SM count). Its rows form one contiguous run of A. A share may
//    cross a system boundary; it is walked as segments, one per system.
//  * A streamed by TMA. One producer thread cuts each segment into pieces
//    (g whole rows, or for long rows one row's column chunk) and copies
//    each piece's byte range, aligned down to 16 bytes at its start and up
//    at its end, with one 1-D bulk copy (cp.async.bulk) into a ring of
//    shared-memory slots that completes on an mbarrier. Rows of A start
//    anywhere (at N = 4177 only 4-byte aligned): the bytes outside a row
//    are masked by their offsets, so row alignment stops mattering. A
//    16-byte block that holds a byte of A lies in the allocation's pages,
//    so the rounded ranges never fault. The copies cost the producer no
//    registers, and a dozen slots keep about 200 KB in flight per SM.
//  * x staged once per segment: the consumer warps read the system's x in
//    its own type (f32 or f64, any stride), round it to f32 (the contract's
//    rounding, once) and keep it in shared memory with zero pads. A row's
//    offset s inside its 16-byte blocks is the same for all of its units,
//    so each unit of A meets its x values in two (f32) or four (bf16)
//    aligned 16-byte reads, picked by a code path specialised on s. Where
//    N is too large for x to fit beside the ring, x is read from device
//    memory instead (x_global).
//  * Consumer warps own pieces round robin: a warp sums its row's units
//    (lane-strided, V accumulators a lane), reduces across the warp by a
//    fixed butterfly, writes y and adds x_i y_i to its alpha partial.
//  * alpha in the same launch: each CTA adds its warps' partials in warp
//    order and writes one partial per segment; the last CTA to finish a
//    system (a counter behind a fence) adds that system's partials in CTA
//    order, writes alpha and resets the counter, so no memset is needed.
// There are no atomics on any sum: y and alpha are the same bits run to
// run on one card. (The TPU kernel adds alpha from partial y per column
// tile; the port is held to ref.py's value, not to that rounding order.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // consumer warps a CTA (4 were slower on the card, 16 no faster)
constexpr int kMaxSlots = 16;
// Full barriers, used in turn by the pieces: piece k completes on
// full[k % kFull], whose phases are then told apart by parity alone only if
// piece k - kFull has landed before any warp waits for piece k. A warp's
// pieces lie at most (kWarps - 1) * chunks + 1 apart, and every piece up
// to `slots` before a warp's last one has landed, so the host requires
// (kWarps - 1) * chunks + 1 + slots <= kFull. (One barrier per slot would let a
// warp that runs ahead read a slot whose earlier piece is still landing.)
constexpr int kFull = 256;
constexpr int kPad = 8;             // zero floats before x in shared memory
constexpr int kTail = 16;           // and after it
constexpr long long kSlotTarget = 32768;  // bytes of A a piece aims at
constexpr long long kXsMax = 16384;       // largest N whose x is staged
// dynamic shared memory a CTA takes: the 227 KB a CTA may have, less the
// static barriers and sums
constexpr int kSmemBudget = 232448 - 4096;

struct Plan {
  long long n, nb;       // N, B
  long long sb, sn;      // x's element strides (system, column)
  long long g;           // whole rows a piece (1 where rows are chunked)
  long long cw;          // columns a chunk, a multiple of the unit (= n unchunked)
  int chunks;            // pieces a row group (1 unless a row is chunked)
  int slot_bytes, slots, xs_bytes;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(double v) { return (float)v; }

template <typename TA>
struct Unit;  // one 16-byte unit of A, widened to f32
template <>
struct Unit<float> {
  static constexpr int kV = 4;
  __device__ __forceinline__ static void load(const uint8_t* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
};
template <>
struct Unit<__nv_bfloat16> {
  static constexpr int kV = 8;
  __device__ __forceinline__ static void load(const uint8_t* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of an f32
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

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

// `bytes` (a multiple of 16) from 16-byte aligned global `src` into shared
// `dst`, completing on `bar`; A is read once, so its lines go first out of
// L2 (`policy`, an evict-first cache policy)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// a barrier of `threads` threads (the consumers); barrier.sync, unlike
// bar.sync, lets a warp arrive diverged (thread 0 may still be adding a
// system's partials while its warp's other lanes arrive)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("barrier.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the CTA whose share holds global row r (shares: [c R / G, (c + 1) R / G))
__device__ __forceinline__ long long cta_of(long long r, long long rows, long long ctas) {
  return ((r + 1) * ctas - 1) / rows;
}

// The byte range of one piece: rows [r0, r0 + nrows) of the flat (B N, N)
// A, columns [c0, c0 + ncols), widened to 16-byte blocks.
template <typename TA>
__device__ __forceinline__ void piece_range(const TA* a, long long n, long long r0,
                                            long long nrows, long long c0, long long ncols,
                                            uintptr_t& lo, uintptr_t& hi) {
  lo = reinterpret_cast<uintptr_t>(a + r0 * n + c0) & ~uintptr_t(15);
  hi = (reinterpret_cast<uintptr_t>(a + (r0 + nrows - 1) * n + c0 + ncols) + 15) & ~uintptr_t(15);
}

// A lane's sum over one row's units in a slot: the row's first element
// sits `off` elements into the slot, its columns are [c0, c0 + ncols); S is
// off modulo the unit. Unit u holds slot elements [V u, V u + V), which are
// columns c0 + V u + c - off. With x in shared memory (XS) the x values of
// unit u are xs[kPad + c0 + V (u - off / V) + c - S]: the 2V floats from
// base - V are aligned 16-byte reads and the code picks from them at
// compile-time positions. Only the first and last unit of a row hold
// elements of other rows; their products are masked, not their operands,
// so a NaN or inf beside the row does not leak in.
template <typename TA, typename TX, bool XS, int S>
__device__ __forceinline__ void row_units(const uint8_t* slot, int off, int ncols, long long c0,
                                          const float* xs, const TX* xg, long long sn, int lane,
                                          float (&acc)[Unit<TA>::kV]) {
  constexpr int V = Unit<TA>::kV;
  const int u0 = off / V, u1 = (off + ncols - 1) / V;
  // xs index of unit u's first x value, less V u (XS only: c0 < N <= kXsMax)
  const int xbase = kPad + (int)c0 - V * u0;
#pragma unroll 4
  for (int u = u0 + lane; u <= u1; u += 32) {
    float av[V];
    Unit<TA>::load(slot + 16 * u, av);
    float xv[V];
    if constexpr (XS) {
      float w[2 * V];
      const float* xw = xs + xbase + V * u - V;  // 16-byte aligned
#pragma unroll
      for (int q = 0; q < 2 * V / 4; ++q) {
        const float4 f = reinterpret_cast<const float4*>(xw)[q];
        w[4 * q] = f.x; w[4 * q + 1] = f.y; w[4 * q + 2] = f.z; w[4 * q + 3] = f.w;
      }
#pragma unroll
      for (int c = 0; c < V; ++c) xv[c] = w[V + c - S];
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const int e = V * u + c;
        xv[c] = (e >= off && e < off + ncols) ? to_f(__ldg(xg + (c0 + e - off) * sn)) : 0.0f;
      }
    }
    if (u == u0 || u == u1) {
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const int e = V * u + c;
        if (e >= off && e < off + ncols) acc[c] = fmaf(av[c], xv[c], acc[c]);
      }
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) acc[c] = fmaf(av[c], xv[c], acc[c]);
    }
  }
}

template <typename TA, typename TX, bool XS>
__device__ __forceinline__ void row_dispatch(int s, const uint8_t* slot, int off, int ncols,
                                             long long c0, const float* xs,
                                             const TX* xg, long long sn, int lane,
                                             float (&acc)[Unit<TA>::kV]) {
  if constexpr (!XS) {
    row_units<TA, TX, false, 0>(slot, off, ncols, c0, xs, xg, sn, lane, acc);
  } else if constexpr (Unit<TA>::kV == 4) {
    switch (s) {
      case 0: row_units<TA, TX, true, 0>(slot, off, ncols, c0, xs, xg, sn, lane, acc); break;
      case 1: row_units<TA, TX, true, 1>(slot, off, ncols, c0, xs, xg, sn, lane, acc); break;
      case 2: row_units<TA, TX, true, 2>(slot, off, ncols, c0, xs, xg, sn, lane, acc); break;
      default: row_units<TA, TX, true, 3>(slot, off, ncols, c0, xs, xg, sn, lane, acc); break;
    }
  } else {
    switch (s) {
      case 0: row_units<TA, TX, true, 0>(slot, off, ncols, c0, xs, xg, sn, lane, acc); break;
      case 1: row_units<TA, TX, true, 1>(slot, off, ncols, c0, xs, xg, sn, lane, acc); break;
      case 2: row_units<TA, TX, true, 2>(slot, off, ncols, c0, xs, xg, sn, lane, acc); break;
      case 3: row_units<TA, TX, true, 3>(slot, off, ncols, c0, xs, xg, sn, lane, acc); break;
      case 4: row_units<TA, TX, true, 4>(slot, off, ncols, c0, xs, xg, sn, lane, acc); break;
      case 5: row_units<TA, TX, true, 5>(slot, off, ncols, c0, xs, xg, sn, lane, acc); break;
      case 6: row_units<TA, TX, true, 6>(slot, off, ncols, c0, xs, xg, sn, lane, acc); break;
      default: row_units<TA, TX, true, 7>(slot, off, ncols, c0, xs, xg, sn, lane, acc); break;
    }
  }
}

// kWarps consumer warps and one producer warp. Named barrier 1 joins the
// consumers alone.
template <typename TA, typename TX, bool XS>
__global__ void __launch_bounds__((kWarps + 1) * 32, 1) fused_matvec_kernel(
    const TA* __restrict__ a, const TX* __restrict__ x, float* __restrict__ y,
    float* __restrict__ alpha, float* __restrict__ partial, int* __restrict__ counter, Plan p) {
  constexpr int V = Unit<TA>::kV;
  constexpr int kConsumers = kWarps * 32;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t full[kFull], empty[kMaxSlots];
  __shared__ float wsum[kWarps];
  float* xs = reinterpret_cast<float*>(smem);
  uint8_t* slots = smem + p.xs_bytes;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n = p.n, rows = p.nb * n, ctas = gridDim.x;
  const long long r_begin = (long long)blockIdx.x * rows / ctas;
  const long long r_end = ((long long)blockIdx.x + 1) * rows / ctas;

  for (int f = threadIdx.x; f < kFull; f += blockDim.x) mbar_init(&full[f], 1);
  if (threadIdx.x < p.slots) mbar_init(&empty[threadIdx.x], 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  if (warp == kWarps) {
    // ---- producer: one thread copies every piece of the share in order
    if (lane == 0) {
      const uint64_t policy = evict_first_policy();
      long long k = 0;
      for (long long r = r_begin; r < r_end;) {
        const long long seg_end = min(r_end, (r / n + 1) * n);
        for (long long r0 = r; r0 < seg_end; r0 += p.g) {
          const long long nrows = min(p.g, seg_end - r0);
          for (int pc = 0; pc < p.chunks; ++pc, ++k) {
            const long long c0 = pc * p.cw, ncols = min(p.cw, n - c0);
            uintptr_t lo, hi;
            piece_range(a, n, r0, nrows, c0, ncols, lo, hi);
            const int s = (int)(k % p.slots);
            uint64_t* f = &full[k % kFull];
            mbar_wait(&empty[s], (uint32_t)(((k / p.slots) & 1) ^ 1));
            mbar_expect_tx(f, (uint32_t)(hi - lo));
            bulk_load(slots + (long long)s * p.slot_bytes, reinterpret_cast<const void*>(lo),
                      (uint32_t)(hi - lo), f, policy);
          }
        }
        r = seg_end;
      }
    }
    return;
  }

  // ---- consumers
  long long k = 0, j = 0;  // piece and row-group counters of the share
  for (long long r = r_begin; r < r_end;) {
    const long long b = r / n, seg_end = min(r_end, (b + 1) * n);
    const TX* xg = x + b * p.sb;
    named_sync(1, kConsumers);  // the last segment's x and wsum are no longer read
    if constexpr (XS) {
      // 16 loads a thread in flight at once: a segment starts with one or
      // two round trips to device memory, not one a value
      constexpr int kBatch = 16;
      const int xs_floats = p.xs_bytes / 4;
      for (int i0 = threadIdx.x; i0 < xs_floats; i0 += kBatch * kConsumers) {
        float v[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const long long jj = (long long)(i0 + q * kConsumers) - kPad;
          v[q] = (jj >= 0 && jj < n) ? to_f(xg[jj * p.sn]) : 0.0f;
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
          if (i0 + q * kConsumers < xs_floats) xs[i0 + q * kConsumers] = v[q];
      }
      named_sync(1, kConsumers);
    }
    float walpha = 0.0f;  // this warp's sum of x_i y_i over its rows, in order
    for (long long r0 = r; r0 < seg_end; r0 += p.g, ++j) {
      if (j % kWarps != warp) {
        k += p.chunks;
        continue;
      }
      const long long nrows = min(p.g, seg_end - r0);
      float acc[V];
#pragma unroll
      for (int c = 0; c < V; ++c) acc[c] = 0.0f;
      for (int pc = 0; pc < p.chunks; ++pc, ++k) {
        const long long c0 = pc * p.cw, ncols = min(p.cw, n - c0);
        uintptr_t lo, hi;
        piece_range(a, n, r0, nrows, c0, ncols, lo, hi);
        const int s = (int)(k % p.slots);
        mbar_wait(&full[k % kFull], (uint32_t)((k / kFull) & 1));
        const uint8_t* slot = slots + (long long)s * p.slot_bytes;
        for (long long rr = 0; rr < nrows; ++rr) {
          const long long row = r0 + rr;
          // the row's first element, in elements from the slot's start
          const int off = (int)((reinterpret_cast<uintptr_t>(a + row * n + c0) - lo) / sizeof(TA));
          row_dispatch<TA, TX, XS>(off % V, slot, off, (int)ncols, c0, xs, xg, p.sn, lane, acc);
          if (pc == p.chunks - 1) {  // the row is complete
            float t = 0.0f;
#pragma unroll
            for (int c = 0; c < V; ++c) {
              t += acc[c];
              acc[c] = 0.0f;
            }
            t = warp_sum(t);
            const long long i = row - b * n;
            if (lane == 0) y[row] = t;
            const float xi = XS ? xs[kPad + i] : to_f(xg[i * p.sn]);
            walpha = fmaf(xi, t, walpha);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
    }
    if (lane == 0) wsum[warp] = walpha;
    named_sync(1, kConsumers);
    if (threadIdx.x == 0) {
      float t = 0.0f;
      for (int w = 0; w < kWarps; ++w) t += wsum[w];  // warps in order
      // the partial of (CTA c, system b) sits at c + b: one slot each, as
      // a later CTA never works on an earlier system
      partial[blockIdx.x + b] = t;
      __threadfence();
      const long long c_first = cta_of(b * n, rows, ctas);
      const long long c_last = cta_of((b + 1) * n - 1, rows, ctas);
      const int seen = atomicAdd(counter + b, 1);
      if (seen == (int)(c_last - c_first)) {  // the last CTA of system b
        __threadfence();
        float s = 0.0f;
        for (long long c = c_first; c <= c_last; ++c) s += __ldcg(partial + c + b);
        alpha[b] = s;
        counter[b] = 0;  // ready for the next launch
      }
    }
    __syncwarp();
    r = seg_end;
  }
}

template <typename TA, typename TX, bool XS>
int launch(const TA* a, const TX* x, void* const* outs, const Plan& p, int ctas,
           cudaStream_t stream) {
  auto kernel = fused_matvec_kernel<TA, TX, XS>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int smem = p.xs_bytes + p.slots * p.slot_bytes;
  kernel<<<ctas, (kWarps + 1) * 32, smem, stream>>>(
      a, x, static_cast<float*>(outs[0]), static_cast<float*>(outs[1]),
      static_cast<float*>(outs[2]), static_cast<int*>(outs[3]), p);
  return (int)cudaGetLastError();
}

// ins: A (B, N, N) contiguous, x (B, N) strided; outs: y (B, N) f32,
// alpha (B,) f32, partial (sms + B,) f32 scratch, counter (B,) int32, zero
// before the first launch and left zero by every launch; dims: B, N, x's
// strides (system, column), the SM count
template <typename TA, typename TX>
int fused_matvec(const void* const* ins, void* const* outs, const long long* dims, void* stream) {
  constexpr long long V = Unit<TA>::kV;
  Plan p;
  p.nb = dims[0];
  p.n = dims[1];
  p.sb = dims[2];
  p.sn = dims[3];
  const long long sms = dims[4];
  if (p.nb <= 0 || p.n <= 0 || sms <= 0) return (int)cudaErrorInvalidValue;
  const long long rows = p.nb * p.n;
  const int ctas = (int)(sms < rows ? sms : rows);
  const bool xs_mode = p.n <= kXsMax;
  p.xs_bytes = xs_mode ? (int)(((p.n + kPad + kTail) * 4 + 127) / 128 * 128) : 0;
  const long long row_bytes = p.n * (long long)sizeof(TA);
  long long piece;  // bytes of A in a piece, before the 16-byte rounding
  if (row_bytes <= kSlotTarget) {
    p.chunks = 1;
    p.cw = p.n;
    p.g = kSlotTarget / row_bytes > 1 ? kSlotTarget / row_bytes : 1;
    piece = p.g * row_bytes;
  } else {
    p.g = 1;
    p.chunks = (int)((row_bytes + kSlotTarget - 1) / kSlotTarget);
    p.cw = ((p.n + p.chunks - 1) / p.chunks + V - 1) / V * V;
    p.chunks = (int)((p.n + p.cw - 1) / p.cw);
    piece = p.cw * (long long)sizeof(TA);
  }
  p.slot_bytes = (int)((piece + 32 + 127) / 128 * 128);
  const long long fit = (kSmemBudget - p.xs_bytes) / (long long)p.slot_bytes;
  p.slots = (int)(fit < kMaxSlots ? fit : kMaxSlots);
  if (p.slots < 2 || (kWarps - 1) * p.chunks + 1 + p.slots > kFull)
    return (int)cudaErrorInvalidConfiguration;
  const TA* a = static_cast<const TA*>(ins[0]);
  const TX* x = static_cast<const TX*>(ins[1]);
  cudaStream_t s = (cudaStream_t)stream;
  return xs_mode ? launch<TA, TX, true>(a, x, outs, p, ctas, s)
                 : launch<TA, TX, false>(a, x, outs, p, ctas, s);
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
