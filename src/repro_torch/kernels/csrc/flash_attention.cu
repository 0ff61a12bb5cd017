// K7: streaming (flash) attention forward with online softmax, causal or
// not, grouped-query heads read through a kv-head index.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py, function
// flash_attention (pallas_call at line 86, body _kernel at line 28), and the
// kv-head repeat of its mha_flash wrapper (line 109): for each head h, with
// kv head h / (H / Hkv),
//   s = (q k^T) * (1 / sqrt(D)),  masked to -1e30 where col >= S or, when
//   causal, col > row (zero-aligned global indices, also for T != S);
//   running m, l, acc in f32: m' = max(m, rowmax s), p = exp(s - m'),
//   l = l exp(m - m') + sum p, acc = acc exp(m - m') + p v;
//   o = acc / max(l, 1e-30), written in the input type.
// The order of scale, mask and update is the reference's. Masked scores are
// -1e30, not -inf, so exp underflows to 0 and never gives NaN.
//
// Bound on the H100: operations. At the main path's llama3-405b prefill
// (128 query heads, 4096 tokens, D = 128, bf16) the causal work is 5.5e11
// flops against 0.3 GB of q, k, v and o: 0.556 ms at the 989 TFLOP/s bf16
// tensor-core rate. P V takes P as two bf16 parts (below), so the tensor
// work is 1.5 times that count, a floor near 0.83 ms.
//
// Three kernels, routed by type and shape (flash_attention.py counts each
// route's launches in ROUTES); all keep the reference's f32 softmax state
// and f32 accumulation, skip causal tiles that lie wholly above the
// diagonal (they would add p = 0 with a rescale of exp(0) = 1, exactly
// nothing), run the query tiles from the last (longest causal rows) to
// the first, split no key range (so outputs have the same bits run to
// run), and divide by max(l, 1e-30) in the epilogue. Scores are kept in
// log2 units (scale * log2 e), so every exponential is one exp2f; m is
// then in log2 units too, and p and the rescale factor are the
// reference's. The reference's P V is f32, and V is exact in bf16, so the
// bf16 kernels feed P to the tensor cores as two bf16 parts, hi = bf16(p)
// and lo = bf16(p - hi), which carry p to about 2^-17 (rounding p to bf16
// alone would be 2^-9, as large as the output's own rounding).
//
// bf16, D = 64 or 128, T >= 64 (flash_fwd_wgmma_kernel, the prefill):
// wgmma, TMA and warp specialisation. A CTA of three warpgroups owns 128
// query rows of one head. Warpgroup 2 is the producer: it hands its
// registers to the consumers (setmaxnreg 24 / 240), and one of its threads
// loads the Q tile once and keeps 64-key K and V tiles in flight through
// a 3-stage ring (TMA into the 128-byte swizzle, full and empty
// mbarriers). The tensor maps describe the strided (B, T, H, D) and
// (B, S, Hkv, D) views as they are, so grouped-query heads stay a kv-head
// index and nothing is copied; rows past T or S load as zeros. Warpgroups
// 0 and 1 own 64 query rows each: S = Q K^T by wgmma m64n64k16 from shared
// memory (f32 accumulators), the online softmax in registers (each row is
// spread over a quad, reduced by shuffles; the mask is applied on diagonal
// and ragged tiles only), then O += P V by wgmma m64nDk16 with P from the
// score registers (hi and lo parts) and V from shared memory through the
// transpose bit. Each consumer warp releases a stage once its products
// have completed. The two consumer warpgroups take turns at the tensor
// cores (named barriers): in its turn one issues S of a tile and P V of
// the tile before, then runs its softmax while the other's products run.
// Timed on the card, this beat each warpgroup running its products and
// softmax in sequence (PERF.md).
//
// bf16 otherwise (flash_fwd_mma_kernel: D = 32, and T below one 64-row
// tile, the decode call): mma.sync m16n8k16 with f32 accumulators. A CTA
// of 4 warps owns 64 query rows of one head, 16 per warp; the query tile
// and each 64-key tile of K and V sit in shared memory as bf16 (rows
// padded by 16 bytes, so ldmatrix reads without bank conflicts), the K and
// V tiles in two buffers: cp.async fills the next tile's while the
// current one is used. A warp keeps its Q fragments in registers, computes
// its 16 x 64 scores, updates m and l for its rows, and feeds P (hi and
// lo) to the P V product straight from the score registers.
//
// f32 (flash_fwd_fma_kernel): CUDA-core f32 FMA, since f32 must not go
// through TF32. A CTA of 256 threads owns 64 query rows; the query tile and
// each 32-key tile of K and V are staged in shared memory (rows padded to
// D + 4 floats: 16-byte loads without bank conflicts). Thread (ty, tx) of a
// 16 x 16 grid keeps the rows ty + 16 i (i < 4): their scores at the
// columns tx + 16 j, their m and l (the same in all 16 threads of a row,
// reduced by butterfly shuffles), and their accumulator at the
// head-dimension columns tx + 16 j (or 4-wide groups when 64 divides D).
// The probabilities go through shared memory to the P V product.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

struct Strides {  // element strides of the (B, T|S, H, D) views
  long long qb, qt, qh, kb, ks, kh, vb, vs, vh, ob, ot, oh;
};

// ---------------------------------------------------------------------------
// f32: CUDA-core FMA

constexpr int kThreads = 256;
constexpr int kBT = 64;  // query rows per CTA
constexpr int kBS = 32;  // keys per tile
constexpr int kRI = kBT / 16;
constexpr int kSJ = kBS / 16;

template <int D>
constexpr int fma_smem_bytes() {
  return (kBT * (D + 4) + 2 * kBS * (D + 4) + kBT * (kBS + 4)) * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_fma_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, Strides st, int rep, int t_len, int s_len, float scale, int causal) {
  constexpr int QS = D + 4;
  constexpr int PS = kBS + 4;
  constexpr int CV = (D % 64 == 0) ? 4 : 1;  // accumulator columns per group
  constexpr int DJ = D / (16 * CV);          // groups per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // kBT x QS
  float* ks = qs + kBT * QS;                    // kBS x QS
  float* vs = ks + kBS * QS;                    // kBS x QS
  float* ps = vs + kBS * QS;                    // kBT x PS

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int t0 = (gridDim.x - 1 - blockIdx.x) * kBT;
  const long long h = blockIdx.y, b = blockIdx.z, hk = h / rep;
  const float* qg = q + b * st.qb + h * st.qh;
  const float* kg = k + b * st.kb + hk * st.kh;
  const float* vg = v + b * st.vb + hk * st.vh;

  for (int e = tid; e < kBT * D; e += kThreads) {
    const int r = e / D, c = e % D;
    qs[r * QS + c] = (t0 + r < t_len) ? qg[(long long)(t0 + r) * st.qt + c] : 0.0f;
  }

  float m[kRI], l[kRI], acc[kRI][DJ * CV];
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ * CV; ++j) acc[i][j] = 0.0f;
  }

  int n_tiles = (s_len + kBS - 1) / kBS;
  if (causal) {  // tiles past the last real row's diagonal add nothing
    const int last_row = min(t0 + kBT, t_len) - 1;
    n_tiles = min(n_tiles, last_row / kBS + 1);
  }
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int s0 = tile * kBS;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int e = tid; e < kBS * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const bool in = s0 + r < s_len;
      ks[r * QS + c] = in ? kg[(long long)(s0 + r) * st.ks + c] : 0.0f;
      vs[r * QS + c] = in ? vg[(long long)(s0 + r) * st.vs + c] : 0.0f;
    }
    __syncthreads();

    // scores of rows ty + 16 i at columns tx + 16 j
    float s[kRI][kSJ];
#pragma unroll
    for (int i = 0; i < kRI; ++i)
#pragma unroll
      for (int j = 0; j < kSJ; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[kRI], kv[kSJ];
#pragma unroll
      for (int i = 0; i < kRI; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * QS + d);
#pragma unroll
      for (int j = 0; j < kSJ; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < kRI; ++i)
#pragma unroll
        for (int j = 0; j < kSJ; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // scale, mask, online softmax update; P to shared memory
#pragma unroll
    for (int i = 0; i < kRI; ++i) {
      const int row = t0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kSJ; ++j) {
        const int col = s0 + tx + 16 * j;
        const bool valid = col < s_len && (!causal || col <= row);
        s[i][j] = valid ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kSJ; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ * CV; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // acc += P V over this tile's keys
#pragma unroll 2
    for (int c = 0; c < kBS; c += 4) {
      float4 pv[kRI];
#pragma unroll
      for (int i = 0; i < kRI; ++i)
        pv[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * PS + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = vs + (c + cc) * QS;
        float vv[DJ * CV];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          if constexpr (CV == 4) {
            const float4 w = *reinterpret_cast<const float4*>(vrow + 4 * tx + 64 * j);
            vv[4 * j] = w.x; vv[4 * j + 1] = w.y; vv[4 * j + 2] = w.z; vv[4 * j + 3] = w.w;
          } else {
            vv[j] = vrow[tx + 16 * j];
          }
        }
#pragma unroll
        for (int i = 0; i < kRI; ++i) {
          const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y : cc == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int j = 0; j < DJ * CV; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
        }
      }
    }
  }

  float* og = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const int row = t0 + ty + 16 * i;
    if (row >= t_len) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = og + (long long)row * st.ot;
#pragma unroll
    for (int j = 0; j < DJ * CV; ++j) {
      const int col = CV == 4 ? 4 * tx + 64 * (j / 4) + (j % 4) : tx + 16 * j;
      orow[col] = acc[i][j] / den;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync)

constexpr int kMmaThreads = 128;  // 4 warps
constexpr int kMT = 64;           // query rows per CTA, 16 per warp
constexpr int kMS = 64;           // keys per tile

template <int D>
constexpr int mma_smem_bytes() {
  return (kMT + 4 * kMS) * (D + 8) * (int)sizeof(__nv_bfloat16);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (a, b) as two bf16 pairs, hi = bf16(a, b) and lo = bf16 of the rest
// (a in the low halves): hi + lo is (a, b) to about 2^-17
__device__ __forceinline__ void split_bf16(uint32_t& hi, uint32_t& lo, float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// rows [r0, r0 + rows) of a (rows x D) bf16 tile into shared memory (row
// stride LD), 16 bytes a thread, zeros past `limit`
template <int D, int LD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, int r0, int rows, int limit) {
  constexpr int CH = D / 8;
  for (int e = threadIdx.x; e < rows * CH; e += kMmaThreads) {
    const int r = e / CH, c = e % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * stride + c * 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
}

// the same, without waiting: 16-byte cp.async copies (zero-filled past
// `limit`) that the caller commits and waits for
template <int D, int LD>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                long long stride, int r0, int rows, int limit) {
  constexpr int CH = D / 8;
  for (int e = threadIdx.x; e < rows * CH; e += kMmaThreads) {
    const int r = e / CH, c = e % CH;
    const bool in = r0 + r < limit;
    const __nv_bfloat16* p = in ? src + (long long)(r0 + r) * stride + c * 8 : src;
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst + r * LD + c * 8);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(p),
                 "r"(in ? 16 : 0));
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, Strides st, int rep,
    int t_len, int s_len, float scale, int causal) {
  constexpr int LD = D + 8;    // shared row stride in elements (16 bytes of pad)
  constexpr int KD = D / 16;   // k-steps of Q K^T
  constexpr int ND = D / 8;    // 8-wide output column tiles
  constexpr int NS = kMS / 8;  // 8-wide score column tiles
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_u4);  // kMT x LD
  __nv_bfloat16* ks0 = qs + kMT * LD;  // two buffers of (K, V), kMS x LD each

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;  // the fragment's row and column pair
  const int t0 = (gridDim.x - 1 - blockIdx.x) * kMT;
  const long long h = blockIdx.y, b = blockIdx.z, hk = h / rep;
  const __nv_bfloat16* kg = k + b * st.kb + hk * st.kh;
  const __nv_bfloat16* vg = v + b * st.vb + hk * st.vh;

  load_tile<D, LD>(qs, q + b * st.qb + h * st.qh, st.qt, t0, kMT, t_len);
  __syncthreads();
  uint32_t qa[KD][4];  // this warp's 16 query rows as A fragments
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldsm_x4(qa[kk], qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + kk * 16 +
                        (lane >> 4) * 8);

  float oacc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};  // rows g and g + 8
  const int row0 = t0 + warp * 16 + g;
  const float scale2 = scale * 1.4426950408889634f;  // scores in log2 units

  int n_tiles = (s_len + kMS - 1) / kMS;
  if (causal) {  // tiles past the last real row's diagonal add nothing
    const int last_row = min(t0 + kMT, t_len) - 1;
    n_tiles = min(n_tiles, last_row / kMS + 1);
  }
  load_tile_async<D, LD>(ks0, kg, st.ks, 0, kMS, s_len);
  load_tile_async<D, LD>(ks0 + kMS * LD, vg, st.vs, 0, kMS, s_len);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int s0 = tile * kMS;
    __nv_bfloat16* ks = (tile & 1) ? ks0 + 2 * kMS * LD : ks0;
    __nv_bfloat16* vs = ks + kMS * LD;
    if (tile + 1 < n_tiles) {  // the next tile into the other buffer
      __nv_bfloat16* kn = (tile & 1) ? ks0 : ks0 + 2 * kMS * LD;
      load_tile_async<D, LD>(kn, kg, st.ks, s0 + kMS, kMS, s_len);
      load_tile_async<D, LD>(kn + kMS * LD, vg, st.vs, s0 + kMS, kMS, s_len);
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();

    // S = Q K^T: K rows are the B operand's columns, as ldmatrix reads them
    float sacc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) sacc[j][0] = sacc[j][1] = sacc[j][2] = sacc[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(sacc[2 * np], qa[kk], kb[0], kb[1]);
        mma_bf16(sacc[2 * np + 1], qa[kk], kb[2], kb[3]);
      }
    }

    // scale, mask, online softmax update of rows g and g + 8
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + (e >> 1) * 8;
        const int col = s0 + j * 8 + 2 * tq + (e & 1);
        const bool valid = col < s_len && (!causal || col <= row);
        sacc[j][e] = valid ? sacc[j][e] * scale2 : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], sacc[j][e]);
      }
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sacc[j][e] = exp2f(sacc[j][e] - m[e >> 1]);
        sum[e >> 1] += sacc[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      oacc[j][0] *= alpha[0];
      oacc[j][1] *= alpha[0];
      oacc[j][2] *= alpha[1];
      oacc[j][3] *= alpha[1];
    }

    // O += P V: the score registers of two 8-key tiles are one A fragment,
    // taken as its hi and lo bf16 parts
#pragma unroll
    for (int kk = 0; kk < kMS / 16; ++kk) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_bf16(ph[e], pl[e], sacc[2 * kk + (e >> 1)][2 * (e & 1)],
                   sacc[2 * kk + (e >> 1)][2 * (e & 1) + 1]);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 +
                          (lane >> 4) * 8);
        mma_bf16(oacc[2 * dp], pl, vb[0], vb[1]);
        mma_bf16(oacc[2 * dp], ph, vb[0], vb[1]);
        mma_bf16(oacc[2 * dp + 1], pl, vb[2], vb[3]);
        mma_bf16(oacc[2 * dp + 1], ph, vb[2], vb[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

  __nv_bfloat16* og = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= t_len) continue;
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = og + (long long)row * st.ot;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * tq) =
          __floats2bfloat162_rn(oacc[j][2 * r] / den, oacc[j][2 * r + 1] / den);
  }
}


// ---------------------------------------------------------------------------
// bf16, D = 64 or 128, T >= 64: wgmma + TMA, warp-specialized

constexpr int kWgBM = 128;       // query rows per CTA: two consumer warpgroups of 64
constexpr int kWgBN = 64;        // keys per tile
constexpr int kWgStages = 3;     // K/V ring
constexpr int kWgThreads = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2

template <int D>
struct WgLayout {
  static constexpr int kChunks = D / 64;                // 128-byte column chunks of a row
  static constexpr int kQChunk = kWgBM * 64;            // elements of one Q chunk
  static constexpr int kKVChunk = kWgBN * 64;           // elements of one K or V chunk
  static constexpr int kQBytes = kChunks * kQChunk * 2;
  static constexpr int kKVBytes = kChunks * kKVChunk * 2;
  static constexpr int kSmem = kQBytes + 2 * kWgStages * kKVBytes + 1024;  // + alignment
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
// than about 10 s at the card's clock traps (the launch fails) rather than
// hang the card
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

// one box of a 4-d tensor map (coordinates innermost first) into shared
// memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor for a tile in the 128-byte swizzle that
// TMA writes (rows of 128 bytes, 8-row groups 1024 bytes apart): lbo is
// the byte stride between 64-column chunks (MN-major operands only), sbo
// that between 8-row groups.
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of r across a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64, f32) (+)= a (64 x 16) * b (16 x 64), bf16 operands in shared
// memory by descriptor, both K-major; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += a (64 x 16, bf16 in registers) * b (16 x 64, bf16 in
// shared memory, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += a (64 x 16, bf16 in registers) * b (16 x 128, bf16 in
// shared memory, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n128(d, a, db);
  }
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// One consumer warpgroup's state and steps over a 64-key tile: S = Q K^T
// into sacc, the online softmax of its rows, P as hi and lo bf16 parts,
// O += P V. Thread (warp wq, lane g * 4 + t4) holds rows row0 and
// row0 + 8 and the columns 8 j + 2 t4 + {0, 1} of each 8-column block.
template <int D>
struct WgConsumer {
  using L = WgLayout<D>;
  float oacc[D / 2];
  float sacc[32];
  uint32_t phi[4][4], plo[4][4];
  float m[2], l[2], alpha[2];
  int row0, tq4;
  float scale2;

  __device__ __forceinline__ void issue_s(const __nv_bfloat16* qw, const __nv_bfloat16* ks) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / 4, kin = (kk % 4) * 16;
      wgmma_ss_n64(sacc, wg_desc(qw + c * L::kQChunk + kin, 16, 1024),
                   wg_desc(ks + c * L::kKVChunk + kin, 16, 1024), kk > 0 ? 1 : 0);
    }
  }

  __device__ __forceinline__ void issue_pv(const __nv_bfloat16* vs) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = wg_desc(vs + kk * 16 * 64, L::kKVChunk * 2, 1024);
      wgmma_rs<D>(oacc, plo[kk], dv);
      wgmma_rs<D>(oacc, phi[kk], dv);
    }
  }

  // scale, mask (only where need_mask), running max, p = exp2(s - m) in
  // sacc, running sum; leaves the rescale factor of O in alpha
  __device__ __forceinline__ void softmax(int s0, int s_len, int causal, bool need_mask) {
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sacc[4 * j + e] * scale2;
        if (need_mask) {
          const int row = row0 + (e >> 1) * 8;
          const int col = s0 + j * 8 + 2 * tq4 + (e & 1);
          if (col >= s_len || (causal && col > row)) x = kNegInf;
        }
        sacc[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sacc[i] = exp2f(sacc[i] - m[(i >> 1) & 1]);
      sum[(i >> 1) & 1] += sacc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
  }

  // O *= alpha, and P as A fragments of four 16-key steps
  __device__ __forceinline__ void rescale_and_split() {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_bf16(phi[kk][e], plo[kk][e], sacc[8 * kk + 2 * e], sacc[8 * kk + 2 * e + 1]);
  }
};

// A CTA owns kWgBM query rows of one head. Warpgroup 2 is the producer: it
// gives up its registers (setmaxnreg), and one of its threads loads the Q
// tile once and keeps K and V tiles of kWgBN keys in flight through a ring
// of kWgStages stages (TMA, full and empty mbarriers). Warpgroups 0 and 1
// are the consumers, 64 query rows each, with the producer's registers:
// S = Q K^T by wgmma from shared memory, the online softmax in registers,
// then O += P V by wgmma with P from registers (as hi and lo bf16 parts)
// and V from shared memory through the transpose bit. Each consumer warp
// releases a stage (8 arrivals per phase) once its products are done.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, Strides st, int rep,
    int t_len, int s_len, float scale, int causal) {
  using L = WgLayout<D>;
  extern __shared__ uint8_t wg_smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, bar_full[kWgStages], bar_empty[kWgStages];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* ks0 = qs + L::kChunks * L::kQChunk;  // stage s: K at ks0 + 2 s kv, V after it
  constexpr int kKV = L::kChunks * L::kKVChunk;       // elements of one K or V tile

  const int wg = threadIdx.x >> 7;
  const int t0 = (gridDim.x - 1 - blockIdx.x) * kWgBM;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / rep;
  int n_tiles = (s_len + kWgBN - 1) / kWgBN;
  if (causal) {  // tiles past the last real row's diagonal add nothing
    const int last_row = min(t0 + kWgBM, t_len) - 1;
    n_tiles = min(n_tiles, last_row / kWgBN + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&bar_full[s], 1);
      mbar_init(&bar_empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(&bar_q, L::kQBytes);
      for (int c = 0; c < L::kChunks; ++c)
        tma_load_4d(qs + c * L::kQChunk, &tq, &bar_q, c * 64, t0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kWgStages;
        const uint32_t ph = (it / kWgStages) & 1;
        mbar_wait(&bar_empty[s], ph ^ 1);
        mbar_expect_tx(&bar_full[s], 2 * L::kKVBytes);
        __nv_bfloat16* ks = ks0 + 2 * s * kKV;
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load_4d(ks + c * L::kKVChunk, &tk, &bar_full[s], c * 64, it * kWgBN, hk, b);
          tma_load_4d(ks + kKV + c * L::kKVChunk, &tv, &bar_full[s], c * 64, it * kWgBN, hk, b);
        }
      }
    }
  } else {
    // ---- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
    const int wg_row0 = t0 + wg * 64;
    WgConsumer<D> c;
    c.tq4 = lane & 3;
    c.row0 = wg_row0 + wq * 16 + (lane >> 2);  // this thread's rows: row0 and row0 + 8
    c.scale2 = scale * 1.4426950408889634f;    // scores in log2 units
#pragma unroll
    for (int i = 0; i < D / 2; ++i) c.oacc[i] = 0.0f;
    c.m[0] = c.m[1] = kNegInf;
    c.l[0] = c.l[1] = 0.0f;
    const __nv_bfloat16* qw = qs + wg * 64 * 64;  // this warpgroup's rows of each Q chunk
    auto stage_k = [&](int it) { return ks0 + 2 * (it % kWgStages) * kKV; };
    auto need_mask = [&](int s0) {
      return s0 + kWgBN > s_len || (causal && s0 + kWgBN - 1 > wg_row0);
    };

    mbar_wait(&bar_q, 0);
    // The two consumer warpgroups take turns at the tensor cores (named
    // barriers 1 and 2, warpgroup 0 first): in its turn a warpgroup
    // issues S of tile it and P V of tile it - 1, then hands the turn
    // over and runs the softmax of tile it while the other's products
    // run. Both walk every tile of the CTA: a tile wholly above a
    // warpgroup's diagonal is masked to p = 0, which adds nothing. The
    // first tile (S only) and the last P V are peeled off the loop, so
    // that no product is issued under a branch.
    const int other = 2 - wg;  // the other warpgroup's barrier
    if (wg == 1) named_arrive(1, 256);
    mbar_wait(&bar_full[0], 0);
    named_sync(1 + wg, 256);
    fence_regs(c.sacc);
    wg_fence();
    c.issue_s(qw, stage_k(0));
    wg_commit();
    named_arrive(other, 256);
    wg_wait<0>();
    fence_regs(c.sacc);
    c.softmax(0, s_len, causal, need_mask(0));
    c.rescale_and_split();
    for (int it = 1; it < n_tiles; ++it) {
      const int s0 = it * kWgBN;
      mbar_wait(&bar_full[it % kWgStages], (it / kWgStages) & 1);
      named_sync(1 + wg, 256);
      fence_regs(c.oacc);
      wg_fence();
      c.issue_s(qw, stage_k(it));
      wg_commit();
      c.issue_pv(stage_k(it - 1) + kKV);
      wg_commit();
      named_arrive(other, 256);
      wg_wait<1>();  // S of tile it
      fence_regs(c.sacc);
      c.softmax(s0, s_len, causal, need_mask(s0));
      wg_wait<0>();  // P V of tile it - 1
      fence_regs(c.oacc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&bar_empty[(it - 1) % kWgStages]);
      c.rescale_and_split();
    }
    named_sync(1 + wg, 256);
    fence_regs(c.oacc);
    wg_fence();
    c.issue_pv(stage_k(n_tiles - 1) + kKV);
    wg_commit();
    named_arrive(other, 256);
    wg_wait<0>();
    fence_regs(c.oacc);
    if (wg == 0) named_sync(1, 256);  // takes warpgroup 1's last hand-over

    __nv_bfloat16* og = o + (long long)b * st.ob + (long long)h * st.oh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = c.row0 + r * 8;
      if (row >= t_len) continue;
      const float den = fmaxf(c.l[r], 1e-30f);
      __nv_bfloat16* orow = og + (long long)row * st.ot;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * c.tq4) =
            __floats2bfloat162_rn(c.oacc[4 * j + 2 * r] / den, c.oacc[4 * j + 2 * r + 1] / den);
    }
  }
}

// ---------------------------------------------------------------------------
// launch

Strides strides_of(const long long* s) {
  Strides st;
  st.qb = s[0]; st.qt = s[1]; st.qh = s[2];
  st.kb = s[3]; st.ks = s[4]; st.kh = s[5];
  st.vb = s[6]; st.vs = s[7]; st.vh = s[8];
  st.ob = s[9]; st.ot = s[10]; st.oh = s[11];
  return st;
}

template <typename T, typename Kernel>
int launch(Kernel kernel, int threads, int rows, int smem, const void* const* ins,
           void* const* outs, const long long* dims, const long long* strides, float scale,
           cudaStream_t stream) {
  const long long nb = dims[0], nh = dims[1], nkv = dims[2], t_len = dims[3], s_len = dims[4];
  if (nb <= 0 || nh <= 0 || t_len <= 0 || nkv <= 0 || nh % nkv != 0 || s_len <= 0)
    return (int)cudaErrorInvalidValue;
  if (nh > 65535 || nb > 65535 || t_len > 2147483647LL || s_len > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((unsigned)((t_len + rows - 1) / rows), (unsigned)nh, (unsigned)nb), threads,
           smem, stream>>>(
      static_cast<const T*>(ins[0]), static_cast<const T*>(ins[1]),
      static_cast<const T*>(ins[2]), static_cast<T*>(outs[0]), strides_of(strides),
      (int)(nh / nkv), (int)t_len, (int)s_len, scale, (int)dims[6]);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// TMA tensor maps (host)

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

// A map of the strided bf16 view (batch, rows, heads, D) with unit stride
// along D, read in boxes of 64 columns x `box_rows` rows of one head, in
// the 128-byte swizzle of the wgmma descriptors; rows past the end read as
// zeros. Element strides in s (b, row, head).
bool make_map(CUtensorMap* map, const void* base, long long nb, long long rows, long long heads,
              long long d, long long sb, long long srow, long long sh, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dim[4] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)heads, (cuuint64_t)nb};
  const cuuint64_t stride[3] = {(cuuint64_t)srow * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dim, stride, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_wgmma(const void* const* ins, void* const* outs, const long long* dims,
                 const long long* s, float scale, cudaStream_t stream) {
  const long long nb = dims[0], nh = dims[1], nkv = dims[2], t_len = dims[3], s_len = dims[4];
  if (nb <= 0 || nh <= 0 || nkv <= 0 || nh % nkv != 0 || t_len < 64 || s_len <= 0)
    return (int)cudaErrorInvalidValue;
  if (nh > 65535 || nb > 65535 || t_len > 2147483647LL || s_len > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, ins[0], nb, t_len, nh, D, s[0], s[1], s[2], kWgBM) ||
      !make_map(&tk, ins[1], nb, s_len, nkv, D, s[3], s[4], s[5], kWgBN) ||
      !make_map(&tv, ins[2], nb, s_len, nkv, D, s[6], s[7], s[8], kWgBN))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = WgLayout<D>::kSmem;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  flash_fwd_wgmma_kernel<D>
      <<<dim3((unsigned)((t_len + kWgBM - 1) / kWgBM), (unsigned)nh, (unsigned)nb), kWgThreads,
         smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(outs[0]), strides_of(s),
                         (int)(nh / nkv), (int)t_len, (int)s_len, scale, (int)dims[6]);
  return (int)cudaGetLastError();
}

}  // namespace

// ins: q (B, T, H, D), k and v (B, S, Hkv, D), strided views with unit
// stride along D (and, for bf16, rows 16-byte aligned); outs: o (B, T, H, D);
// dims: B, H, Hkv, T, S, D, causal; strides: q (b, t, h), k (b, s, h),
// v (b, s, h), o (b, t, h)
extern "C" int flash_attention_f32(const void* const* ins, void* const* outs,
                                   const long long* dims, const long long* strides, float scale,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dims[5]) {
    case 32:
      return launch<float>(flash_fwd_fma_kernel<32>, kThreads, kBT, fma_smem_bytes<32>(), ins,
                           outs, dims, strides, scale, s);
    case 64:
      return launch<float>(flash_fwd_fma_kernel<64>, kThreads, kBT, fma_smem_bytes<64>(), ins,
                           outs, dims, strides, scale, s);
    case 128:
      return launch<float>(flash_fwd_fma_kernel<128>, kThreads, kBT, fma_smem_bytes<128>(), ins,
                           outs, dims, strides, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int flash_attention_bf16(const void* const* ins, void* const* outs,
                                    const long long* dims, const long long* strides, float scale,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dims[5]) {
    case 32:
      return launch<__nv_bfloat16>(flash_fwd_mma_kernel<32>, kMmaThreads, kMT,
                                   mma_smem_bytes<32>(), ins, outs, dims, strides, scale, s);
    case 64:
      return launch<__nv_bfloat16>(flash_fwd_mma_kernel<64>, kMmaThreads, kMT,
                                   mma_smem_bytes<64>(), ins, outs, dims, strides, scale, s);
    case 128:
      return launch<__nv_bfloat16>(flash_fwd_mma_kernel<128>, kMmaThreads, kMT,
                                   mma_smem_bytes<128>(), ins, outs, dims, strides, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The same operands as flash_attention_bf16, through the wgmma + TMA kernel:
// D = 64 or 128, T >= 64, every stride but D's a multiple of 8 elements
// and the bases 16-byte aligned (the tensor maps' terms).
extern "C" int flash_attention_bf16_wgmma(const void* const* ins, void* const* outs,
                                          const long long* dims, const long long* strides,
                                          float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dims[5]) {
    case 64:
      return launch_wgmma<64>(ins, outs, dims, strides, scale, s);
    case 128:
      return launch_wgmma<128>(ins, outs, dims, strides, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
