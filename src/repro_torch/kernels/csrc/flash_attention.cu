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
// flops against 0.3 GB of q, k, v and o.
//
// Two kernels, one per input type; both keep the reference's f32 softmax
// state and f32 accumulation, skip causal tiles that lie wholly above the
// diagonal (they would add p = 0 with a rescale of exp(0) = 1, exactly
// nothing), and run the query tiles from the last (longest causal rows) to
// the first.
//
// bf16 (flash_fwd_mma_kernel): tensor cores through mma.sync m16n8k16 with
// f32 accumulators. A CTA of 4 warps owns 64 query rows of one head, 16 per
// warp; the query tile and each 64-key tile of K and V sit in shared memory
// as bf16 (rows padded by 16 bytes, so ldmatrix reads without bank
// conflicts), the K and V tiles in two buffers: cp.async fills the next
// tile's while the current one is used. A warp keeps its Q fragments in
// registers, computes its 16 x 64 scores, updates m and l for its rows
// (each row is spread over the four threads of a quad, reduced by
// shuffles), and feeds the probabilities to the P V product straight from
// the score registers. The reference's P V is f32, and V is exact in bf16,
// so P goes in as two bf16 A operands, hi = bf16(p) and lo = bf16(p - hi),
// which carry p to about 2^-17 (rounding p to bf16 alone would be 2^-9,
// as large as the output's own rounding): two mma per V fragment, half
// again the tensor-core work of a single bf16 P. The scores are kept in log2 units
// (scale * log2 e), so every exponential is one exp2f; m is then in log2
// units too, and p and the rescale factor are the reference's. wgmma and
// TMA are later work.
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
