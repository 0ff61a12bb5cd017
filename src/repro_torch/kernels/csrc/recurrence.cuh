// One Alg. 5 recurrence update per lane: the Sherman-Morrison Gauss
// update, the three pivot recurrences, and the Radau/Lobatto estimates
// from the Golub (1973) extensions.
//
// Replaces the body shared by the TPU kernels K1, K3 and K4:
// src/repro/kernels/gql_update.py, function recurrence_math (lines
// 22-62). Copied guard for guard: the _EPS clamps on every pivot and the
// sign-aware, never-zero denominator guard of sm(). jnp.maximum and
// jnp.minimum propagate NaN, so jmax/jmin do too. K1 (gql_update.cu) and
// the fused-step tail (step_tail.cuh, used by K3 and K4) include this one
// header, as the reference shares one body (lanczos_step.py:82).
#pragma once

namespace repro {

template <typename T>
__device__ __forceinline__ T jmax(T a, T b) {
  return (a != a || a > b) ? a : b;
}

template <typename T>
__device__ __forceinline__ T jmin(T a, T b) {
  return (a != a || a < b) ? a : b;
}

// out: g, c, delta, d_lr, d_rr, g_rr, g_lr, g_lo (the reference's order)
template <typename T>
__device__ __forceinline__ void recurrence_math(
    T alpha_n, T beta_n, T beta_p, T g, T c, T delta, T d_lr, T d_rr,
    T lam_min, T lam_max, T* out) {
  const T eps = T(1e-30);
  const T b2p = beta_p * beta_p;
  const T delta_s = jmax(delta, eps);
  const T dlr_s = jmax(d_lr, eps);
  const T drr_s = jmin(d_rr, -eps);

  const T den_g = delta_s * (alpha_n * delta_s - b2p);
  const T g_new = g + b2p * (c * c) / jmax(den_g, eps);
  const T c_new = c * beta_p / delta_s;
  const T delta_new = alpha_n - b2p / delta_s;
  const T dlr_new = alpha_n - lam_min - b2p / dlr_s;
  const T drr_new = alpha_n - lam_max - b2p / drr_s;

  // extensions with beta_{i+1}
  const T b2 = beta_n * beta_n;
  const T dlr_c = jmax(dlr_new, eps);
  const T drr_c = jmin(drr_new, -eps);
  const T dn_c = jmax(delta_new, eps);
  const T alpha_lr = lam_min + b2 / dlr_c;
  const T alpha_rr = lam_max + b2 / drr_c;
  const T den_lo = drr_c - dlr_c;
  const T b2_lo = (lam_max - lam_min) * dlr_c * drr_c / den_lo;
  const T alpha_lo = (lam_max * drr_c - lam_min * dlr_c) / den_lo;

  const T c2 = c_new * c_new;
  auto sm = [&](T alpha_hat, T b2_hat) {
    const T den = dn_c * (alpha_hat * dn_c - b2_hat);
    const T safe = (den >= T(0)) ? jmax(den, eps) : jmin(den, -eps);
    return g_new + b2_hat * c2 / safe;
  };
  out[0] = g_new;
  out[1] = c_new;
  out[2] = delta_new;
  out[3] = dlr_new;
  out[4] = drr_new;
  out[5] = sm(alpha_rr, b2);
  out[6] = sm(alpha_lr, b2);
  out[7] = sm(alpha_lo, b2_lo);
}

// Sum over a warp; every lane gets the total (fixed xor tree, so the
// result does not depend on scheduling).
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace repro
